"""Dataflow-graph (DFG) representation of an OpenCL compute kernel.

This is the paper's central IR (Table II / Fig. 3): nodes are operations,
edges carry 16/32-bit scalar values between them, inputs are ``invar`` nodes
(one per kernel work-item load) and outputs are ``outvar`` nodes (stores).

Two frontends build DFGs:
  * :mod:`repro_torch.core.ir` — the OpenCL-C subset parser (paper's Clang/LLVM path),
  * :func:`trace` here — a Python operator-overloading tracer so model code
    can declare pointwise kernels directly (``overlay_jit``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# Primitive operations executable by a single DSP-block FU (paper §III-B).
# ``muladd``/``mulsub`` are the DSP48 fused forms; ``imm`` variants carry a
# constant operand baked into the FU configuration.
PRIMITIVE_OPS = (
    "add", "sub", "mul", "muladd", "mulsub", "imuladd", "imulsub", "pass",
    "min", "max", "abs", "neg", "rsub",
)

# imuladd/imulsub carry the immediate on the *multiplier* port:
#   imuladd(a, c) imm=k  =  a*k + c      imulsub(a, c) imm=k  =  a*k - c
_ARITY = {
    "add": 2, "sub": 2, "rsub": 2, "mul": 2, "min": 2, "max": 2,
    "muladd": 3, "mulsub": 3, "imuladd": 3, "imulsub": 3,
    "pass": 1, "abs": 1, "neg": 1,
    "input": 0, "output": 1, "const": 0,
}


@dataclasses.dataclass
class Node:
    """One DFG node.

    op:    one of PRIMITIVE_OPS or 'input' / 'output' / 'const'.
    args:  node ids of operands (in order).
    imm:   optional immediate constant used as the *last* operand.
    """

    nid: int
    op: str
    args: Tuple[int, ...] = ()
    imm: Optional[float] = None
    name: str = ""

    @property
    def arity(self) -> int:
        return _ARITY[self.op]


class DFG:
    """A kernel dataflow graph. Nodes are stored in topological order."""

    def __init__(self, name: str = "kernel"):
        self.name = name
        self.nodes: Dict[int, Node] = {}
        self.inputs: List[int] = []   # invar node ids, in argument order
        self.outputs: List[int] = []  # outvar node ids, in result order
        self._next = 0
        # set by optimize(): lets the JIT frontend skip re-optimizing a DFG
        # that already went through the pass pipeline (e.g. the cache-keying
        # path lowers source before the frontend stage runs)
        self.optimized = False

    # ------------------------------------------------------------- building
    def add(self, op: str, args: Sequence[int] = (), imm: Optional[float] = None,
            name: str = "") -> int:
        for a in args:
            if a not in self.nodes:
                raise ValueError(f"dangling operand {a} for op {op}")
        nid = self._next
        self._next += 1
        self.nodes[nid] = Node(nid, op, tuple(args), imm, name or f"{op}_N{nid}")
        if op == "input":
            self.inputs.append(nid)
        elif op == "output":
            self.outputs.append(nid)
        self.optimized = False   # mutation invalidates the optimized form
        return nid

    # ------------------------------------------------------------ structure
    def users(self) -> Dict[int, List[int]]:
        u: Dict[int, List[int]] = {nid: [] for nid in self.nodes}
        for n in self.nodes.values():
            for a in n.args:
                u[a].append(n.nid)
        return u

    def op_nodes(self) -> List[Node]:
        return [n for n in self.nodes.values()
                if n.op not in ("input", "output", "const")]

    @property
    def n_ops(self) -> int:
        return len(self.op_nodes())

    @property
    def n_io(self) -> int:
        return len(self.inputs) + len(self.outputs)

    def toposort(self) -> List[Node]:
        order: List[Node] = []
        done: set = set()
        # nodes dict preserves insertion order which is already topological for
        # both frontends, but re-verify (fusion rewrites can permute ids).
        pending = list(self.nodes.values())
        while pending:
            progressed = False
            rest = []
            for n in pending:
                if all(a in done for a in n.args):
                    order.append(n)
                    done.add(n.nid)
                    progressed = True
                else:
                    rest.append(n)
            if not progressed:
                raise ValueError(f"cycle in DFG {self.name}")
            pending = rest
        return order

    def depth(self) -> int:
        """Longest op chain input→output (pipeline depth in FU hops)."""
        d: Dict[int, int] = {}
        for n in self.toposort():
            base = max((d[a] for a in n.args), default=0)
            d[n.nid] = base + (1 if n.op not in ("input", "output", "const") else 0)
        return max((d[o] for o in self.outputs), default=0)

    # ----------------------------------------------------------- evaluation
    def evaluate(self, inputs: Sequence[Any], ops: Optional[Dict[str, Callable]] = None
                 ) -> List[Any]:
        """Topologically evaluate the DFG.

        Works for numpy arrays, torch tensors and python scalars: this is
        both the reference oracle for the overlay executor and the "compiled
        mode" used to embed overlay programs in larger torch computations.
        """
        if len(inputs) != len(self.inputs):
            raise ValueError(
                f"{self.name}: expected {len(self.inputs)} inputs, got {len(inputs)}")
        fns = _default_ops()
        if ops:
            fns.update(ops)
        env: Dict[int, Any] = {}
        for n in self.toposort():
            if n.op == "input":
                env[n.nid] = inputs[self.inputs.index(n.nid)]
            elif n.op == "const":
                env[n.nid] = n.imm
            elif n.op == "output":
                env[n.nid] = env[n.args[0]]
            else:
                a = [env[x] for x in n.args]
                if n.imm is not None:
                    a.append(n.imm)
                env[n.nid] = fns[n.op](*a)
        return [env[o] for o in self.outputs]

    # -------------------------------------------------------------- utility
    def validate(self) -> None:
        users = self.users()
        for n in self.nodes.values():
            want = n.arity
            have = len(n.args) + (1 if n.imm is not None and
                                  n.op in ("add", "sub", "rsub", "mul", "muladd",
                                           "mulsub", "imuladd", "imulsub",
                                           "min", "max") else 0)
            if n.op in ("input", "const"):
                continue
            if have != want:
                raise ValueError(f"{self.name}:{n.name}: arity {have} != {want}")
        for o in self.outputs:
            if self.nodes[o].op != "output":
                raise ValueError("outputs list corrupt")
        for n in self.op_nodes():
            if not users[n.nid]:
                raise ValueError(f"dead op node {n.name} (run DCE first)")

    def to_dot(self) -> str:
        lines = [f'digraph {self.name} {{']
        for n in self.nodes.values():
            kind = {"input": "invar", "output": "outvar", "const": "const"}.get(
                n.op, "operation")
            label = n.name if n.imm is None or n.op in ("input", "output") else \
                f"{n.op}_Imm_{n.imm:g}_N{n.nid}"
            lines.append(f'  N{n.nid} [ntype="{kind}", label="{label}"];')
        for n in self.nodes.values():
            for a in n.args:
                lines.append(f"  N{a} -> N{n.nid};")
        lines.append("}")
        return "\n".join(lines)

    def copy(self, name: Optional[str] = None) -> "DFG":
        g = DFG(name or self.name)
        g.nodes = {k: dataclasses.replace(v) for k, v in self.nodes.items()}
        g.inputs = list(self.inputs)
        g.outputs = list(self.outputs)
        g._next = self._next
        g.optimized = self.optimized
        return g


def _default_ops() -> Dict[str, Callable]:
    return {
        "add": lambda a, b: a + b,
        "sub": lambda a, b: a - b,
        "rsub": lambda a, b: b - a,
        "mul": lambda a, b: a * b,
        "muladd": lambda a, b, c: a * b + c,
        "mulsub": lambda a, b, c: a * b - c,
        # imm arrives as the last positional arg; it is the multiplier k
        "imuladd": lambda a, c, k: a * k + c,
        "imulsub": lambda a, c, k: a * k - c,
        "pass": lambda a: a,
        "abs": abs,
        "neg": lambda a: -a,
        # torch tensors, numpy arrays and python scalars alike, with
        # np.minimum/np.maximum semantics (NaN propagates)
        "min": _generic_min,
        "max": _generic_max,
    }


def tensor_minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``np.minimum`` on tensors: a NaN in either operand propagates, and on
    a tie (+0 against -0) the second operand is kept.  ``torch.minimum``
    keeps the first operand on a tie in its scalar CPU loop and the second
    in its vectorised one, so the result would depend on the length."""
    return torch.where((a < b) | torch.isnan(a), a, b)


def tensor_maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``np.maximum`` on tensors; see :func:`tensor_minimum`."""
    return torch.where((a > b) | torch.isnan(a), a, b)


def _generic_min(a, b):
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return tensor_minimum(*_as_tensor_pair(a, b))
    if isinstance(a, (float, int)) and isinstance(b, (float, int)):
        return min(a, b)
    return np.minimum(a, b)


def _generic_max(a, b):
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return tensor_maximum(*_as_tensor_pair(a, b))
    if isinstance(a, (float, int)) and isinstance(b, (float, int)):
        return max(a, b)
    return np.maximum(a, b)


def _as_tensor_pair(a, b):
    """Lift a scalar operand to a 0-d tensor of the other operand's dtype
    and device (the same f32 rounding numpy applies to a python float
    against an f32 array)."""
    t = a if isinstance(a, torch.Tensor) else b
    lift = (lambda v: v if isinstance(v, torch.Tensor)
            else torch.as_tensor(v, dtype=t.dtype, device=t.device))
    return lift(a), lift(b)


# ===================================================================== tracer

class TraceVal:
    """Operator-overloading value used by :func:`trace`."""

    __slots__ = ("g", "nid")
    __array_priority__ = 100  # beat numpy scalars

    def __init__(self, g: DFG, nid: int):
        self.g = g
        self.nid = nid

    def _bin(self, op: str, other: Any, swap: bool = False) -> "TraceVal":
        if isinstance(other, TraceVal):
            if other.g is not self.g:
                raise ValueError("mixing values from different traces")
            args = (other.nid, self.nid) if swap else (self.nid, other.nid)
            return TraceVal(self.g, self.g.add(op, args))
        imm = float(other)
        if swap and op == "sub":       # imm - x
            return TraceVal(self.g, self.g.add("rsub", (self.nid,), imm=imm))
        return TraceVal(self.g, self.g.add(op, (self.nid,), imm=imm))

    def __add__(self, o):  return self._bin("add", o)
    def __radd__(self, o): return self._bin("add", o)
    def __sub__(self, o):  return self._bin("sub", o)
    def __rsub__(self, o): return self._bin("sub", o, swap=True)
    def __mul__(self, o):  return self._bin("mul", o)
    def __rmul__(self, o): return self._bin("mul", o)
    def __neg__(self):     return TraceVal(self.g, self.g.add("neg", (self.nid,)))
    def __abs__(self):     return TraceVal(self.g, self.g.add("abs", (self.nid,)))

    def min(self, o):      return self._bin("min", o)
    def max(self, o):      return self._bin("max", o)


def trace(fn: Callable, n_inputs: int, name: Optional[str] = None) -> DFG:
    """Trace a python function of TraceVals into a DFG.

    >>> g = trace(lambda x: x*(x*(16*x*x - 20)*x + 5), 1, 'chebyshev')
    """
    g = DFG(name or getattr(fn, "__name__", "kernel"))
    args = [TraceVal(g, g.add("input", name=f"I{i}_N{i}")) for i in range(n_inputs)]
    out = fn(*args)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    for i, o in enumerate(outs):
        if not isinstance(o, TraceVal):
            raise TypeError("kernel returned a constant; nothing to map")
        g.add("output", (o.nid,), name=f"O{i}")
    return g


# ============================================================ graph rewrites

def dce(g: DFG) -> DFG:
    """Remove op nodes not reachable from an output."""
    live: set = set()
    stack = list(g.outputs)
    while stack:
        nid = stack.pop()
        if nid in live:
            continue
        live.add(nid)
        stack.extend(g.nodes[nid].args)
    live.update(g.inputs)  # kernel signature is fixed even if an arg is unused
    out = DFG(g.name)
    out.nodes = {nid: dataclasses.replace(g.nodes[nid])
                 for nid in g.nodes if nid in live}
    out.inputs = list(g.inputs)
    out.outputs = list(g.outputs)
    out._next = g._next
    return out


def cse(g: DFG) -> DFG:
    """Common-subexpression elimination (structural hashing)."""
    g = g.copy()
    remap: Dict[int, int] = {}
    seen: Dict[Tuple, int] = {}
    for n in g.toposort():
        args = tuple(remap.get(a, a) for a in n.args)
        n.args = args
        if n.op in ("input", "output"):
            continue
        commutative = n.op in ("add", "mul", "min", "max")
        key_args = tuple(sorted(args)) if commutative else args
        key = (n.op, key_args, n.imm)
        if key in seen:
            remap[n.nid] = seen[key]
        else:
            seen[key] = n.nid
    if remap:
        for n in g.nodes.values():
            n.args = tuple(remap.get(a, a) for a in n.args)
        g = dce(g)
    return g


def constant_fold(g: DFG) -> DFG:
    """Fold ops whose operands are all constants."""
    g = g.copy()
    fns = _default_ops()
    const: Dict[int, float] = {n.nid: n.imm for n in g.nodes.values()
                               if n.op == "const"}
    for n in g.toposort():
        if n.op in ("input", "output", "const"):
            continue
        if all(a in const for a in n.args):
            a = [const[x] for x in n.args]
            if n.imm is not None:
                a.append(n.imm)
            val = float(fns[n.op](*a))
            const[n.nid] = val
            n.op, n.args, n.imm = "const", (), val
    return dce(g)


def optimize(g: DFG) -> DFG:
    """The paper's 'LLVM optimization passes' analogue at DFG level."""
    g = constant_fold(g)
    g = cse(g)
    g = dce(g)
    g.validate()
    g.optimized = True
    return g
