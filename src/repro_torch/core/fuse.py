"""DFG → FU-aware DFG transformation (paper §III-B, Fig. 3(a)→(b)/(d)).

A DSP48-style FU computes ``(a*b) ± c`` in one pass, so a ``mul`` whose single
user is an ``add``/``sub`` collapses into one FU (``muladd``/``mulsub``).
With two DSP blocks per FU (paper Fig. 3(d)) a further chained pair of
DSP-sized ops merges into a single placed FU ("super-node").

The output of this pass is what gets replicated, placed and routed: its node
count is the paper's "FU requirement" for the kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, Iterable, List, Sequence, Tuple

from repro_torch.core.dfg import DFG, dce, optimize


class FusionError(ValueError):
    """A requested kernel fusion is malformed (bad wiring, wrong arity,
    parts out of dependency order)."""

# ops a single DSP block can absorb as the multiply stage
_MUL_OPS = ("mul",)
# ops absorbable as the post-adder given a preceding multiply
_POST = {"add": "muladd", "sub": "mulsub"}


def fuse_muladd(g: DFG) -> DFG:
    """Collapse mul→add / mul→sub chains with single-use muls into fused FUs.

    Fusable forms (one DSP pass each):
      muladd(a, b, c)       = a*b + c        from  add(mul(a,b), c)
      mulsub(a, b, c)       = a*b - c        from  sub(mul(a,b), c)
      muladd(a, b) imm=k    = a*b + k        from  add-imm(mul(a,b), k)
      muladd(a, c) imm=k    = a*k + c        from  add(mul-imm(a,k), c)
    A node carrying two immediates (a*k1 + k2) is not representable on one
    FU config word and is left unfused.
    """
    g = g.copy()
    users = g.users()
    for n in list(g.nodes.values()):
        if n.op not in _POST:
            continue
        for slot, a in enumerate(n.args):
            m = g.nodes[a]
            if m.op != "mul" or len(users[a]) != 1:
                continue
            if any(g.nodes[o].op == "output" and o == a for o in ()):
                continue
            if n.op == "sub" and slot == 1:
                # x - (a*b): the DSP post-adder computes a*b ± c, not c - a*b.
                continue
            other = n.args[1 - slot] if len(n.args) == 2 else None
            if m.imm is not None and n.imm is not None:
                continue  # two immediates: not representable
            fused = _POST[n.op]
            if m.imm is not None:
                # (a * k) ± other  →  imuladd/imulsub(a, other) imm=k
                if other is None:
                    continue
                fused = {"muladd": "imuladd", "mulsub": "imulsub"}[fused]
                n.op, n.args, n.imm = fused, (m.args[0], other), m.imm
            elif other is None:
                # (a*b) ± k  →  fused(a, b) imm=k (imm is addend port)
                n.op, n.args = fused, (m.args[0], m.args[1])
            else:
                n.op, n.args, n.imm = fused, (m.args[0], m.args[1], other), None
            n.name = f"{fused}_N{n.nid}"
            users[a] = []
            break
    return dce(g)


@dataclasses.dataclass
class SuperNode:
    """A placed FU containing 1..dsp_per_fu primitive DFG nodes (a chain)."""
    sid: int
    members: List[int]                     # DFG node ids, producer order
    inputs: List[int] = dataclasses.field(default_factory=list)   # sids/-1-k
    # external input sources: list of ('fu', sid) or ('in', invar_index)


class FUGraph:
    """FU-level netlist: what placement and routing operate on.

    nodes: SuperNodes; edges: (src_sid, dst_sid, dst_port).
    Kernel I/O appears as dedicated IO nodes so VPR-style P&R can pin them to
    the overlay perimeter.
    """

    def __init__(self, g: DFG, dsp_per_fu: int = 2):
        self.dfg = g
        self.dsp_per_fu = dsp_per_fu
        self.supers: List[SuperNode] = []
        self.node_of: Dict[int, int] = {}      # dfg nid -> sid
        self._cluster(g, dsp_per_fu)
        self.edges: List[Tuple[str, int, str, int, int]] = []  # (skind,sid,dkind,did,port)
        self._build_edges(g)

    # -- clustering: chain-pack up to dsp_per_fu dependent ops into one FU
    def _cluster(self, g: DFG, k: int) -> None:
        users = g.users()
        order = [n for n in g.toposort() if n.op not in ("input", "output", "const")]
        taken: Dict[int, int] = {}
        for n in order:
            if n.nid in taken:
                continue
            chain = [n.nid]
            cur = n
            while len(chain) < k:
                us = [u for u in users[cur.nid]
                      if g.nodes[u].op not in ("output",) and u not in taken]
                # extend only through a single-use edge, keeping the chain a
                # pure pipeline inside the FU
                if len(users[cur.nid]) == 1 and len(us) == 1:
                    nxt = g.nodes[us[0]]
                    chain.append(nxt.nid)
                    cur = nxt
                else:
                    break
            sid = len(self.supers)
            self.supers.append(SuperNode(sid, chain))
            for c in chain:
                taken[c] = sid
        self.node_of = taken

    def _build_edges(self, g: DFG) -> None:
        # IO nodes: invars get kind 'in', outvars kind 'out'
        self.in_ids = {nid: i for i, nid in enumerate(g.inputs)}
        self.out_ids = {nid: i for i, nid in enumerate(g.outputs)}
        for s in self.supers:
            ports = 0
            internal = set(s.members)
            for m in s.members:
                for a in g.nodes[m].args:
                    if a in internal:
                        continue
                    src = g.nodes[a]
                    if src.op == "input":
                        self.edges.append(("in", self.in_ids[a], "fu", s.sid, ports))
                    elif src.op == "const":
                        pass  # baked into FU config
                    else:
                        self.edges.append(("fu", self.node_of[a], "fu", s.sid, ports))
                    ports += 1
        for nid, oi in self.out_ids.items():
            src = g.nodes[nid].args[0]
            sn = g.nodes[src]
            if sn.op == "input":
                self.edges.append(("in", self.in_ids[src], "out", oi, 0))
            else:
                self.edges.append(("fu", self.node_of[src], "out", oi, 0))

    @property
    def n_fus(self) -> int:
        return len(self.supers)

    @property
    def n_in(self) -> int:
        return len(self.in_ids)

    @property
    def n_out(self) -> int:
        return len(self.out_ids)

    @property
    def n_io(self) -> int:
        return self.n_in + self.n_out


def to_fu_graph(g: DFG, dsp_per_fu: int = 2) -> FUGraph:
    """DFG → fused → clustered FU netlist."""
    return FUGraph(fuse_muladd(g), dsp_per_fu=dsp_per_fu)


# ======================================================== n-ary kernel fusion

# how one input of a fused part is fed:
#   ("ext", key)           — an external buffer; equal keys share ONE fused
#                            input (alias-safe: the value is read-only)
#   ("int", src_idx, oidx) — output ``oidx`` of the EARLIER part ``src_idx``
FuseRef = Tuple


def fuse_dfgs(parts: Sequence[Tuple[DFG, Sequence[FuseRef]]],
              keep_outputs: Iterable[Tuple[int, int]],
              name: str = "fused",
              run_optimize: bool = True) -> Tuple[DFG, List[Hashable]]:
    """Merge several kernel DFGs into ONE fused DFG (graph-replay tentpole).

    ``parts[i] = (dfg, args)`` wires input ``j`` of that dfg to ``args[j]``
    (a :data:`FuseRef`).  Values flowing between parts are stitched
    producer-to-consumer directly — the producer's ``output`` node and the
    consumer's ``input`` node are both **elided**, so an intermediate buffer
    costs neither an IO pad nor a perimeter route in the fused artifact.
    Only ``keep_outputs`` (``(part_idx, output_idx)``, in the order the
    fused kernel should expose them) survive as real outputs: everything a
    later partition or the graph's caller needs to observe.

    Returns ``(fused_dfg, ext_keys)`` where ``ext_keys`` lists the distinct
    external-input keys in fused-input order (first appearance): the launch
    path gathers the actual buffers in exactly this order.

    The merged graph is re-run through :func:`~repro_torch.core.dfg.optimize`
    (``run_optimize``), so subexpressions duplicated ACROSS the constituent
    kernels collapse too — fusion is where cross-kernel CSE becomes legal.
    Evaluation order of every surviving op is unchanged (same primitive ops
    on the same float32 values), so the fused kernel is numerically
    identical to running the parts back-to-back.
    """
    fused = DFG(name)
    ext_ids: Dict[Hashable, int] = {}
    val: Dict[Tuple[int, int], int] = {}       # (part, local nid) -> fused nid
    out_src: Dict[Tuple[int, int], int] = {}   # (part, out idx)  -> fused nid
    for i, (g, args) in enumerate(parts):
        if len(args) != len(g.inputs):
            raise FusionError(
                f"{name}: part {i} ({g.name}) takes {len(g.inputs)} inputs, "
                f"wiring gives {len(args)}")
        for n in g.toposort():
            if n.op == "input":
                ref = args[g.inputs.index(n.nid)]
                if ref[0] == "ext":
                    key = ref[1]
                    if key not in ext_ids:
                        ext_ids[key] = fused.add(
                            "input", name=f"I{len(ext_ids)}")
                    val[(i, n.nid)] = ext_ids[key]
                elif ref[0] == "int":
                    src = (ref[1], ref[2])
                    if ref[1] >= i or src not in out_src:
                        raise FusionError(
                            f"{name}: part {i} reads output {ref[2]} of "
                            f"part {ref[1]} — parts must be wired in "
                            f"dependency order")
                    val[(i, n.nid)] = out_src[src]
                else:
                    raise FusionError(f"{name}: unknown input ref {ref!r}")
            elif n.op == "output":
                out_src[(i, g.outputs.index(n.nid))] = val[(i, n.args[0])]
            elif n.op == "const":
                val[(i, n.nid)] = fused.add("const", imm=n.imm)
            else:
                val[(i, n.nid)] = fused.add(
                    n.op, tuple(val[(i, a)] for a in n.args), imm=n.imm)
    for pos, (i, oi) in enumerate(keep_outputs):
        if (i, oi) not in out_src:
            raise FusionError(f"{name}: keep_outputs names output {oi} of "
                              f"part {i}, which does not exist")
        fused.add("output", (out_src[(i, oi)],), name=f"O{pos}")
    if not fused.outputs:
        raise FusionError(f"{name}: fusion exposes no outputs")
    fused = optimize(fused) if run_optimize else fused
    # every fused DFG goes through the static analyzer before it can reach
    # a compile: a fusion bug (dropped dependency, dead operator, broken IO
    # perimeter) surfaces here as a FusionError with structured findings,
    # not as a mis-mapped artifact.  Lazy import — repro_torch.analysis depends
    # on this module.
    from repro_torch.analysis import dfg_checks as _dfg_checks
    bad = [d for d in _dfg_checks.check_dfg(fused, origin="fuse")
           if d.severity == "error"]
    if bad:
        raise FusionError(
            f"{name}: fused DFG failed semantic checks: "
            + "; ".join(str(d) for d in bad[:4])
            + (f" (+{len(bad) - 4} more)" if len(bad) > 4 else ""))
    return fused, list(ext_ids.keys())
