"""OpenCL-C subset frontend: lexer → AST → SSA mini-IR → optimized IR → DFG.

This reproduces the paper's Clang/LLVM path (Table I) without an external
toolchain.  Supported kernel subset — exactly the shape of the paper's six
benchmarks (pointwise dataflow kernels):

    __kernel void name(__global TYPE *A, ..., __global TYPE *Out) {
        int idx = get_global_id(0);
        TYPE x = A[idx];
        TYPE t = <arith expr over locals/params/constants>;
        Out[idx] = <expr>;
    }

Pointer params indexed by ``get_global_id(0)`` become DFG invars (loads) and
outvars (stores).  Scalar (non-pointer) params become invars broadcast over
work-items.  The IR is SSA with LLVM-flavoured textual printing so the
intermediate artifacts in tests/docs look like the paper's Table I(b)/(c).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

from repro_torch.core.dfg import DFG, optimize

# ------------------------------------------------------------------- lexer

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|/\*.*?\*/|//[^\n]*)
  | (?P<num>\d+\.\d*([eE][-+]?\d+)?f?|\.\d+f?|\d+([eE][-+]?\d+)?f?)
  | (?P<id>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op>\(|\)|\{|\}|\[|\]|,|;|\*|\+|-|/|=)
""", re.VERBOSE | re.DOTALL)

_KEYWORDS = {"__kernel", "kernel", "void", "__global", "global", "int",
             "float", "short", "const"}
_TYPES = {"int", "float", "short"}


@dataclasses.dataclass
class Tok:
    kind: str
    text: str
    pos: int


def _lex(src: str) -> List[Tok]:
    toks, i = [], 0
    while i < len(src):
        m = _TOKEN_RE.match(src, i)
        if not m:
            raise SyntaxError(f"lex error at {src[i:i+20]!r}")
        i = m.end()
        if m.lastgroup == "ws":
            continue
        toks.append(Tok(m.lastgroup, m.group(), m.start()))
    toks.append(Tok("eof", "", len(src)))
    return toks


# ---------------------------------------------------------------- SSA IR

@dataclasses.dataclass
class Instr:
    """One SSA instruction. op in {param, gid, gep, load, store, bin, const}."""
    res: str                 # SSA name, e.g. '%7' ('' for store)
    op: str
    operands: Tuple[str, ...] = ()
    attr: Optional[str] = None   # binop kind / param name / constant literal

    def render(self) -> str:
        if self.op == "param":
            return f"{self.res} = param {self.attr}"
        if self.op == "gid":
            return (f"{self.res} = call i32 @get_global_id(i32 0)")
        if self.op == "gep":
            return (f"{self.res} = getelementptr inbounds i32* "
                    f"{self.operands[0]}, i32 {self.operands[1]}")
        if self.op == "load":
            return f"{self.res} = load i32* {self.operands[0]}"
        if self.op == "store":
            return f"store i32 {self.operands[0]}, i32* {self.operands[1]}"
        if self.op == "const":
            return f"{self.res} = const {self.attr}"
        return (f"{self.res} = {self.attr} nsw i32 "
                f"{', '.join(self.operands)}")


@dataclasses.dataclass
class Module:
    name: str
    params: List[Tuple[str, bool]]        # (name, is_pointer)
    instrs: List[Instr]

    def render(self) -> str:
        head = f"; kernel {self.name}\n%0:\n"
        return head + "\n".join("  " + i.render() for i in self.instrs)


# ---------------------------------------------------------------- parser

class _Parser:
    def __init__(self, src: str):
        self.toks = _lex(src)
        self.i = 0
        self.instrs: List[Instr] = []
        self.env: Dict[str, str] = {}      # C var -> SSA name
        self.params: List[Tuple[str, bool]] = []
        self.ptr_ssa: Dict[str, str] = {}  # pointer param -> SSA name
        self.gid: Optional[str] = None
        self.n = 0

    # token helpers
    def peek(self) -> Tok:
        return self.toks[self.i]

    def next(self) -> Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, text: str) -> Tok:
        t = self.next()
        if t.text != text:
            raise SyntaxError(f"expected {text!r}, got {t.text!r} @{t.pos}")
        return t

    def fresh(self) -> str:
        self.n += 1
        return f"%{self.n}"

    def emit(self, op: str, operands: Tuple[str, ...] = (),
             attr: Optional[str] = None) -> str:
        res = "" if op == "store" else self.fresh()
        self.instrs.append(Instr(res, op, operands, attr))
        return res

    # grammar
    def parse(self) -> Module:
        while self.peek().text in ("__kernel", "kernel"):
            self.next()
        self.expect("void")
        name = self.next().text
        self.expect("(")
        while self.peek().text != ")":
            is_ptr = False
            while self.peek().text in _KEYWORDS:
                self.next()
            if self.peek().text == "*":
                self.next()
                is_ptr = True
            pname = self.next().text
            self.params.append((pname, is_ptr))
            ssa = self.emit("param", attr=pname)
            if is_ptr:
                self.ptr_ssa[pname] = ssa
            else:
                self.env[pname] = ssa
            if self.peek().text == ",":
                self.next()
        self.expect(")")
        self.expect("{")
        while self.peek().text != "}":
            self.statement()
        self.expect("}")
        return Module(name, self.params, self.instrs)

    def statement(self) -> None:
        t = self.peek()
        if t.text in _TYPES or t.text == "const":
            while self.peek().text in _TYPES or self.peek().text == "const":
                self.next()
            var = self.next().text
            self.expect("=")
            self.env[var] = self.expr()
            self.expect(";")
            return
        # assignment:  lhs = expr ;   where lhs is var or ptr[idx]
        lhs = self.next().text
        if self.peek().text == "[":
            self.next()
            idx = self.expr()
            self.expect("]")
            self.expect("=")
            val = self.expr()
            self.expect(";")
            if lhs not in self.ptr_ssa:
                raise SyntaxError(f"store to non-pointer {lhs}")
            gep = self.emit("gep", (self.ptr_ssa[lhs], idx))
            self.emit("store", (val, gep))
            return
        self.expect("=")
        self.env[lhs] = self.expr()
        self.expect(";")

    # precedence climbing: + - < * /
    def expr(self) -> str:
        v = self.term()
        while self.peek().text in ("+", "-"):
            op = self.next().text
            r = self.term()
            v = self.emit("bin", (v, r), "add" if op == "+" else "sub")
        return v

    def term(self) -> str:
        v = self.unary()
        while self.peek().text in ("*", "/"):
            op = self.next().text
            if op == "/":
                raise SyntaxError("division not supported by the overlay FU")
            r = self.unary()
            v = self.emit("bin", (v, r), "mul")
        return v

    def unary(self) -> str:
        if self.peek().text == "-":
            self.next()
            v = self.unary()
            zero = self.emit("const", attr="0")
            return self.emit("bin", (zero, v), "sub")
        return self.atom()

    def atom(self) -> str:
        t = self.next()
        if t.text == "(":
            v = self.expr()
            self.expect(")")
            return v
        if t.kind == "num":
            return self.emit("const", attr=t.text.rstrip("f"))
        if t.kind != "id":
            raise SyntaxError(f"unexpected {t.text!r} @{t.pos}")
        if t.text == "get_global_id":
            self.expect("(")
            self.next()   # dimension literal
            self.expect(")")
            if self.gid is None:
                self.gid = self.emit("gid")
            return self.gid
        if self.peek().text == "[":               # pointer load  A[idx]
            self.next()
            idx = self.expr()
            self.expect("]")
            if t.text not in self.ptr_ssa:
                raise SyntaxError(f"load from non-pointer {t.text}")
            gep = self.emit("gep", (self.ptr_ssa[t.text], idx))
            return self.emit("load", (gep,))
        if t.text in self.env:
            return self.env[t.text]
        raise SyntaxError(f"undefined identifier {t.text!r} @{t.pos}")


def parse_kernel(src: str) -> Module:
    """OpenCL-C source → unoptimized SSA module (paper Table I(b) stage)."""
    return _Parser(src).parse()


# --------------------------------------------------------- IR optimization

def optimize_module(m: Module) -> Module:
    """Constant-fold + copy-propagate + DCE at IR level (Table I(c) stage).

    The heavyweight optimizations (CSE, algebraic) run on the DFG; here we do
    what LLVM's mem2reg+instcombine would: collapse constants and drop dead
    geps/loads.
    """
    consts: Dict[str, float] = {}
    out: List[Instr] = []
    remap: Dict[str, str] = {}

    def res(x: str) -> str:
        return remap.get(x, x)

    for ins in m.instrs:
        ops = tuple(res(o) for o in ins.operands)
        if ins.op == "const":
            consts[ins.res] = float(ins.attr)
            out.append(Instr(ins.res, "const", (), ins.attr))
            continue
        if ins.op == "bin" and all(o in consts for o in ops):
            a, b = (consts[o] for o in ops)
            v = {"add": a + b, "sub": a - b, "mul": a * b}[ins.attr]
            consts[ins.res] = v
            out.append(Instr(ins.res, "const", (), repr(v)))
            continue
        # x*1, x+0 identities
        if ins.op == "bin" and ins.attr == "mul" and any(
                o in consts and consts[o] == 1.0 for o in ops):
            keep = ops[0] if ops[1] in consts and consts[ops[1]] == 1.0 else ops[1]
            remap[ins.res] = keep
            continue
        if ins.op == "bin" and ins.attr == "add" and any(
                o in consts and consts[o] == 0.0 for o in ops):
            keep = ops[0] if ops[1] in consts and consts[ops[1]] == 0.0 else ops[1]
            remap[ins.res] = keep
            continue
        out.append(Instr(ins.res, ins.op, ops, ins.attr))

    # DCE: keep instructions reachable from stores
    live: set = set()
    by_res = {i.res: i for i in out if i.res}
    work = [o for i in out if i.op == "store" for o in i.operands]
    for i in out:
        if i.op == "store":
            live.add(id(i))
    while work:
        r = work.pop()
        i = by_res.get(r)
        if i is None or id(i) in live:
            continue
        live.add(id(i))
        work.extend(i.operands)
    pruned = [i for i in out if id(i) in live or i.op in ("param",)]
    return Module(m.name, m.params, pruned)


# -------------------------------------------------------------- DFG extract

def module_to_dfg(m: Module) -> DFG:
    """Optimized IR → DFG (paper §III-A step 2).

    Loads through ``ptr[gid]`` become invars, stores become outvars, scalar
    params become invars; gid/gep disappear (they are addressing, not data).
    """
    g = DFG(m.name)
    val: Dict[str, int] = {}
    param_of_gep: Dict[str, str] = {}
    ptr_loaded: Dict[str, int] = {}
    param_names = {i.res: i.attr for i in m.instrs if i.op == "param"}

    for ins in m.instrs:
        if ins.op == "param":
            ptr = any(p == ins.attr and is_ptr for p, is_ptr in m.params)
            if not ptr:
                val[ins.res] = g.add("input", name=f"S_{ins.attr}")
            continue
        if ins.op == "gid":
            continue
        if ins.op == "gep":
            param_of_gep[ins.res] = param_names.get(ins.operands[0], "?")
            continue
        if ins.op == "load":
            pname = param_of_gep[ins.operands[0]]
            if pname not in ptr_loaded:
                ptr_loaded[pname] = g.add("input", name=f"I_{pname}")
            val[ins.res] = ptr_loaded[pname]
            continue
        if ins.op == "const":
            val[ins.res] = g.add("const", imm=float(ins.attr))
            continue
        if ins.op == "store":
            pname = param_of_gep[ins.operands[1]]
            g.add("output", (val[ins.operands[0]],), name=f"O_{pname}")
            continue
        if ins.op == "bin":
            a, b = (val[o] for o in ins.operands)
            val[ins.res] = g.add(ins.attr, (a, b))
            continue
        raise ValueError(f"unhandled IR op {ins.op}")
    return g


def compile_opencl_to_dfg(src: str) -> DFG:
    """Full frontend: source → lex/parse → SSA → opt → DFG → DFG-opt."""
    m = parse_kernel(src)
    m = optimize_module(m)
    g = module_to_dfg(m)
    return optimize(_lower_consts(g))


def _lower_consts(g: DFG) -> DFG:
    """Turn const nodes feeding binary ops into immediates (FU-config form)."""
    g = g.copy()
    for n in list(g.nodes.values()):
        if n.op in ("add", "sub", "mul", "min", "max") and len(n.args) == 2:
            a, b = n.args
            an, bn = g.nodes[a], g.nodes[b]
            if bn.op == "const":
                n.args, n.imm = (a,), bn.imm
            elif an.op == "const":
                if n.op == "sub":           # const - x  →  rsub(x, imm)
                    n.op, n.args, n.imm = "rsub", (b,), an.imm
                else:                        # commutative
                    n.args, n.imm = (b,), an.imm
    from repro_torch.core.dfg import dce
    return dce(g)
