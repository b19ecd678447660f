"""Pass family 1: DFG semantic checks (codes A001-A006).

These mirror — and go beyond — ``DFG.validate``, but report *all* findings
as diagnostics instead of raising on the first, and they never crash on a
malformed graph (a DFG whose ``nodes`` dict was corrupted by a buggy
rewrite is exactly the input they exist for).

``fuse_dfgs`` runs :func:`check_dfg` on every fused result (see
``repro_torch.core.fuse``), so a fusion bug that drops a dependency or leaves a
dead operator is caught before the compile pipeline spends placement
effort on it.
"""

from __future__ import annotations

from typing import List, Optional

from repro_torch.core.dfg import _ARITY, DFG

from .diagnostics import Diagnostic, ERROR, Span, VerificationError, diag

# ops whose FU configuration has an immediate field
_IMM_OPS = ("add", "sub", "rsub", "mul", "muladd", "mulsub",
            "imuladd", "imulsub", "min", "max")


def _span(g: DFG, nid: Optional[int] = None) -> Span:
    node = None
    if nid is not None:
        n = g.nodes.get(nid)
        node = n.name if n is not None and n.name else f"N{nid}"
    return Span(target=g.name, node=node)


def check_dfg(g: DFG, origin: str = "") -> List[Diagnostic]:
    """Run every DFG semantic check; returns all findings.

    ``origin`` (e.g. ``"fuse"``, ``"partition[2]"``) is prefixed to the
    span target so a report over many DFGs stays attributable.
    """
    out: List[Diagnostic] = []
    prefix = f"{origin}:" if origin else ""

    def span(nid: Optional[int] = None) -> Span:
        s = _span(g, nid)
        return Span(target=prefix + s.target, node=s.node) if prefix else s

    # --- A001: undefined producers --------------------------------------
    for n in list(g.nodes.values()):
        for a in n.args:
            if a not in g.nodes:
                out.append(diag(
                    "A001", span(n.nid),
                    f"node {n.name or n.nid} ({n.op}) reads operand N{a}, "
                    f"which does not exist in the DFG"))

    # --- A003: IO perimeter consistency ---------------------------------
    for idx, o in enumerate(g.outputs):
        n = g.nodes.get(o)
        if n is None:
            out.append(diag(
                "A003", span(),
                f"outputs[{idx}] names node N{o}, which does not exist"))
        elif n.op != "output":
            out.append(diag(
                "A003", span(o),
                f"outputs[{idx}] names node {n.name or o} of op "
                f"{n.op!r}, not an 'output' node"))
    for idx, i in enumerate(g.inputs):
        n = g.nodes.get(i)
        if n is None:
            out.append(diag(
                "A003", span(),
                f"inputs[{idx}] names node N{i}, which does not exist"))
        elif n.op != "input":
            out.append(diag(
                "A003", span(i),
                f"inputs[{idx}] names node {n.name or i} of op "
                f"{n.op!r}, not an 'input' node"))
    in_set, out_set = set(g.inputs), set(g.outputs)
    for n in list(g.nodes.values()):
        if n.op == "input" and n.nid not in in_set:
            out.append(diag(
                "A003", span(n.nid),
                f"'input' node {n.name or n.nid} is not in the inputs "
                f"list — consumers read a buffer no kernel argument ever "
                f"writes"))
        if n.op == "output" and n.nid not in out_set:
            out.append(diag(
                "A003", span(n.nid),
                f"'output' node {n.name or n.nid} is not in the outputs "
                f"list — its store never leaves the fabric"))

    # --- A004 / A006: arity, opcode and immediate legality ---------------
    for n in list(g.nodes.values()):
        if n.op not in _ARITY:
            out.append(diag(
                "A004", span(n.nid),
                f"node {n.name or n.nid} has unknown op {n.op!r}"))
            continue
        if n.op == "const":
            if n.args:
                out.append(diag(
                    "A006", span(n.nid),
                    f"const node {n.name or n.nid} has {len(n.args)} "
                    f"operand(s); constants take none"))
            if n.imm is None:
                out.append(diag(
                    "A006", span(n.nid),
                    f"const node {n.name or n.nid} carries no immediate "
                    f"value"))
            continue
        if n.op == "input":
            if n.args:
                out.append(diag(
                    "A004", span(n.nid),
                    f"input node {n.name or n.nid} has operands"))
            continue
        have = len(n.args) + (1 if n.imm is not None and
                              n.op in _IMM_OPS else 0)
        if have != _ARITY[n.op]:
            out.append(diag(
                "A004", span(n.nid),
                f"node {n.name or n.nid} ({n.op}) has {have} operand(s) "
                f"(args={len(n.args)}"
                + (", imm" if n.imm is not None and n.op in _IMM_OPS
                   else "")
                + f"), op takes {_ARITY[n.op]}"))
        if n.imm is not None and n.op not in _IMM_OPS:
            out.append(diag(
                "A006", span(n.nid),
                f"node {n.name or n.nid} ({n.op}) carries immediate "
                f"{n.imm!r}, but {n.op!r} has no immediate field — the "
                f"bitstream packer would drop it"))

    # --- A005: cycles (Kahn; only over well-formed edges) ----------------
    indeg = {nid: 0 for nid in g.nodes}
    users = {nid: [] for nid in g.nodes}
    for n in g.nodes.values():
        for a in n.args:
            if a in g.nodes:
                indeg[n.nid] += 1
                users[a].append(n.nid)
    ready = [nid for nid, d in indeg.items() if d == 0]
    seen = 0
    while ready:
        nid = ready.pop()
        seen += 1
        for u in users[nid]:
            indeg[u] -= 1
            if indeg[u] == 0:
                ready.append(u)
    if seen != len(g.nodes):
        cyc = sorted(nid for nid, d in indeg.items() if d > 0)
        names = ", ".join(
            (g.nodes[nid].name or f"N{nid}") for nid in cyc[:8])
        out.append(diag(
            "A005", span(),
            f"dependency cycle through {len(cyc)} node(s): {names}"
            + (" ..." if len(cyc) > 8 else "")))
        return out  # reachability below needs an acyclic graph

    # --- A002: dead nodes (unreachable from every output) ----------------
    live: set = set()
    stack = [o for o in g.outputs if o in g.nodes]
    while stack:
        nid = stack.pop()
        if nid in live:
            continue
        live.add(nid)
        stack.extend(a for a in g.nodes[nid].args if a in g.nodes)
    for n in list(g.nodes.values()):
        if n.op in ("input", "output", "const"):
            continue
        if n.nid not in live:
            out.append(diag(
                "A002", span(n.nid),
                f"op node {n.name or n.nid} ({n.op}) is unreachable from "
                f"every output; it would occupy an FU for nothing",
                fixit="run repro_torch.core.dfg.dce (or optimize) before "
                      "compiling"))

    return out


def assert_clean(g: DFG, origin: str = "") -> List[Diagnostic]:
    """Run :func:`check_dfg`; raise :class:`VerificationError` if any
    finding is error-severity.  Returns the (possibly warning-only)
    findings otherwise."""
    diags = check_dfg(g, origin=origin)
    errors = [d for d in diags if d.severity == ERROR]
    if errors:
        raise VerificationError(
            f"DFG {g.name!r} failed semantic checks: "
            + "; ".join(str(d) for d in errors[:4])
            + (f" (+{len(errors) - 4} more)" if len(errors) > 4 else ""),
            diags)
    return diags
