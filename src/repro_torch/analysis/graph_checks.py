"""Pass family 2: race/alias analysis over captured KernelGraphs and
their partition cuts (codes A101-A109).

A captured graph is SSA — every ``GraphBuffer`` names one node-output
written exactly once — so the classic hazards map onto structure:

* RAW race  -> a read whose producer replays *later* (A101): replay runs
  nodes in recording order, so a forward reference reads stale memory.
* WAW race  -> two nodes sharing one nid (A102): every buffer naming that
  id resolves to whichever write replay performs last.
* WAR race  -> impossible within one SSA graph, but reappears at the
  partition level when a cross-partition edge is missing from the
  partition DAG (A105): without the dep edge, replay may overlap the
  reader with (or order it before) the writer.
* aliasing  -> one external buffer bound to two fused-input slots, or a
  partition feeding itself through its own "external" inputs (A108).

``check_graph`` runs on a graph alone; ``check_partitions`` additionally
proves a partition cut against the graph it claims to cover (coverage,
dep-DAG shape, fused-IO wiring) and re-runs the A0xx DFG checks on every
fused partition kernel.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from repro_torch.core.graph import KernelGraph, Partition

from .diagnostics import Diagnostic, Span, diag

from .dfg_checks import check_dfg


def _node_span(g: KernelGraph, nid: int) -> Span:
    return Span(target=g.name, node=f"N{nid}")


def check_graph(g: KernelGraph) -> List[Diagnostic]:
    """Def-use analysis of one captured graph (A101-A104)."""
    out: List[Diagnostic] = []

    # first recording position of each nid (duplicates keep the first —
    # A102 reports the collision itself)
    pos: Dict[int, int] = {}
    n_outs: Dict[int, int] = {}
    for p, node in enumerate(g.nodes):
        if node.nid in pos:
            other = g.nodes[pos[node.nid]]
            out.append(diag(
                "A102", _node_span(g, node.nid),
                f"nodes[{p}] ({node.dfg.name}) and nodes[{pos[node.nid]}] "
                f"({other.dfg.name}) share nid {node.nid} — a WAW hazard: "
                f"buffers naming N{node.nid} alias whichever write replays "
                f"last"))
        else:
            pos[node.nid] = p
            n_outs[node.nid] = node.n_outputs

    # --- A101 / A103: every read has an earlier, in-range definition ----
    for p, node in enumerate(g.nodes):
        for ai, b in enumerate(node.args):
            ref = b.ref()
            if ref[0] == "in":
                if not 0 <= ref[1] < len(g.inputs):
                    out.append(diag(
                        "A103", _node_span(g, node.nid),
                        f"N{node.nid} arg {ai} reads graph input "
                        f"{ref[1]}, but only {len(g.inputs)} are "
                        f"declared"))
                continue
            _, src, oi = ref
            if src not in pos:
                out.append(diag(
                    "A101", _node_span(g, node.nid),
                    f"N{node.nid} arg {ai} reads output {oi} of unknown "
                    f"node N{src}"))
                continue
            if not 0 <= oi < n_outs[src]:
                out.append(diag(
                    "A101", _node_span(g, node.nid),
                    f"N{node.nid} arg {ai} reads output {oi} of N{src}, "
                    f"which has {n_outs[src]} output(s)"))
                continue
            if pos[src] >= p:
                out.append(diag(
                    "A101", _node_span(g, node.nid),
                    f"N{node.nid} (replay position {p}) reads N{src} "
                    f"(replay position {pos[src]}) — producer does not "
                    f"precede consumer in recording order, so replay "
                    f"reads stale data"))

    # --- A104: graph outputs must be materializable ----------------------
    for i, b in enumerate(g.outputs):
        ref = b.ref()
        if ref[0] != "node":
            out.append(diag(
                "A104", Span(target=g.name, node=f"out[{i}]"),
                f"graph output {i} is not a node output ({b!r})"))
            continue
        _, src, oi = ref
        if src not in pos:
            out.append(diag(
                "A104", Span(target=g.name, node=f"out[{i}]"),
                f"graph output {i} names unknown node N{src}"))
        elif not 0 <= oi < n_outs[src]:
            out.append(diag(
                "A104", Span(target=g.name, node=f"out[{i}]"),
                f"graph output {i} names output {oi} of N{src}, which "
                f"has {n_outs[src]} output(s)"))
    return out


def check_partitions(g: KernelGraph,
                     partitions: Sequence[Partition]) -> List[Diagnostic]:
    """Prove a partition cut against its graph (A105-A109), including the
    A0xx semantic checks on every fused partition DFG."""
    out: List[Diagnostic] = []
    known = {n.nid for n in g.nodes}
    n_outs = {n.nid: n.n_outputs for n in g.nodes}

    def pspan(part: Partition, node: str = "") -> Span:
        return Span(target=f"{g.name}/partition[{part.index}]",
                    node=node or None)

    # --- A106: exact coverage -------------------------------------------
    owner: Dict[int, int] = {}
    for part in partitions:
        for nid in part.node_ids:
            if nid not in known:
                out.append(diag(
                    "A106", pspan(part, f"N{nid}"),
                    f"partition {part.index} claims node N{nid}, which "
                    f"the graph does not record"))
            elif nid in owner:
                out.append(diag(
                    "A106", pspan(part, f"N{nid}"),
                    f"node N{nid} is assigned to partitions "
                    f"{owner[nid]} and {part.index} — replay would run "
                    f"it twice"))
            else:
                owner[nid] = part.index
    for nid in sorted(known - set(owner)):
        out.append(diag(
            "A106", _node_span(g, nid),
            f"node N{nid} is assigned to no partition — replay would "
            f"skip it"))

    indices = {p.index for p in partitions}
    for part in partitions:
        # --- A107: dep edges must point strictly backward ----------------
        for d in part.deps:
            if d == part.index:
                out.append(diag(
                    "A107", pspan(part),
                    f"partition {part.index} depends on itself"))
            elif d not in indices:
                out.append(diag(
                    "A107", pspan(part),
                    f"partition {part.index} depends on nonexistent "
                    f"partition {d}"))
            elif d > part.index:
                out.append(diag(
                    "A107", pspan(part),
                    f"partition {part.index} depends on LATER partition "
                    f"{d} — fused replay only waits on earlier events"))

        # --- A105 / A108: external wiring --------------------------------
        seen_keys: Dict[Tuple, int] = {}
        for slot, ref in enumerate(part.ext):
            if ref in seen_keys:
                out.append(diag(
                    "A108", pspan(part, f"ext[{slot}]"),
                    f"external buffer {ref} is bound to fused-input "
                    f"slots {seen_keys[ref]} and {slot} — fuse_dfgs "
                    f"dedups equal keys, so duplicate slots mean the "
                    f"wiring was edited after fusion"))
            else:
                seen_keys[ref] = slot
            if ref[0] == "in":
                if not 0 <= ref[1] < len(g.inputs):
                    out.append(diag(
                        "A103", pspan(part, f"ext[{slot}]"),
                        f"external input slot {slot} reads graph input "
                        f"{ref[1]}, but only {len(g.inputs)} are "
                        f"declared"))
                continue
            _, src, oi = ref
            if src not in known or not 0 <= oi < n_outs.get(src, 0):
                out.append(diag(
                    "A101", pspan(part, f"ext[{slot}]"),
                    f"external input slot {slot} reads {ref}, which no "
                    f"recorded node produces"))
                continue
            src_part = owner.get(src)
            if src_part is None:
                continue  # already an A106 above
            if src_part == part.index:
                out.append(diag(
                    "A108", pspan(part, f"ext[{slot}]"),
                    f"partition {part.index} consumes its own member "
                    f"N{src} through an 'external' input — an in-place "
                    f"alias across its own fusion boundary"))
            elif src_part not in part.deps:
                out.append(diag(
                    "A105", pspan(part, f"ext[{slot}]"),
                    f"partition {part.index} reads N{src} owned by "
                    f"partition {src_part}, but {src_part} is missing "
                    f"from deps={part.deps} — replay may read the "
                    f"buffer before it is written"))

        # --- A109: fused kernel <-> wiring metadata ----------------------
        if len(part.ext) != len(part.dfg.inputs):
            out.append(diag(
                "A109", pspan(part),
                f"partition {part.index} lists {len(part.ext)} external "
                f"buffer(s) but its fused kernel takes "
                f"{len(part.dfg.inputs)} input(s)"))
        if len(part.outputs) != len(part.dfg.outputs):
            out.append(diag(
                "A109", pspan(part),
                f"partition {part.index} exposes {len(part.outputs)} "
                f"output(s) but its fused kernel produces "
                f"{len(part.dfg.outputs)}"))
        members = set(part.node_ids)
        for i, (src, oi) in enumerate(part.outputs):
            if src not in members:
                out.append(diag(
                    "A109", pspan(part, f"out[{i}]"),
                    f"exposed output {i} names N{src}, which is not a "
                    f"member of partition {part.index}"))
            elif not 0 <= oi < n_outs.get(src, 0):
                out.append(diag(
                    "A109", pspan(part, f"out[{i}]"),
                    f"exposed output {i} names output {oi} of N{src}, "
                    f"which has {n_outs.get(src, 0)} output(s)"))

        # --- A0xx on the fused kernel itself -----------------------------
        out.extend(check_dfg(part.dfg,
                             origin=f"{g.name}/partition[{part.index}]"))

    # --- A104: every graph output must be exposed by its owner -----------
    exposed = {(part.index, o) for part in partitions for o in part.outputs}
    for i, b in enumerate(g.outputs):
        ref = b.ref()
        if ref[0] != "node" or ref[1] not in owner:
            continue  # check_graph already reports the dangling case
        if (owner[ref[1]], (ref[1], ref[2])) not in exposed:
            out.append(diag(
                "A104", Span(target=g.name, node=f"out[{i}]"),
                f"graph output {i} = {ref} is owned by partition "
                f"{owner[ref[1]]} but not exposed in its outputs — "
                f"launch could not materialize it"))
    return out
