"""Pass family 3: independent artifact verifier (codes A201-A208).

Re-proves the legality of a :class:`~repro_torch.core.jit.CompiledKernel` from
scratch.  The point is *independence*: except for the final bit-identity
check (A208, which by definition replays the deterministic packer), this
module never calls the placer, router, balancer or their helper classes —
capacity tables, adjacency and latency are re-derived here directly from
``OverlaySpec`` arithmetic, so a bug shared with the compiler cannot
self-certify.

What is proved, per artifact:

* A201 — every (replica, FU) and (replica, IO) key the netlist implies is
  placed, on-grid, with no two FUs sharing a tile, and the replica count
  matches the replication plan.
* A202 — IO placements sit on real perimeter sites and no site exceeds
  its pad capacity (``io_per_edge_tile`` per virtual coord).
* A203 — the routed netlist covers exactly the FU netlist x replicas
  (no dropped or phantom connections), and every path is a contiguous
  chain of legal fabric edges whose endpoints match the placement.
* A204 — recomputed channel load (tree segments counted once per
  multi-terminal net, exactly as the interconnect is shared) is within
  every channel bundle's capacity.  Gap-filled artifacts merge the
  pre-existing nets into the same RoutingResult, so this also validates
  exclusivity under ``base_usage``.
* A205 — the latency certificate re-proves: with the stamped delay
  chains, all inputs of every FU arrive in the same cycle, all outputs
  of a replica align, the stamped ready times agree with recomputation,
  and pipeline_depth is the true maximum.
* A206 — every delay chain (including the implied IO pad delays, which
  are not stored) is within ``[0, max_delay]``.
* A207 — resource-ledger conservation: plan usage equals
  replicas x footprint, within device totals, and equals what the
  placement actually occupies.
* A208 — the shipped bitstream is byte-identical to repacking this
  artifact's P&R state (and its header agrees with spec and plan).

``assert_valid`` is the gate used by ``verify_level="full"``: failures
raise :class:`VerificationError` and the JIT quarantines the cache entry
exactly like a corrupt DiskCache pickle.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Tuple

from repro_torch.core.overlay import Coord, OverlaySpec

from .diagnostics import Diagnostic, ERROR, Span, VerificationError, diag


def _span(name: str, node: str = "") -> Span:
    return Span(target=name, node=node or None)


# --------------------------------------------------------- fabric geometry
# Re-derived from OverlaySpec arithmetic; deliberately NOT RoutingGraph.

def _on_grid(spec: OverlaySpec, c: Coord) -> bool:
    return 0 <= c[0] < spec.width and 0 <= c[1] < spec.height


def _io_tile(spec: OverlaySpec, io: Coord) -> Coord | None:
    """The unique grid tile a perimeter IO coord attaches to, else None."""
    x, y = io
    w, h = spec.width, spec.height
    if y == -1 and 0 <= x < w:
        return (x, 0)
    if y == h and 0 <= x < w:
        return (x, h - 1)
    if x == -1 and 0 <= y < h:
        return (0, y)
    if x == w and 0 <= y < h:
        return (w - 1, y)
    return None


def _edge_capacity(spec: OverlaySpec, a: Coord, b: Coord) -> int:
    """Capacity of directed fabric edge a->b; 0 if the edge does not exist."""
    if _on_grid(spec, a) and _on_grid(spec, b):
        if abs(a[0] - b[0]) + abs(a[1] - b[1]) == 1:
            return spec.channel_width
        return 0
    for io, tile in ((a, b), (b, a)):
        if _io_tile(spec, io) == tile and tile is not None:
            return spec.io_per_edge_tile * 2
    return 0


def _pad_capacity(spec: OverlaySpec) -> Dict[Coord, int]:
    return dict(Counter(spec.io_sites()))


# ------------------------------------------------------------ the verifier

def verify_artifact(ck) -> List[Diagnostic]:
    """Re-prove the legality of one CompiledKernel.  Returns all findings;
    never raises on malformed artifacts (that is the input it exists for)."""
    out: List[Diagnostic] = []
    name = ck.name
    spec: OverlaySpec = ck.spec
    fug = ck.fug
    placement, routing, lat, plan = ck.placement, ck.routing, ck.latency, \
        ck.plan

    # ---- A201: FU slot occupancy ----------------------------------------
    reps = sorted({k[0] for k in placement.fu_pos})
    if len(reps) != plan.replicas:
        out.append(diag(
            "A201", _span(name),
            f"placement covers {len(reps)} replica(s), plan says "
            f"{plan.replicas}"))
    sids = {s.sid for s in fug.supers}
    tile_owner: Dict[Coord, Tuple[int, int]] = {}
    for key, c in placement.fu_pos.items():
        if key[1] not in sids:
            out.append(diag(
                "A201", _span(name, f"fu{key}"),
                f"placed FU {key} does not exist in the FU netlist "
                f"(sids 0..{len(sids) - 1})"))
            continue
        if not _on_grid(spec, c):
            out.append(diag(
                "A201", _span(name, f"fu{key}"),
                f"FU {key} placed off-grid at {c} on a "
                f"{spec.width}x{spec.height} fabric"))
        elif c in tile_owner:
            out.append(diag(
                "A201", _span(name, f"fu{key}"),
                f"FUs {tile_owner[c]} and {key} both placed on tile {c}"))
        else:
            tile_owner[c] = key
    for r in reps:
        for sid in sids:
            if (r, sid) not in placement.fu_pos:
                out.append(diag(
                    "A201", _span(name, f"fu({r}, {sid})"),
                    f"replica {r} has no placement for FU {sid}"))
        for table, kind, count in ((placement.in_pos, "in", fug.n_in),
                                   (placement.out_pos, "out", fug.n_out)):
            for i in range(count):
                if (r, i) not in table:
                    out.append(diag(
                        "A201", _span(name, f"{kind}({r}, {i})"),
                        f"replica {r} has no placement for {kind}-pad "
                        f"{i}"))

    # ---- A202: IO pad capacity ------------------------------------------
    pad_cap = _pad_capacity(spec)
    pad_load: Counter = Counter()
    for table, kind in ((placement.in_pos, "in"), (placement.out_pos,
                                                   "out")):
        for key, c in table.items():
            if c not in pad_cap:
                out.append(diag(
                    "A202", _span(name, f"{kind}{key}"),
                    f"{kind}-pad {key} placed at {c}, which is not a "
                    f"perimeter IO site"))
            else:
                pad_load[c] += 1
    for c, n in sorted(pad_load.items()):
        if n > pad_cap.get(c, 0):
            out.append(diag(
                "A202", _span(name, f"pad{c}"),
                f"IO site {c} carries {n} placements, capacity is "
                f"{pad_cap.get(c, 0)}"))

    # ---- A203: netlist coverage + path continuity -----------------------
    expected = {(skind, (r, sid), dkind, (r, did), port)
                for r in reps
                for skind, sid, dkind, did, port in fug.edges}
    actual = Counter()
    for net in routing.nets:
        actual[(net.skind, tuple(net.src), net.dkind, tuple(net.dst),
                net.port)] += 1
    for sig in sorted(expected - set(actual), key=str):
        out.append(diag(
            "A203", _span(name),
            f"netlist connection {sig} has no routed net — the config "
            f"drops a dataflow edge"))
    for sig, n in sorted(actual.items(), key=str):
        if sig not in expected:
            out.append(diag(
                "A203", _span(name),
                f"routed net {sig} corresponds to no netlist edge"))
        elif n > 1:
            out.append(diag(
                "A203", _span(name),
                f"netlist connection {sig} is routed {n} times"))

    def _endpoint(kind: str, key) -> Coord | None:
        table = {"fu": placement.fu_pos, "in": placement.in_pos,
                 "out": placement.out_pos}.get(kind)
        return None if table is None else table.get(tuple(key))

    for net in routing.nets:
        where = _span(name, f"net{net.net_id}")
        if not net.path:
            out.append(diag("A203", where,
                            f"net {net.net_id} has an empty path"))
            continue
        src_c = _endpoint(net.skind, net.src)
        dst_c = _endpoint(net.dkind, net.dst)
        if src_c is not None and net.path[0] != src_c:
            out.append(diag(
                "A203", where,
                f"net {net.net_id} starts at {net.path[0]}, but its "
                f"source {net.skind}{net.src} is placed at {src_c}"))
        if dst_c is not None and net.path[-1] != dst_c:
            out.append(diag(
                "A203", where,
                f"net {net.net_id} ends at {net.path[-1]}, but its sink "
                f"{net.dkind}{net.dst} is placed at {dst_c}"))
        for a, b in zip(net.path, net.path[1:]):
            if _edge_capacity(spec, a, b) == 0:
                out.append(diag(
                    "A203", where,
                    f"net {net.net_id} hop {a}->{b} is not a fabric "
                    f"edge (non-adjacent or off-fabric)"))

    # ---- A204: channel exclusivity --------------------------------------
    # one multi-terminal net = one routing tree; its wire segments are
    # occupied once no matter how many sinks share them
    tree_edges: Dict[Tuple[str, Tuple[int, int]], set] = {}
    for net in routing.nets:
        seg = tree_edges.setdefault((net.skind, tuple(net.src)), set())
        seg.update(zip(net.path, net.path[1:]))
    load: Counter = Counter()
    for segs in tree_edges.values():
        for e in segs:
            load[e] += 1
    for e, n in sorted(load.items()):
        cap = _edge_capacity(spec, *e)
        if cap and n > cap:
            out.append(diag(
                "A204", _span(name, f"edge{e}"),
                f"channel bundle {e[0]}->{e[1]} carries {n} nets, "
                f"capacity is {cap}"))

    # ---- A205 / A206: latency certificate -------------------------------
    depth_of = {s.sid: len(s.members) * spec.fu_latency for s in fug.supers}
    for key, d in lat.delays.items():
        if not 0 <= d <= spec.max_delay:
            out.append(diag(
                "A206", _span(name, f"delay{key}"),
                f"delay chain {key} = {d} outside [0, {spec.max_delay}]"))

    incoming: Dict[Tuple[int, int], List] = {}
    out_nets = []
    for net in routing.nets:
        if net.dkind == "fu":
            incoming.setdefault(tuple(net.dst), []).append(net)
        elif net.dkind == "out":
            out_nets.append(net)

    ready: Dict[Tuple[int, int], int] = {}
    pending = {(r, sid) for r in reps for sid in sids}
    progressed = True
    while pending and progressed:
        progressed = False
        for key in sorted(pending):
            ins = incoming.get(key, [])
            if any(n.skind == "fu" and tuple(n.src) not in ready
                   for n in ins):
                continue
            arrivals = []
            for n in ins:
                base = 0 if n.skind == "in" else ready[tuple(n.src)]
                arrivals.append(
                    base + n.hops
                    + lat.delays.get((key[0], key[1], n.port), 0))
            if arrivals and len(set(arrivals)) > 1:
                out.append(diag(
                    "A205", _span(name, f"fu{key}"),
                    f"FU {key} inputs arrive at cycles "
                    f"{sorted(set(arrivals))} — the delay chains do not "
                    f"align them (II=1 would mix work-items)"))
            ready[key] = max(arrivals, default=0) + depth_of.get(key[1], 0)
            pending.discard(key)
            progressed = True
    if pending:
        out.append(diag(
            "A205", _span(name),
            f"latency graph has a cycle through {sorted(pending)[:4]} — "
            f"ready times cannot be certified"))
    for key, r_stamped in lat.ready.items():
        r_new = ready.get(tuple(key))
        if r_new is not None and r_new != r_stamped:
            out.append(diag(
                "A205", _span(name, f"fu{tuple(key)}"),
                f"stamped ready[{tuple(key)}] = {r_stamped}, "
                f"recomputation gives {r_new}"))

    by_rep: Dict[int, List[int]] = {}
    for net in out_nets:
        key = tuple(net.dst)
        base = 0 if net.skind == "in" else ready.get(tuple(net.src))
        if base is None:
            continue  # already an A203/A205 above
        arr = base + net.hops
        stamped = lat.out_ready.get(key)
        if stamped is None:
            out.append(diag(
                "A205", _span(name, f"out{key}"),
                f"output {key} has no stamped ready time"))
            continue
        pad = stamped - arr  # the implied (unstored) IO delay chain
        if pad < 0 or pad > spec.max_delay:
            out.append(diag(
                "A206", _span(name, f"out{key}"),
                f"output {key} arrives at cycle {arr}, stamped ready "
                f"{stamped} implies IO delay {pad} outside "
                f"[0, {spec.max_delay}]"))
        by_rep.setdefault(key[0], []).append(stamped)
    for r, vals in sorted(by_rep.items()):
        if len(set(vals)) > 1:
            out.append(diag(
                "A205", _span(name, f"replica{r}"),
                f"replica {r} outputs ready at cycles "
                f"{sorted(set(vals))} — stores of one work-item would "
                f"straddle cycles"))
    all_out = [v for vals in by_rep.values() for v in vals]
    if all_out and lat.pipeline_depth != max(all_out):
        out.append(diag(
            "A205", _span(name),
            f"stamped pipeline_depth {lat.pipeline_depth} != recomputed "
            f"output maximum {max(all_out)}"))

    # ---- A207: resource-ledger conservation -----------------------------
    checks = (
        ("fus_used", plan.fus_used, plan.replicas * fug.n_fus),
        ("io_used", plan.io_used, plan.replicas * fug.n_io),
        ("fus_total", plan.fus_total, spec.n_fus),
        ("io_total", plan.io_total, spec.n_io),
        ("placed FUs", len(placement.fu_pos), plan.replicas * fug.n_fus),
        ("placed IO", len(placement.in_pos) + len(placement.out_pos),
         plan.replicas * fug.n_io),
    )
    for what, got, want in checks:
        if got != want:
            out.append(diag(
                "A207", _span(name),
                f"ledger: {what} = {got}, conservation requires {want}"))
    if plan.fus_used > plan.fus_total or plan.io_used > plan.io_total:
        out.append(diag(
            "A207", _span(name),
            f"ledger: usage {plan.fus_used} FU / {plan.io_used} IO "
            f"exceeds device totals {plan.fus_total} FU / "
            f"{plan.io_total} IO"))

    # ---- A208: bitstream integrity --------------------------------------
    try:
        from repro_torch.core.bitstream import generate, parse_header
        hdr = parse_header(ck.bitstream)
        for field, want in (("width", spec.width), ("height", spec.height),
                            ("dsp_per_fu", spec.dsp_per_fu),
                            ("replicas", plan.replicas & 0xFF),
                            ("tiles_used", len(placement.fu_pos)),
                            ("nets", len(routing.nets))):
            if hdr[field] != want:
                out.append(diag(
                    "A208", _span(name),
                    f"bitstream header {field} = {hdr[field]}, artifact "
                    f"state implies {want}"))
        regen = generate(fug, spec, placement, routing, lat,
                         plan.replicas)
        if regen.sha256() != ck.bitstream.sha256():
            out.append(diag(
                "A208", _span(name),
                f"bitstream sha256 {ck.bitstream.sha256()[:16]}... != "
                f"repacked {regen.sha256()[:16]}... — the shipped config "
                f"is not the one this P&R state implies"))
    except Exception as e:  # noqa: BLE001 - corrupt state must not crash
        out.append(diag(
            "A208", _span(name),
            f"bitstream could not be re-derived from the artifact's P&R "
            f"state: {e!r}"))

    return out


def assert_valid(ck) -> List[Diagnostic]:
    """Run :func:`verify_artifact`; raise :class:`VerificationError` on any
    error-severity finding (the ``verify_level="full"`` gate)."""
    diags = verify_artifact(ck)
    errors = [d for d in diags if d.severity == ERROR]
    if errors:
        raise VerificationError(
            f"artifact {ck.name!r} failed legality re-proof: "
            + "; ".join(str(d) for d in errors[:4])
            + (f" (+{len(errors) - 4} more)" if len(errors) > 4 else ""),
            diags)
    return diags
