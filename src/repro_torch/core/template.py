"""Template-stamped place & route: O(one replica) P&R for R replicas.

The paper's replicas are identical by construction (§III-C/D): the compiler
replicates one kernel DFG, so the R mapped copies differ only in *where* they
sit on the fabric.  The joint annealer ignored that and re-annealed all R
copies (O(R) moves, O(R) routing); this module exploits it:

  1. **Template build** (:func:`build_template`): anneal ONE replica into a
     compact ``w × h`` tile region anchored at the north-west corner of the
     overlay, with its kernel I/O pinned to the north perimeter pads above
     the region, route it with PathFinder on a *strip-local* routing graph
     (routes provably cannot leave the region), and latency-balance it.
     Several candidate region shapes are tried (low-waste shapes first) and
     the one whose verified slot list packs the most replicas wins.

  2. **Stamping** (:func:`stamp`): emit R transformed copies of the template.
     A stamp slot is (perimeter edge, offset along that edge, band depth).
     All FOUR perimeter edges host stamps: north slots translate
     the template, south slots mirror it vertically, and east/west slots
     rotate it a quarter turn so the template's pad row lands on the side
     perimeter.  Bands deeper than the perimeter splice a straight
     "trunk" — vertical for N/S, horizontal for E/W — that extends every
     I/O route from the band's perimeter pad through the shallower bands.

  3. **Gap fill** (:func:`gap_fill`): the rectangular stamp grid leaves
     remnant tiles (dead center rows, column remainders, per-region waste).
     When the build wants more replicas than the grid holds, remnant
     replicas are placed & routed ONE AT A TIME into the leftover tiles and
     pads, with all existing nets pre-charged into the router as immovable
     base load.  Each remnant costs one single-replica P&R (milliseconds),
     so template + gap fill reaches joint-anneal fill at a fraction of the
     joint annealer's cost — this is what lets ``pr_mode="auto"`` stay on
     the fast path for uncapped builds.

**Stamp legality argument.**  The overlay's channel graph is vertex-transitive
over interior tiles: every tile edge is a channel bundle of identical capacity
``channel_width`` and every perimeter tile carries the same IO pads, so a
legal route under any grid isometry — horizontal/vertical translation, the
vertical mirror (swaps N↔S channel directions of equal capacity), or the
quarter-turn onto a side edge (swaps N/S↔E/W directions of equal capacity) —
is again a legal route over distinct resources, provided no two stamps share
a channel.  Stamps occupy pairwise-disjoint tile rectangles (checked exactly
against an occupancy grid — this is what resolves corner conflicts between
north/south and east/west stamps), and strip-local routing confines each
stamp's non-trunk segments to its own rectangle, so the only shared
resources are (a) perimeter pads and (b) channels crossed by trunks of
deeper bands.  Both are counted exactly at template-build time
(:func:`_verify_slots`, vectorized over numpy edge codes): a candidate slot
is accepted only if adding its edge multiset and pad multiset keeps every
channel bundle within ``channel_width`` and every pad coordinate within
``io_per_edge_tile``.  Accepted slots are ordered shallow-first, so the edge
usage of any prefix of the slot list is a sub-multiset of the verified total
— which is why :func:`stamp` needs no verification at all: stamping R ≤
capacity replicas is legal by construction.  Gap-fill replicas are the one
exception: they are not template copies, so each one is individually routed
by PathFinder against the full pre-charged usage — legality by construction
again, just per replica instead of per template.

Latency composes in closed form: a trunk of length ``T = band·h`` adds ``T``
hops to every input route and ``T`` hops to every output route of that stamp,
shifting every FU-ready time by ``T`` and every output-arrival by ``2T``
uniformly — so the template's delay-chain settings are reused unchanged and
the per-stamp ready/arrival tables are the template's plus a constant.  This
holds for all four edges (the trunk length depends only on the band depth,
not the edge).  ``tests/test_template.py`` asserts this equals re-running
the latency stage.

Templates are cached in :class:`repro_torch.core.cache.JITCache` keyed on
(DFG fingerprint, OverlaySpec, seed, effort) — independent of the
free-resource snapshot — so a replica-count change (congestion shedding,
scheduler shedding, re-inflation) re-stamps in ~a millisecond instead of
re-running P&R.  With a ``persist_dir`` the template also survives process
restarts (see :class:`repro_torch.core.cache.DiskCache`).
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.fuse import FUGraph
from repro_torch.core.latency import LatencyAssignment, LatencyError, balance
from repro_torch.core.overlay import Coord, OverlaySpec, RoutingGraph
from repro_torch.core.place import (Placement, PlacementError, anneal_single)
from repro_torch.core.route import RoutedNet, RoutingError, RoutingResult, route


class TemplateError(PlacementError):
    """No feasible template region / no stampable slot on this overlay.

    Subclasses :class:`~repro_torch.core.place.PlacementError` so that forced
    ``pr_mode="template"`` failures honour ``jit_compile``'s documented
    mapping-failure contract (callers catch PlacementError/RoutingError/
    LatencyError — e.g. the Scheduler's shed/probe loops)."""


EDGES = ("N", "S", "W", "E")


@dataclasses.dataclass(frozen=True)
class Slot:
    """One stamp position: perimeter edge, offset along it, band depth.

    ``offset`` is measured in tiles along the anchoring perimeter (columns
    for N/S, rows for W/E); ``band`` counts region-depths inward from that
    perimeter, so the trunk length is ``band * h``."""
    edge: str        # 'N' | 'S' | 'W' | 'E'
    offset: int      # tile offset along the perimeter (multiple of w)
    band: int        # 0 = at the perimeter; trunk length = band * h


# one multi-terminal net in the template frame:
#   ((skind, src_id), [(dkind, dst_id, port, path), ...])
TemplateNet = Tuple[Tuple[str, int], List[Tuple[str, int, int, List[Coord]]]]


@dataclasses.dataclass
class Template:
    """A routed, latency-balanced single replica plus its verified slots."""
    spec: OverlaySpec
    w: int                         # region width  (tiles)
    h: int                         # region height (tiles)
    fu_pos: Dict[int, Coord]       # sid -> tile, template frame
    in_pos: Dict[int, Coord]       # invar idx -> north pad, template frame
    out_pos: Dict[int, Coord]      # outvar idx -> north pad, template frame
    nets: List[TemplateNet]
    latency: LatencyAssignment     # replica-0 frame
    cost: float
    moves: int
    iterations: int
    slots: List[Slot]              # verified, shallow-first
    slot_wirelength: List[int]     # tree segments per slot (trunks included)
    build_ms: Dict[str, float]     # place / route / latency / scan times

    @property
    def capacity(self) -> int:
        return len(self.slots)


# -------------------------------------------------------------- region shape

def _ceil_div(a: int, b: int) -> int:
    return -(-a // max(1, b))


def region_shape(fug: FUGraph, spec: OverlaySpec) -> Tuple[int, int]:
    """Minimal region (w, h): enough tiles for the FUs and enough north pads
    above the region for the kernel I/O."""
    w = max(1, _ceil_div(fug.n_io, spec.io_per_edge_tile),
            _ceil_div(fug.n_fus, spec.height))
    h = max(1, _ceil_div(fug.n_fus, w))
    return w, h


def _region_candidates(fug: FUGraph, spec: OverlaySpec,
                       limit: int = 10) -> List[Tuple[int, int]]:
    """Candidate region shapes, lowest tile waste first.

    The region's perimeter span ``w`` must host all kernel I/O on its pads;
    beyond that, a shape's stamp capacity is driven by how little area it
    wastes (``w*h - n_fus``) and how its depth ``h`` divides the fabric, so
    low-area shapes are tried first and the best verified capacity wins."""
    w_io = _ceil_div(fug.n_io, spec.io_per_edge_tile)
    shapes: List[Tuple[int, int]] = []
    for h in range(1, spec.height + 1):
        w = max(1, w_io, _ceil_div(fug.n_fus, h))
        if w > spec.width:
            continue
        for cand in ((w, h), (w + 1, h)):   # +1 col of routing slack
            if cand[0] <= spec.width and cand not in shapes:
                shapes.append(cand)
    shapes.sort(key=lambda wh: (wh[0] * wh[1], wh[1]))
    return shapes[:limit]


def _side_bands(depth: int, h: int, pads_per_coord: int,
                spec: OverlaySpec) -> Tuple[int, int]:
    """Bands available from the two opposing perimeters of a ``depth``-tile
    fabric axis, split near/far and clipped by the perimeter pad budget."""
    v = depth // h
    near, far = (v + 1) // 2, v // 2
    if pads_per_coord > 0:
        by_pads = spec.io_per_edge_tile // pads_per_coord
        near, far = min(near, by_pads), min(far, by_pads)
    return near, far


def _enumerate_slots(spec: OverlaySpec, w: int, h: int,
                     pads_per_coord: int) -> List[Slot]:
    """Geometric slot candidates on all four edges, shallow-first (minimal
    trunks first).  Corner conflicts between N/S and W/E rectangles are NOT
    resolved here — :func:`_verify_slots` rejects overlaps exactly."""
    nb, sb = _side_bands(spec.height, h, pads_per_coord, spec)
    wb, eb = _side_bands(spec.width, h, pads_per_coord, spec)
    ns_offs = spec.width // w        # N/S slots step along columns
    we_offs = spec.height // w       # W/E slots step along rows
    slots: List[Slot] = []
    for j in range(max(nb, sb, wb, eb, 0)):
        for edge, bands, n_offs in (("N", nb, ns_offs), ("S", sb, ns_offs),
                                    ("W", wb, we_offs), ("E", eb, we_offs)):
            if j >= bands:
                continue
            for i in range(n_offs):
                slots.append(Slot(edge, i * w, j))
    return slots


def estimate_capacity(fug: FUGraph, spec: OverlaySpec) -> int:
    """Optimistic stamp capacity (assumes even pad spread, ignores corner
    conflicts between edges); the exact number is :attr:`Template.capacity`
    after building, which this bounds from above."""
    best = 0
    for w, h in _region_candidates(fug, spec):
        n = len(_enumerate_slots(spec, w, h, _ceil_div(fug.n_io, w)))
        best = max(best, n)
    return best


# ---------------------------------------------------------- coord transforms

def _edge_geometry(slot: Slot, spec: OverlaySpec):
    """(pad coord builder, inward unit step) for the slot's perimeter edge."""
    if slot.edge == "N":
        return (lambda p: (slot.offset + p, -1)), (0, 1)
    if slot.edge == "S":
        return (lambda p: (slot.offset + p, spec.height)), (0, -1)
    if slot.edge == "W":
        return (lambda p: (-1, slot.offset + p)), (1, 0)
    return (lambda p: (spec.width, slot.offset + p)), (-1, 0)


def _tx_coord(c: Coord, slot: Slot, spec: OverlaySpec, h: int) -> Coord:
    """Template-frame coord -> fabric coord under the slot's isometry."""
    x, y = c
    pad, step = _edge_geometry(slot, spec)
    if y == -1:                                   # perimeter pad
        return pad(x)
    d = slot.band * h + y                         # depth inward
    px, py = pad(x)
    return (px + step[0] * (d + 1), py + step[1] * (d + 1))


def _trunk(pad_coord: Coord, slot: Slot, spec: OverlaySpec,
           h: int) -> List[Coord]:
    """Tiles between the slot's perimeter pad and its region, pad-first."""
    _pad, step = _edge_geometry(slot, spec)
    t = slot.band * h
    return [(pad_coord[0] + step[0] * (k + 1), pad_coord[1] + step[1] * (k + 1))
            for k in range(t)]


def _tx_path(path: List[Coord], slot: Slot, spec: OverlaySpec,
             h: int) -> List[Coord]:
    pts = [_tx_coord(p, slot, spec, h) for p in path]
    if slot.band == 0 or len(path) < 2:
        return pts
    if path[0][1] == -1:                          # route starts at a pad
        pts = [pts[0]] + _trunk(pts[0], slot, spec, h) + pts[1:]
    if path[-1][1] == -1:                         # route ends at a pad
        tr = _trunk(pts[-1], slot, spec, h)
        tr.reverse()
        pts = pts[:-1] + tr + [pts[-1]]
    return pts


def _slot_rect(slot: Slot, spec: OverlaySpec, w: int,
               h: int) -> Tuple[int, int, int, int]:
    """Occupied tile rectangle (x0, y0, nx, ny) of the slot's region."""
    t = slot.band * h
    if slot.edge == "N":
        return (slot.offset, t, w, h)
    if slot.edge == "S":
        return (slot.offset, spec.height - t - h, w, h)
    if slot.edge == "W":
        return (t, slot.offset, h, w)
    return (spec.width - t - h, slot.offset, h, w)


def _slot_edge_multiset(tmpl_nets: Sequence[TemplateNet], slot: Slot,
                        spec: OverlaySpec, h: int) -> Counter:
    """Channel-bundle usage of one stamp: tree edges counted once per net
    (fanout of one source shares wires, as in PathFinder's accounting).

    Reference implementation — :func:`_verify_slots` uses the vectorized
    numpy equivalent; tests assert they agree."""
    usage: Counter = Counter()
    for _src, sinks in tmpl_nets:
        edges = set()
        for _dk, _di, _port, path in sinks:
            tp = _tx_path(path, slot, spec, h)
            edges.update(zip(tp, tp[1:]))
        usage.update(edges)
    return usage


# ------------------------------------------------- vectorized slot verifier

# direction index of a unit grid step (bx-ax, by-ay) -> 0..3
_DIR = {(1, 0): 0, (-1, 0): 1, (0, 1): 2, (0, -1): 3}


def _encode_edges(e: np.ndarray, spec: OverlaySpec) -> np.ndarray:
    """(n, 4) [ax, ay, bx, by] -> edge codes: start-node code * 4 + direction.
    Node codes cover the fabric plus the four virtual perimeter rings."""
    node = (e[:, 0] + 1) * (spec.height + 2) + (e[:, 1] + 1)
    dx, dy = e[:, 2] - e[:, 0], e[:, 3] - e[:, 1]
    d = np.where(dx == 1, 0, np.where(dx == -1, 1, np.where(dy == 1, 2, 3)))
    return node * 4 + d


def _cap_array(spec: OverlaySpec) -> np.ndarray:
    """Dense capacity lookup over edge codes; -1 where no edge exists."""
    n_codes = (spec.width + 2) * (spec.height + 2) * 4
    caps = np.full(n_codes, -1, np.int64)
    for (a, b), c in RoutingGraph(spec).capacity.items():
        code = ((a[0] + 1) * (spec.height + 2) + (a[1] + 1)) * 4 + \
            _DIR[(b[0] - a[0], b[1] - a[1])]
        caps[code] = c
    return caps


def _net_edge_arrays(tmpl_nets: Sequence[TemplateNet]
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Template-frame per-net-unique tree edges, split into interior edges
    and pad-incident edges (the latter become trunk chains when stamped).

    Returns (interior (n,4) int array, in-pad columns (m,), out-pad columns
    (k,)) — pad columns repeat once per net that uses them, so plain
    concatenation at stamp time counts channel usage once per net."""
    interior: List[Tuple[int, int, int, int]] = []
    in_cols: List[int] = []
    out_cols: List[int] = []
    for _src, sinks in tmpl_nets:
        edges = set()
        for _dk, _di, _port, path in sinks:
            edges.update(zip(path, path[1:]))
        for (ax, ay), (bx, by) in edges:
            if ay == -1:
                in_cols.append(ax)
            elif by == -1:
                out_cols.append(bx)
            else:
                interior.append((ax, ay, bx, by))
    return (np.asarray(interior, np.int64).reshape(-1, 4),
            np.asarray(in_cols, np.int64), np.asarray(out_cols, np.int64))


def _tx_interior(e: np.ndarray, slot: Slot, spec: OverlaySpec,
                 h: int) -> np.ndarray:
    """Vectorized :func:`_tx_coord` over interior edges (no pads)."""
    if not len(e):
        return e
    x, y = e[:, (0, 2)], e[:, (1, 3)]
    t = slot.band * h
    if slot.edge == "N":
        fx, fy = slot.offset + x, t + y
    elif slot.edge == "S":
        fx, fy = slot.offset + x, spec.height - 1 - (t + y)
    elif slot.edge == "W":
        fx, fy = t + y, slot.offset + x
    else:
        fx, fy = spec.width - 1 - (t + y), slot.offset + x
    return np.stack([fx[:, 0], fy[:, 0], fx[:, 1], fy[:, 1]], 1)


def _chain_edges(cols: np.ndarray, slot: Slot, spec: OverlaySpec, h: int,
                 outbound: bool) -> np.ndarray:
    """Pad-to-region route segments of one slot as (n*(t+1), 4) edges:
    the pad edge plus the trunk hops (band 0 yields just the pad edge)."""
    if not len(cols):
        return np.empty((0, 4), np.int64)
    pad, step = _edge_geometry(slot, spec)
    t = slot.band * h
    p = np.asarray([pad(c) for c in cols], np.int64)          # (n, 2)
    ks = np.arange(t + 1, dtype=np.int64)                     # hop index
    ax = p[:, 0, None] + step[0] * ks[None, :]
    ay = p[:, 1, None] + step[1] * ks[None, :]
    e = np.stack([ax, ay, ax + step[0], ay + step[1]], -1).reshape(-1, 4)
    return e[:, (2, 3, 0, 1)] if outbound else e


def _verify_slots(tmpl_nets: Sequence[TemplateNet], pads: Sequence[Coord],
                  candidates: Sequence[Slot], spec: OverlaySpec,
                  w: int, h: int) -> Tuple[List[Slot], List[int]]:
    """Accept candidate slots greedily (shallow-first) while (a) no two
    regions overlap a tile, (b) total channel usage stays within capacity,
    and (c) pad multiplicity stays within ``io_per_edge_tile``.

    The edge accounting is exact and fully vectorized: each slot's channel
    multiset is built as numpy edge-code arrays (interior isometry + trunk
    chain broadcast) and checked/accumulated against dense capacity/usage
    arrays — no python loop over nets × coords."""
    caps = _cap_array(spec)
    usage = np.zeros_like(caps)
    n_node = (spec.width + 2) * (spec.height + 2)
    pad_cnt = np.zeros(n_node, np.int64)
    occ = np.zeros((spec.width, spec.height), bool)
    interior, in_cols, out_cols = _net_edge_arrays(tmpl_nets)
    pad_cols = np.asarray([p[0] for p in pads], np.int64)

    accepted: List[Slot] = []
    wirelengths: List[int] = []
    for slot in candidates:
        x0, y0, nx, ny = _slot_rect(slot, spec, w, h)
        if occ[x0:x0 + nx, y0:y0 + ny].any():
            continue                               # corner / region conflict
        e = np.concatenate([
            _tx_interior(interior, slot, spec, h),
            _chain_edges(in_cols, slot, spec, h, outbound=False),
            _chain_edges(out_cols, slot, spec, h, outbound=True)])
        codes, counts = np.unique(_encode_edges(e, spec), return_counts=True)
        if (usage[codes] + counts > caps[codes]).any():
            continue
        pad_fn, _step = _edge_geometry(slot, spec)
        pc = np.asarray([pad_fn(c) for c in pad_cols], np.int64)
        pcodes, pcounts = np.unique((pc[:, 0] + 1) * (spec.height + 2) +
                                    (pc[:, 1] + 1), return_counts=True)
        if (pad_cnt[pcodes] + pcounts > spec.io_per_edge_tile).any():
            continue
        usage[codes] += counts
        pad_cnt[pcodes] += pcounts
        occ[x0:x0 + nx, y0:y0 + ny] = True
        accepted.append(slot)
        wirelengths.append(int(counts.sum()))
    return accepted, wirelengths


# ----------------------------------------------------------------- building

def _strip_graph(spec: OverlaySpec, w: int, h: int) -> RoutingGraph:
    """Fabric routing graph restricted to the template region + its pads."""
    rg = RoutingGraph(spec)
    allowed = {(x, y) for x in range(w) for y in range(h)}
    allowed |= {(x, -1) for x in range(w)}
    rg.adj = {n: [m for m in nbrs if m in allowed]
              for n, nbrs in rg.adj.items() if n in allowed}
    rg.capacity = {e: c for e, c in rg.capacity.items()
                   if e[0] in allowed and e[1] in allowed}
    return rg


def build_template(fug: FUGraph, spec: OverlaySpec, seed: int = 0,
                   effort: float = 1.0,
                   target: Optional[int] = None) -> Template:
    """Place, route and latency-balance one replica, then enumerate + verify
    its four-edge stamp slots.  Candidate region shapes are scanned lowest-
    waste-first and the template with the largest verified capacity wins.

    ``target`` bounds the scan: it stops at the first candidate whose
    capacity already covers the requested replica count (a capped build
    needs one viable shape, not the best one — this keeps capped cold
    template builds ~an order of magnitude cheaper than the joint annealer).
    Without a target the scan runs until the fabric's FU bound is reached or
    the candidate list is exhausted.  A cached template built under a small
    target may therefore have less slot capacity than a full scan would
    find; later builds that need more replicas make up the difference
    through :func:`gap_fill`, so fill is never lost — only split
    differently between stamping and infill.  Raises
    :class:`TemplateError` when no region maps (caller falls back to the
    joint annealer)."""
    last_err: Optional[Exception] = None
    best: Optional[Template] = None
    fu_bound = (spec.width * spec.height) // max(1, fug.n_fus)
    stop_at = fu_bound if target is None else min(target, fu_bound)
    t_scan0 = time.perf_counter()
    for w, h in _region_candidates(fug, spec):
        tiles = [(x, y) for y in range(h) for x in range(w)]
        pads = [(x, -1) for x in range(w)
                for _ in range(spec.io_per_edge_tile)]
        try:
            t0 = time.perf_counter()
            sp = anneal_single(fug, tiles, pads, seed=seed, effort=effort)
            place_ms = (time.perf_counter() - t0) * 1e3
            placement = sp.as_placement()
            t0 = time.perf_counter()
            routing = route(fug, spec, placement, replicas=1,
                            rg=_strip_graph(spec, w, h))
            route_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            lat = balance(fug, spec, routing)
            lat_ms = (time.perf_counter() - t0) * 1e3
        except (PlacementError, RoutingError, LatencyError) as e:
            last_err = e
            continue
        nets = _group_nets(routing.nets)
        pad_coords = list(sp.in_pos.values()) + list(sp.out_pos.values())
        pads_per_coord = max(Counter(pad_coords).values(), default=0)
        candidates = _enumerate_slots(spec, w, h, pads_per_coord)
        slots, wls = _verify_slots(nets, pad_coords, candidates, spec, w, h)
        if not slots:
            last_err = TemplateError(
                f"region {w}x{h} routed but produced no legal stamp slot")
            continue
        cand = Template(spec, w, h, sp.fu_pos, sp.in_pos, sp.out_pos, nets,
                        lat, sp.cost, sp.moves, routing.iterations, slots,
                        wls, dict(place=place_ms, route=route_ms,
                                  latency=lat_ms))
        if best is None or cand.capacity > best.capacity:
            best = cand
        if best.capacity >= stop_at:
            break
    if best is None:
        raise TemplateError(f"no feasible template region on "
                            f"{spec.width}x{spec.height}: {last_err}")
    # the scan's wall time beyond the winning candidate's own stages is
    # booked separately so compile_time_ms still reports real wall time
    scan_ms = (time.perf_counter() - t_scan0) * 1e3
    best.build_ms["scan"] = max(0.0, scan_ms - sum(best.build_ms.values()))
    return best


def _group_nets(nets: Sequence[RoutedNet]) -> List[TemplateNet]:
    grouped: Dict[Tuple[str, int], List] = {}
    for n in nets:
        grouped.setdefault((n.skind, n.src[1]), []).append(
            (n.dkind, n.dst[1], n.port, n.path))
    return sorted(grouped.items())


# ----------------------------------------------------------------- stamping

def stamp(tmpl: Template, spec: OverlaySpec, replicas: int
          ) -> Tuple[Placement, RoutingResult, LatencyAssignment]:
    """Compose the full P&R artifact for ``replicas`` copies by transforming
    the template — pure translation/mirror/rotation/trunk-splice, no
    annealing, no routing, no balancing."""
    if not 1 <= replicas <= tmpl.capacity:
        raise TemplateError(
            f"requested {replicas} stamps, template capacity "
            f"{tmpl.capacity}")
    fu_pos: Dict[Tuple[int, int], Coord] = {}
    in_pos: Dict[Tuple[int, int], Coord] = {}
    out_pos: Dict[Tuple[int, int], Coord] = {}
    nets: List[RoutedNet] = []
    usage: Counter = Counter()
    delays: Dict[Tuple[int, int, int], int] = {}
    ready: Dict[Tuple[int, int], int] = {}
    out_ready: Dict[Tuple[int, int], int] = {}
    nid = 0
    for r, slot in enumerate(tmpl.slots[:replicas]):
        t = slot.band * tmpl.h
        for sid, c in tmpl.fu_pos.items():
            fu_pos[(r, sid)] = _tx_coord(c, slot, spec, tmpl.h)
        for i, c in tmpl.in_pos.items():
            in_pos[(r, i)] = _tx_coord(c, slot, spec, tmpl.h)
        for i, c in tmpl.out_pos.items():
            out_pos[(r, i)] = _tx_coord(c, slot, spec, tmpl.h)
        for (skind, src), sinks in tmpl.nets:
            edges = set()
            for dkind, did, port, path in sinks:
                tp = _tx_path(path, slot, spec, tmpl.h)
                nets.append(RoutedNet(nid, skind, (r, src), dkind, (r, did),
                                      port, tp))
                nid += 1
                edges.update(zip(tp, tp[1:]))
            usage.update(edges)
        for (_z, sid, port), d in tmpl.latency.delays.items():
            delays[(r, sid, port)] = d
        for (_z, sid), v in tmpl.latency.ready.items():
            ready[(r, sid)] = v + t
        for (_z, oi), v in tmpl.latency.out_ready.items():
            out_ready[(r, oi)] = v + 2 * t
    placement = Placement(fu_pos, in_pos, out_pos,
                          tmpl.cost * replicas, tmpl.moves)
    routing = RoutingResult(nets, tmpl.iterations,
                            max(usage.values(), default=0),
                            sum(tmpl.slot_wirelength[:replicas]))
    lat = LatencyAssignment(delays, ready, out_ready,
                            max(out_ready.values(), default=0),
                            tmpl.latency.max_delay_used)
    return placement, routing, lat


# ----------------------------------------------------------------- gap fill

def _base_usage(nets: Sequence[RoutedNet]) -> Counter:
    """Channel usage of an existing routing, counted once per source net
    (PathFinder's tree accounting)."""
    per_net: Dict[Tuple[str, Tuple[int, int]], set] = {}
    for n in nets:
        per_net.setdefault((n.skind, n.src), set()).update(
            zip(n.path, n.path[1:]))
    usage: Counter = Counter()
    for edges in per_net.values():
        usage.update(edges)
    return usage


def gap_fill(fug: FUGraph, spec: OverlaySpec, placement: Placement,
             routing: RoutingResult, lat: LatencyAssignment,
             target: int, seed: int = 0, effort: float = 1.0,
             route_iters: int = 16, attempts: int = 2
             ) -> Tuple[Placement, RoutingResult, LatencyAssignment, int]:
    """Grow a stamped artifact toward ``target`` replicas by placing &
    routing remnant replicas one at a time into the tiles and pads the stamp
    grid left free.

    Every existing net (stamped or previously gap-filled) is pre-charged
    into PathFinder as immovable base load, so each remnant route is legal
    against the composed artifact by construction.  Each remnant costs one
    single-replica P&R (``anneal_single`` + strip-free PathFinder + latency
    balance) — milliseconds — instead of re-annealing the whole fabric.
    Deterministic given ``seed``.  Stops at the first remnant that cannot be
    placed/routed after ``attempts`` seeds and returns what was achieved.

    The passed artifacts are mutated in place and also returned, along with
    the achieved total replica count.
    """
    replicas = len({k[0] for k in placement.fu_pos})
    if target <= replicas:
        return placement, routing, lat, replicas
    occupied = set(placement.fu_pos.values())
    tiles = [t for t in spec.tiles() if t not in occupied]
    pad_free = Counter(spec.io_sites())
    pad_free.subtract(Counter(placement.in_pos.values()))
    pad_free.subtract(Counter(placement.out_pos.values()))
    pads = [c for c, n in sorted(pad_free.items()) for _ in range(max(0, n))]
    base = _base_usage(routing.nets)
    rg = RoutingGraph(spec)

    r = replicas
    while r < target:
        if fug.n_fus > len(tiles) or fug.n_io > len(pads):
            break
        done = None
        for attempt in range(attempts):
            sp = anneal_single(fug, tiles, pads,
                               seed=seed + 101 * r + attempt, effort=effort)
            try:
                rr = route(fug, spec, sp.as_placement(), replicas=1,
                           rg=rg, base_usage=base, max_iters=route_iters)
                la = balance(fug, spec, rr)
            except (RoutingError, LatencyError):
                continue
            done = (sp, rr, la)
            break
        if done is None:
            break
        sp, rr, la = done
        for sid, c in sp.fu_pos.items():
            placement.fu_pos[(r, sid)] = c
        for i, c in sp.in_pos.items():
            placement.in_pos[(r, i)] = c
        for i, c in sp.out_pos.items():
            placement.out_pos[(r, i)] = c
        placement.cost += sp.cost
        placement.moves += sp.moves
        nid = len(routing.nets)
        for n in rr.nets:
            routing.nets.append(RoutedNet(nid, n.skind, (r, n.src[1]),
                                          n.dkind, (r, n.dst[1]), n.port,
                                          n.path))
            nid += 1
        base.update(_base_usage(rr.nets))
        routing.iterations = max(routing.iterations, rr.iterations)
        routing.total_wirelength += rr.total_wirelength
        routing.max_channel_load = max(base.values())
        for (_z, sid, port), d in la.delays.items():
            lat.delays[(r, sid, port)] = d
        for (_z, sid), v in la.ready.items():
            lat.ready[(r, sid)] = v
        for (_z, oi), v in la.out_ready.items():
            lat.out_ready[(r, oi)] = v
        lat.pipeline_depth = max(lat.pipeline_depth, la.pipeline_depth)
        lat.max_delay_used = max(lat.max_delay_used, la.max_delay_used)
        used_tiles = set(sp.fu_pos.values())
        tiles = [t for t in tiles if t not in used_tiles]
        used_pads = Counter(sp.in_pos.values()) + Counter(sp.out_pos.values())
        remaining: List[Coord] = []
        for c in pads:
            if used_pads.get(c, 0) > 0:
                used_pads[c] -= 1
            else:
                remaining.append(c)
        pads = remaining
        r += 1
    return placement, routing, lat, r
