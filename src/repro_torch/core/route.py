"""PathFinder negotiated-congestion routing (paper §III-D).

Routes the FU netlist over the overlay's channel graph.  Nets are
multi-terminal: all fanout of one source shares a routing tree (wire
segments are counted once per net, as on the real interconnect).  Classic
PathFinder: iteratively rip-up & re-route with edge costs
``1 + overuse * p_fac + history``; p_fac escalates per iteration until no
channel bundle exceeds its capacity.

Per-sink hop counts (1 cycle per registered link) feed latency balancing.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

from repro_torch.core.faults import fault_point
from repro_torch.core.fuse import FUGraph
from repro_torch.core.overlay import Coord, OverlaySpec, RoutingGraph
from repro_torch.core.place import Placement


class RoutingError(RuntimeError):
    pass


@dataclasses.dataclass
class RoutedNet:
    net_id: int
    skind: str
    src: Tuple[int, int]        # (replica, id)
    dkind: str
    dst: Tuple[int, int]
    port: int
    path: List[Coord]           # src tile … dst tile inclusive

    @property
    def hops(self) -> int:
        return max(0, len(self.path) - 1)


_KIND = {"in": 0, "fu": 1, "out": 2}
_KIND_R = {v: k for k, v in _KIND.items()}


def _pack_nets(nets: List[RoutedNet]) -> Tuple["np.ndarray", "np.ndarray"]:
    import numpy as np
    meta = np.empty((len(nets), 9), np.int32)
    coords = np.empty((sum(len(n.path) for n in nets), 2), np.int32)
    off = 0
    for i, n in enumerate(nets):
        meta[i] = (n.net_id, _KIND[n.skind], n.src[0], n.src[1],
                   _KIND[n.dkind], n.dst[0], n.dst[1], n.port, len(n.path))
        coords[off:off + len(n.path)] = n.path
        off += len(n.path)
    return meta, coords


def _unpack_nets(meta, coords) -> List[RoutedNet]:
    nets: List[RoutedNet] = []
    off = 0
    cl = coords.tolist()
    for nid, sk, sr, si, dk, dr, di, port, plen in meta.tolist():
        nets.append(RoutedNet(nid, _KIND_R[sk], (sr, si), _KIND_R[dk],
                              (dr, di), port,
                              [tuple(c) for c in cl[off:off + plen]]))
        off += plen
    return nets


class RoutingResult:
    """The routed netlist plus router statistics.

    Pickles in a *packed* form — two numpy arrays instead of tens of
    thousands of per-net python objects — and rebuilds :attr:`nets` lazily
    on first access.  A disk-cache warm load therefore never materializes
    the net objects at all (the serving path only executes the already-
    generated bitstream/program), which keeps restart warm-loads in the
    ~millisecond range and avoids large GC allocation bursts.
    """

    def __init__(self, nets: List[RoutedNet], iterations: int,
                 max_channel_load: int, total_wirelength: int):
        self._nets: Optional[List[RoutedNet]] = nets
        self._packed = None
        self.iterations = iterations
        self.max_channel_load = max_channel_load
        self.total_wirelength = total_wirelength   # tree segments, once/net

    @property
    def nets(self) -> List[RoutedNet]:
        if self._nets is None:
            self._nets = _unpack_nets(*self._packed)
            self._packed = None
        return self._nets

    def wires_used(self) -> int:
        return self.total_wirelength

    def __getstate__(self):
        meta, coords = self._packed if self._packed is not None \
            else _pack_nets(self._nets)
        return dict(meta=meta, coords=coords, iterations=self.iterations,
                    max_channel_load=self.max_channel_load,
                    total_wirelength=self.total_wirelength)

    def __setstate__(self, state):
        self._nets = None
        self._packed = (state["meta"], state["coords"])
        self.iterations = state["iterations"]
        self.max_channel_load = state["max_channel_load"]
        self.total_wirelength = state["total_wirelength"]

    def __repr__(self) -> str:
        n = len(self._nets) if self._nets is not None else len(self._packed[0])
        return (f"RoutingResult({n} nets, {self.iterations} iters, "
                f"wirelength {self.total_wirelength})")


def _pos(placement: Placement, kind: str, key: Tuple[int, int]) -> Coord:
    if kind == "fu":
        return placement.fu_pos[key]
    if kind == "in":
        return placement.in_pos[key]
    return placement.out_pos[key]


def route(fug: FUGraph, spec: OverlaySpec, placement: Placement,
          replicas: int = 1, max_iters: int = 60,
          rg: Optional[RoutingGraph] = None,
          base_usage: Optional[Dict[Tuple[Coord, Coord], int]] = None
          ) -> RoutingResult:
    """Route the placed netlist.  ``rg`` restricts routing to a sub-graph of
    the fabric (the template pipeline passes a strip-local graph so routes
    provably never leave the stamped region).  ``base_usage`` pre-charges
    channel load that PathFinder must route around but may never rip up —
    the template gap-fill pass uses it to add remnant replicas to an
    already-routed fabric without disturbing the existing nets."""
    fault_point("route", fug.dfg.name)
    if rg is None:
        rg = RoutingGraph(spec)

    # ---- group edges into multi-terminal nets keyed by source
    sinks_of: Dict[Tuple[str, Tuple[int, int]], List] = {}
    for r in range(replicas):
        for skind, sid, dkind, did, port in fug.edges:
            key = (skind, (r, sid))
            sinks_of.setdefault(key, []).append((dkind, (r, did), port))
    net_keys = sorted(sinks_of.keys(), key=lambda k: (k[0], k[1]))

    usage: Dict[Tuple[Coord, Coord], int] = \
        dict(base_usage) if base_usage else {}
    history: Dict[Tuple[Coord, Coord], float] = {}
    # per net: set of tree edges, and per-sink coord paths
    tree_edges: Dict[int, List[Tuple[Coord, Coord]]] = {}
    sink_paths: Dict[int, List[List[Coord]]] = {}

    def edge_cost(e: Tuple[Coord, Coord], p_fac: float) -> float:
        cap = rg.capacity[e]
        u = usage.get(e, 0)
        over = max(0, u + 1 - cap)
        return 1.0 + over * p_fac + history.get(e, 0.0)

    def route_net(ni: int, src: Coord, dsts: List[Coord], p_fac: float):
        """Grow a routing tree from src to every dst (nearest-first)."""
        # parent map over coords; tree initially just the source
        parent: Dict[Coord, Optional[Coord]] = {src: None}
        edges: List[Tuple[Coord, Coord]] = []
        paths: List[Optional[List[Coord]]] = [None] * len(dsts)
        remaining = set(range(len(dsts)))
        while remaining:
            # multi-source Dijkstra from all tree nodes to nearest remaining
            dist: Dict[Coord, float] = {n: 0.0 for n in parent}
            prev: Dict[Coord, Coord] = {}
            pq = [(0.0, n) for n in parent]
            heapq.heapify(pq)
            seen = set()
            target = None
            targets = {dsts[i] for i in remaining}
            while pq:
                d, n = heapq.heappop(pq)
                if n in seen:
                    continue
                seen.add(n)
                if n in targets:
                    target = n
                    break
                for m in rg.neighbours(n):
                    e = (n, m)
                    nd = d + edge_cost(e, p_fac)
                    if nd < dist.get(m, float("inf")):
                        dist[m] = nd
                        prev[m] = n
                        heapq.heappush(pq, (nd, m))
            if target is None:
                raise RoutingError(f"no path to sinks {sorted(targets)}")
            # back-trace new segment to the tree, attach
            seg = [target]
            while seg[-1] not in parent:
                seg.append(prev[seg[-1]])
            seg.reverse()                       # tree node … target
            for a, b in zip(seg, seg[1:]):
                if b not in parent:             # guard against revisits
                    parent[b] = a
                    edges.append((a, b))
            # record full path root→target for every dst at this coord
            full = _walk(parent, target)
            for i in list(remaining):
                if dsts[i] == target:
                    paths[i] = full
                    remaining.discard(i)
        tree_edges[ni] = edges
        sink_paths[ni] = [p if p is not None else [src] for p in paths]

    def _walk(parent: Dict[Coord, Optional[Coord]], node: Coord) -> List[Coord]:
        out = [node]
        while parent[out[-1]] is not None:
            out.append(parent[out[-1]])
        out.reverse()
        return out

    p_fac = 0.5
    iters = 0
    for it in range(max_iters):
        iters = it + 1
        for ni, key in enumerate(net_keys):
            # rip up
            for e in tree_edges.get(ni, ()):
                usage[e] -= 1
            skind, skey = key
            src = _pos(placement, skind, skey)
            dsts = [_pos(placement, dkind, dkey)
                    for dkind, dkey, _p in sinks_of[key]]
            route_net(ni, src, dsts, p_fac)
            for e in tree_edges[ni]:
                usage[e] = usage.get(e, 0) + 1
        over = 0
        for e, u in usage.items():
            if u > rg.capacity[e]:
                over += 1
                history[e] = history.get(e, 0.0) + (u - rg.capacity[e]) * 0.5
        if over == 0:
            break
        p_fac *= 1.6
    else:
        raise RoutingError(
            f"unroutable after {max_iters} iters on "
            f"{spec.width}x{spec.height} cw={spec.channel_width}")

    nets: List[RoutedNet] = []
    nid = 0
    for ni, key in enumerate(net_keys):
        skind, skey = key
        for (dkind, dkey, port), path in zip(sinks_of[key], sink_paths[ni]):
            nets.append(RoutedNet(nid, skind, skey, dkind, dkey, port, path))
            nid += 1
    wirelength = sum(len(v) for v in tree_edges.values())
    max_load = max(usage.values(), default=0)
    return RoutingResult(nets, iters, max_load, wirelength)
