"""Latency balancing (paper §III-E).

The overlay datapath is fully pipelined with II=1: every FU fires each cycle,
so *all inputs of an FU must arrive in the same cycle*.  After P&R we know
each connection's hop latency (1 cycle per registered link) and each FU's
pipeline depth; this pass computes per-input delay-chain settings and the
total pipeline depth of the mapped kernel.

Raises if any required delay exceeds the overlay's delay-chain capacity —
that is a real mapping failure, as on the hardware.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.core.fuse import FUGraph
from repro_torch.core.overlay import OverlaySpec
from repro_torch.core.place import PackedMaps
from repro_torch.core.route import RoutingResult


class LatencyError(RuntimeError):
    pass


@dataclasses.dataclass
class LatencyAssignment(PackedMaps):
    _MAPS = ("delays", "ready", "out_ready")

    # (replica, sid, port) -> delay-chain length in cycles
    delays: Dict[Tuple[int, int, int], int]
    # (replica, sid) -> cycle at which this FU's *output* is valid
    ready: Dict[Tuple[int, int], int]
    # (replica, out idx) -> arrival cycle at the IO pad
    out_ready: Dict[Tuple[int, int], int]
    pipeline_depth: int
    max_delay_used: int


def balance(fug: FUGraph, spec: OverlaySpec, routing: RoutingResult
            ) -> LatencyAssignment:
    # member count per sid (dual-DSP FUs have 2 chained primitives)
    depth_of = {s.sid: len(s.members) * spec.fu_latency for s in fug.supers}

    # group incoming nets per (replica, sid)
    incoming: Dict[Tuple[int, int], List] = {}
    out_nets = []
    for n in routing.nets:
        if n.dkind == "fu":
            incoming.setdefault(n.dst, []).append(n)
        else:
            out_nets.append(n)

    ready: Dict[Tuple[int, int], int] = {}
    delays: Dict[Tuple[int, int, int], int] = {}

    def src_ready(net) -> int:
        if net.skind == "in":
            return 0            # IO pads present data at cycle 0
        return ready[net.src]

    # process FUs in dependency order: iterate to fixed point (graph is a DAG)
    reps = sorted({k[0] for k in incoming} |
                  {n.src[0] for n in routing.nets if n.skind == "fu"} | {0})
    pending = {(r, s.sid) for r in reps for s in fug.supers}

    progressed = True
    while pending and progressed:
        progressed = False
        for key in sorted(pending):
            ins = incoming.get(key, [])
            if any(n.skind == "fu" and n.src not in ready for n in ins):
                continue
            arrivals = [src_ready(n) + n.hops for n in ins]
            latest = max(arrivals, default=0)
            for n, arr in zip(ins, arrivals):
                delays[(key[0], key[1], n.port)] = latest - arr
            ready[key] = latest + depth_of[key[1]]
            pending.discard(key)
            progressed = True
    if pending:
        raise LatencyError(f"latency graph has a cycle: {sorted(pending)[:4]}")

    out_ready = {}
    for n in out_nets:
        out_ready[n.dst] = src_ready(n) + n.hops
    # outputs of one kernel replica must also be aligned (a store happens for
    # all outvars of a work-item in the same cycle): pad with IO delays
    by_rep: Dict[int, List[Tuple[Tuple[int, int], int]]] = {}
    for k, v in out_ready.items():
        by_rep.setdefault(k[0], []).append((k, v))
    io_delays = {}
    for r, items in by_rep.items():
        latest = max(v for _, v in items)
        for k, v in items:
            io_delays[k] = latest - v
            out_ready[k] = latest

    max_d = max(list(delays.values()) + list(io_delays.values()) + [0])
    if max_d > spec.max_delay:
        raise LatencyError(
            f"required delay {max_d} exceeds delay-chain capacity "
            f"{spec.max_delay}")
    depth = max(out_ready.values(), default=0)
    return LatencyAssignment(delays, ready, out_ready, depth, max_d)
