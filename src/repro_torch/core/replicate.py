"""Resource-aware kernel replication (paper §III-C, §IV, Figs. 5-6).

The OpenCL runtime exposes the overlay geometry (size, FU type, free I/O);
the compiler replicates the kernel DFG to fill those resources.  The same
policy generalises to the cluster: given the live device list, it picks the
data-parallel replica count — this is how the framework re-plans after an
elastic resize or node failure (DESIGN.md §7).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.fuse import FUGraph
from repro_torch.core.overlay import OverlaySpec


@dataclasses.dataclass(frozen=True)
class ReplicationPlan:
    replicas: int
    fus_used: int
    fus_total: int
    io_used: int
    io_total: int
    limited_by: str              # 'fu' | 'io' | 'request' | 'congestion'
    #                            # | 'stamp' (template slot capacity)

    @property
    def fu_utilisation(self) -> float:
        return self.fus_used / max(1, self.fus_total)

    def with_replicas(self, fug: FUGraph, replicas: int,
                      limited_by: str) -> "ReplicationPlan":
        """The same plan re-targeted at a different replica count (congestion
        shedding, template stamp capacity) with usage recomputed."""
        return dataclasses.replace(
            self, replicas=replicas, fus_used=replicas * fug.n_fus,
            io_used=replicas * fug.n_io, limited_by=limited_by)


def plan_replication(fug: FUGraph, spec: OverlaySpec,
                     max_replicas: Optional[int] = None,
                     fu_headroom: int = 0, io_headroom: int = 0
                     ) -> ReplicationPlan:
    """Max replicas that fit the overlay's FU and I/O budgets.

    ``*_headroom`` models 'other logic in the system' (paper Fig. 5): resources
    already consumed that the runtime subtracts before exposing the overlay.
    """
    fus_free = spec.n_fus - fu_headroom
    io_free = spec.n_io - io_headroom
    if fug.n_fus == 0:
        raise ValueError("kernel has no operations")
    by_fu = fus_free // fug.n_fus
    by_io = io_free // max(1, fug.n_io)
    r = max(0, min(by_fu, by_io))
    limited = "fu" if by_fu <= by_io else "io"
    if max_replicas is not None and r > max_replicas:
        r, limited = max_replicas, "request"
    return ReplicationPlan(
        replicas=r,
        fus_used=r * fug.n_fus, fus_total=spec.n_fus,
        io_used=r * fug.n_io, io_total=spec.n_io,
        limited_by=limited)


def throughput_gops(fug: FUGraph, spec: OverlaySpec, replicas: int,
                    io_bw_words_per_cycle: Optional[int] = None) -> float:
    """Analytic throughput of the mapped overlay (paper Fig. 6 model).

    Each replica retires one kernel iteration per cycle (II=1), performing
    ``n_primitive_ops`` arithmetic ops, until the perimeter I/O bandwidth
    saturates.
    """
    ops_per_iter = len(fug.dfg.op_nodes())
    io_words = fug.n_io
    iters_per_cycle = float(replicas)
    if io_bw_words_per_cycle is None:
        io_bw_words_per_cycle = spec.n_io
    iters_per_cycle = min(iters_per_cycle,
                          io_bw_words_per_cycle / max(1, io_words))
    return ops_per_iter * iters_per_cycle * spec.fclk_mhz * 1e6 / 1e9


# ---------------------------------------------------------------- cluster

@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """Resource-aware replication lifted to the device mesh.

    dp_replicas × model_shards must equal the usable device count; after an
    elastic resize the planner re-derives the largest coherent mesh.
    """
    n_devices: int
    dp_replicas: int
    model_shards: int
    dropped_devices: int

    @property
    def mesh_shape(self) -> Tuple[int, int]:
        return (self.dp_replicas, self.model_shards)


def plan_cluster(n_devices: int, model_shards: int) -> ClusterPlan:
    """Largest (dp, tp) mesh with the requested model sharding that fits the
    live device count; surplus devices are benched (like partial overlay
    occupancy in Fig. 5)."""
    if model_shards <= 0:
        raise ValueError("model_shards must be positive")
    if n_devices < model_shards:
        # shrink model sharding to the largest power-of-two that fits
        ms = 1
        while ms * 2 <= n_devices:
            ms *= 2
        model_shards = ms
    dp = n_devices // model_shards
    used = dp * model_shards
    return ClusterPlan(n_devices, dp, model_shards, n_devices - used)
