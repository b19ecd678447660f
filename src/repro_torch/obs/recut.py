"""Profile-guided graph re-cutting: the first closed observability loop.

A graph's cut is decided once, with no knowledge of the batch sizes it
will serve: the greedy cut (``repro_torch.core.graph.partition_graph``) is
item-oblivious, instantiation-time ``max_partition_fus`` caps outlive
the multi-tenant pressure that motivated them, and plans adopted from a
fleet profile (or an earlier re-cut) go stale when the traffic regime
changes.  Whether the cut in use is still the right one — config
charges vs the ``ceil(items / replicas)`` streaming term under the
fabric the cut's partitions share — is exactly what the
:class:`~repro_torch.obs.profile.ReplayProfile` measured: items per replay,
µs per config charge, per-node cost attribution.

:func:`plan_recut` runs a resource DP over all topo-contiguous interval
cuts, pricing each candidate segment with the *measured* batch size and
config charge::

    seg_us = config_unit_us + (depth + ceil(items / replicas)) / fclk

(depth approximated by the fused FU count — negligible against the
streaming term at profiled batch sizes).  Crucially the replicas a
segment is priced at are NOT planned against the full fabric: every
partition of an instantiated graph is resident at once, so the cut's
segments share one FU/IO budget.  The DP therefore runs over
``(prefix, fabric-consumed)`` states — pricing each segment against a
full fabric would systematically over-credit splits (each priced as if
alone on the device) and adopt cuts that are measurably *slower* than
the fused cut they replace.  :class:`ReCutter` then applies the
never-worse contract: the candidate cut is adopted only when its
co-resident estimate *strictly* beats the same estimator applied to the
current cut; the winning cut is compiled through the ordinary warm
single-flight ``Session.compile`` path and memoised via
``Session.adopt_graph_plan`` so every future ``instantiate`` of the
graph is a warm hit on the re-cut kernels.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.fuse import FusionError, to_fu_graph
from repro_torch.core.graph import (_fuse_partition, _graph_consumers,
                                    partition_graph, partition_graph_grouped)
from repro_torch.core.replicate import plan_replication
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.profile import (ProfileStore, ReplayProfile,
                                     profile_key)

__all__ = ["ReCutResult", "ReCutter", "estimate_cut_us", "plan_recut"]

Cut = Tuple[Tuple[int, ...], ...]


@dataclasses.dataclass
class ReCutResult:
    """Outcome of one re-cut attempt.  ``gexec`` is the freshly
    instantiated replacement when ``swapped`` (the caller retires the
    old exec); estimates are modelled µs per replay under the profile's
    measured batch size."""

    swapped: bool
    reason: str
    graph_name: str
    old_cut: Cut
    new_cut: Cut
    old_est_us: float
    new_est_us: float
    gexec: Optional[object] = None

    @property
    def gain(self) -> float:
        """Estimated speedup of the adopted cut (1.0 when kept)."""
        if not self.swapped or self.new_est_us <= 0.0:
            return 1.0
        return self.old_est_us / self.new_est_us

    def as_dict(self) -> dict:
        return dict(swapped=self.swapped, reason=self.reason,
                    graph=self.graph_name,
                    old_cut=[list(g) for g in self.old_cut],
                    new_cut=[list(g) for g in self.new_cut],
                    old_est_us=self.old_est_us, new_est_us=self.new_est_us,
                    gain=self.gain)


def _default_config_unit_us(spec) -> float:
    """Config-charge estimate when the profile never observed one:
    the bitstream model's 25 MB/s partial-reconfiguration rate over the
    spec's full config image."""
    return spec.config_bits() / 8.0 / 25.0


def _segment_probe(graph, nodes, spec, fu_budget: int,
                   consumers) -> Optional[Tuple[object, int]]:
    """Fuse a candidate segment and bound its replication: returns the
    fused FU graph plus the replica cap it would get ALONE on the fabric
    (the co-resident assignment can only lower it), or None when the
    segment is infeasible (incompatible, over budget, no replica)."""
    head = nodes[0]
    for n in nodes[1:]:
        if not head.opts.fuse_compatible(n.opts):
            return None
    try:
        part = _fuse_partition(graph, nodes, index=0, consumers=consumers)
    except FusionError:
        return None
    fug = to_fu_graph(part.dfg, dsp_per_fu=spec.dsp_per_fu)
    if fug.n_fus > fu_budget or fug.n_io > spec.n_io:
        return None
    plan = plan_replication(fug, spec,
                            max_replicas=part.opts.max_replicas)
    if plan.replicas < 1:
        return None
    return fug, plan.replicas


def _coresident_replicas(segs: Sequence[Tuple[object, int]],
                         spec) -> Optional[List[int]]:
    """Replica assignment for a whole cut under CO-RESIDENCY: every
    partition of an instantiated graph holds its fabric at once, so the
    segments water-fill one shared FU/IO budget.  Starts every segment
    at one replica (None if even that does not fit) and repeatedly
    grants +1 to the segment with the largest marginal streaming
    reduction (∝ 1 / r(r+1); all segments stream the same batch)."""
    rs = [1] * len(segs)
    fus = sum(f.n_fus for f, _ in segs)
    ios = sum(f.n_io for f, _ in segs)
    if fus > spec.n_fus or ios > spec.n_io:
        return None
    while True:
        pick = -1
        pick_gain = 0.0
        for i, (f, cap) in enumerate(segs):
            if rs[i] >= cap or fus + f.n_fus > spec.n_fus \
                    or ios + f.n_io > spec.n_io:
                continue
            gain = 1.0 / (rs[i] * (rs[i] + 1))
            if gain > pick_gain:
                pick, pick_gain = i, gain
        if pick < 0:
            return rs
        rs[pick] += 1
        fus += segs[pick][0].n_fus
        ios += segs[pick][0].n_io


def _price_cut(segs: Sequence[Tuple[object, int]], spec, items: float,
               config_unit_us: float) -> Optional[float]:
    """Co-resident modelled µs for one replay of a probed cut."""
    rs = _coresident_replicas(segs, spec)
    if rs is None:
        return None
    total = 0.0
    for (fug, _), r in zip(segs, rs):
        cycles = fug.n_fus + math.ceil(items / r)
        total += config_unit_us + cycles / spec.fclk_mhz
    return total


def estimate_cut_us(graph, spec, cut: Sequence[Sequence[int]],
                    profile: ReplayProfile,
                    max_partition_fus: Optional[int] = None
                    ) -> Optional[float]:
    """Price an existing cut with the same estimator the DP uses, so
    old-vs-new comparisons are apples to apples."""
    items = profile.items_per_replay()
    cfg = profile.config_unit_us()
    if cfg is None:
        cfg = _default_config_unit_us(spec)
    fu_budget = spec.n_fus if max_partition_fus is None \
        else min(max_partition_fus, spec.n_fus)
    consumers = _graph_consumers(graph)
    by_nid = {n.nid: n for n in graph.nodes}
    segs = []
    for grp in cut:
        probe = _segment_probe(graph, [by_nid[nid] for nid in grp], spec,
                               fu_budget, consumers)
        if probe is None:
            return None
        segs.append(probe)
    return _price_cut(segs, spec, items, cfg)


def plan_recut(graph, spec, profile: ReplayProfile,
               max_partition_fus: Optional[int] = None,
               max_segment: int = 12
               ) -> Optional[Tuple[List[List[int]], float]]:
    """Optimal topo-contiguous interval cut under the measured costs
    AND the shared fabric.

    Shortest path over ``(prefix j, FUs consumed)`` states: a segment
    entering the cut picks its replica count r and pays ``fus × r`` out
    of the one budget every co-resident partition shares, priced with
    the profile's measured items and config-charge µs.  States are kept
    sparse (only reachable fabric sums); segments are capped at
    ``max_segment`` nodes to bound the O(n · max_segment) fuse probes.
    The winning cut is re-priced with :func:`estimate_cut_us` (which
    also enforces the IO budget) so the returned estimate is exactly
    comparable with the current cut's.  Returns ``(groups,
    estimated_us)`` or None when no feasible cut exists.
    """
    order = graph.toposort()
    n = len(order)
    if n == 0:
        return None
    items = profile.items_per_replay()
    cfg = profile.config_unit_us()
    if cfg is None:
        cfg = _default_config_unit_us(spec)
    fu_budget = spec.n_fus if max_partition_fus is None \
        else min(max_partition_fus, spec.n_fus)
    consumers = _graph_consumers(graph)

    probes: Dict[Tuple[int, int], Tuple[int, int]] = {}
    for j in range(1, n + 1):
        for i in range(max(0, j - max_segment), j):
            probe = _segment_probe(graph, order[i:j], spec, fu_budget,
                                   consumers)
            if probe is not None:
                probes[(i, j)] = (probe[0].n_fus, probe[1])

    # sparse DP: best[j] maps fabric-consumed -> (cost, (i, f, r)) back-ptr
    best: List[Dict[int, Tuple[float, Optional[Tuple[int, int, int]]]]] = \
        [{} for _ in range(n + 1)]
    best[0][0] = (0.0, None)
    for j in range(1, n + 1):
        for i in range(max(0, j - max_segment), j):
            seg = probes.get((i, j))
            if seg is None:
                continue
            seg_fus, rcap = seg
            for f, (cost, _) in list(best[i].items()):
                for r in range(1, rcap + 1):
                    nf = f + seg_fus * r
                    if nf > spec.n_fus:
                        break
                    cand = cost + cfg + \
                        (seg_fus + math.ceil(items / r)) / spec.fclk_mhz
                    cur = best[j].get(nf)
                    if cur is None or cand < cur[0] - 1e-12:
                        best[j][nf] = (cand, (i, f, r))
    if not best[n]:
        return None
    end_f = min(best[n], key=lambda f: (best[n][f][0], f))
    groups: List[List[int]] = []
    j, f = n, end_f
    while j > 0:
        i, pf, _ = best[j][f][1]
        groups.append([node.nid for node in order[i:j]])
        j, f = i, pf
    groups.reverse()
    honest = estimate_cut_us(graph, spec, groups, profile,
                             max_partition_fus)
    if honest is None:
        return None
    return groups, honest


class ReCutter:
    """Background profile-guided re-cutter bound to one Session.

    :meth:`consider` is the synchronous core; :meth:`consider_async`
    submits it to the session's build pool so re-cutting rides the same
    worker threads (and tracer/fault activation) as hedged compiles.
    """

    FIELDS = ("attempts", "swapped", "kept", "cold", "infeasible")

    def __init__(self, session, store: ProfileStore,
                 min_replays: int = 2, min_gain: float = 1.01):
        self.session = session
        self.store = store
        self.min_replays = int(min_replays)
        self.min_gain = float(min_gain)
        self._lock = threading.Lock()
        self._rstats = {f: 0 for f in self.FIELDS}  # lock: _lock

    def _bump(self, field: str) -> None:
        with self._lock:
            self._rstats[field] += 1

    def consider(self, graph, max_partition_fus: Optional[int] = None,
                 tenant: Optional[str] = None) -> ReCutResult:
        """Re-cut ``graph`` if its profile says a better cut exists.

        Never-worse contract: without a hot profile, or when the DP's
        best estimate does not beat the current cut's estimate by at
        least ``min_gain``, the current cut is kept and no compile is
        issued.  On a win the new cut is instantiated through the warm
        single-flight path and memoised for future instantiations.
        """
        sess = self.session
        with obs_trace.activate(sess.tracer), \
                obs_trace.span("recut:consider", "session",
                               graph=graph.name) as sp:
            self._bump("attempts")
            spec = sess.scheduler.partition_spec()
            parts_old = sess.graph_plan(graph, max_partition_fus)
            if parts_old is None:
                parts_old = partition_graph(graph, spec, max_partition_fus)
            old_cut: Cut = tuple(tuple(p.node_ids) for p in parts_old)
            prof = self.store.get(profile_key(graph.fingerprint(), spec))
            if prof is None or prof.replays < self.min_replays \
                    or prof.cut != old_cut:
                self._bump("cold")
                sp["reason"] = "cold"
                return ReCutResult(False, "cold", graph.name,
                                   old_cut, old_cut,
                                   float("nan"), float("nan"))
            old_est = estimate_cut_us(graph, spec, old_cut, prof,
                                      max_partition_fus)
            if old_est is None:
                old_est = float("inf")
            plan = plan_recut(graph, spec, prof, max_partition_fus)
            if plan is None:
                self._bump("infeasible")
                sp["reason"] = "infeasible"
                return ReCutResult(False, "infeasible", graph.name,
                                   old_cut, old_cut, old_est, old_est)
            groups, new_est = plan
            new_cut: Cut = tuple(tuple(g) for g in groups)
            sp["old_est_us"] = old_est
            sp["new_est_us"] = new_est
            if new_cut == old_cut or new_est * self.min_gain > old_est:
                self._bump("kept")
                sp["reason"] = "kept"
                return ReCutResult(False, "kept", graph.name,
                                   old_cut, new_cut, old_est, new_est)
            partitions = partition_graph_grouped(
                graph, spec, groups, max_partition_fus=max_partition_fus)
            gexec = sess.instantiate(graph, tenant=tenant,
                                     max_partition_fus=max_partition_fus,
                                     plan=partitions)
            sess.adopt_graph_plan(graph, partitions,
                                  max_partition_fus=max_partition_fus)
            self._bump("swapped")
            sp["reason"] = "swapped"
            return ReCutResult(True, "swapped", graph.name,
                               old_cut, new_cut, old_est, new_est,
                               gexec=gexec)

    def consider_async(self, graph,
                       max_partition_fus: Optional[int] = None,
                       tenant: Optional[str] = None):
        """Run :meth:`consider` on the session's build pool; returns a
        Future[ReCutResult]."""
        return self.session._pool.submit(
            self.consider, graph, max_partition_fus, tenant)

    def stats_dict(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._rstats)

    def __repr__(self) -> str:
        d = self.stats_dict()
        return (f"ReCutter({d['attempts']} attempt(s), "
                f"{d['swapped']} swap(s))")
