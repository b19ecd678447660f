"""Content-addressed replay profiles, persisted through the cache tiers.

A :class:`ReplayProfile` accumulates what the runtime *measured* while
replaying one captured graph against one overlay spec: per-partition hit
counts, work items, modelled exec/config µs, config charges and observed
queue gaps.  The key — ``profile:<graph_fp>@<spec_fp>`` — is content
addressed exactly like compiled-kernel keys, so profiles ride the same
disk/remote write-through tiers and warm-start across process restarts
and across the fleet: a fresh host can re-cut a graph it has never
replayed, using the fleet's measurements.

The :class:`~repro_torch.core.session.Session` calls
:meth:`ProfileStore.record` at the end of every ``launch`` when a store is
attached; the profile-guided re-cutter (``repro_torch.obs.recut``) is the
first consumer.

Every time in a profile is the command queues' *modelled* µs, as in the
JAX package, never a time measured on the card: the re-cutter prices cuts
with the same model the queues book, so the two must not mix.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
from typing import Dict, Optional, Tuple

from repro_torch.core.cache import spec_fingerprint
from repro_torch.obs import trace as obs_trace

__all__ = ["PartitionProfile", "ProfileStore", "ReplayProfile",
           "hot_profiles", "profile_key"]


def profile_key(graph_fp: str, spec) -> str:
    """Content-addressed cache key for one (graph, overlay spec) pair."""
    return f"profile:{graph_fp}@{spec_fingerprint(spec)[:16]}"


@dataclasses.dataclass
class PartitionProfile:
    """Cumulative measurements for one partition of one cut."""

    index: int
    nodes: Tuple[int, ...] = ()
    name: str = ""
    hits: int = 0               # replays observed
    items: float = 0.0          # cumulative work items enqueued
    exec_us: float = 0.0        # cumulative modelled execution µs
    config_us: float = 0.0      # cumulative modelled config-charge µs
    config_charges: int = 0     # replays that paid a config charge
    queue_gap_us: float = 0.0   # cumulative submit-vs-ready gap µs

    def as_dict(self) -> dict:
        return dict(index=self.index, nodes=list(self.nodes),
                    name=self.name, hits=self.hits, items=self.items,
                    exec_us=self.exec_us, config_us=self.config_us,
                    config_charges=self.config_charges,
                    queue_gap_us=self.queue_gap_us)


@dataclasses.dataclass
class ReplayProfile:
    """All measurements for one graph fingerprint under one cut.

    The profile is cut-scoped: if the graph is re-cut (or the session's
    partition cap changes the greedy cut), accumulated per-partition
    rows no longer describe the running kernels and are reset.
    """

    key: str
    graph_fp: str
    cut: Tuple[Tuple[int, ...], ...] = ()
    replays: int = 0
    parts: Dict[int, PartitionProfile] = dataclasses.field(
        default_factory=dict)

    # ------------------------------------------------------------ accumulate

    def note_replay(self, partitions, events) -> None:
        """Fold one replay's per-partition events in (caller holds the
        store lock; ``events[i]`` is the Event of ``partitions[i]``)."""
        cut_now = tuple(tuple(p.node_ids) for p in partitions)
        if cut_now != self.cut:
            self.cut = cut_now
            self.replays = 0
            self.parts = {}
        self.replays += 1
        for p, ev in zip(partitions, events):
            pp = self.parts.get(p.index)
            if pp is None:
                pp = self.parts[p.index] = PartitionProfile(
                    p.index, tuple(p.node_ids), p.opts.name or "")
            pp.hits += 1
            kernel = getattr(ev, "_kernel", None)
            if kernel is not None:
                pp.items += kernel.work_items
            pp.exec_us += ev.exec_us
            pp.config_us += ev.config_us
            if ev.config_us > 0.0:
                pp.config_charges += 1
            pp.queue_gap_us += ev.queue_delay_us

    # ----------------------------------------------------------- derivation

    def items_per_replay(self) -> float:
        """Measured work items one replay pushes through the pipeline
        (max across partitions: every stage of a chain sees the full
        batch, and max is robust to partitions joining mid-profile)."""
        if self.replays == 0:
            return 0.0
        return max((pp.items / max(1, pp.hits)
                    for pp in self.parts.values()), default=0.0)

    def config_unit_us(self) -> Optional[float]:
        """Measured µs of one config charge, or None if never observed."""
        charges = sum(pp.config_charges for pp in self.parts.values())
        if charges == 0:
            return None
        return sum(pp.config_us for pp in self.parts.values()) / charges

    def node_cost_us(self) -> Dict[int, float]:
        """Measured per-node cost attribution: each partition's mean
        exec µs split evenly across its member nodes."""
        out: Dict[int, float] = {}
        for pp in self.parts.values():
            if not pp.nodes or pp.hits == 0:
                continue
            share = pp.exec_us / pp.hits / len(pp.nodes)
            for nid in pp.nodes:
                out[nid] = out.get(nid, 0.0) + share
        return out

    def mean_queue_gap_us(self) -> float:
        hits = sum(pp.hits for pp in self.parts.values())
        if hits == 0:
            return 0.0
        return sum(pp.queue_gap_us for pp in self.parts.values()) / hits

    def as_dict(self) -> dict:
        return dict(key=self.key, graph_fp=self.graph_fp,
                    cut=[list(g) for g in self.cut], replays=self.replays,
                    items_per_replay=self.items_per_replay(),
                    config_unit_us=self.config_unit_us(),
                    mean_queue_gap_us=self.mean_queue_gap_us(),
                    parts={i: pp.as_dict()
                           for i, pp in sorted(self.parts.items())})

    def __repr__(self) -> str:
        return (f"ReplayProfile({self.key}: {self.replays} replay(s), "
                f"{len(self.parts)} partition(s))")


class ProfileStore:
    """Memory tier over the session cache's disk/remote tiers.

    Reads promote (remote → disk → memory) and writes flush through,
    mirroring ``JITCache`` — but through the *tiers directly*, so
    profiles never compete with compiled kernels for the LRU memory
    tier and never perturb compile-cache hit statistics.
    """

    FIELDS = ("records", "flushes", "flush_errors", "loads_memory",
              "loads_disk", "loads_remote", "load_misses")

    def __init__(self, cache=None, flush_every: int = 1):
        self.cache = cache                       # JITCache (tier access)
        self.flush_every = max(1, int(flush_every))
        self._lock = threading.Lock()
        self._profiles: Dict[str, ReplayProfile] = {}  # lock: _lock
        self._pending: Dict[str, int] = {}  # lock: _lock
        self._ocounts = {f: 0 for f in self.FIELDS}  # lock: _lock

    # -------------------------------------------------------------- recording

    def record(self, gexec, events, spec) -> Optional[ReplayProfile]:
        """Fold one ``Session.launch`` replay into the graph's profile.

        Returns the updated profile, or None when the replay did not run
        partition-for-partition (e.g. the node-wise recovery fallback
        replaced a fused kernel — those events do not describe the cut).
        """
        partitions = gexec.partitions
        if len(events) != len(partitions) or any(
                getattr(ev, "_kernel", None) is None for ev in events):
            # a replay where the node-wise recovery ladder replaced a
            # fused kernel (aggregate events carry no kernel) does not
            # describe the cut — profiling it would poison the re-cutter
            return None
        key = profile_key(gexec.graph.fingerprint(), spec)
        prof = self.get(key)
        with self._lock:
            if prof is None:
                prof = self._profiles.get(key)
                if prof is None:
                    prof = ReplayProfile(key, gexec.graph.fingerprint())
                    self._profiles[key] = prof
            prof.note_replay(partitions, events)
            self._ocounts["records"] += 1
            n = self._pending.get(key, 0) + 1
            flush = n >= self.flush_every
            self._pending[key] = 0 if flush else n
            snap = copy.deepcopy(prof) if flush else None
        if flush:
            self._flush(key, snap)
        return prof

    # ----------------------------------------------------------------- tiers

    def get(self, key: str) -> Optional[ReplayProfile]:
        """Memory → disk → remote lookup with promotion."""
        with self._lock:
            prof = self._profiles.get(key)
            if prof is not None:
                self._ocounts["loads_memory"] += 1
                return prof
        loaded, tier = self._load_tiers(key)
        with self._lock:
            cur = self._profiles.get(key)
            if cur is not None:              # raced another loader
                return cur
            if loaded is None:
                self._ocounts["load_misses"] += 1
                return None
            self._ocounts[tier] += 1
            self._profiles[key] = loaded
        return loaded

    def _load_tiers(self, key: str):
        cache = self.cache
        if cache is None:
            return None, ""
        disk = getattr(cache, "disk", None)
        remote = getattr(cache, "remote", None)
        with obs_trace.span("profile:load", "cache", key=key) as sp:
            if disk is not None:
                try:
                    obj = disk.get(key)
                except Exception:
                    obj = None
                if isinstance(obj, ReplayProfile):
                    sp["tier"] = "disk"
                    return obj, "loads_disk"
            if remote is not None:
                try:
                    obj = remote.get(key)
                except Exception:
                    obj = None
                if isinstance(obj, ReplayProfile):
                    sp["tier"] = "remote"
                    if disk is not None:     # promote for the next restart
                        try:
                            disk.put(key, obj)
                        except Exception:
                            pass
                    return obj, "loads_remote"
            sp["tier"] = "miss"
        return None, ""

    def _flush(self, key: str, snap: ReplayProfile) -> None:
        """Write-through one snapshot to the persistent tiers (best
        effort: a dead tier must never fail the replay that profiled)."""
        cache = self.cache
        if cache is None:
            return
        ok = False
        with obs_trace.span("profile:flush", "cache", key=key):
            disk = getattr(cache, "disk", None)
            if disk is not None:
                try:
                    disk.put(key, snap)
                    ok = True
                except Exception:
                    pass
            remote = getattr(cache, "remote", None)
            if remote is not None:
                try:
                    remote.put(key, snap)
                    ok = True
                except Exception:
                    pass
        with self._lock:
            self._ocounts["flushes" if ok else "flush_errors"] += 1

    def flush(self) -> None:
        """Force-write every in-memory profile (shutdown hook)."""
        with self._lock:
            snaps = {k: copy.deepcopy(p) for k, p in self._profiles.items()}
            for k in snaps:
                self._pending[k] = 0
        for k, snap in sorted(snaps.items()):
            self._flush(k, snap)

    # ---------------------------------------------------------- observability

    def stats_dict(self) -> dict:
        with self._lock:
            out = dict(self._ocounts)
            out["profiles"] = len(self._profiles)
            out["replays"] = sum(p.replays for p in self._profiles.values())
        return out

    def __repr__(self) -> str:
        d = self.stats_dict()
        return (f"ProfileStore({d['profiles']} profile(s), "
                f"{d['records']} record(s))")


def hot_profiles(store: ProfileStore, min_replays: int = 2):
    """Profiles with at least ``min_replays`` replays, hottest first —
    the re-cutter's work queue."""
    with store._lock:
        profs = list(store._profiles.values())
    hot = [p for p in profs if p.replays >= min_replays]
    hot.sort(key=lambda p: (-p.replays * max(1.0, p.items_per_replay()),
                            p.key))
    return hot
