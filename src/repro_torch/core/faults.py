"""Deterministic fault-injection plane for the JIT serving stack.

The paper's value proposition — compilation cheap enough to run *during*
serving — turns compile failures, slow builds and device loss into
request-path events.  This module makes those events **reproducible**: a
:class:`FaultPlan` is a seeded set of rules that fire at named stage
boundaries of the pipeline, and every decision is a pure function of
``(seed, stage, site key, visit count)`` — no global RNG, no wall-clock —
so a chaos test or benchmark replays the exact same failure schedule on
every run.

Injection sites (the :data:`STAGES`) are one call each, placed at the
boundary the failure models:

  * ``frontend``     — kernel lowering (parse/trace) in :mod:`repro_torch.core.jit`;
  * ``place``        — joint annealer AND the template's single-replica
                       placement (:mod:`repro_torch.core.place`);
  * ``route``        — PathFinder routing (:mod:`repro_torch.core.route`);
  * ``stamp``        — template stamping (:func:`repro_torch.core.jit._template_par`);
  * ``disk_read`` /
    ``disk_write``   — the persistent tier (:class:`~repro_torch.core.cache.DiskCache`);
  * ``remote_read`` /
    ``remote_write`` — the fleet-wide blob tier
                       (:class:`~repro_torch.core.remote.RemoteCache`);
  * ``farm_rpc``     — compile-farm push/prefetch RPCs
                       (:class:`~repro_torch.core.remote.CompileFarm`);
  * ``queue_submit`` — command-queue admission (:mod:`repro_torch.core.queue`);
  * ``device_exec``  — kernel execution on the overlay engine.

Three fault kinds: ``"error"`` raises :class:`InjectedFault` at the site
(a transient failure the self-healing layer in :mod:`repro_torch.core.recovery`
must absorb), ``"slow"`` sleeps ``slow_us`` of real wall time (a straggler
build — what compile deadlines and hedged rebuilds race against), and
``"corrupt"`` raises :class:`CorruptedFault` — the blob-tier read paths
(disk and remote) interpret it as a torn/bit-flipped payload and walk
their checksum-quarantine path instead of the retry path, exactly as a
real checksum mismatch would.

Whole-device failure is modelled on the Device itself
(:meth:`~repro_torch.core.runtime.Device.fail` /
:meth:`~repro_torch.core.runtime.Device.recover`); the queue and scheduler raise
/ route around :class:`DeviceLostError` for a failed device.

The plan is threaded ambiently: ``Session(faults=plan)`` activates it
(thread-local) around every worker-pool build and every enqueue, so the
deep pipeline stages need no new parameters — and with no plan active,
:func:`fault_point` is a single thread-local read, keeping the fault-free
hot path untouched (gated in ``benchmarks/jit_cache_perf.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

STAGES = ("frontend", "place", "route", "stamp", "disk_read", "disk_write",
          "remote_read", "remote_write", "farm_rpc",
          "queue_submit", "device_exec")

FAULT_KINDS = ("error", "slow", "corrupt")


class InjectedFault(RuntimeError):
    """A failure injected by a :class:`FaultPlan` — transient by contract:
    the recovery layer retries/falls back instead of propagating it to the
    tenant whenever a budget remains."""


class CorruptedFault(InjectedFault):
    """An injected *payload corruption* (torn write, bit flip, partial
    read).  Unlike a plain :class:`InjectedFault` the right response is not
    a retry of the same bytes — the blob tiers quarantine the entry and
    report a miss, exactly like a real checksum mismatch."""


class DeviceLostError(RuntimeError):
    """The target device failed (``Device.fail()``): its queues reject new
    work and the scheduler must place (or migrate) elsewhere."""


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One injection rule: fire ``kind`` at ``stage`` with probability
    ``rate`` per visit, at most ``times`` times (None = unlimited), only at
    sites whose key contains ``match`` (None = every site)."""
    stage: str
    rate: float = 1.0
    times: Optional[int] = None
    kind: str = "error"              # error | slow | corrupt
    slow_us: float = 0.0             # wall-clock inflation for kind="slow"
    match: Optional[str] = None      # substring filter on the site key

    def __post_init__(self) -> None:
        if self.stage not in STAGES:
            raise ValueError(f"unknown stage {self.stage!r}; "
                             f"stages are {STAGES}")
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"kind must be one of {FAULT_KINDS}, "
                             f"got {self.kind!r}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate!r}")
        if self.times is not None and self.times < 1:
            raise ValueError(f"times must be >= 1, got {self.times!r}")
        if self.kind == "slow" and self.slow_us <= 0.0:
            raise ValueError("kind='slow' needs slow_us > 0")


class FaultPlan:
    """A seeded, deterministic schedule of injected failures.

    >>> plan = (FaultPlan(seed=7)
    ...         .add("place", rate=0.05)            # 5% of placements fail
    ...         .add("stamp", times=1)              # first stamp fails
    ...         .add("route", kind="slow", slow_us=50_000, times=2))
    >>> Session(devices, faults=plan)

    Decisions are a pure hash of (seed, stage, site key, per-site visit
    count): two runs with the same plan and the same per-key visit order
    inject identically, regardless of wall clock.  Counters
    (:meth:`as_dict`) record every visit/injection per stage so tests and
    the chaos benchmark can assert the schedule actually fired.
    """

    def __init__(self, seed: int = 0,
                 rules: Iterable[FaultRule] = ()):
        self.seed = seed
        self.rules: List[FaultRule] = list(rules)
        self._lock = threading.Lock()
        # per-(stage, key) visit counter: the deterministic decision index
        self._visits: Dict[Tuple[str, str], int] = {}  # lock: _lock
        # per-rule consumed budget (index-aligned with self.rules)
        self._consumed: Dict[int, int] = {}  # lock: _lock
        self.injected: Dict[str, int] = {}  # lock: _lock
        self.slowed: Dict[str, int] = {}  # lock: _lock
        self.visits_total = 0  # lock: _lock

    # ----------------------------------------------------------- authoring
    def add(self, stage: str, rate: float = 1.0,
            times: Optional[int] = None, kind: str = "error",
            slow_us: float = 0.0, match: Optional[str] = None) -> "FaultPlan":
        """Append a rule; returns self for chaining.  Author the plan fully
        before handing it to a Session — rules are consulted lock-free."""
        self.rules.append(FaultRule(stage, rate=rate, times=times, kind=kind,
                                    slow_us=slow_us, match=match))
        return self

    # ------------------------------------------------------------ decision
    def _decide(self, stage: str, key: str, visit: int, rate: float) -> bool:
        if rate >= 1.0:
            return True
        if rate <= 0.0:
            return False
        h = hashlib.sha256(
            f"{self.seed}:{stage}:{key}:{visit}".encode()).digest()
        return int.from_bytes(h[:8], "big") / 2.0 ** 64 < rate

    def visit(self, stage: str, key: str = "") -> None:
        """Called by :func:`fault_point` at a stage boundary: applies the
        first matching rule that fires (slow rules sleep, error rules raise
        :class:`InjectedFault`).  Thread-safe; deterministic per
        (seed, stage, key, visit index)."""
        sleep_us = 0.0
        boom: Optional[str] = None
        boom_cls = InjectedFault
        with self._lock:
            self.visits_total += 1
            n = self._visits.get((stage, key), 0)
            self._visits[(stage, key)] = n + 1
            for i, rule in enumerate(self.rules):
                if rule.stage != stage:
                    continue
                if rule.match is not None and rule.match not in key:
                    continue
                if rule.times is not None and \
                        self._consumed.get(i, 0) >= rule.times:
                    continue
                if not self._decide(stage, key, n, rule.rate):
                    continue
                self._consumed[i] = self._consumed.get(i, 0) + 1
                if rule.kind == "slow":
                    self.slowed[stage] = self.slowed.get(stage, 0) + 1
                    sleep_us += rule.slow_us
                else:
                    self.injected[stage] = self.injected.get(stage, 0) + 1
                    noun = "corruption" if rule.kind == "corrupt" else "fault"
                    boom = f"injected {noun} at {stage}" + \
                        (f" ({key})" if key else "")
                    if rule.kind == "corrupt":
                        boom_cls = CorruptedFault
                break
        # side effects OUTSIDE the lock: a slow fault must not serialize
        # every other site's decisions behind its sleep
        if sleep_us > 0.0:
            time.sleep(sleep_us * 1e-6)
        if boom is not None:
            raise boom_cls(boom)

    # -------------------------------------------------------- observability
    def as_dict(self) -> dict:
        with self._lock:
            return dict(seed=self.seed, rules=len(self.rules),
                        visits=self.visits_total,
                        injected=dict(self.injected),
                        slowed=dict(self.slowed))

    def total_injected(self) -> int:
        with self._lock:
            return sum(self.injected.values())

    def __repr__(self) -> str:
        d = self.as_dict()
        return (f"FaultPlan(seed={self.seed}, rules={d['rules']}, "
                f"injected={d['injected']})")


# ---------------------------------------------------------------- ambient

# The active plan is thread-local: the Session activates it around every
# worker-pool build and every enqueue, so pipeline stages call fault_point
# with no plan parameter.  Thread-local (not a contextvar) on purpose —
# builds never await, and a pool thread runs exactly one build at a time.
_TLS = threading.local()


def active_plan() -> Optional[FaultPlan]:
    return getattr(_TLS, "plan", None)


@contextlib.contextmanager
def activate(plan: Optional[FaultPlan]):
    """Make ``plan`` the calling thread's ambient fault plan (None = no-op
    but still scoped, so nesting restores correctly)."""
    prev = getattr(_TLS, "plan", None)
    _TLS.plan = plan
    try:
        yield plan
    finally:
        _TLS.plan = prev


def fault_point(stage: str, key: str = "") -> None:
    """Declare a stage boundary.  With no ambient plan this is ONE
    thread-local read — the instrumented hot path costs nothing when chaos
    is off (gated in ``benchmarks/jit_cache_perf.py``)."""
    plan = getattr(_TLS, "plan", None)
    if plan is not None:
        plan.visit(stage, key)
