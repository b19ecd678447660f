"""Self-healing policies for the JIT serving stack: retries, hedging
parameters, per-device circuit breakers, and the recovery counters the
Session surfaces in :meth:`~repro_torch.core.session.Session.stats`.

The mechanisms live where the work happens — the Session's build/enqueue
paths and the Scheduler's ranking/migration — but the *policy* and the
*state* are defined here so they can be lock-annotated, lint-checked
(``python -m repro_torch.analysis locklint``) and unit-tested in isolation:

  * :class:`RetryPolicy` — per-stage retry with exponential backoff and
    **deterministic** jitter (hash of the site key and attempt number, not
    an RNG: two runs of the same failing trace back off identically), plus
    the hedging knobs (a build that misses its deadline races a second
    attempt at lower ``place_effort`` — replicas are ~1 ms re-stamps, so a
    cheaper P&R is the natural straggler hedge);
  * :class:`CircuitBreaker` — the classic closed → open → half-open state
    machine, one per device (and one per remote endpoint in
    :mod:`repro_torch.core.remote`): ``threshold`` consecutive device-attributable
    failures open it (the scheduler then excludes the device from the
    ``projected_makespan_us`` ranking), after ``cooldown_s`` it half-opens
    and probe builds are allowed back; a probe success closes it, a probe
    failure re-opens it with a fresh cooldown;
  * :class:`RecoveryStats` — the observability blob: retries, hedge
    outcomes, fallback ladder hits (fused → nodewise, template → joint),
    migrations and re-enqueues.

Deep pipeline code (``jit_compile`` noting a template → joint fallback)
reports through the same thread-local ambience the fault plane uses:
:func:`note` bumps the Session's stats when one is active and is a single
thread-local read otherwise — nothing on the fault-free hot path.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Optional

from repro_torch.core.faults import DeviceLostError, InjectedFault

#: exception classes the retry loop treats as transient.  Genuine mapping
#: failures (PlacementError and friends: the kernel does not fit) are NOT
#: retryable — the same build would fail the same way.  OSError covers the
#: I/O tiers: disk faults AND the remote tier's RemoteUnavailable
#: (repro_torch.core.remote subclasses it on purpose), so endpoint loss and
#: farm-RPC drops are retryable without this module importing remote.
TRANSIENT = (InjectedFault, DeviceLostError, OSError)


def _unit_hash(key: str) -> float:
    """Deterministic uniform in [0, 1) from a string — jitter without RNG
    state, so backoff schedules replay exactly under a seeded fault plan."""
    h = hashlib.sha256(key.encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 64


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Session-wide retry/hedge defaults.  ``CompileOptions.retry_budget``
    and ``CompileOptions.deadline_ms`` override per build."""
    max_retries: int = 2             # transient build failures absorbed
    backoff_us: float = 500.0        # first backoff (doubles per attempt)
    backoff_mult: float = 2.0
    jitter: float = 0.5              # +[0, jitter) fraction, deterministic
    max_backoff_us: float = 50_000.0
    hedge_effort: float = 0.25       # hedge place_effort multiplier
    enqueue_retries: int = 3         # transient exec faults absorbed
    breaker_threshold: int = 3       # consecutive failures that trip
    breaker_cooldown_s: float = 0.05  # open → half-open wall time

    def __post_init__(self) -> None:
        if self.max_retries < 0 or self.enqueue_retries < 0:
            raise ValueError("retry counts must be >= 0")
        if self.breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1")
        if not 0.0 < self.hedge_effort <= 1.0:
            raise ValueError("hedge_effort must be in (0, 1]")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")

    def retryable(self, exc: BaseException) -> bool:
        return isinstance(exc, TRANSIENT)

    def backoff_s(self, attempt: int, key: str = "") -> float:
        """Backoff before retry ``attempt`` (1-based): exponential with
        deterministic jitter, capped at ``max_backoff_us``."""
        base = self.backoff_us * self.backoff_mult ** (attempt - 1)
        base *= 1.0 + self.jitter * _unit_hash(f"{key}#{attempt}")
        return min(base, self.max_backoff_us) * 1e-6


class CircuitBreaker:
    """Per-device breaker: closed → (threshold consecutive failures) →
    open → (cooldown) → half-open → probe success closes / probe failure
    re-opens.  ``force_open`` models hard device loss (``Device.fail()``):
    no failure count needed, the device is known-gone."""

    STATES = ("closed", "open", "half_open")

    def __init__(self, threshold: int = 3, cooldown_s: float = 0.05):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._lock = threading.Lock()
        self.state = "closed"  # lock: _lock
        self.consecutive = 0  # lock: _lock
        self.trips = 0  # lock: _lock
        self.opened_at = 0.0  # lock: _lock

    def allows(self) -> bool:
        """May work be placed on this device now?  An open breaker past its
        cooldown transitions to half-open here (and admits probe work —
        the scheduler ranks half-open devices last, so probes only land
        when the healthy fleet is the worse choice or a probe is due)."""
        with self._lock:
            if self.state == "open":
                if time.monotonic() - self.opened_at >= self.cooldown_s:
                    self.state = "half_open"
                    return True
                return False
            return True

    def record_failure(self) -> bool:
        """Count a device-attributable failure; returns True when this call
        tripped the breaker (closed → open) or re-opened a half-open one."""
        with self._lock:
            self.consecutive += 1
            if self.state == "half_open":
                # failed probe: back to open with a fresh cooldown (counted
                # as a trip — the device proved it is still sick)
                self.state = "open"
                self.opened_at = time.monotonic()
                self.trips += 1
                return True
            if self.state == "closed" and self.consecutive >= self.threshold:
                self.state = "open"
                self.opened_at = time.monotonic()
                self.trips += 1
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self.consecutive = 0
            if self.state == "half_open":
                self.state = "closed"

    def force_open(self) -> bool:
        """Trip immediately (device loss); True if it was not already open."""
        with self._lock:
            was = self.state
            self.state = "open"
            self.opened_at = time.monotonic()
            if was != "open":
                self.trips += 1
                return True
            return False

    @property
    def closed(self) -> bool:
        with self._lock:
            return self.state == "closed"

    def as_dict(self) -> dict:
        with self._lock:
            return dict(state=self.state, consecutive=self.consecutive,
                        trips=self.trips)

    def __repr__(self) -> str:
        return f"CircuitBreaker({self.state}, trips={self.trips})"


class RecoveryStats:
    """Counters for every self-healing mechanism, one lock, one blob for
    ``Session.stats()['recovery']``.  All zero on a fault-free run — gated
    in ``benchmarks/jit_cache_perf.py``."""

    FIELDS = ("retries", "enqueue_retries", "hedges_started", "hedges_won",
              "hedges_lost", "fallback_nodewise", "fallback_joint",
              "migrated_programs", "lost_programs", "requeued_events")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts = {f: 0 for f in self.FIELDS}  # lock: _lock

    def bump(self, field: str, n: int = 1) -> None:
        with self._lock:
            self._counts[field] += n           # KeyError on a typo'd field

    def get(self, field: str) -> int:
        with self._lock:
            return self._counts[field]

    def as_dict(self) -> dict:
        with self._lock:
            return dict(self._counts)

    def all_zero(self) -> bool:
        with self._lock:
            return not any(self._counts.values())


# ---------------------------------------------------------------- ambient

# Deep pipeline code (jit_compile's template → joint fallback) reports into
# the owning Session's stats through the same thread-local pattern as the
# fault plane; no plumbing through CompileOptions or jit_compile kwargs.
_TLS = threading.local()


def activate_stats(stats: Optional[RecoveryStats]):
    """Context manager scoping the ambient RecoveryStats (see faults.activate
    for the pattern)."""
    import contextlib

    @contextlib.contextmanager
    def _scope():
        prev = getattr(_TLS, "ambient_recovery", None)
        _TLS.ambient_recovery = stats
        try:
            yield stats
        finally:
            _TLS.ambient_recovery = prev
    return _scope()


def note(field: str, n: int = 1) -> None:
    """Bump the ambient RecoveryStats, if any — one thread-local read when
    recovery observability is off, and only ever called on failure paths."""
    stats = getattr(_TLS, "ambient_recovery", None)
    if stats is not None:
        stats.bump(field, n)
