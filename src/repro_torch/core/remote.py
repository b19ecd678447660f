"""Fleet-wide remote cache tier & compile farm — warm start that survives
the network.

Per-host caches (PR 3's :class:`~repro_torch.core.cache.DiskCache`) make ONE
server fast across restarts; this module lifts the same content-addressed,
sha256-checksummed artifacts into a **shared blob tier** so the whole
fleet warm-starts from each other's builds: a brand-new host joining a
warm fleet performs zero cold compiles for any ``(kernel, CompileOptions)``
pair some other host — or the :class:`CompileFarm` — already built.  The
related JIT-assembly overlay work (Aklah et al.) and pre-built
application-specific overlay generation (Mbongue et al.) amortize build
cost across deployments the same way; here the amortization unit is the
cache key the local tiers already speak.

A remote tier is only production-grade if every network interaction has a
failure story, so the robustness surface is the headline:

  * **one wire format** — blobs are framed by
    :func:`repro_torch.core.cache.encode_blob` (MAGIC | version | key | sha256 |
    payload), byte-identical to the disk tier, and every read re-verifies
    the checksum; a corrupt remote blob is **quarantined** (deleted from
    the store, counted) and reported as a miss — it never reaches the
    local memory/disk tiers;
  * **per-endpoint failure domains** — each :class:`RemoteEndpoint` has a
    deterministic latency/loss model, a hard ``fail()``/``recover()``
    switch, and its own :class:`~repro_torch.core.recovery.CircuitBreaker`;
    reads retry across endpoints under the shared
    :class:`~repro_torch.core.recovery.RetryPolicy`, and an endpoint that keeps
    failing is excluded until its cooldown half-opens it;
  * **hedged fetch vs local rebuild** — a fetch whose modelled latency
    runs past ``hedge_deadline_us`` races a hedged local rebuild
    (estimated at ``rebuild_est_us``): whichever is modelled to land first
    wins, so a congested remote can never make warm-start *slower* than
    PR-3 behaviour;
  * **degradation ladder remote → disk → cold build** — every failure
    mode above reduces to a cache miss.  A total remote outage (all
    endpoints down / breakers open) degrades the fleet to per-host disk
    caches with **zero failed requests**; writes during the outage are
    swallowed into counters exactly like a full disk;
  * **chaos-injectable** — reads, writes and farm RPCs are
    :func:`~repro_torch.core.faults.fault_point` stage boundaries
    (``remote_read`` / ``remote_write`` / ``farm_rpc``), so a seeded
    :class:`~repro_torch.core.faults.FaultPlan` replays timeouts (``slow``),
    endpoint errors (``error``) and torn payloads (``corrupt`` →
    :class:`~repro_torch.core.faults.CorruptedFault`, walks the quarantine
    path) deterministically.

The store itself (:class:`RemoteBlobStore`) is an in-process simulation —
a dict behind a lock — because what this repo models is the *protocol*
and its failure semantics, not a particular blob service; hundreds of
simulated hosts share one store object in
``benchmarks/fleet_warm_start_perf.py``.

The :class:`CompileFarm` is the push side of the tier: a dedicated role
that observes fleet demand, predicts hot ``(kernel, opts)`` pairs and
builds them ahead of demand through an ordinary remote-attached
:class:`~repro_torch.core.cache.JITCache`, so artifacts land fleet-wide before
the first host ever asks.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cache import (CacheKey, WireStaleError, decode_blob,
                              encode_blob)
from repro_torch.core.faults import CorruptedFault, InjectedFault, fault_point
from repro_torch.core.recovery import CircuitBreaker, RetryPolicy
from repro_torch.obs import trace as obs_trace

#: modelled one-way fetch latency of a healthy same-region endpoint (µs)
DEFAULT_LATENCY_US = 2_000.0
#: modelled fetch latency beyond which a local rebuild is hedged (µs)
DEFAULT_HEDGE_DEADLINE_US = 20_000.0
#: modelled cost of a local cold rebuild when no estimate is supplied (µs)
DEFAULT_REBUILD_EST_US = 50_000.0


class RemoteUnavailable(OSError):
    """An endpoint could not serve (down, lossy, or injected fault).
    Subclasses :class:`OSError` on purpose: it is transient by contract
    and already a member of :data:`repro_torch.core.recovery.TRANSIENT`."""


def _unit_hash(*parts) -> float:
    """Deterministic uniform in [0, 1) — same construction as the fault
    plane, so loss/jitter schedules replay exactly across runs."""
    h = hashlib.sha256(":".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 64


# ----------------------------------------------------------------- the store

class RemoteBlobStore:
    """The shared fleet blob service: content-addressed, in-process.

    One instance is shared by every host's :class:`RemoteCache` (and the
    :class:`CompileFarm`) in a simulation — it stands in for S3/GCS/a
    dedicated artifact service.  Blobs are stored fully framed
    (:func:`~repro_torch.core.cache.encode_blob`), so the store never holds
    un-checksummed bytes and a reader can always re-verify.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._blobs: Dict[str, bytes] = {}  # lock: _lock

    @staticmethod
    def addr(key: CacheKey) -> str:
        """Content address of a cache key (same derivation as the disk
        tier's path — one key, one address, every tier)."""
        return hashlib.sha256(key.encode()).hexdigest()

    def read(self, addr: str) -> Optional[bytes]:
        with self._lock:
            return self._blobs.get(addr)

    def write(self, addr: str, blob: bytes) -> None:
        with self._lock:
            self._blobs[addr] = blob

    def delete(self, addr: str) -> bool:
        with self._lock:
            return self._blobs.pop(addr, None) is not None

    def corrupt(self, addr: str, flip_byte: int = -8) -> bool:
        """Test/chaos helper: bit-flip one payload byte in place — the
        next reader's checksum re-verification must catch it."""
        with self._lock:
            blob = self._blobs.get(addr)
            if blob is None:
                return False
            b = bytearray(blob)
            b[flip_byte] ^= 0xFF
            self._blobs[addr] = bytes(b)
            return True

    def __len__(self) -> int:
        with self._lock:
            return len(self._blobs)

    def n_bytes(self) -> int:
        with self._lock:
            return sum(len(b) for b in self._blobs.values())


# -------------------------------------------------------------- the endpoint

class RemoteEndpoint:
    """One frontend to the blob store with its own failure domain.

    The latency/loss model is deterministic — a pure hash of
    ``(seed, op, address, visit index)``, the fault plane's construction —
    so a chaos benchmark replays the same slow fetches and the same
    dropped requests on every run.  ``fail()``/``recover()`` model hard
    endpoint loss (region partition, service crash): a failed endpoint
    refuses every request until recovered.
    """

    def __init__(self, store: RemoteBlobStore, name: str = "remote0",
                 latency_us: float = DEFAULT_LATENCY_US,
                 jitter: float = 0.25, loss_rate: float = 0.0,
                 seed: int = 0):
        if not 0.0 <= loss_rate < 1.0:
            raise ValueError(f"loss_rate must be in [0, 1), got {loss_rate!r}")
        if latency_us < 0.0:
            raise ValueError(f"latency_us must be >= 0, got {latency_us!r}")
        self.store = store
        self.name = name
        self.latency_us = latency_us
        self.jitter = jitter
        self.loss_rate = loss_rate
        self.seed = seed
        # hard endpoint loss: a single flag write either way (same contract
        # as Device.failed), so fail()/recover() are safe from any thread
        self.failed = False
        self._lock = threading.Lock()
        self._visits: Dict[Tuple[str, str], int] = {}  # lock: _lock

    # ------------------------------------------------------------- lifecycle
    def fail(self) -> None:
        """Declare the endpoint lost (partition / service crash)."""
        self.failed = True

    def recover(self) -> None:
        self.failed = False

    # --------------------------------------------------------------- model
    def _visit(self, op: str, addr: str) -> int:
        with self._lock:
            n = self._visits.get((op, addr), 0)
            self._visits[(op, addr)] = n + 1
            return n

    def _model(self, op: str, addr: str) -> float:
        """Modelled latency of this request; raises
        :class:`RemoteUnavailable` when the request is lost."""
        if self.failed:
            raise RemoteUnavailable(f"endpoint {self.name} is down")
        n = self._visit(op, addr)
        if self.loss_rate > 0.0 and \
                _unit_hash(self.seed, op, addr, n, "loss") < self.loss_rate:
            raise RemoteUnavailable(
                f"endpoint {self.name} dropped {op} (visit {n})")
        return self.latency_us * \
            (1.0 + self.jitter * _unit_hash(self.seed, op, addr, n, "lat"))

    # ----------------------------------------------------------------- ops
    def read(self, key: CacheKey, addr: str) -> Tuple[Optional[bytes], float]:
        """-> (framed blob or None, modelled fetch µs).  Raises
        :class:`RemoteUnavailable` on loss/outage, :class:`InjectedFault`
        flavours from the ambient fault plan."""
        # chaos boundary: error → endpoint failure (retry/breaker), slow →
        # wall-clock straggler, corrupt → CorruptedFault (quarantine path)
        fault_point("remote_read", f"{self.name}:{key}")
        us = self._model("read", addr)
        return self.store.read(addr), us

    def write(self, key: CacheKey, addr: str, blob: bytes) -> float:
        """Store a framed blob; returns modelled µs.  Raises like read."""
        fault_point("remote_write", f"{self.name}:{key}")
        us = self._model("write", addr)
        self.store.write(addr, blob)
        return us

    def __repr__(self) -> str:
        state = "down" if self.failed else "up"
        return (f"RemoteEndpoint({self.name}, {state}, "
                f"{self.latency_us:g}us, loss={self.loss_rate:g})")


# ----------------------------------------------------------------- the stats

class RemoteStats:
    """Counters for every remote-tier mechanism: one lock, one blob for
    ``Session.stats()['remote']``.  All zero (and never even constructed)
    on a host with no remote tier — gated in
    ``benchmarks/jit_cache_perf.py``."""

    FIELDS = ("hits", "misses", "writes", "write_errors", "read_errors",
              "quarantined", "invalidated", "hedges_started", "hedges_won",
              "hedges_lost", "degraded")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts = {f: 0 for f in self.FIELDS}  # lock: _lock
        self._fetch_us_ewma: Optional[float] = None  # lock: _lock

    def bump(self, field: str, n: int = 1) -> None:
        with self._lock:
            self._counts[field] += n           # KeyError on a typo'd field

    def get(self, field: str) -> int:
        with self._lock:
            return self._counts[field]

    def note_fetch_us(self, us: float) -> None:
        with self._lock:
            prev = self._fetch_us_ewma
            self._fetch_us_ewma = us if prev is None else \
                0.8 * prev + 0.2 * us

    @property
    def fetch_us(self) -> float:
        with self._lock:
            return self._fetch_us_ewma or 0.0

    def as_dict(self) -> dict:
        with self._lock:
            out = dict(self._counts)
            out["fetch_us"] = round(self._fetch_us_ewma or 0.0, 1)
            return out


# ------------------------------------------------------------------ the tier

class RemoteCache:
    """Per-host client of the fleet blob tier — the third
    :class:`~repro_torch.core.cache.JITCache` level (memory → disk → remote).

    Duck-typed to the :class:`~repro_torch.core.cache.DiskCache` surface the
    JITCache consumes (``get``/``put``/``quarantine``), with the network
    failure story layered on:

      * reads walk the endpoint list best-breaker-first, retrying
        transient failures across endpoints up to the
        :class:`~repro_torch.core.recovery.RetryPolicy` budget; every failure
        counts against that endpoint's breaker, every success resets it;
      * a fetch whose modelled latency exceeds ``hedge_deadline_us``
        races a hedged local rebuild estimated at ``rebuild_est_us``
        (callers pass their measured build EWMA when they have one): if
        the rebuild is modelled to land first the fetch is abandoned —
        reported as a miss with ``hedges_won`` — so a congested remote
        can only ever *add* wins over PR-3 behaviour, never latency;
      * a blob that fails its sha256 re-verification (real corruption or
        an injected :class:`~repro_torch.core.faults.CorruptedFault`) is
        quarantined — deleted from the store, counted — and reported as
        a miss, so it can never be promoted into a local tier;
      * a stale blob (foreign schema version / address collision) is
        invalidated and dropped, exactly like the disk tier;
      * **every** failure mode reduces to a miss: the caller's ladder is
        remote → disk → cold build, and a total remote outage is PR-3
        behaviour with zero failed requests.

    Thread-safe; the modelled fetch clock never sleeps, so holding the
    JITCache lock across a lookup costs microseconds, not round trips.
    """

    def __init__(self, endpoints: Sequence[RemoteEndpoint],
                 retry: Optional[RetryPolicy] = None,
                 hedge_deadline_us: float = DEFAULT_HEDGE_DEADLINE_US,
                 rebuild_est_us: float = DEFAULT_REBUILD_EST_US):
        if not endpoints:
            raise ValueError("RemoteCache needs at least one endpoint")
        names = [e.name for e in endpoints]
        if len(set(names)) != len(names):
            raise ValueError(f"endpoint names must be unique, got {names}")
        self.endpoints = list(endpoints)
        self.retry = retry if retry is not None else RetryPolicy()
        self.hedge_deadline_us = hedge_deadline_us
        self.rebuild_est_us = rebuild_est_us
        self.stats = RemoteStats()
        # one breaker per endpoint, the recovery-plane state machine:
        # threshold consecutive failures exclude the endpoint until its
        # cooldown half-opens it for probe traffic
        self.breakers: Dict[str, CircuitBreaker] = {
            e.name: CircuitBreaker(self.retry.breaker_threshold,
                                   self.retry.breaker_cooldown_s)
            for e in endpoints}

    # ------------------------------------------------------------- plumbing
    def _candidates(self) -> List[RemoteEndpoint]:
        """Endpoints worth trying now: breaker-admitted, closed breakers
        first (probe traffic reaches a half-open endpoint only after the
        healthy ones failed)."""
        ok = [e for e in self.endpoints if self.breakers[e.name].allows()]
        return sorted(ok, key=lambda e: 0 if self.breakers[e.name].closed
                      else 1)

    def total_outage(self) -> bool:
        """True when no endpoint is currently admissible — the fleet is
        running on per-host disk tiers alone (PR-3 behaviour)."""
        return not self._candidates()

    # ---------------------------------------------------------------- reads
    def get(self, key: CacheKey, rebuild_est_us: Optional[float] = None):
        """Fetch + verify + unpickle the artifact for ``key``, or None.

        None covers every degraded mode — endpoint loss, retry budget
        exhausted, hedged-rebuild win, corruption quarantine, staleness,
        genuine absence — because the caller's next rung (disk already
        missed) is always a local cold build that cannot fail for remote
        reasons."""
        addr = RemoteBlobStore.addr(key)
        budget = self.retry.max_retries
        attempts = 0
        for ep in self._candidates():
            if attempts > budget:
                break
            with obs_trace.span("remote:fetch", "cache",
                                endpoint=ep.name) as _sp:
                try:
                    blob, us = ep.read(key, addr)
                except CorruptedFault:
                    # injected torn payload: the bytes are damaged, not the
                    # endpoint — quarantine, never retry the same bytes
                    _sp["outcome"] = "corrupt"
                    self._quarantine_addr(addr)
                    self.stats.bump("misses")
                    return None
                except (RemoteUnavailable, InjectedFault):
                    _sp["outcome"] = "error"
                    attempts += 1
                    self.stats.bump("read_errors")
                    self.breakers[ep.name].record_failure()
                    continue
                self.breakers[ep.name].record_success()
                if blob is None:
                    _sp["outcome"] = "absent"
                    self.stats.bump("misses")
                    return None
                _sp["fetch_us"] = us
                if us > self.hedge_deadline_us:
                    # straggler fetch: race a hedged local rebuild.  Modelled
                    # race — the rebuild starts at the deadline and needs
                    # rebuild_est_us more; the fetch needs (us) total
                    est = rebuild_est_us if rebuild_est_us is not None \
                        else self.rebuild_est_us
                    self.stats.bump("hedges_started")
                    if self.hedge_deadline_us + est < us:
                        # local rebuild lands first: abandon the fetch (miss);
                        # the caller's cold build IS the hedge winning
                        _sp["outcome"] = "hedge_won"
                        self.stats.bump("hedges_won")
                        self.stats.bump("misses")
                        return None
                    _sp["hedge"] = "lost"
                    self.stats.bump("hedges_lost")
                try:
                    obj = decode_blob(key, blob)
                except WireStaleError:
                    _sp["outcome"] = "stale"
                    self.stats.bump("invalidated")
                    ep.store.delete(addr)
                    self.stats.bump("misses")
                    return None
                except Exception:
                    # checksum mismatch / unpicklable: quarantine so the
                    # next reader is not poisoned, and report a miss — the
                    # entry must NEVER reach the local memory/disk tiers
                    _sp["outcome"] = "corrupt"
                    self._quarantine_addr(addr)
                    self.stats.bump("misses")
                    return None
                _sp["outcome"] = "hit"
                self.stats.bump("hits")
                self.stats.note_fetch_us(us)
                return obj
        # endpoints exhausted (outage / retry budget): degrade to local
        self.stats.bump("degraded")
        self.stats.bump("misses")
        return None

    # --------------------------------------------------------------- writes
    def put(self, key: CacheKey, obj) -> None:
        """Push an artifact fleet-wide, best-effort: transient failures
        retry across endpoints, and a total outage is swallowed into
        ``write_errors`` — a dead remote must never block (or fail) the
        local build that produced the artifact."""
        addr = RemoteBlobStore.addr(key)
        try:
            blob = encode_blob(key, obj)
        except Exception:
            self.stats.bump("write_errors")   # unpicklable artifact
            return
        budget = self.retry.max_retries
        attempts = 0
        for ep in self._candidates():
            if attempts > budget:
                break
            try:
                ep.write(key, addr, blob)
            except (RemoteUnavailable, InjectedFault):
                attempts += 1
                self.breakers[ep.name].record_failure()
                continue
            self.breakers[ep.name].record_success()
            self.stats.bump("writes")
            return
        self.stats.bump("write_errors")

    def quarantine(self, key: CacheKey) -> None:
        """Remove ``key`` fleet-wide (the verifier refused to certify the
        artifact, or a reader proved the blob corrupt)."""
        self._quarantine_addr(RemoteBlobStore.addr(key))

    def _quarantine_addr(self, addr: str) -> None:
        self.stats.bump("quarantined")
        for ep in self.endpoints:
            ep.store.delete(addr)

    # -------------------------------------------------------- observability
    def stats_dict(self) -> dict:
        """The ``Session.stats()['remote']`` blob: counters, fetch EWMA,
        and per-endpoint breaker/liveness states."""
        out = self.stats.as_dict()
        out["endpoints"] = {
            e.name: dict(failed=e.failed,
                         **self.breakers[e.name].as_dict())
            for e in self.endpoints}
        return out

    def __repr__(self) -> str:
        d = self.stats.as_dict()
        return (f"RemoteCache({len(self.endpoints)} endpoint(s), "
                f"{d['hits']} hits / {d['misses']} misses)")


# ------------------------------------------------------------------ the farm

class CompileFarm:
    """The push side of the fleet tier: a dedicated compile role that
    builds hot/predicted ``(kernel, CompileOptions)`` pairs ahead of
    demand and pushes the artifacts fleet-wide.

    The farm is an ordinary build host: it compiles through a
    remote-attached :class:`~repro_torch.core.cache.JITCache`, so artifacts,
    templates and lowered frontends all land in the shared store via the
    normal write-through path — a serving host's first request for a
    prefetched pair is a remote hit, never a cold build.

    Demand prediction is frequency-based: serving hosts (or the trace
    replayer) report observed pairs via :meth:`observe`; :meth:`hot`
    ranks them and :meth:`prefetch_hot` builds the top N.  Each prefetch
    is one ``farm_rpc`` fault boundary with the retry policy's transient
    budget — a flaky farm link degrades prefetch coverage, never
    correctness (missed pairs simply cold-compile on first demand).
    """

    def __init__(self, spec, remote: RemoteCache,
                 retry: Optional[RetryPolicy] = None,
                 cache=None):
        from repro_torch.core.cache import JITCache
        self.spec = spec
        self.remote = remote
        self.retry = retry if retry is not None else RetryPolicy()
        self.cache = cache if cache is not None else JITCache(remote=remote)
        self._lock = threading.Lock()
        # kernel fingerprint+opts -> (demand count, pair); the prediction
        # input, reported by serving hosts
        self._demand: Dict[Tuple, list] = {}  # lock: _lock
        self.built = 0  # lock: _lock
        self.push_failures = 0  # lock: _lock

    # ------------------------------------------------------------ prediction
    def observe(self, kernel, opts, weight: int = 1) -> None:
        """Report fleet demand for a pair (hosts call this per request)."""
        from repro_torch.core.cache import kernel_fingerprint
        fp = kernel_fingerprint(kernel, n_inputs=opts.n_inputs,
                                name=opts.name)
        with self._lock:
            ent = self._demand.setdefault((fp, opts), [0, (kernel, opts)])
            ent[0] += weight

    def hot(self, top_n: int = 16) -> List[Tuple]:
        """The ``top_n`` most-demanded (kernel, opts) pairs, hottest
        first (ties broken by fingerprint for determinism)."""
        with self._lock:
            ranked = sorted(self._demand.items(),
                            key=lambda kv: (-kv[1][0], kv[0][0]))
        return [ent[1] for _key, ent in ranked[:top_n]]

    # -------------------------------------------------------------- building
    def prefetch(self, pairs: Sequence[Tuple]) -> int:
        """Build every (kernel, opts) pair and push it fleet-wide; returns
        how many built (cache hits count — the artifact is pushed either
        way via write-through).  Transient failures (injected ``farm_rpc``
        faults, endpoint loss) retry up to the policy budget; a pair whose
        budget is exhausted is skipped and counted, never raised — it
        will cold-compile on first demand instead."""
        from repro_torch.core.jit import jit_compile
        done = 0
        for kernel, opts in pairs:
            attempts = 0
            while True:
                try:
                    fault_point("farm_rpc", opts.name or "kernel")
                    jit_compile(kernel, self.spec, opts=opts,
                                cache=self.cache)
                    with self._lock:
                        self.built += 1
                    done += 1
                    break
                except Exception as e:
                    attempts += 1
                    if attempts > self.retry.max_retries or \
                            not self.retry.retryable(e):
                        with self._lock:
                            self.push_failures += 1
                        break
        return done

    def prefetch_hot(self, top_n: int = 16) -> int:
        """Build + push the predicted-hot set (see :meth:`hot`)."""
        return self.prefetch(self.hot(top_n))

    def stats_dict(self) -> dict:
        with self._lock:
            return dict(built=self.built, push_failures=self.push_failures,
                        demand_pairs=len(self._demand))
