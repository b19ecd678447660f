"""JIT compile cache — the artifact store that makes run-time compilation
*cheap enough to sit on the serving path*.

The paper's pitch is that overlay JIT compilation is fast (seconds, not the
hours of a full FPGA flow); a serving runtime goes one step further and makes
the *second* compilation of the same kernel free.  Entries are keyed on a
content hash of everything that can change the produced configuration:

  * the kernel itself — a canonical fingerprint of its DFG (``jit_compile``
    lowers OpenCL-C text and python callables to a DFG before keying, so
    every entry point keys the same kernel identically; two lambdas with
    identical code but different closure constants hash differently — the
    constants surface as DFG immediates);
  * the :class:`~repro_torch.core.overlay.OverlaySpec` (all geometry/FU fields);
  * the **effective replica cap** the free-resource snapshot implies — NOT
    the raw (free FUs, free IO) numbers.  The compiler consumes the snapshot
    only through :func:`~repro_torch.core.replicate.plan_replication`, so two
    snapshots that yield the same plan yield bit-identical artifacts;
    hashing the raw numbers (as the first cache generation did) fragmented
    a busy fleet's entries across every transient occupancy level and the
    cache almost never hit.  A build made when the overlay was empty is
    still never reused once the cap changes — the plan changes with it;
  * the replication knobs (``max_replicas``, ``seed``, ``place_effort``)
    and the P&R mode knobs (``pr_mode``, ``min_template_fill``).

Eviction is LRU with a configurable capacity; hit/miss/eviction counters feed
the serving dashboards (``benchmarks/jit_cache_perf.py``).

Two tiers sit below the in-memory LRU:

  * a **stage-level template store** (:func:`make_template_key`) — a P&R
    template hit on a full-key miss means the build skips place/route/
    latency entirely and only re-stamps;
  * an optional **content-addressed on-disk store** (:class:`DiskCache`,
    enabled via ``JITCache(persist_dir=...)``) that write-throughs every
    artifact and warm-loads them after a process restart — the paper's
    run-time-compile claim extended across server restarts
    (``benchmarks/persistent_cache_perf.py``: warm ≳ 50× faster than cold).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import struct
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Callable, Iterable, Optional, Union

from repro_torch.core.dfg import DFG
from repro_torch.core.faults import fault_point
from repro_torch.core.options import CompileOptions
from repro_torch.core.overlay import OverlaySpec
from repro_torch.obs import trace as obs_trace

CacheKey = str


# ------------------------------------------------------------- fingerprints

def dfg_fingerprint(g: DFG) -> str:
    """Canonical content hash of a DFG: stable under node renumbering.

    Nodes are visited in topological order and renumbered densely; each
    contributes (op, renumbered args, imm).  Input/output order is part of
    the fingerprint (it is part of the kernel ABI); node *names* are not.
    """
    renum = {}
    parts = []
    for n in g.toposort():
        renum[n.nid] = len(renum)
        args = ",".join(str(renum[a]) for a in n.args)
        imm = "" if n.imm is None else repr(float(n.imm))
        parts.append(f"{n.op}({args};{imm})")
    sig = "|".join(parts)
    io = (",".join(str(renum[i]) for i in g.inputs) + ">" +
          ",".join(str(renum[o]) for o in g.outputs))
    return hashlib.sha256(f"{sig}#{io}".encode()).hexdigest()


def spec_fingerprint(spec: OverlaySpec) -> str:
    return hashlib.sha256(repr(dataclasses.astuple(spec)).encode()).hexdigest()


def kernel_fingerprint(kernel: Union[str, Callable, DFG],
                       n_inputs: Optional[int] = None,
                       name: Optional[str] = None) -> str:
    """Content hash of the kernel alone (no overlay / resource context).

    DFGs and callables hash the same optimized normal form — delegated to
    ``jit.lower_to_dfg`` so the form has ONE definition — and a kernel
    reaches one cache entry whether it arrives raw-traced, pre-optimized,
    or as a callable (closure constants land in the hash as DFG immediates;
    hashing code bytes would wrongly share entries between closures over
    different constants)."""
    if isinstance(kernel, str):
        return "src:" + hashlib.sha256(kernel.encode()).hexdigest()
    from repro_torch.core.jit import lower_to_dfg   # lazy: no cycle at call time
    return "dfg:" + dfg_fingerprint(lower_to_dfg(kernel, n_inputs, name))


def make_cache_key(kernel: Union[str, Callable, DFG],
                   spec: OverlaySpec,
                   free_fus: int,
                   free_io: int,
                   n_inputs: Optional[int] = None,
                   name: Optional[str] = None,
                   max_replicas: Optional[int] = None,
                   seed: int = 0,
                   place_effort: float = 1.0,
                   pr_mode: str = "auto",
                   min_template_fill: Optional[float] = None,
                   fug=None,
                   opts: Optional[CompileOptions] = None) -> CacheKey:
    """The full key: kernel content × overlay × *normalized* free-resource
    snapshot × :class:`~repro_torch.core.options.CompileOptions`.

    The knob tail of the key IS ``opts.key_tail()`` — the frozen options
    object replaced the ad-hoc tuple this function used to assemble, so a
    knob added to CompileOptions is automatically part of the key.  The
    loose keyword arguments survive as a shim: when ``opts`` is None they
    are folded into one (legacy callers and tests keep working).

    The snapshot is normalized to the replication plan it implies (the
    effective replica cap plus its limiting resource): ``jit_compile``
    consumes ``free_fus``/``free_io`` only through ``plan_replication``, so
    any two snapshots producing the same plan produce the same artifact and
    must share one entry.  On a busy fleet this turns near-certain misses
    (every transient FU count was its own key) into hits whenever occupancy
    moves less than one replica's footprint.

    ``fug`` optionally passes the caller's already-fused FU graph so the
    normalization doesn't re-lower the kernel (``jit_compile`` does this);
    otherwise the kernel is lowered and fused here.
    """
    from repro_torch.core.replicate import plan_replication
    if opts is None:
        kw = {} if min_template_fill is None else \
            dict(min_template_fill=min_template_fill)
        opts = CompileOptions(n_inputs=n_inputs, name=name,
                              max_replicas=max_replicas, seed=seed,
                              place_effort=place_effort, pr_mode=pr_mode,
                              **kw)
    kf = kernel_fingerprint(kernel, n_inputs=opts.n_inputs, name=opts.name)
    if fug is None:
        from repro_torch.core.fuse import to_fu_graph
        from repro_torch.core.jit import lower_to_dfg
        g = lower_to_dfg(kernel, opts.n_inputs, opts.name, parse_source=True)
        fug = to_fu_graph(g, dsp_per_fu=spec.dsp_per_fu)
    plan = plan_replication(fug, spec, max_replicas=opts.max_replicas,
                            fu_headroom=spec.n_fus - free_fus,
                            io_headroom=spec.n_io - free_io)
    ctx = (f"{spec_fingerprint(spec)}:r{plan.replicas}:{plan.limited_by}:"
           f"{opts.key_tail()}")
    return f"{kf}@{hashlib.sha256(ctx.encode()).hexdigest()[:16]}"


def make_graph_key(graph_fingerprint: str, spec: OverlaySpec,
                   max_partition_fus: Optional[int] = None) -> CacheKey:
    """Key for a recorded graph's *partition plan* (how the Session cut the
    DAG into fused overlay configurations).

    Partitioning depends only on the graph's content, the overlay geometry
    and the partition-FU budget — NOT on the free-resource snapshot (replica
    budget is decided per partition at build time, like any other compile).
    The fused artifacts themselves are keyed per partition through the
    ordinary :func:`make_cache_key` path (content hash of the fused DFG +
    opts), which is what makes re-instantiation warm across restarts via
    the disk tier."""
    cap = "-" if max_partition_fus is None else str(max_partition_fus)
    return (f"graph:{graph_fingerprint}@{spec_fingerprint(spec)[:16]}:"
            f"p{cap}")


def make_template_key(g: DFG, spec: OverlaySpec, seed: int = 0,
                      place_effort: float = 1.0) -> CacheKey:
    """Stage-level key for P&R templates (:mod:`repro_torch.core.template`).

    Deliberately **independent of the free-resource snapshot** and of
    ``max_replicas``: the template is a single placed+routed replica, equally
    valid at any replica count — that independence is what turns a
    replica-count change (shedding, re-inflation) into a stamp instead of a
    recompile."""
    return (f"tpl:{dfg_fingerprint(g)}@{spec_fingerprint(spec)[:16]}:"
            f"{seed}:{place_effort:g}")


# -------------------------------------------------------------- wire format

# One checksummed frame for every blob tier — the disk store AND the
# fleet-wide remote store (repro_torch.core.remote) encode/decode through these
# two functions, so an artifact written by any host's disk tier is
# byte-compatible with the remote tier and vice versa:
#
#     MAGIC(4) | version(u16) | key_len(u32) | key | sha256(payload) | payload
#
# Decoding distinguishes *stale* (old schema version, embedded-key
# mismatch: drop and rebuild) from *corrupt* (bad magic, truncation,
# checksum mismatch, unpicklable payload: quarantine) — the two failure
# classes every tier must treat differently.

#
# The magic is this package's own: keys are content-only, so the JAX
# package computes the same key (and the same file name) for the same
# kernel, and a directory both packages write to holds blobs of each.  A
# blob of the other package fails the magic check and is quarantined as
# corrupt — it is never unpickled, which would import the other package.
WIRE_MAGIC = b"OVJT"
WIRE_VERSION = 1


class WireStaleError(ValueError):
    """The blob decoded cleanly but belongs to another schema version or
    another key (filename/address collision): drop it and rebuild."""


class WireCorruptError(ValueError):
    """The blob is damaged (bad magic, truncation, checksum mismatch,
    unpicklable payload): quarantine it — retrying the same bytes cannot
    help, and the entry must never reach a healthy tier."""


def encode_blob(key: CacheKey, obj,
                version: int = WIRE_VERSION) -> bytes:
    """Frame ``obj`` for any blob tier (see module wire-format comment)."""
    payload = pickle.dumps(obj, protocol=4)
    kb = key.encode()
    return (WIRE_MAGIC + struct.pack("<HI", version, len(kb)) + kb +
            hashlib.sha256(payload).digest() + payload)


def decode_blob(key: CacheKey, blob: bytes,
                version: int = WIRE_VERSION):
    """Inverse of :func:`encode_blob`.  Raises :class:`WireStaleError` for
    schema/key mismatches and :class:`WireCorruptError` for damage."""
    try:
        if blob[:4] != WIRE_MAGIC or len(blob) < 10:
            raise WireCorruptError("bad magic")
        ver, klen = struct.unpack_from("<HI", blob, 4)
        off = 10
        if len(blob) < off + klen + 32:
            raise WireCorruptError("truncated header")
        stored_key = blob[off:off + klen].decode()
        off += klen
        digest = blob[off:off + 32]
        # a view, not a copy: the payload is most of the blob
        payload = memoryview(blob)[off + 32:]
    except WireCorruptError:
        raise
    except Exception as e:
        raise WireCorruptError(f"unreadable frame: {e}") from e
    if ver != version or stored_key != key:
        raise WireStaleError(f"version {ver} key {stored_key!r}")
    if hashlib.sha256(payload).digest() != digest:
        raise WireCorruptError("checksum mismatch")
    try:
        return pickle.loads(payload)
    except Exception as e:
        raise WireCorruptError(f"unpicklable payload: {e}") from e


# --------------------------------------------------------------- disk tier

def _read_file(p: Path) -> bytes:
    """The file's bytes in four system calls (open, fstat, read, close),
    where ``Path.read_bytes`` makes about twice as many: on a host whose
    system calls are slow they are most of a warm build."""
    fd = os.open(p, os.O_RDONLY)
    try:
        size = os.fstat(fd).st_size
        blob = os.read(fd, size)
        while len(blob) < size:     # entries are replaced whole, never grown
            more = os.read(fd, size - len(blob))
            if not more:
                break
            blob += more
    finally:
        os.close(fd)
    return blob


class DiskCache:
    """Content-addressed on-disk artifact store (one file per cache key).

    Artifacts (``CompiledKernel``, ``Template`` — anything picklable) are
    stored under ``root/<sha2>/<sha>.bin`` framed by :func:`encode_blob` —
    the same sha256-checksummed wire format the fleet-wide
    :class:`~repro_torch.core.remote.RemoteCache` speaks.

    Guarantees:

      * **atomic writes** — payloads land in a ``.tmp`` sibling and are
        ``os.replace``d into place, so a crashed writer never leaves a
        half-written entry visible;
      * **corruption quarantine** — any unreadable entry (bad magic, short
        header, checksum mismatch, unpicklable payload) is renamed to
        ``*.corrupt`` and treated as a miss, never crashed on;
      * **version invalidation** — entries written by an older
        ``SCHEMA_VERSION`` (or whose embedded key doesn't match, i.e. a
        filename collision) are silently removed and recompiled.

    The store is best-effort: I/O errors on write are counted
    (``write_errors``) but never raised — a full disk must not take down
    the serving path.  Entries are trusted pickles; point ``root`` only at
    a directory the serving user owns.
    """

    MAGIC = WIRE_MAGIC
    SCHEMA_VERSION = WIRE_VERSION

    def __init__(self, root: Union[str, Path]):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.hits = 0
        self.misses = 0
        self.writes = 0
        self.write_errors = 0
        self.quarantined = 0
        self.invalidated = 0

    def _path(self, key: CacheKey) -> Path:
        d = hashlib.sha256(key.encode()).hexdigest()
        return self.root / d[:2] / f"{d}.bin"

    def get(self, key: CacheKey):
        p = self._path(key)
        try:
            blob = _read_file(p)
        except OSError:
            self.misses += 1
            return None
        try:
            # chaos boundary: an injected disk_read fault takes the same
            # quarantine-and-miss path as real corruption — the degraded
            # mode under test IS the existing resilience ladder
            fault_point("disk_read", key)
            obj = decode_blob(key, blob, version=self.SCHEMA_VERSION)
        except WireStaleError:
            # stale schema or filename collision: not corruption —
            # drop the entry and recompile
            self.invalidated += 1
            p.unlink(missing_ok=True)
            self.misses += 1
            return None
        except Exception:
            self._quarantine(p)
            self.misses += 1
            return None
        self.hits += 1
        return obj

    def put(self, key: CacheKey, obj) -> None:
        tmp: Optional[Path] = None
        try:
            # chaos boundary: an injected disk_write fault is swallowed into
            # write_errors exactly like a full disk — serving never notices
            fault_point("disk_write", key)
            blob = encode_blob(key, obj, version=self.SCHEMA_VERSION)
            p = self._path(key)
            p.parent.mkdir(parents=True, exist_ok=True)
            tmp = p.with_name(f"{p.name}.tmp{os.getpid()}")
            tmp.write_bytes(blob)
            os.replace(tmp, p)
            self.writes += 1
        except Exception:
            self.write_errors += 1
            if tmp is not None:        # don't leak partial tmp files
                try:
                    tmp.unlink()
                except OSError:
                    pass

    def _quarantine(self, p: Path) -> None:
        try:
            os.replace(p, p.with_suffix(".corrupt"))
            self.quarantined += 1
        except OSError:
            pass

    def __len__(self) -> int:
        return sum(1 for _ in self.root.glob("*/*.bin"))


# -------------------------------------------------------------------- cache

@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    insertions: int = 0
    evictions: int = 0
    # misses whose compile then failed to place/route (e.g. scheduler
    # placement probes on a full device) — without this the dashboard
    # hit_rate under-reads real cache behaviour
    build_failures: int = 0
    # stage-level template store (see make_template_key): a template hit on a
    # full-key miss means the build skipped place/route/latency entirely
    template_hits: int = 0
    template_misses: int = 0
    template_evictions: int = 0
    # frontend tier (source text -> lowered DFG): a hit skips parse+optimize
    frontend_hits: int = 0
    frontend_misses: int = 0
    # persistent tier: disk_hits count toward `hits` (no compile ran) but
    # mark that the artifact was warm-loaded from disk, not memory
    disk_hits: int = 0
    disk_template_hits: int = 0
    # fleet tier: the artifact was fetched from the shared remote blob
    # store (repro_torch.core.remote) — some OTHER host (or the compile farm)
    # paid the cold build
    remote_hits: int = 0
    remote_template_hits: int = 0
    remote_frontend_hits: int = 0
    # Session single-flight: a compile request that joined an identical
    # in-flight build instead of starting its own pipeline run.  These never
    # reach get()/put(), so without the counter the dedup win is invisible
    singleflight_hits: int = 0
    # entries evicted because the repro_torch.analysis artifact verifier
    # (CompileOptions.verify_level="full") failed to re-prove their
    # legality — treated exactly like corrupt DiskCache pickles
    verify_quarantined: int = 0

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def as_dict(self) -> dict:
        return dict(hits=self.hits, misses=self.misses,
                    insertions=self.insertions, evictions=self.evictions,
                    build_failures=self.build_failures,
                    template_hits=self.template_hits,
                    template_misses=self.template_misses,
                    template_evictions=self.template_evictions,
                    frontend_hits=self.frontend_hits,
                    frontend_misses=self.frontend_misses,
                    disk_hits=self.disk_hits,
                    disk_template_hits=self.disk_template_hits,
                    remote_hits=self.remote_hits,
                    remote_template_hits=self.remote_template_hits,
                    remote_frontend_hits=self.remote_frontend_hits,
                    singleflight_hits=self.singleflight_hits,
                    verify_quarantined=self.verify_quarantined,
                    hit_rate=round(self.hit_rate, 4))


class JITCache:
    """LRU cache of built :class:`~repro_torch.core.jit.CompiledKernel` objects.

    Shared safely between any number of Contexts/Schedulers: entries are
    immutable compile artifacts, and resource accounting happens in the
    runtime ledger, never in the cache.

    **Thread-safe**: the Session API runs builds on a worker pool, so every
    tier lookup/insert (and its LRU reordering + stats mutation) happens
    under one reentrant lock — an OrderedDict mid-``move_to_end`` is not
    safe to mutate from a second thread.  The lock is held only around
    in-memory bookkeeping and (on misses/writes) the disk tier; it is never
    held while a compile runs, so builds still overlap.

    With ``persist_dir`` every insertion is written through to a
    :class:`DiskCache` and every in-memory miss falls back to a disk
    lookup; a disk hit is promoted back into the LRU.  The disk tier is
    shared across processes (atomic writes), so a restarted server —
    or a sibling worker on the same host — warm-starts from it.

    With ``remote`` (a :class:`~repro_torch.core.remote.RemoteCache`) a third
    tier sits below disk: memory → disk → remote.  A remote hit — an
    artifact some OTHER host or the compile farm built — is promoted into
    the LRU *and* written through to the local disk tier, so one fetch
    warms every local tier.  Every local insertion is pushed to the remote
    store best-effort (a dead remote never blocks a build), and the entire
    remote plumbing is behind ``is not None`` checks: with no remote tier
    the hot path is untouched (gated in ``benchmarks/jit_cache_perf.py``,
    same pattern as the fault-plane TLS gate).
    """

    def __init__(self, capacity: int = 128, template_capacity: int = 64,
                 persist_dir: Optional[Union[str, Path]] = None,
                 remote=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if template_capacity < 1:
            raise ValueError("template_capacity must be >= 1")
        self.capacity = capacity
        self.template_capacity = template_capacity
        self._entries: "OrderedDict[CacheKey, Any]" = OrderedDict()  # lock: _lock
        self._templates: "OrderedDict[CacheKey, Any]" = OrderedDict()  # lock: _lock
        self._frontends: "OrderedDict[CacheKey, Any]" = OrderedDict()  # lock: _lock
        self._frontend_capacity = max(256, capacity)
        self.disk: Optional[DiskCache] = \
            DiskCache(persist_dir) if persist_dir is not None else None
        # the fleet tier (repro_torch.core.remote.RemoteCache); internally locked
        # and fully fault-isolated, so it is consulted without widening this
        # cache's lock contract
        self.remote = remote
        self.stats = CacheStats()          # lock: _lock
        self._lock = threading.RLock()

    # ------------------------------------------------------------- protocol
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: CacheKey) -> bool:
        with self._lock:
            return key in self._entries

    def keys(self) -> Iterable[CacheKey]:
        """Keys in LRU order (least recently used first)."""
        with self._lock:
            return tuple(self._entries.keys())

    # -------------------------------------------------------------- lookups
    def get(self, key: CacheKey):
        """Return the cached CompiledKernel or None; counts hit/miss and
        refreshes recency on hit.  Falls through (and promotes from) the
        lower tiers when configured: memory → disk → remote."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None and self.disk is not None:
                with obs_trace.span("cache:disk", "cache",
                                    kind="kernel") as _sp:
                    entry = self.disk.get(key)
                    _sp["hit"] = entry is not None
                if entry is not None:
                    self.stats.disk_hits += 1
                    self._insert(self._entries, key, entry, self.capacity)
            if entry is None and self.remote is not None:
                with obs_trace.span("cache:remote", "cache",
                                    kind="kernel") as _sp:
                    entry = self.remote.get(key)
                    _sp["hit"] = entry is not None
                if entry is not None:
                    # one fetch warms every local tier: promote into the
                    # LRU and persist to disk so a restart stays warm even
                    # through a later remote outage
                    self.stats.remote_hits += 1
                    self._insert(self._entries, key, entry, self.capacity)
                    if self.disk is not None:
                        self.disk.put(key, entry)
            if entry is None:
                self.stats.misses += 1
                return None
            self._entries.move_to_end(key)
            self.stats.hits += 1
            return entry

    def put(self, key: CacheKey, ck) -> None:
        with self._lock:
            self._insert(self._entries, key, ck, self.capacity)
            self.stats.insertions += 1
            if self.disk is not None:
                self.disk.put(key, ck)
            if self.remote is not None:
                self.remote.put(key, ck)

    def note_build_failure(self) -> None:
        """Count a miss whose compile then failed to place/route (e.g. a
        scheduler placement probe on a full device) — callers may be on
        worker threads, so the increment takes the cache lock like every
        other stats mutation."""
        with self._lock:
            self.stats.build_failures += 1

    def note_singleflight(self) -> None:
        """Count a compile request that joined an identical in-flight build.
        The Session calls this under ITS lock; cache stats belong to the
        cache's lock, so the increment takes it here (lock order
        session -> cache, never reversed)."""
        with self._lock:
            self.stats.singleflight_hits += 1

    def quarantine(self, key: CacheKey) -> None:
        """Evict an entry the artifact verifier refused to certify
        (``verify_level="full"``), memory AND disk tiers — the same
        treatment a corrupt DiskCache pickle gets, so a poisoned artifact
        cannot be served to the next requester while the caller rebuilds."""
        with self._lock:
            self._entries.pop(key, None)
            self.stats.verify_quarantined += 1
            if self.disk is not None:
                self.disk._quarantine(self.disk._path(key))
            if self.remote is not None:
                self.remote.quarantine(key)

    def _insert(self, table, key: CacheKey, obj, capacity: int) -> None:  # lock: held(_lock)
        table[key] = obj
        table.move_to_end(key)
        while len(table) > capacity:
            table.popitem(last=False)
            if table is self._entries:
                self.stats.evictions += 1
            elif table is self._templates:
                self.stats.template_evictions += 1

    # ------------------------------------------------------------ templates
    def get_template(self, key: CacheKey):
        """Stage-level lookup of a P&R :class:`~repro_torch.core.template.Template`;
        counts template_hits/template_misses and refreshes recency."""
        with self._lock:
            entry = self._templates.get(key)
            if entry is None and self.disk is not None:
                with obs_trace.span("cache:disk", "cache",
                                    kind="template") as _sp:
                    entry = self.disk.get(key)
                    _sp["hit"] = entry is not None
                if entry is not None:
                    self.stats.disk_template_hits += 1
                    self._insert(self._templates, key, entry,
                                 self.template_capacity)
            if entry is None and self.remote is not None:
                with obs_trace.span("cache:remote", "cache",
                                    kind="template") as _sp:
                    entry = self.remote.get(key)
                    _sp["hit"] = entry is not None
                if entry is not None:
                    self.stats.remote_template_hits += 1
                    self._insert(self._templates, key, entry,
                                 self.template_capacity)
                    if self.disk is not None:
                        self.disk.put(key, entry)
            if entry is None:
                self.stats.template_misses += 1
                return None
            self._templates.move_to_end(key)
            self.stats.template_hits += 1
            return entry

    def put_template(self, key: CacheKey, tmpl) -> None:
        with self._lock:
            self._insert(self._templates, key, tmpl, self.template_capacity)
            if self.disk is not None:
                self.disk.put(key, tmpl)
            if self.remote is not None:
                self.remote.put(key, tmpl)

    # ------------------------------------------------------------- frontend
    def get_frontend(self, key: CacheKey):
        """Lowered-DFG lookup keyed on the raw source fingerprint
        (:func:`kernel_fingerprint` of the text — computable WITHOUT
        parsing).  A hit skips the OpenCL parse + optimize pipeline, which
        is most of what a disk-warm build would otherwise still pay; the
        DFG is shared read-only across builds (the fuse stage copies)."""
        with self._lock:
            g = self._frontends.get(key)
            if g is None and self.disk is not None:
                with obs_trace.span("cache:disk", "cache",
                                    kind="frontend") as _sp:
                    g = self.disk.get(key)
                    _sp["hit"] = g is not None
                if g is not None:
                    self._insert(self._frontends, key, g,
                                 self._frontend_capacity)
            if g is None and self.remote is not None:
                with obs_trace.span("cache:remote", "cache",
                                    kind="frontend") as _sp:
                    g = self.remote.get(key)
                    _sp["hit"] = g is not None
                if g is not None:
                    self.stats.remote_frontend_hits += 1
                    self._insert(self._frontends, key, g,
                                 self._frontend_capacity)
                    if self.disk is not None:
                        self.disk.put(key, g)
            if g is None:
                self.stats.frontend_misses += 1
                return None
            self._frontends.move_to_end(key)
            self.stats.frontend_hits += 1
            return g

    def put_frontend(self, key: CacheKey, g) -> None:
        with self._lock:
            self._insert(self._frontends, key, g, self._frontend_capacity)
            if self.disk is not None:
                self.disk.put(key, g)
            if self.remote is not None:
                self.remote.put(key, g)

    def clear(self) -> None:
        """Drop the in-memory tiers (the disk tier, if any, is retained —
        it is the restart-survival layer)."""
        with self._lock:
            self._entries.clear()
            self._templates.clear()
            self._frontends.clear()

    def __repr__(self) -> str:
        return (f"JITCache({len(self)}/{self.capacity} entries, "
                f"{self.stats.hits} hits / {self.stats.misses} misses)")
