"""Session — the unified async host API over the overlay JIT runtime.

The paper's core claim is that overlay JIT compilation is cheap enough to
happen *during serving*.  The pieces below the Session already deliver that
(template-stamped P&R, the multi-tier JIT cache, the modelled command
queues); what was missing is a host API that lets compilation **overlap**
execution the way the paper's Fig. 5 flow draws it.  A Session owns the
whole serving stack — Platform/devices, the queue-aware :class:`Scheduler`,
one fleet-wide :class:`JITCache` (with optional disk tier), and per-tenant
:class:`CommandQueue` s — behind two calls:

  * :meth:`Session.compile` submits the JIT pipeline to a worker pool and
    returns a :class:`KernelFuture` immediately — no compiler stage runs on
    the caller's thread.  Identical concurrent requests are **single-flight
    deduplicated**: the second caller gets a future onto the first caller's
    in-flight build (counted in ``cache.stats.singleflight_hits``) and the
    pipeline runs once.
  * :meth:`Session.enqueue` chains a kernel execution onto the compile:
    the returned Event carries a dependency on the build's *compile event*,
    so its config/exec timestamps sit **after** the modelled JIT-compile
    finish time — serving latency accounts for compile latency exactly as
    Fig. 5 implies, and a warm-cache compile (sub-millisecond) costs the
    timeline nothing.

For the dominant serving pattern — many small kernels from one tenant,
where per-kernel enqueue pays a configuration charge on every switch — the
Session also speaks recorded graphs (:mod:`repro_torch.core.graph`):
:meth:`Session.capture` records calls into a DAG without compiling,
:meth:`Session.instantiate` partitions the DAG and compiles each partition
as ONE fused kernel (futures-based, through the same single-flight/cached
pipeline), and :meth:`Session.launch` replays the graph paying the config
charge once per partition instead of once per node.

Timestamps: the Session pins µs-time zero at construction; compile events
are stamped with real wall-clock build completion relative to that epoch,
which is what makes compile latency and the modelled device timeline share
one clock.

Placement is the Scheduler's queue-aware makespan ranking (see
:mod:`repro_torch.core.runtime`); per-tenant priorities (:meth:`set_priority`)
decide who gets shed first when the fleet is full.

Buffers: arrays handed to :meth:`Session.enqueue` / :meth:`Session.launch`
become device :class:`~repro_torch.core.runtime.Buffer` s on the Session's
``device`` (default: the CUDA card; ``device="cpu"`` runs the executor's
plain version), and every execution runs the overlay executor
(``use_overlay_executor=True``, where the JAX package defaulted to the
numpy ``run_reference``).  Outputs stay on the device until the caller
reads them.

Single-flight sharing means two tenants compiling the same (kernel, opts)
while the first build is still in flight resolve to the SAME resident
Program — releasing it releases it for both, exactly like two references
to one cache entry.  Tenants that need private residency should compile
distinct kernels (or wait for the first build to land, which makes the
second a near-free cache-hit build of its own Program).
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

from repro_torch.core import faults as faults_mod
from repro_torch.core import recovery as recovery_mod
from repro_torch.core.cache import JITCache, kernel_fingerprint, make_graph_key
from repro_torch.core.faults import DeviceLostError, FaultPlan, InjectedFault
from repro_torch.core.graph import (GraphError, KernelGraph, Partition,
                              partition_graph)
from repro_torch.core.options import CompileOptions
from repro_torch.core.queue import CommandQueue, Event, user_event
from repro_torch.core.recovery import RecoveryStats, RetryPolicy
from repro_torch.core.runtime import (Buffer, Context, Device, Platform,  # noqa: F401 — Device re-exported for Session users
                                Program, Scheduler)
from repro_torch.device import DeviceLike
from repro_torch.obs import trace as obs_trace


class SessionError(RuntimeError):
    pass


def _release_result(fut: "KernelFuture") -> None:
    """Done-callback: release a superseded build's Program (idempotent)."""
    if fut.exception() is None:
        fut.result().release()


class KernelFuture:
    """Handle to an asynchronous JIT build; resolves to a resident
    :class:`~repro_torch.core.runtime.Program`.

    Futures returned for deduplicated requests share one underlying build
    (and therefore one Program and one compile event).  ``result()`` blocks
    until the pipeline lands; :meth:`compile_event` is the build's finish
    time on the Session's modelled clock — the event executions chain on.
    """

    def __init__(self, session: "Session", key: Tuple,
                 fut: "concurrent.futures.Future[Program]", record: Dict,
                 tenant: Optional[str]):
        self._session = session
        self._fut = fut
        self._record = record          # shared across deduplicated futures
        self.key = key                 # single-flight identity
        self.tenant = tenant
        self.t_request_us = session.now_us()

    # ------------------------------------------------------ future protocol
    def done(self) -> bool:
        return self._fut.done()

    def result(self, timeout: Optional[float] = None) -> Program:
        return self._fut.result(timeout)

    def exception(self, timeout: Optional[float] = None):
        return self._fut.exception(timeout)

    def add_done_callback(self, fn) -> None:
        self._fut.add_done_callback(lambda _f: fn(self))

    # ----------------------------------------------------------- modelling
    @property
    def program(self) -> Program:
        """The resident Program (blocks until the build lands)."""
        return self.result()

    def compile_event(self) -> Event:
        """A pre-completed event at the build's modelled finish time (µs on
        the Session clock).  Blocks until the build lands — the event's
        timestamp does not exist before then."""
        prog = self.result()
        return user_event(self._record["t_done_us"],
                          name=f"jit:{prog.compiled.name}")

    @property
    def compile_us(self) -> float:
        """Modelled submit→finish compile latency (blocks until done)."""
        self.result()
        return self._record["t_done_us"] - self._record["t_submit_us"]


class GraphExec:
    """An instantiated :class:`~repro_torch.core.graph.KernelGraph`: one compiled
    (or compiling — instantiation is futures-based) fused kernel per
    partition, plus the wiring replay needs.

    ``session.launch(gexec, *inputs)`` replays the whole recorded DAG with
    ONE configuration charge per partition; re-launching reuses the same
    resident programs, so steady-state serving of the pipeline pays no
    further compiles and — when the graph fused to a single partition — no
    further reconfigurations at all.  Release the fabric with
    :meth:`release` (GraphExec is a context manager).
    """

    def __init__(self, session: "Session", graph: KernelGraph,
                 partitions: Sequence[Partition],
                 futures: Sequence[KernelFuture], tenant: Optional[str]):
        self.session = session
        self.graph = graph
        self.partitions = list(partitions)
        self.futures = list(futures)
        self.tenant = tenant
        owner = {nid: p.index for p in self.partitions for nid in p.node_ids}
        # per partition: fused-kernel args as ("in", graph_input_idx) or
        # ("step", partition_idx, output_pos) — resolved against real
        # buffers at launch
        self._steps = []
        for p in self.partitions:
            args = []
            for ref in p.ext:
                if ref[0] == "in":
                    args.append(("in", ref[1]))
                else:
                    src = self.partitions[owner[ref[1]]]
                    args.append(("step", src.index,
                                 src.out_pos(ref[1], ref[2])))
            label = f"graph:{graph.name}/p{p.index}[{p.dfg.name}]"
            self._steps.append((self.futures[p.index], args, p.deps, label))
        self._outs = []
        for b in graph.outputs:
            src = self.partitions[owner[b.nid]]
            self._outs.append((src.index, src.out_pos(b.nid, b.out_idx)))

    # ------------------------------------------------------------ lifecycle
    @property
    def n_partitions(self) -> int:
        """Upper bound on configuration charges per replay — the quantity
        the graph API amortizes (k nodes → n_partitions ≤ k configs)."""
        return len(self.partitions)

    def done(self) -> bool:
        return all(f.done() for f in self.futures)

    def result(self, timeout: Optional[float] = None) -> "GraphExec":
        """Block until every partition's build landed (errors surface
        here, exactly like ``KernelFuture.result``).  ``timeout`` bounds
        the WHOLE wait, not each partition."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for f in self.futures:
            f.result(None if deadline is None
                     else max(0.0, deadline - time.monotonic()))
        return self

    @property
    def programs(self):
        return [f.result() for f in self.futures]

    def release(self) -> None:
        """Release every partition's fabric (idempotent; identical
        partitions that single-flighted into one Program release once).
        Partitions whose build FAILED hold no fabric and are skipped — a
        partial instantiation must still release what did land, not leak
        it behind the first build error."""
        seen = set()
        for f in self.futures:
            try:
                prog = f.result()
            except Exception:
                continue
            if id(prog) not in seen:
                seen.add(id(prog))
                prog.release()

    def __enter__(self) -> "GraphExec":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return (f"GraphExec({self.graph.name}: {len(self.graph.nodes)} "
                f"nodes -> {self.n_partitions} partitions)")


class Session:
    """The single facade a serving host talks to (see module docstring).

    >>> with Session([Device("ovl0", spec), Device("ovl1", spec)]) as sess:
    ...     fut = sess.compile(SOURCE, CompileOptions(max_replicas=8),
    ...                        tenant="tenant-a")
    ...     ev = sess.enqueue(fut, x)          # waits for + chains on compile
    ...     y = ev.wait()[0].read()
    """

    def __init__(self, devices: Optional[Sequence[Device]] = None,
                 cache: Optional[JITCache] = None,
                 persist_dir: Optional[str] = None,
                 max_workers: int = 4,
                 policy: str = "makespan",
                 use_overlay_executor: bool = True,
                 faults: Optional[FaultPlan] = None,
                 retry: Optional[RetryPolicy] = None,
                 remote=None,
                 tracer=None,
                 metrics=None,
                 profiles=None,
                 device: DeviceLike = None):
        self.scheduler = Scheduler(
            list(devices) if devices else Platform.default().devices,
            cache=cache, persist_dir=persist_dir, policy=policy)
        if remote is not None:
            # fleet blob tier (repro_torch.core.remote.RemoteCache): attach as the
            # JITCache's third level (memory → disk → remote).  Duck-typed
            # and internally fault-isolated — a dead remote degrades every
            # lookup to the local tiers, never fails a build
            self.scheduler.cache.remote = remote
        self.platform = Platform(list(self.scheduler.devices))
        self.use_overlay_executor = use_overlay_executor
        # where arrays handed to enqueue/launch become Buffers (None: the
        # CUDA card); Buffers and tensors stay where they lie
        self.device = device
        # chaos + self-healing plane: the fault plan (if any) is activated
        # thread-locally around every worker-pool build and every enqueue;
        # the retry policy parameterizes backoff/hedging/breakers and the
        # RecoveryStats blob surfaces in stats()["recovery"].  With no plan
        # every fault_point is a single thread-local read — nothing on the
        # fault-free hot path (gated in benchmarks/jit_cache_perf.py)
        self.faults = faults
        # observability plane (repro_torch.obs): the tracer is activated
        # thread-locally at exactly the fault plane's activation sites
        # (worker-pool builds, hedge racers, every enqueue), so spans from
        # racing threads nest coherently; with no tracer every probe is a
        # single thread-local read — nothing on the warm hit path (gated
        # in benchmarks/torch_trace_overhead_perf.py).  ``profiles`` records
        # per-partition replay measurements at the end of every launch().
        # ``metrics`` is a repro_torch.obs.metrics.MetricsRegistry and
        # ``profiles`` a repro_torch.obs.profile.ProfileStore (both hold
        # modelled µs, never device times)
        self.tracer = tracer
        self.metrics = metrics
        self.profiles = profiles
        self.retry = retry if retry is not None else RetryPolicy()
        self.recovery = RecoveryStats()
        self.scheduler.configure_breakers(self.retry.breaker_threshold,
                                          self.retry.breaker_cooldown_s)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="jit")
        # reentrant: a future that completes before its done-callback is
        # registered runs the callback INLINE on the registering thread,
        # which then re-enters this lock through _forget
        self._lock = threading.RLock()
        # single-flight map: (kernel fingerprint, opts) -> (future, record).
        # Entries live only while the build is in flight; sequential repeat
        # compiles are the JITCache's job, not this map's
        self._inflight: Dict[Tuple, Tuple] = {}  # lock: _lock
        self._queues: Dict[Tuple[str, str], CommandQueue] = {}  # lock: _lock
        # graph-plan memo: make_graph_key -> List[Partition].  Partitioning
        # is pure in (graph content, spec, budget), so repeat instantiations
        # of one pipeline skip the cut; the fused ARTIFACTS warm through the
        # ordinary JITCache (single-flight + disk tier)
        self._graph_plans: Dict[str, list] = {}  # lock: _lock
        # nodewise-replay memo: (graph fingerprint, tenant) -> node futures.
        # Without it every repeat replay would re-key each node against a
        # snapshot its own resident predecessors shrank, building (and
        # leaking) a fresh Program per request — a real pre-graph server
        # holds its Program handles across requests, so the baseline must
        self._nodewise_futs: Dict[Tuple, list] = {}  # lock: _lock
        self._graph_count = 0  # lock: _lock
        # pluggable stats() sections: subsystem name -> zero-arg provider
        # (repro_torch.serve registers "serving" here).  Providers run OUTSIDE
        # the session lock — they may call back into Session accessors
        self._stats_sections: Dict[str, Callable[[], dict]] = {}  # lock: _lock
        self._t0 = time.perf_counter()
        self._closed = False  # lock: _lock
        if metrics is not None:
            metrics.install(self)          # stats()["obs"]

    #: section names :meth:`stats` always emits itself — providers
    #: registered through :meth:`register_stats_section` may not shadow
    #: them (the dashboard would silently lose a built-in blob)
    BUILTIN_SECTIONS = frozenset({
        "cache", "devices", "inflight", "queues", "graph_plans", "config",
        "recovery", "disk", "remote", "faults", "profiles"})

    # ------------------------------------------------------------ plumbing
    @property
    def cache(self) -> JITCache:
        return self.scheduler.cache

    @property
    def devices(self):
        return self.scheduler.devices

    @property
    def contexts(self) -> Dict[str, Context]:
        return self.scheduler.contexts

    def now_us(self) -> float:
        """Wall-clock µs on the Session's modelled clock (zero at init)."""
        return (time.perf_counter() - self._t0) * 1e6

    def set_priority(self, tenant: str, priority: int) -> None:
        self.scheduler.set_priority(tenant, priority)

    # ------------------------------------------------------------- compile
    def compile(self, source, opts: Optional[CompileOptions] = None,
                tenant: Optional[str] = None) -> KernelFuture:
        """Submit the JIT pipeline for ``source`` to the worker pool and
        return immediately.  Requests identical in (kernel content, opts)
        to a build still in flight join that build instead of starting a
        second pipeline run (single-flight; the shared JITCache already
        dedups *sequential* repeats)."""
        opts = opts if opts is not None else CompileOptions()
        # outside the session lock: str sources hash without parsing, but a
        # python callable is traced here (µs-scale, NOT a pipeline stage) —
        # that must not stall concurrent compile()/enqueue() on the lock
        fp = kernel_fingerprint(source, n_inputs=opts.n_inputs,
                                name=opts.name)
        key = (fp, opts)
        with self._lock:
            if self._closed:
                raise SessionError("session is closed")
            entry = self._inflight.get(key)
            if entry is not None and entry[0].done() \
                    and entry[0].exception() is not None:
                # the registered build already FAILED but its _forget
                # callback hasn't run yet (it re-enters this lock): joining
                # it would hand this caller a stale exception for a build
                # it never asked for.  Treat the dead entry as absent and
                # start a fresh build — the failed build's waiters all got
                # the exception, and the cache was never poisoned
                entry = None
            if entry is not None:
                fut, record = entry
                # the stats counter belongs to the cache's lock domain, not
                # the session's — mutate it through the cache's own API
                self.cache.note_singleflight()
            else:
                record = dict(t_submit_us=self.now_us(), t_start_us=None,
                              t_done_us=None, attempts=0)
                booking = self.scheduler.book_inflight(fp)
                fut = self._pool.submit(self._build, source, opts, tenant,
                                        fp, booking, record)
                self._inflight[key] = (fut, record)
        # registered outside the critical section: a build that failed or
        # hit the cache instantly runs the callback inline, right here.
        # _build's finally stamps t_done_us BEFORE the future resolves, so
        # callbacks (and joiners) always see it set
        if entry is None:
            fut.add_done_callback(lambda _f, k=key, f=fut: self._forget(k, f))
        return KernelFuture(self, key, fut, record, tenant)

    def _build(self, source, opts: CompileOptions, tenant: Optional[str],
               fp: str, booking, record: Dict) -> Program:
        """Worker-pool body: the retry loop around the scheduler build.

        Transient failures (injected faults, device loss, I/O errors — see
        ``recovery.TRANSIENT``) are absorbed with exponential backoff up to
        the per-build budget (``opts.retry_budget``, else the session
        policy's ``max_retries``); genuine mapping failures propagate
        immediately — the same build would fail the same way.  The final
        exception reaches every deduplicated waiter through the shared
        future, and the finally-stamped ``t_done_us`` means retries and
        backoff genuinely inflate the modelled compile event downstream
        executions chain on."""
        record["t_start_us"] = self.now_us()
        budget = opts.retry_budget if opts.retry_budget is not None \
            else self.retry.max_retries
        try:
            with faults_mod.activate(self.faults), \
                    obs_trace.activate(self.tracer), \
                    recovery_mod.activate_stats(self.recovery), \
                    obs_trace.span("jit:build", "compile",
                                   kernel=opts.name or fp[:12]):
                attempt = 0
                while True:
                    record["attempts"] = attempt + 1
                    try:
                        if opts.deadline_ms is not None:
                            return self._build_hedged(source, opts, tenant,
                                                      booking, fp)
                        return self.scheduler.build_opts(
                            source, opts, tenant=tenant, inflight=booking,
                            fingerprint=fp)
                    except Exception as e:
                        attempt += 1
                        if attempt > budget or not self.retry.retryable(e):
                            raise
                        self.recovery.bump("retries")
                        time.sleep(self.retry.backoff_s(attempt, key=fp))
        finally:
            record["t_done_us"] = self.now_us()
            self.scheduler.release_inflight(booking)

    def _build_hedged(self, source, opts: CompileOptions,
                      tenant: Optional[str], booking, fp: str) -> Program:
        """One build attempt under a compile deadline: the primary build
        runs on its own thread; if it misses ``opts.deadline_ms`` a hedge
        rebuild at lower ``place_effort`` races it and the first artifact
        to land wins.  The straggler is never abandoned mid-ledger: each
        racer always reports into the queue, and whichever Program loses
        the race is released when it lands (hedges are full peer builds
        with their own cache keys, so the winner's residency is unaffected).
        """
        import queue as _stdq
        resq: "_stdq.SimpleQueue" = _stdq.SimpleQueue()
        hedge_opts = opts.replace(
            deadline_ms=None,
            place_effort=max(0.05,
                             opts.place_effort * self.retry.hedge_effort))
        plan = faults_mod.active_plan()

        def run(o: CompileOptions, tag: str) -> None:
            with faults_mod.activate(plan), \
                    obs_trace.activate(self.tracer), \
                    recovery_mod.activate_stats(self.recovery), \
                    obs_trace.span(f"jit:racer:{tag}", "compile",
                                   kernel=o.name or fp[:12]):
                try:
                    resq.put((tag, self.scheduler.build_opts(
                        source, o, tenant=tenant, inflight=booking,
                        fingerprint=fp), None))
                except BaseException as e:
                    resq.put((tag, None, e))

        threading.Thread(target=run, args=(opts, "primary"),
                         name="jit-primary", daemon=True).start()
        try:
            first = resq.get(timeout=opts.deadline_ms * 1e-3)
        except _stdq.Empty:
            first = None
        if first is None:
            # deadline missed: race a cheaper rebuild against the straggler
            self.recovery.bump("hedges_started")
            threading.Thread(target=run, args=(hedge_opts, "hedge"),
                             name="jit-hedge", daemon=True).start()
            first = resq.get()
            if first[1] is not None:
                self.recovery.bump("hedges_won" if first[0] == "hedge"
                                   else "hedges_lost")
                threading.Thread(target=self._drain_hedge, args=(resq,),
                                 name="jit-hedge-drain",
                                 daemon=True).start()
                return first[1]
            # the first to land failed: the race reduces to the other racer
            second = resq.get()
            if second[1] is not None:
                self.recovery.bump("hedges_won" if second[0] == "hedge"
                                   else "hedges_lost")
                return second[1]
            raise (first[2] if first[0] == "primary" else second[2])
        if first[2] is not None:
            raise first[2]
        return first[1]

    @staticmethod
    def _drain_hedge(resq) -> None:
        """Release the losing racer's Program when it eventually lands —
        without this a near-simultaneous finish would leak the loser's
        fabric on the ledger forever."""
        _tag, prog, _err = resq.get()
        if prog is not None:
            prog.release()

    def _forget(self, key: Tuple, fut) -> None:
        with self._lock:
            # identity-checked: a failed build's late callback must not pop
            # the FRESH entry a subsequent compile() registered for the key
            entry = self._inflight.get(key)
            if entry is not None and entry[0] is fut:
                self._inflight.pop(key)

    def build(self, source, opts: Optional[CompileOptions] = None,
              tenant: Optional[str] = None) -> Program:
        """Synchronous convenience: ``compile(...).result()``."""
        return self.compile(source, opts, tenant=tenant).result()

    # ------------------------------------------------------------- enqueue
    def queue_for(self, tenant: Optional[str], device_name: str,
                  in_order: Optional[bool] = None) -> CommandQueue:
        """The (tenant, device) submission stream, created on first use —
        out-of-order by default so independent tenants backfill each
        other's idle gaps.  ``in_order=None`` (the default, and what
        ``enqueue`` uses) accepts whichever flavor exists; an EXPLICIT
        flavor that contradicts the existing queue's is an error, not a
        silent hand-back — kernels the caller expected to serialize must
        not quietly backfill."""
        key = (tenant or "default", device_name)
        with self._lock:
            q = self._queues.get(key)
            if q is None:
                q = self.scheduler.contexts[device_name].create_queue(
                    in_order=bool(in_order),
                    use_overlay_executor=self.use_overlay_executor,
                    tenant=key[0])
                self._queues[key] = q
            elif in_order is not None and q.in_order != in_order:
                raise SessionError(
                    f"queue for {key} already exists with "
                    f"in_order={q.in_order}; cannot reopen with "
                    f"in_order={in_order}")
            return q

    def enqueue(self, handle: Union[KernelFuture, Program], *args,
                wait_for: Sequence[Event] = (),
                tenant: Optional[str] = None,
                label: Optional[str] = None) -> Event:
        """Run a kernel on its program's device queue.

        With a :class:`KernelFuture` handle, execution is chained onto the
        build: the kernel's event depends on the compile event, so it
        cannot submit (nor backfill) before the modelled compile-finish
        time — compile latency is on the serving timeline.  ``args`` are
        Buffers, tensors or arrays (wrapped as Buffers on the Session's
        ``device``); ``label`` overrides the
        event's kernel name (graph replay tags partition launches)."""
        deps = tuple(wait_for)
        if isinstance(handle, KernelFuture):
            prog = handle.result()     # the host needs the artifact to run
            deps = deps + (handle.compile_event(),)
            tenant = tenant if tenant is not None else handle.tenant
        else:
            prog = handle
            tenant = tenant if tenant is not None else prog.tenant
        bufs = [self._buffer(a) for a in args]
        return self._enqueue_resilient(prog, bufs, deps, tenant, label)

    def _buffer(self, a) -> Buffer:
        return a if isinstance(a, Buffer) else Buffer(a, device=self.device)

    def _enqueue_resilient(self, prog: Program, bufs, deps,
                           tenant: Optional[str],
                           label: Optional[str]) -> Event:
        """The execution-side healing loop.  Transient submit/exec faults
        retry with backoff and count against the device's circuit breaker;
        a breaker trip — or outright device loss — heals the device
        (migrate resident Programs, re-enqueue lost events) and the retry
        lands on wherever the program now lives.  The loop is bounded by
        the enqueue retry budget plus one healing hop per device."""
        attempts = hops = 0
        while True:
            dev = prog.ctx.device.name
            q = self.queue_for(tenant, dev)
            try:
                with faults_mod.activate(self.faults), \
                        obs_trace.activate(self.tracer):
                    ev = q.enqueue_kernel(
                        prog.create_kernel().set_args(*bufs),
                        wait_for=deps, label=label)
                # a completed command is health evidence: resets the
                # breaker's consecutive count / closes a half-open probe
                self.scheduler.breakers[dev].record_success()
                return ev
            except DeviceLostError:
                hops += 1
                if hops > len(self.contexts):
                    raise        # every device in the fleet is gone
                self._heal_device(dev)
                if prog.released or prog.ctx.device.name == dev:
                    raise        # migration could not re-seat the program
            except InjectedFault:
                attempts += 1
                tripped = self.scheduler.breakers[dev].record_failure()
                if tripped:
                    # consecutive failures say the device is sick even
                    # though it still answers: evacuate it and retry the
                    # command where the program migrated to
                    self._heal_device(dev)
                    if prog.released or prog.ctx.device.name == dev:
                        raise
                    continue
                if attempts > self.retry.enqueue_retries:
                    raise
                self.recovery.bump("enqueue_retries")
                time.sleep(self.retry.backoff_s(attempts, key=dev))

    # -------------------------------------------------------- device health
    def fail_device(self, name: str, at_us: Optional[float] = None) -> None:
        """Declare device ``name`` lost (chaos harness / health monitor)
        and heal around it immediately: the breaker force-opens, resident
        Programs migrate to the healthy fleet through the warm-cache
        rebuild path, and — when ``at_us`` marks the modelled failure time
        — commands that had not finished by then are re-executed on the
        devices their programs migrated to, so no request observes lost
        work."""
        if name not in self.scheduler.contexts:
            raise SessionError(f"unknown device {name!r}")
        self.scheduler.contexts[name].device.fail(at_us=at_us)
        self._heal_device(name)

    def recover_device(self, name: str) -> None:
        """Bring a failed device back.  Its breaker stays open until the
        cooldown half-opens it, so returning traffic probes the device
        before the scheduler trusts it again."""
        if name not in self.scheduler.contexts:
            raise SessionError(f"unknown device {name!r}")
        self.scheduler.contexts[name].device.recover()

    def _heal_device(self, name: str) -> None:
        """Evacuate ``name``: force its breaker open, migrate resident
        Programs (owners' handles stay valid, now resident elsewhere) and
        re-enqueue the commands the failure interrupted."""
        self.scheduler.breakers[name].force_open()
        migrated, lost = self.scheduler.migrate_programs(name)
        if migrated:
            self.recovery.bump("migrated_programs", migrated)
        if lost:
            self.recovery.bump("lost_programs", lost)
        self._requeue_events(name)

    def _requeue_events(self, name: str) -> int:
        """Re-execute commands stranded by a device failure: every event on
        the dead device's queues whose modelled finish time is after the
        failure instant re-runs — same kernel object, same argument buffers
        — on whatever device its (already migrated) Program now lives.
        The ORIGINAL Event object is re-pointed at the re-execution's
        outputs and timestamps, so holders of the old handle transparently
        observe the recovered result (bit-identical: the kernels are
        deterministic functions of their argument buffers)."""
        at = self.scheduler.contexts[name].device.failed_at_us
        if at is None:
            return 0
        with self._lock:
            doomed = [(k[0], q) for k, q in self._queues.items()
                      if k[1] == name]
        requeued = 0
        for tenant, q in doomed:
            for ev in q.events:
                kern = getattr(ev, "_kernel", None)
                if ev.t_end_us <= at or kern is None:
                    continue
                prog = kern.program
                if prog.released or prog.ctx.device.name == name:
                    continue       # not migrated; nothing to re-run on
                nq = self.queue_for(tenant, prog.ctx.device.name)
                nev = nq.enqueue_kernel(kern, wait_for=(),
                                        label=ev.kernel_name)
                ev.outputs = nev.outputs
                ev.t_submit_us = nev.t_submit_us
                ev.config_us = nev.config_us
                ev.t_start_us = nev.t_start_us
                ev.t_end_us = nev.t_end_us
                requeued += 1
        if requeued:
            self.recovery.bump("requeued_events", requeued)
        return requeued

    # ------------------------------------------------- graph capture/replay
    def capture(self, tenant: Optional[str] = None,
                name: Optional[str] = None) -> KernelGraph:
        """Open a recording context (OpenCL command-buffer / CUDA-Graph
        style): inside ``with session.capture(tenant) as g:`` every
        ``g.call(source, opts, *buffers)`` RECORDS a kernel call — no
        compile, no enqueue — and buffer flow between calls defines a DAG.
        Leaving the block freezes + validates the graph; hand it to
        :meth:`instantiate`.  Source lowering at record time rides the
        cache's frontend tier, so re-capturing a known pipeline re-parses
        nothing."""
        from repro_torch.core.jit import lower_cached

        def lower(source, opts: CompileOptions, n_args: int):
            n = opts.n_inputs if opts.n_inputs is not None else n_args
            return lower_cached(source, n, opts.name, cache=self.cache)

        with self._lock:
            self._graph_count += 1
            gname = name or f"graph{self._graph_count}"
        return KernelGraph(gname, tenant=tenant, lower=lower)

    def instantiate(self, graph: KernelGraph, tenant: Optional[str] = None,
                    max_partition_fus: Optional[int] = None,
                    plan: Optional[Sequence[Partition]] = None) -> GraphExec:
        """Compile a recorded graph into packed overlay configurations.

        The DAG is cut into partitions (dependency-adjacent nodes fused
        under the FU/IO budget of the fleet's roomiest device —
        :func:`repro_torch.core.graph.partition_graph`), and each partition's
        fused DFG is submitted through the normal :meth:`compile` path:
        futures-based, single-flight deduplicated, and keyed on a content
        hash of the fused DFG + opts — so a repeat instantiation (same
        process or after a restart, via the disk tier) runs no compiler
        stage.  Returns immediately; builds land on the worker pool.

        ``plan`` supplies a precomputed partition list (e.g. the
        profile-guided re-cutter's explicit cut built with
        :func:`repro_torch.core.graph.partition_graph_grouped`); it bypasses
        the greedy cut and the plan memo but rides the same verification
        gate and the same warm compile path."""
        graph.freeze()                    # no-op when capture already froze
        if max_partition_fus is not None and max_partition_fus < 1:
            raise ValueError(f"max_partition_fus must be >= 1, "
                             f"got {max_partition_fus!r}")
        spec = self.scheduler.partition_spec()
        if max_partition_fus is None:
            caps = [n.opts.max_partition_fus for n in graph.nodes
                    if n.opts.max_partition_fus is not None]
            max_partition_fus = min(caps) if caps else None
        key = make_graph_key(graph.fingerprint(), spec, max_partition_fus)
        if plan is not None:
            partitions = self._verified_plan(graph, list(plan))
            tenant = tenant if tenant is not None else graph.tenant
            futures = [self.compile(p.dfg, p.opts, tenant=tenant)
                       for p in partitions]
            return GraphExec(self, graph, partitions, futures, tenant)
        with self._lock:
            partitions = self._graph_plans.get(key)
        if partitions is None:
            with obs_trace.activate(self.tracer), \
                    obs_trace.span("graph:partition", "compile",
                                   graph=graph.name):
                partitions = partition_graph(
                    graph, spec, max_partition_fus=max_partition_fus)
            partitions = self._verified_plan(graph, partitions)
            with self._lock:
                self._graph_plans.setdefault(key, partitions)
        tenant = tenant if tenant is not None else graph.tenant
        futures = [self.compile(p.dfg, p.opts, tenant=tenant)
                   for p in partitions]
        return GraphExec(self, graph, partitions, futures, tenant)

    def _verified_plan(self, graph: KernelGraph, partitions):
        """Gate a partition plan through the A1xx race/alias analysis
        when any node opted into verification (shared by the greedy cut
        and caller-supplied plans); returns the plan unchanged."""
        if any(n.opts.verify_level != "off" for n in graph.nodes):
            # any node opting into verification gates the whole cut:
            # run the A1xx race/alias analysis on the fresh plan before
            # it is memoized or a single partition build is submitted
            from repro_torch.analysis import (ERROR, VerificationError,
                                              check_graph, check_partitions)
            diags = check_graph(graph) + check_partitions(graph,
                                                          partitions)
            bad = [d for d in diags if d.severity == ERROR]
            if bad:
                raise VerificationError(
                    f"{graph.name}: partition plan failed verification",
                    bad)
        return partitions

    def graph_plan(self, graph: KernelGraph,
                   max_partition_fus: Optional[int] = None):
        """The memoized partition plan for ``graph`` under the current
        spec (None when never instantiated or not memoized) — what a
        repeat :meth:`instantiate` would reuse."""
        spec = self.scheduler.partition_spec()
        if max_partition_fus is None:
            caps = [n.opts.max_partition_fus for n in graph.nodes
                    if n.opts.max_partition_fus is not None]
            max_partition_fus = min(caps) if caps else None
        key = make_graph_key(graph.fingerprint(), spec, max_partition_fus)
        with self._lock:
            return self._graph_plans.get(key)

    def adopt_graph_plan(self, graph: KernelGraph,
                         partitions: Sequence[Partition],
                         max_partition_fus: Optional[int] = None) -> None:
        """Replace the memoized partition plan for ``graph``: every
        future :meth:`instantiate` under the same (spec, budget) key
        reuses ``partitions`` — warm, since the adopter (the re-cutter)
        already compiled them through the single-flight path."""
        graph.freeze()
        spec = self.scheduler.partition_spec()
        if max_partition_fus is None:
            caps = [n.opts.max_partition_fus for n in graph.nodes
                    if n.opts.max_partition_fus is not None]
            max_partition_fus = min(caps) if caps else None
        key = make_graph_key(graph.fingerprint(), spec, max_partition_fus)
        with self._lock:
            self._graph_plans[key] = list(partitions)

    def launch(self, gexec: GraphExec, *inputs,
               wait_for: Sequence[Event] = (),
               tenant: Optional[str] = None) -> Event:
        """Replay an instantiated graph over real input arrays.

        One fused kernel is enqueued per partition — the configuration
        charge is paid per PARTITION, not per recorded node — with
        cross-partition dependencies expressed as ordinary ``wait_for``
        event edges on the per-tenant out-of-order queues (each partition
        execution also chains on its own compile event, Fig. 5 style).
        ``wait_for`` events gate the whole replay: they are added to every
        ROOT partition's dependencies, so no part of the graph models
        starting before them (serving uses this to chain a request's
        decode steps and to anchor launches at request-arrival events).
        Returns one aggregate Event: ``wait()`` yields the graph outputs,
        timestamps span the whole replay.

        Degradation ladder: a partition whose FUSED build failed (or whose
        fused launch cannot be healed) is replayed node-by-node through
        :meth:`_nodewise_partition_event` — per-node compiles are smaller,
        independently cached and independently placeable, so the request
        completes with identical results at per-node config cost for that
        partition only (``recovery.fallback_nodewise`` counts these)."""
        tenant = tenant if tenant is not None else gexec.tenant
        graph = gexec.graph
        if len(inputs) != len(graph.inputs):
            raise GraphError(
                f"{graph.name}: expected {len(graph.inputs)} inputs, "
                f"got {len(inputs)}")
        bufs = [self._buffer(a) for a in inputs]
        extern = tuple(wait_for)
        events = []
        for p, (fut, args, deps, label) in zip(gexec.partitions,
                                               gexec._steps):
            argv = [bufs[r[1]] if r[0] == "in" else
                    events[r[1]].outputs[r[2]] for r in args]
            dep_evs = tuple(events[d] for d in deps)
            if not deps:
                dep_evs = extern       # roots inherit the external gate

            try:
                events.append(self.enqueue(fut, *argv, wait_for=dep_evs,
                                           tenant=tenant, label=label))
                continue
            except Exception:
                # fused path dead for this partition (build failed after
                # retries, or execution unhealable): degrade, don't fail
                self.recovery.bump("fallback_nodewise")
            events.append(self._nodewise_partition_event(
                graph, p, argv, dep_evs, tenant, f"{label}:nodewise"))
        if self.profiles is not None:
            # observability plane: fold this replay's per-partition events
            # into the graph's persistent ReplayProfile (events align with
            # partitions by index; the store ignores replays where the
            # nodewise ladder replaced a fused kernel)
            with obs_trace.activate(self.tracer):
                self.profiles.record(gexec, events,
                                     self.scheduler.partition_spec())
        outputs = tuple(events[si].outputs[pos] for si, pos in gexec._outs)
        t_end = max(e.t_end_us for e in events)
        return Event(kernel_name=f"graph:{graph.name}", t_queued_us=0.0,
                     t_submit_us=t_end, t_start_us=t_end, t_end_us=t_end,
                     status="complete", outputs=outputs, deps=tuple(events))

    def _nodewise_partition_event(self, graph: KernelGraph, p: Partition,
                                  argv, deps, tenant: Optional[str],
                                  label: str) -> Event:
        """Replay ONE partition node-by-node (the fused artifact is
        unavailable): each member node compiles through the ordinary
        cached/single-flight path and enqueues with the partition's
        external argument buffers mapped back onto per-node wiring.  The
        returned aggregate Event exposes outputs in the SAME order as the
        fused kernel's, so downstream partitions consume it unchanged."""
        by_nid = {n.nid: n for n in graph.nodes}
        ext_pos = p.ext_index()
        evs: Dict[int, Event] = {}
        for nid in p.node_ids:     # node_ids are topological by construction
            node = by_nid[nid]
            nargs, ndeps = [], list(deps)
            for b in node.args:
                ref = b.ref()
                if ref in ext_pos:
                    nargs.append(argv[ext_pos[ref]])
                else:              # internal edge: producer in this group
                    nargs.append(evs[b.nid].outputs[b.out_idx])
                    ndeps.append(evs[b.nid])
            fut = self.compile(node.dfg, node.opts, tenant=tenant)
            evs[nid] = self.enqueue(fut, *nargs, wait_for=tuple(ndeps),
                                    tenant=tenant,
                                    label=f"{label}/N{nid}[{node.dfg.name}]")
        outs = tuple(evs[nid].outputs[oi] for nid, oi in p.outputs)
        t_end = max(e.t_end_us for e in evs.values())
        return Event(kernel_name=label, t_queued_us=0.0, t_submit_us=t_end,
                     t_start_us=t_end, t_end_us=t_end, status="complete",
                     outputs=outs, deps=tuple(evs.values()))

    def launch_nodewise(self, graph: KernelGraph, *inputs,
                        tenant: Optional[str] = None) -> Event:
        """Replay a recorded graph the PRE-graph way: every node compiled
        (cache-deduplicated) and enqueued individually, paying a config
        charge per node whenever configurations alternate.  This is the
        baseline `instantiate`/:meth:`launch` amortizes — kept as API so
        serving code and ``benchmarks/graph_replay_perf.py`` can measure
        both sides of the trade on identical traces."""
        graph.freeze()
        tenant = tenant if tenant is not None else graph.tenant
        futs = self._node_futures(graph, tenant)
        # recording order IS topological (a call can only consume buffers
        # that already exist), so step index == position in graph.nodes
        pos = {node.nid: i for i, node in enumerate(graph.nodes)}
        steps = []
        for node, fut in zip(graph.nodes, futs):
            args = [b.ref() if b.kind == "in" else
                    ("step", pos[b.nid], b.out_idx) for b in node.args]
            deps = sorted(pos[d] for d in graph.node_deps(node))
            steps.append((fut, args, deps,
                          f"graph:{graph.name}/N{node.nid}[{node.dfg.name}]"))
        outs = [(pos[b.nid], b.out_idx) for b in graph.outputs]
        return self._replay(graph, steps, outs, inputs, tenant,
                            f"graph:{graph.name}:nodewise")

    def _node_futures(self, graph: KernelGraph, tenant: Optional[str]):
        """Per-node compile futures for nodewise replay, memoized per
        (graph content, tenant) so repeat replays reuse the SAME resident
        Programs — a server holds its Program handles across requests, and
        re-keying each node against a snapshot its own resident
        predecessors shrank would build a fresh Program per request.

        Lookup, staleness check and store are one atomic step under the
        session lock (compile() only *submits* under it, no pipeline stage
        runs), so two tenant threads replaying the same graph cannot both
        build and orphan a loser's resident Programs.  A stale entry (a
        build failed, or shedding released a node's Program) is rebuilt
        whole, and whatever remains resident of the old generation is
        released — not silently leaked off the ledger."""
        key = (graph.fingerprint(), tenant)
        with self._lock:
            futs = self._nodewise_futs.get(key)
            # pending builds are fresh by definition; only a *landed* build
            # can have failed or had its Program released (non-blocking)
            if futs is not None and not any(
                    f.done() and (f.exception() is not None
                                  or f.result().released)
                    for f in futs):
                return futs
            stale = futs
            futs = [self.compile(node.dfg, node.opts, tenant=tenant)
                    for node in graph.nodes]
            self._nodewise_futs[key] = futs
        if stale is not None:
            # a stale build still in flight is JOINED by its replacement
            # (single-flight: same key, same underlying future, same
            # Program) — releasing it would release the new generation's
            # Program too, so only genuinely superseded builds are dropped
            kept = {id(f._fut) for f in futs}
            for f in stale:
                if id(f._fut) not in kept:
                    f.add_done_callback(_release_result)
        return futs

    def _replay(self, graph: KernelGraph, steps, outs, inputs,
                tenant: Optional[str], name: str) -> Event:
        if len(inputs) != len(graph.inputs):
            raise GraphError(
                f"{graph.name}: expected {len(graph.inputs)} inputs, "
                f"got {len(inputs)}")
        bufs = [self._buffer(a) for a in inputs]
        events = []
        for fut, args, deps, label in steps:
            argv = [bufs[r[1]] if r[0] == "in" else
                    events[r[1]].outputs[r[2]] for r in args]
            # enqueue() chains the step on its own compile event and routes
            # it to the (tenant, device) queue — replay adds only the
            # cross-step event edges
            events.append(self.enqueue(
                fut, *argv, wait_for=tuple(events[d] for d in deps),
                tenant=tenant, label=label))
        outputs = tuple(events[si].outputs[pos] for si, pos in outs)
        t_end = max(e.t_end_us for e in events)
        return Event(kernel_name=name, t_queued_us=0.0, t_submit_us=t_end,
                     t_start_us=t_end, t_end_us=t_end, status="complete",
                     outputs=outputs, deps=tuple(events))

    # ---------------------------------------------------------- inspection
    def finish(self) -> float:
        """Wait for every in-flight build, then return the fleet's modelled
        makespan (µs): the max finish time across every tenant queue.
        Build *errors* are not raised here — they surface on the owning
        future's ``result()``."""
        with self._lock:
            pending = [fut for fut, _ in self._inflight.values()]
        concurrent.futures.wait(pending)
        with self._lock:
            queues = list(self._queues.values())
        return max((q.makespan_us for q in queues), default=0.0)

    def ledger(self):
        return self.scheduler.ledger()

    def ledger_consistent(self) -> bool:
        return self.scheduler.ledger_consistent()

    def makespan_report(self):
        return self.scheduler.makespan_report()

    def config_charges(self) -> dict:
        """Reconfiguration accounting across every tenant queue — the
        serving cost graph replay amortizes."""
        with self._lock:
            queues = list(self._queues.values())
        return dict(charges=sum(q.config_charges for q in queues),
                    config_us=sum(q.config_us_total for q in queues))

    def register_stats_section(self, name: str,
                               provider: Callable[[], dict]) -> None:
        """Attach a subsystem dashboard to :meth:`stats`: ``provider()``
        is called on every stats() and its dict lands under ``name``
        (the inference server registers ``"serving"`` this way).
        Re-registering a name replaces its provider; a name stats()
        emits itself (:attr:`BUILTIN_SECTIONS`) is refused — it would
        silently shadow a built-in dashboard blob."""
        if name in self.BUILTIN_SECTIONS:
            raise SessionError(
                f"stats section {name!r} shadows a built-in section "
                f"(reserved: {', '.join(sorted(self.BUILTIN_SECTIONS))})")
        with self._lock:
            self._stats_sections[name] = provider

    def stats(self) -> dict:
        """One serving dashboard blob: cache tiers, per-device makespan,
        and the self-healing counters — retries, hedge outcomes, breaker
        trips/states, fallback ladder hits, migrations — plus the disk
        tier's quarantine/write-error counters (previously only reachable
        via cache internals), the fleet remote tier's dashboard when one
        is attached, the fault plan's injection tallies when chaos is
        on, and every section a subsystem registered through
        :meth:`register_stats_section` (e.g. ``"serving"``) in
        deterministic name order, after every built-in section."""
        recovery = self.recovery.as_dict()
        recovery["breaker_trips"] = sum(
            b.trips for b in self.scheduler.breakers.values())
        recovery["breakers"] = {name: b.as_dict() for name, b
                                in self.scheduler.breakers.items()}
        out = dict(cache=self.cache.stats.as_dict(),
                   devices=self.makespan_report(),
                   inflight=len(self._inflight),
                   queues=len(self._queues),
                   graph_plans=len(self._graph_plans),
                   config=self.config_charges(),
                   recovery=recovery)
        disk = self.cache.disk
        if disk is not None:
            out["disk"] = dict(hits=disk.hits, misses=disk.misses,
                               writes=disk.writes,
                               write_errors=disk.write_errors,
                               quarantined=disk.quarantined,
                               invalidated=disk.invalidated)
        remote = self.cache.remote
        if remote is not None:
            # fleet tier dashboard: hit/miss/quarantine counters, fetch-µs
            # EWMA, hedge outcomes and per-endpoint breaker states
            out["remote"] = remote.stats_dict()
        if self.faults is not None:
            out["faults"] = self.faults.as_dict()
        if self.profiles is not None:
            out["profiles"] = self.profiles.stats_dict()
        with self._lock:
            sections = sorted(self._stats_sections.items())
        for name, provider in sections:     # outside the lock: providers
            out[name] = provider()          # may re-enter Session APIs
        return out

    # ------------------------------------------------------------ lifecycle
    def close(self, wait: bool = True) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._pool.shutdown(wait=wait)

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
