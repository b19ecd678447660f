"""OpenCL-like runtime (paper §IV: pocl on the Zynq ARM) — v2.

A minimal, faithful object model — Platform / Device / Context / Program /
Kernel / Buffer — whose Device exposes the overlay geometry to the JIT
compiler (the paper's key runtime↔compiler contract), and whose Program
objects are built *at run time* (`clBuildProgram` semantics) through
:func:`repro_torch.core.jit.jit_compile`.

The runtime owns the *resource ledger*: every built Program **debits** the
FUs and IO pads its replication plan occupies, and credits them back on
:meth:`Program.release` — so a second build genuinely sees a smaller
overlay, which is what "resource-aware" means operationally.  Reservations
(:meth:`Context.reserve`) model other logic occupying fabric (paper Fig. 5).

On top sit the serving-layer pieces:

  * :class:`repro_torch.core.cache.JITCache` — content-addressed compile cache a
    Context (or a whole Scheduler) threads through ``jit_compile``; built
    with ``persist_dir`` it write-throughs to an on-disk tier, so a
    restarted server (or a sibling worker on the host) warm-loads compiled
    artifacts in milliseconds instead of recompiling;
  * :class:`repro_torch.core.queue.CommandQueue` — in/out-of-order kernel queues
    with Event timestamps (see that module);
  * :class:`Scheduler` — multi-device placement, **queue-aware** since the
    Session API: devices are ranked by modelled makespan (engine-timeline
    end + pending reconfiguration charge + in-flight compile estimates),
    not free fabric alone; when nothing fits, the scheduler sheds replicas
    from resident programs — lowest-priority tenant first — to make room
    (time-multiplexing the FU array across tenants).

Buffers and execution.  A :class:`Buffer` holds a contiguous float32
tensor on a torch device (numpy data goes to the CUDA card unless the
caller passes ``device="cpu"``; a tensor stays where it lies), and
:meth:`Kernel.enqueue` runs the overlay executor on it: the CUDA kernel
(``csrc/overlay_exec.cu``) for CUDA tensors, its plain PyTorch version for
CPU tensors.  The outputs are new Buffers on the same device, never copied
to the host, so a command queue or a replayed graph whose kernels consume
each other's outputs stays on the device.  One input buffer reaches the
executor as a view; more are first copied into one (n_in, N) tensor on
their device, a copy of the inputs' bytes.  Each :class:`Program` keeps one
resident executor image per torch device, loaded at its first enqueue
there; when shedding or migration swaps a new artifact into the Program,
the next enqueue rewrites that image in place (the paper's
reconfiguration as a buffer write) or, when the program's signature
changed, loads a new one.  The image lives on the Program, never on the
:class:`~repro_torch.core.jit.CompiledKernel`, which the compile cache
pickles.

``use_overlay_executor`` defaults to True here, where the JAX package's
default (False) ran ``CompiledKernel.run_reference`` in numpy on the host:
on the card that would be a host path hidden inside the main path.  False
remains for parity tests on the CPU: it evaluates ``run_reference`` for
CPU buffers, and raises for buffers on any other device.

Builds may run on the Session's worker pool, so the ledger is guarded:
every Context carries a reentrant ``lock`` held across its compile+debit
and release+credit paths, and the Scheduler serializes fleet-level
placement/shedding/re-inflation under one fleet lock (lock order is always
fleet lock → context lock; ``Program.release`` takes only the context lock
and fires the re-inflation hook *after* dropping it).
"""

from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from typing import (TYPE_CHECKING, Callable, Dict, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch.core.cache import JITCache, kernel_fingerprint
from repro_torch.core.faults import DeviceLostError
from repro_torch.core.jit import CompiledKernel, jit_compile
from repro_torch.core.options import CompileOptions
from repro_torch.core.overlay import OverlaySpec
from repro_torch.core.recovery import CircuitBreaker
from repro_torch.device import DeviceLike, to_tensors

# The executor's modules (``kernels/overlay_exec``) import this package's
# ``core.program``, so they are imported where they run, not here.
if TYPE_CHECKING:                                     # pragma: no cover
    from repro_torch.kernels.overlay_exec.kernel import ExecImage

# modelled compile-time guess (µs) for a kernel the fleet has never built —
# the order of a cold template build; refined per kernel by an EWMA of
# observed build times as soon as one real build lands
DEFAULT_BUILD_EST_US = 50_000.0


class RuntimeError_(RuntimeError):
    pass


class SchedulerError(RuntimeError_):
    """No device can host the kernel, even after replica shedding."""


@dataclasses.dataclass
class Device:
    """One overlay instance living on a fabric region."""
    name: str
    spec: OverlaySpec
    # a Device is mutated through whichever Context/Scheduler reference
    # holds it, so the ledger contract is lock-NAME-based, not path-based
    fu_used: int = 0  # lock: any(lock)
    io_used: int = 0  # lock: any(lock)
    # whole-device failure (card dropped off the bus, region went dark):
    # a failed device rejects new queue submissions (DeviceLostError), is
    # excluded from scheduler ranking, and its resident Programs are
    # migrated by Scheduler.migrate_programs.  A single flag write either
    # way, so fail()/recover() are safe from any thread
    failed: bool = False
    failed_at_us: Optional[float] = None   # modelled time of failure, if any

    @property
    def fu_free(self) -> int:
        return self.spec.n_fus - self.fu_used

    @property
    def io_free(self) -> int:
        return self.spec.n_io - self.io_used

    # ------------------------------------------------------------- failure
    def fail(self, at_us: Optional[float] = None) -> None:
        """Mark the device lost (chaos harness / health monitor).  Takes
        effect immediately: the next enqueue or build targeting it raises
        :class:`~repro_torch.core.faults.DeviceLostError`."""
        self.failed = True
        self.failed_at_us = at_us

    def recover(self) -> None:
        """Bring the device back (its breaker still half-opens first, so
        returning traffic probes before it floods back)."""
        self.failed = False
        self.failed_at_us = None

    # ------------------------------------------------------------- ledger
    def debit(self, fus: int, io: int = 0) -> None:  # lock: held(lock)
        if fus > self.fu_free or io > self.io_free:
            raise RuntimeError_(
                f"{self.name}: debit of {fus} FUs / {io} IO exceeds free "
                f"{self.fu_free} FUs / {self.io_free} IO")
        self.fu_used += fus
        self.io_used += io

    def credit(self, fus: int, io: int = 0) -> None:  # lock: held(lock)
        self.fu_used = max(0, self.fu_used - fus)
        self.io_used = max(0, self.io_used - io)

    def info(self) -> Dict[str, object]:
        """CL_DEVICE_* analogue; everything the compiler needs."""
        return dict(name=self.name, width=self.spec.width,
                    height=self.spec.height, dsp_per_fu=self.spec.dsp_per_fu,
                    fu_free=self.fu_free, io_free=self.io_free,
                    fclk_mhz=self.spec.fclk_mhz,
                    peak_gops=self.spec.peak_gops())


class Platform:
    def __init__(self, devices: Optional[List[Device]] = None):
        self.devices = devices or [Device("overlay0", OverlaySpec())]

    @staticmethod
    def default() -> "Platform":
        return Platform()


class Buffer:
    """cl_mem analogue: float32 words resident on a torch device.

    ``data`` becomes a contiguous float32 tensor: numpy arrays and
    sequences go to ``device`` (default: the CUDA card), a tensor stays on
    its own device (a ``device`` that names another raises)."""

    def __init__(self, data: Union[torch.Tensor, np.ndarray, Sequence[float]],
                 device: DeviceLike = None):
        if not isinstance(data, torch.Tensor):
            data = np.ascontiguousarray(data, np.float32)
        self.data = to_tensors([data], device)[0].contiguous()

    @property
    def device(self) -> torch.device:
        return self.data.device

    def read(self) -> np.ndarray:
        """A host copy of the buffer (clEnqueueReadBuffer)."""
        return self.data.detach().cpu().numpy().copy()


class Context:
    def __init__(self, device: Optional[Device] = None,
                 cache: Optional[JITCache] = None):
        self.device = device or Platform.default().devices[0]
        self.cache = cache
        self.programs: List["Program"] = []  # lock: lock
        self.reserved_fus = 0  # lock: lock
        self.reserved_io = 0  # lock: lock
        # guards the device ledger + resident-program list: Session builds
        # run on a worker pool, and an unguarded release() racing a build
        # (or a concurrent release()) could double-credit the ledger
        self.lock = threading.RLock()
        # called with the released Program after its fabric is credited back;
        # the Scheduler hooks this to re-inflate shed programs.  Fired
        # OUTSIDE the context lock (the hook takes the fleet lock; taking it
        # under the context lock would invert the fleet→context lock order)
        self.on_release: Optional[Callable[["Program"], None]] = None
        # modelled overlay-engine timeline, shared by every CommandQueue on
        # this context: busy intervals (sorted), the configuration-switch
        # history (ascending), and the running end-of-timeline.  Queues on
        # different host threads (one per tenant under a Session) book onto
        # it under timeline_lock — a torn gap-scan would double-book the
        # engine
        self.timeline_lock = threading.RLock()
        self._engine_busy: List[tuple] = []  # lock: timeline_lock
        self._config_switches: List[tuple] = []  # lock: timeline_lock
        self._engine_end = 0.0  # lock: timeline_lock
        # modelled µs of JIT builds currently in flight toward this device
        # (booked by the Session / Scheduler under the estimator lock) —
        # the "compile-in-flight" term of the makespan ranking
        self.pending_compile_us = 0.0  # lock: any(_est_lock)

    # ----------------------------------------------------------- modelling
    @property
    def engine_end_us(self) -> float:
        """End of the device's modelled engine timeline (µs)."""
        return self._engine_end

    def projected_makespan_us(self) -> float:
        """Modelled time at which work placed on this device NOW would get
        the engine: timeline end, plus compile time of builds already in
        flight toward the device, plus the pending reconfiguration charge —
        a newly placed kernel almost always needs its own configuration
        loaded, estimated as the mean bitstream-load time of the resident
        programs (zero on a never-configured device, where the first load
        is paid wherever the kernel lands and so ranks no device apart)."""
        t = self._engine_end + self.pending_compile_us
        # snapshot: this is called lock-free from the Session's submit path
        # (book_inflight), racing releases that mutate self.programs
        progs = list(self.programs)
        if self._config_switches and progs:
            t += (sum(p.compiled.bitstream.load_time_us()
                      for p in progs) / len(progs))
        return t

    # ----------------------------------------------------------- programs
    def build_program(self, source: Union[str, Callable],
                      n_inputs: Optional[int] = None,
                      max_replicas: Optional[int] = None,
                      name: Optional[str] = None,
                      opts: Optional[CompileOptions] = None,
                      tenant: Optional[str] = None) -> "Program":
        """clBuildProgram: JIT-compile against the *currently free* overlay
        resources exposed by the device, then debit the ledger with the
        plan's FU/IO usage (credited back by :meth:`Program.release`).

        ``opts`` is the canonical way to tune the build; the loose keywords
        are a **deprecated** legacy shim folded into a CompileOptions when
        it is absent (the Session core always passes ``opts``).
        Compile + debit happen under the context lock, so the headroom a
        build plans against cannot be invalidated mid-pipeline by a
        concurrent build or release on the same device."""
        if self.device.failed:
            raise DeviceLostError(
                f"device {self.device.name} is failed; cannot build")
        if opts is None:
            warnings.warn(
                "Context.build_program(source, n_inputs=..., ...) with "
                "loose keywords is deprecated; use Session.build(source, "
                "CompileOptions(n_inputs=...), tenant=...) — see the "
                "ROADMAP 'Runtime v2' migration table",
                DeprecationWarning, stacklevel=2)
            opts = CompileOptions(n_inputs=n_inputs, name=name,
                                  max_replicas=max_replicas)
        with self.lock:
            t0 = time.perf_counter()
            ck = jit_compile(source, self.device.spec, opts=opts,
                             fu_headroom=self.device.fu_used,
                             io_headroom=self.device.io_used,
                             cache=self.cache)
            build_ms = (time.perf_counter() - t0) * 1e3
            self.device.debit(ck.plan.fus_used, ck.plan.io_used)
            prog = Program(self, ck, build_ms, source=source, opts=opts,
                           tenant=tenant)
            self.programs.append(prog)
            return prog

    def reserve(self, fus: int, io: int = 0) -> None:
        """Model 'other logic' consuming fabric (paper Fig. 5)."""
        with self.lock:
            self.device.debit(fus, io)
            self.reserved_fus += fus
            self.reserved_io += io

    def release(self, fus: int, io: int = 0) -> None:
        """Release a prior :meth:`reserve` (programs release themselves).
        Mirrors the debit-side validation: crediting more than the
        outstanding reservation would un-book fabric owned by resident
        programs and corrupt the ledger."""
        with self.lock:
            if fus > self.reserved_fus or io > self.reserved_io:
                raise RuntimeError_(
                    f"release of {fus} FUs / {io} IO exceeds outstanding "
                    f"reservation {self.reserved_fus} FUs / "
                    f"{self.reserved_io} IO")
            self.device.credit(fus, io)
            self.reserved_fus -= fus
            self.reserved_io -= io

    # -------------------------------------------------------------- queues
    def create_queue(self, in_order: bool = True,
                     use_overlay_executor: bool = True,
                     tenant: Optional[str] = None):
        from repro_torch.core.queue import CommandQueue
        return CommandQueue(self, in_order=in_order,
                            use_overlay_executor=use_overlay_executor,
                            tenant=tenant)

    def ledger_consistent(self) -> bool:
        """Invariant: device usage == reservations + resident programs."""
        with self.lock:
            fus = self.reserved_fus + sum(p.compiled.plan.fus_used
                                          for p in self.programs)
            io = self.reserved_io + sum(p.compiled.plan.io_used
                                        for p in self.programs)
            return (fus == self.device.fu_used and io == self.device.io_used
                    and 0 <= self.device.fu_used <= self.device.spec.n_fus
                    and 0 <= self.device.io_used <= self.device.spec.n_io)


class Program:
    def __init__(self, ctx: Context, ck: CompiledKernel, build_ms: float,
                 source: Union[str, Callable, None] = None,
                 opts: Optional[CompileOptions] = None,
                 tenant: Optional[str] = None):
        self.ctx = ctx
        self.compiled = ck  # lock: ctx.lock
        self.build_ms = build_ms  # lock: ctx.lock
        self.source = source
        # the exact options this program was built with — resize/re-inflate
        # rebuilds derive theirs via opts.replace(max_replicas=...)
        self.opts = opts if opts is not None else CompileOptions()
        self.tenant = tenant
        self.released = False  # lock: ctx.lock
        # sticky owner intent: release() during a scheduler resize window
        # (victim transiently non-resident, so the call no-ops) must not be
        # lost when the resize re-seats the program — the scheduler honors
        # it after the swap/restore (see Scheduler._resize)
        self.release_requested = False  # lock: ctx.lock
        # the replica count this program was first built at; shedding swaps a
        # smaller artifact into `compiled` but leaves this untouched, so the
        # scheduler knows how far to re-inflate once fabric frees up
        self.planned_replicas = ck.plan.replicas
        # free-resource level (fu, io) at the last re-inflation attempt that
        # produced no growth; retried only once more fabric than that frees
        self.grow_failed_free: Optional[tuple] = None  # lock: any(_lock)
        # torch device -> (the CompiledKernel the image was built from, its
        # resident executor image).  Keyed on the artifact's identity, so a
        # shed or migration that swaps `compiled` can never run a stale image
        self._images: Dict[torch.device,
                           Tuple[CompiledKernel, "ExecImage"]] = {}  # lock: _image_lock
        self._image_lock = threading.Lock()

    def create_kernel(self) -> "Kernel":
        if self.released:
            raise RuntimeError_("program was released")
        return Kernel(self)

    def configure_overlay(self) -> float:
        """'Load the bitstream': returns modelled config time in µs."""
        return self.compiled.bitstream.load_time_us()

    def execute(self, x: torch.Tensor) -> torch.Tensor:
        """Run the current artifact over ``x`` (n_in, N) on the executor
        image of ``x``'s device: loaded at the first enqueue there and
        reused after.  When the artifact is not the one the image was built
        from (shedding or migration swapped it in), the image is rewritten
        in place if the program's signature allows, else a new one is
        loaded.  The artifact is read, and the launch made, under the image
        lock, so no launch can rewrite the image to an artifact that was
        swapped out."""
        from repro_torch.kernels.overlay_exec.kernel import overlay_execute
        from repro_torch.kernels.overlay_exec.ops import resident_image
        with self._image_lock:
            ck = self.compiled
            entry = self._images.get(x.device)
            if entry is None or entry[0] is not ck:
                img = resident_image(
                    ck.program, x.device,
                    entry[1] if entry is not None else None)
                entry = self._images[x.device] = (ck, img)
            return overlay_execute(entry[1], x)

    def _take_images(self) -> Dict:
        with self._image_lock:
            images, self._images = self._images, {}
            return images

    def _keep_images(self, images: Dict) -> None:
        """Re-seat images taken before a scheduler's administrative
        release: the next enqueue rewrites them for the new artifact."""
        with self._image_lock:
            self._images = images

    def release(self) -> None:
        """Credit the program's FUs/IO back to the device ledger.

        Idempotent AND atomic: the released check-and-set happens under the
        context's ledger lock, so two threads racing on release() (an owner
        disconnecting while the scheduler resizes the same program on a
        worker thread) cannot both credit the fabric back.  The scheduler's
        re-inflation hook fires after the lock is dropped — it takes the
        fleet lock, which must never be acquired under a context lock."""
        with self.ctx.lock:
            self.release_requested = True
            if self.released:
                return
            self.released = True
            self._take_images()
            self.ctx.device.credit(self.compiled.plan.fus_used,
                                   self.compiled.plan.io_used)
            if self in self.ctx.programs:
                self.ctx.programs.remove(self)
            hook = self.ctx.on_release
        if hook is not None:
            hook(self)

    def __enter__(self) -> "Program":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class Kernel:
    def __init__(self, program: Program):
        self.program = program
        self.args: List[Buffer] = []

    def set_args(self, *buffers: Buffer) -> "Kernel":
        self.args = list(buffers)
        return self

    @property
    def work_items(self) -> int:
        return int(self.args[0].data.numel()) if self.args else 1

    def enqueue(self, use_overlay_executor: bool = True):
        """clEnqueueNDRangeKernel: run over all work-items of the buffers.

        Runs the overlay executor on the program's resident image for the
        buffers' device; returns new Buffers on that device.  With
        ``use_overlay_executor=False`` (parity tests only) the numpy
        ``run_reference`` computes the outputs instead, for CPU buffers
        only: buffers on another device raise."""
        if self.program.released:
            raise RuntimeError_(
                "kernel's program was released; its fabric may already be "
                "occupied by another program")
        ck = self.program.compiled
        ins = [b.data for b in self.args]
        if len(ins) != len(ck.dfg.inputs):
            raise RuntimeError_(
                f"kernel expects {len(ck.dfg.inputs)} buffers, got {len(ins)}")
        shape, dev = ins[0].shape, ins[0].device
        if any(t.device != dev or t.shape != shape for t in ins):
            raise RuntimeError_(
                f"kernel buffers must share one device and shape; got "
                f"{[(str(t.device), tuple(t.shape)) for t in ins]}")
        if not use_overlay_executor:
            if dev.type != "cpu":
                raise RuntimeError_(
                    f"use_overlay_executor=False runs run_reference in numpy "
                    f"on the host and takes CPU buffers only; these lie on "
                    f"{dev}")
            outs = ck.run_reference(*[b.read() for b in self.args])
            outs = outs if isinstance(outs, tuple) else (outs,)
            return tuple(Buffer(torch.from_numpy(np.array(o, np.float32)))
                         for o in outs)
        # one input is a view; more are copied into one (n_in, N) tensor
        x = ins[0].reshape(1, -1) if len(ins) == 1 else \
            torch.stack([t.reshape(-1) for t in ins])
        out = self.program.execute(x)
        return tuple(Buffer(row.reshape(shape)) for row in out)


# ================================================================ scheduler

class Scheduler:
    """Resource-aware placement of incoming kernels onto a device fleet.

    Placement is **queue-aware** (``policy="makespan"``, the default):
    candidate devices are ranked by :meth:`Context.projected_makespan_us` —
    modelled engine-timeline end, plus the estimated compile time of builds
    already in flight toward the device, plus the pending reconfiguration
    charge — with free fabric only as the tie-break.  An idle fleet
    therefore ranks exactly like the historical best-fit-by-free-fabric
    policy (``policy="free_fabric"``, kept for comparison and the
    ``benchmarks/queue_sched_perf.py`` gate), but a fleet with deep queues
    routes new tenants *around* the backlog instead of piling onto the
    device that merely has the most free FUs.

    When *no* device can host even a single replica, the scheduler frees
    fabric by halving the replica count of a resident program and retries —
    multi-tenant time multiplexing of the FU array.  Victims are chosen
    lowest :meth:`tenant priority <set_priority>` first (then busiest
    device, then largest footprint), so paying tenants degrade last.

    Shedding is symmetric: every ``Program.release()`` triggers
    :meth:`reinflate`, which grows shed programs back toward the replica
    count they were first built at.  Both directions swap the new artifact
    into the owner's existing Program handle exception-safely, and both are
    re-stamps of the cached P&R template (no place/route stage runs) when
    the template path applies.

    Fleet-level mutation (ranking snapshots, shedding, re-inflation) is
    serialized under one reentrant fleet lock; each device's compile+debit
    and release+credit run under that context's own ledger lock, so builds
    bound for DIFFERENT devices overlap while two builds racing onto one
    device serialize and the second re-plans against the first's debit.
    Lock order is fleet lock → context lock, never the reverse.
    """

    POLICIES = ("makespan", "free_fabric")

    def __init__(self, devices: Sequence[Device],
                 cache: Optional[JITCache] = None,
                 persist_dir: Optional[str] = None,
                 policy: str = "makespan"):
        if not devices:
            raise ValueError("scheduler needs at least one device")
        if cache is not None and persist_dir is not None:
            raise ValueError(
                "pass persist_dir OR an explicit cache (construct the cache "
                "with JITCache(persist_dir=...) to combine them)")
        if policy not in self.POLICIES:
            raise ValueError(f"policy must be one of {self.POLICIES}, "
                             f"got {policy!r}")
        self.cache = cache if cache is not None else \
            JITCache(persist_dir=persist_dir)
        self.policy = policy
        self.contexts: Dict[str, Context] = {
            d.name: Context(d, cache=self.cache) for d in devices}
        # tenant -> priority (higher keeps replicas longer); unknown
        # tenants (and None) rank at 0
        self.priorities: Dict[str, int] = {}  # lock: _lock
        # kernel fingerprint -> EWMA of observed build time (µs); feeds the
        # compile-in-flight term of the makespan ranking.  Guarded by its
        # own small lock, NOT the fleet lock: Session.compile books its
        # estimate at submit time and must never block behind a build that
        # is holding the fleet lock for a full pipeline run
        self._build_est: Dict[str, float] = {}  # lock: _est_lock
        self._est_lock = threading.Lock()
        self._lock = threading.RLock()
        # per-device circuit breakers (repro_torch.core.recovery): consecutive
        # device-attributable failures open one, excluding the device from
        # ranking until its cooldown half-opens it for probe traffic.  The
        # dict itself is immutable after construction (keyed identically to
        # contexts); each breaker is internally locked
        self.breakers: Dict[str, CircuitBreaker] = {
            d.name: CircuitBreaker() for d in devices}
        # guards against recursive rebalancing: shedding and re-inflation
        # both release() programs mid-flight, which must not re-trigger the
        # release hook (only ever read/written under the fleet lock)
        self._rebalancing = False  # lock: _lock
        for ctx in self.contexts.values():
            ctx.on_release = self._on_release

    @property
    def devices(self) -> List[Device]:
        return [c.device for c in self.contexts.values()]

    def set_priority(self, tenant: str, priority: int) -> None:
        """Higher-priority tenants are shed last when the fleet is full."""
        with self._lock:
            self.priorities[tenant] = priority

    def configure_breakers(self, threshold: int, cooldown_s: float) -> None:
        """Re-arm every device breaker with the given policy (the Session
        applies its RetryPolicy here at construction)."""
        with self._lock:
            self.breakers = {name: CircuitBreaker(threshold, cooldown_s)
                             for name in self.contexts}

    def partition_spec(self) -> OverlaySpec:
        """The overlay geometry graph partitioning plans against: the
        roomiest device's spec (by FU count, then IO).  A partition must fit
        SOME device with at least one replica; which device actually hosts
        it — and at how many replicas — is decided per partition at build
        time by the ordinary placement/replication path."""
        ctx = max(self.contexts.values(),
                  key=lambda c: (c.device.spec.n_fus, c.device.spec.n_io))
        return ctx.device.spec

    # -------------------------------------------------------------- ranking
    def _ranked(self, exclude: Optional[Tuple[Context, float]] = None
                ) -> List[Context]:
        """Candidate devices, best first, per the placement policy.

        ``exclude`` backs a build's OWN in-flight booking out of the
        ranking — otherwise the estimate a build posted for itself would
        push that same build off its favoured device.

        Failed devices and devices whose breaker is open (still cooling
        down) are excluded entirely; a device whose breaker is half-open or
        mid-count ranks after every healthy one, so probe traffic reaches
        it only when the healthy fleet is the worse choice or a probe is
        due — on an all-healthy fleet the ranking is unchanged."""
        ctxs = [c for c in self.contexts.values()
                if not c.device.failed
                and self.breakers[c.device.name].allows()]
        if self.policy == "free_fabric":
            return sorted(ctxs, key=lambda c: (c.device.fu_free,
                                               c.device.io_free),
                          reverse=True)

        def key(c: Context):
            t = c.projected_makespan_us()
            if exclude is not None and c is exclude[0]:
                t -= exclude[1]
            return (0 if self.breakers[c.device.name].closed else 1,
                    t, -c.device.fu_free, -c.device.io_free)
        return sorted(ctxs, key=key)

    # --------------------------------------------- in-flight compile model
    def estimate_build_us(self, fingerprint: str) -> float:
        """Modelled compile time for a kernel (EWMA of past builds)."""
        with self._est_lock:
            return self._build_est.get(fingerprint, DEFAULT_BUILD_EST_US)

    def _note_build_us(self, fingerprint: str, us: float) -> None:
        with self._est_lock:
            prev = self._build_est.get(fingerprint)
            self._build_est[fingerprint] = \
                us if prev is None else 0.5 * prev + 0.5 * us

    def book_inflight(self, fingerprint: str) -> Tuple[Context, float]:
        """Charge a build's estimated compile time to the device the
        ranking currently favours; the Session books this at submit time so
        *later* submissions see the queued compile in the makespan model.
        Returns a token for :meth:`release_inflight`.

        The ranking read here is advisory (a placement *hint*, re-ranked
        for real inside :meth:`build_opts`), so it deliberately skips the
        fleet lock — booking must not block behind a build that is holding
        it for a full pipeline run."""
        est = self.estimate_build_us(fingerprint)
        ranked = self._ranked()
        if ranked:
            ctx = ranked[0]
        else:
            # every device failed or breaker-open: book against the least
            # loaded anyway — the booking is advisory, and the build itself
            # will fail (or a breaker will half-open) with a real error
            ctx = min(self.contexts.values(),
                      key=lambda c: c.projected_makespan_us())
        with self._est_lock:
            ctx.pending_compile_us += est
        return ctx, est

    def release_inflight(self, token: Tuple[Context, float]) -> None:
        ctx, est = token
        with self._est_lock:
            ctx.pending_compile_us = max(0.0, ctx.pending_compile_us - est)

    # ------------------------------------------------------------ placement
    def build(self, source: Union[str, Callable],
              n_inputs: Optional[int] = None,
              name: Optional[str] = None,
              max_replicas: Optional[int] = None,
              max_shed_rounds: int = 8) -> Program:
        """**Deprecated** legacy entry point — a thin shim folding the loose
        knobs into a :class:`CompileOptions` and delegating to
        :meth:`build_opts` (the Session core), so both paths exercise one
        implementation.  New code wants
        ``Session.compile(source, CompileOptions(...)).result()``."""
        warnings.warn(
            "Scheduler.build(source, max_replicas=...) is deprecated; use "
            "Session.compile(source, CompileOptions(max_replicas=...))"
            ".result() or Scheduler.build_opts — see the ROADMAP "
            "'Runtime v2' migration table",
            DeprecationWarning, stacklevel=2)
        return self.build_opts(
            source, CompileOptions(n_inputs=n_inputs, name=name,
                                   max_replicas=max_replicas),
            max_shed_rounds=max_shed_rounds)

    def build_opts(self, source: Union[str, Callable],
                   opts: Optional[CompileOptions] = None,
                   tenant: Optional[str] = None,
                   max_shed_rounds: int = 8,
                   inflight: Optional[Tuple[Context, float]] = None,
                   fingerprint: Optional[str] = None) -> Program:
        """Place + JIT-build ``source`` on the best device per the placement
        policy; returns the resident Program (release() it to free fabric).
        This is the core every entry point funnels into — ``Session.compile``
        submits it to the worker pool, :meth:`build` calls it inline.

        ``inflight`` is the booking token the Session posted at submit time
        (see :meth:`book_inflight`); it is excluded from this build's own
        ranking and stays booked until the Session releases it.
        ``fingerprint`` passes the caller's already-computed
        ``kernel_fingerprint`` (the EWMA namespace) so a python callable is
        not traced a second time just for the estimate key."""
        from repro_torch.core.jit import lower_to_dfg
        from repro_torch.core.latency import LatencyError
        from repro_torch.core.place import PlacementError
        from repro_torch.core.route import RoutingError

        opts = opts if opts is not None else CompileOptions()
        # EWMA key: the SAME namespace Session.compile books estimates
        # under, computed before lowering so str sources stay hash-only
        fp = fingerprint if fingerprint is not None else \
            kernel_fingerprint(source, n_inputs=opts.n_inputs,
                               name=opts.name)
        # lower to a DFG once: each per-device placement probe (and every
        # shed retry) reuses it instead of re-parsing / re-tracing.  Done
        # OUTSIDE the fleet lock — only ranking and shedding serialize;
        # per-device compile+debit is guarded by each context's own lock,
        # so builds bound for different devices overlap
        source = lower_to_dfg(source, opts.n_inputs, opts.name,
                              parse_source=True)

        last_err: Optional[Exception] = None
        for _ in range(max_shed_rounds + 1):
            with self._lock:
                order = self._ranked(exclude=inflight)
            for ctx in order:
                try:
                    prog = ctx.build_program(source, opts=opts,
                                             tenant=tenant)
                    self._note_build_us(fp, prog.build_ms * 1e3)
                    # a completed build is evidence the device is healthy:
                    # resets the breaker's consecutive count, closes a
                    # half-open breaker whose probe this was
                    self.breakers[ctx.device.name].record_success()
                    return prog
                except (PlacementError, RoutingError, LatencyError) as e:
                    # genuine mapping failure: deterministic, NOT device
                    # health — never counted against the breaker
                    last_err = e
                    self.cache.note_build_failure()
                except DeviceLostError as e:
                    # the device dropped between ranking and build: count
                    # it and try the next candidate
                    last_err = e
                    self.breakers[ctx.device.name].record_failure()
            if not self._shed_one():
                break
        if not self._ranked(exclude=inflight):
            raise SchedulerError(
                f"no device available (fleet of {len(self.contexts)} all "
                f"failed or breaker-open); last error: {last_err}")
        raise SchedulerError(
            f"kernel fits on no device (fleet of {len(self.contexts)}); "
            f"last error: {last_err}")

    def _shed_one(self) -> bool:
        """Halve the replicas of one resident program to make room.  The
        victim is the lowest-priority tenant's program (ties: busiest
        device, then largest FU footprint) — equal- or higher-priority
        programs are still sheddable as a last resort, so an unprioritized
        fleet behaves exactly as before and a full fleet always yields
        SOME fabric rather than failing the request.  Returns False when
        nothing sheddable remains (or the shed rebuild itself fails, in
        which case the victim is restored)."""
        with self._lock:
            candidates = [(p, ctx) for ctx in self.contexts.values()
                          for p in ctx.programs
                          if p.compiled.plan.replicas > 1]
            if not candidates:
                return False
            victim, ctx = min(
                candidates,
                key=lambda pc: (self.priorities.get(pc[0].tenant, 0),
                                -pc[1].device.fu_used,
                                -pc[0].compiled.plan.fus_used))
            target = max(1, victim.compiled.plan.replicas // 2)
            return self._resize(victim, ctx, target, require_growth=False)

    # -------------------------------------------------------- re-inflation
    def _on_release(self, _prog: Program) -> None:
        """Release hook: freed fabric is an opportunity to grow shed
        programs back toward their planned replica count.  Takes the fleet
        lock first, so a hook firing on one thread while another thread is
        mid-shed waits for the shed to finish instead of interleaving."""
        with self._lock:
            if not self._rebalancing:
                self.reinflate()

    def reinflate(self) -> int:
        """Re-stamp shed programs back toward their planned replica counts
        (ROADMAP open item).  With the P&R template cached, each growth is a
        re-stamp — no place/route stage runs.  Returns programs grown."""
        with self._lock:
            grown = 0
            while self._reinflate_one():
                grown += 1
            return grown

    def _reinflate_one(self) -> bool:
        candidates = [(p, ctx) for ctx in self.contexts.values()
                      for p in ctx.programs
                      if p.planned_replicas > p.compiled.plan.replicas
                      and self._growth_fits(p, ctx)]
        # most-shed first, so the worst-degraded tenant recovers first
        candidates.sort(key=lambda pc: (pc[0].planned_replicas -
                                        pc[0].compiled.plan.replicas),
                        reverse=True)
        for victim, ctx in candidates:
            if self._resize(victim, ctx, victim.planned_replicas,
                            require_growth=True):
                return True
        return False

    @staticmethod
    def _growth_fits(p: Program, ctx: Context) -> bool:
        """Cheap pre-check: could ``p`` rebuild at even one more replica once
        its own fabric is freed?  Skips the speculative release/recompile/
        restore cycle for hopeless candidates (each would otherwise cost a
        full P&R when the template path doesn't apply).  A candidate whose
        last growth attempt failed (e.g. P&R congestion despite a fitting
        ledger) is retried only once MORE fabric is free than back then."""
        plan, fug = p.compiled.plan, p.compiled.fug
        free_fus = ctx.device.fu_free + plan.fus_used
        free_io = ctx.device.io_free + plan.io_used
        if (plan.replicas + 1) * fug.n_fus > free_fus or \
                (plan.replicas + 1) * fug.n_io > free_io:
            return False
        if p.grow_failed_free is not None and \
                ctx.device.fu_free <= p.grow_failed_free[0] and \
                ctx.device.io_free <= p.grow_failed_free[1]:
            return False
        return True

    def _resize(self, victim: Program, ctx: Context, target: int,
                require_growth: bool) -> bool:
        """Rebuild ``victim`` at ``max_replicas=target`` and swap the new
        artifact into the owner's handle, exception-safely: on any failure
        (or, for re-inflation, no actual growth) the victim's residency and
        ledger debit are restored unchanged.

        Runs entirely under the fleet lock, and holds the device's ledger
        lock from the victim's release through the rebuild to the swap or
        the restore: the fabric the release frees stays this resize's, so
        another thread's ``Context.build_program`` on the device (which
        takes only that lock) waits and plans against the ledger as the
        resize leaves it, and ``restore()``'s re-debit always fits (an
        unguarded window let such a build take the fabric and made the
        re-debit raise).  A concurrent ``Program.release()`` of the same
        victim either completes before the resize starts or blocks until
        the victim is resident again — it can never double-credit the
        ledger in between.  The release hook our own releases fire takes
        the fleet lock this thread already holds, so holding the ledger
        lock there inverts no order.
        """
        from repro_torch.core.latency import LatencyError
        from repro_torch.core.place import PlacementError
        from repro_torch.core.route import RoutingError
        with self._lock:
            old = victim.compiled
            prev = self._rebalancing
            self._rebalancing = True

            images: Dict = {}

            def restore() -> None:
                # restore the victim's residency rather than destroying a
                # tenant's program — its fabric is free again at this point,
                # so the re-debit holds
                with ctx.lock:
                    ctx.device.debit(old.plan.fus_used, old.plan.io_used)
                    victim.released = False
                    victim._keep_images(images)
                    ctx.programs.append(victim)

            try:
                with ctx.lock:
                    if victim.released:
                        return False        # the owner beat us to it
                    images = victim._take_images()
                    victim.release()
                    # that was OUR administrative release; a True from here
                    # on means the owner asked for release mid-resize
                    victim.release_requested = False
                    rebuilt: Optional[Program] = None
                    try:
                        rebuilt = ctx.build_program(
                            victim.source,
                            opts=victim.opts.replace(max_replicas=target),
                            tenant=victim.tenant)
                    except (PlacementError, RoutingError, LatencyError):
                        pass
                    except BaseException:
                        # unexpected rebuild failure must still restore the
                        # tenant before propagating (the failed build
                        # debited nothing)
                        restore()
                        raise
                    if rebuilt is None or (require_growth and
                                           rebuilt.compiled.plan.replicas <=
                                           old.plan.replicas):
                        if rebuilt is not None:  # too-small rebuild: free it
                            rebuilt.release()
                        restore()
                        if require_growth:
                            victim.grow_failed_free = (ctx.device.fu_free,
                                                       ctx.device.io_free)
                        return False
                    # swap the artifact into the victim in place: handles
                    # the owner already holds stay valid and resident (its
                    # images stay: keyed on the old artifact, the next
                    # enqueue rewrites them for the new one)
                    victim.compiled = rebuilt.compiled
                    victim.build_ms = rebuilt.build_ms
                    victim.released = False
                    victim.grow_failed_free = None
                    victim._keep_images(images)
                    ctx.programs[ctx.programs.index(rebuilt)] = victim
                    return True
            finally:
                # honor a release the owner requested while the victim was
                # transiently non-resident (their call no-op'd on the
                # released flag): drop the re-seated program now.  The
                # rebalance flag is restored FIRST so the release's hook
                # can offer the freed fabric to shed programs (when this
                # resize is itself part of a reinflate pass, prev is True
                # and the enclosing loop picks the fabric up instead)
                with ctx.lock:
                    pending = (victim.release_requested
                               and not victim.released)
                self._rebalancing = prev
                if pending:
                    victim.release()

    # ------------------------------------------------------------ migration
    def migrate_programs(self, name: str) -> Tuple[int, int]:
        """Evacuate every resident Program of device ``name`` (failed or
        breaker-tripped) onto the healthy fleet, swapping each rebuilt
        artifact into the owner's existing handle exactly like
        :meth:`_resize` — handles tenants hold stay valid, now pointing at
        a Program resident elsewhere.  Rebuilds go through the shared cache,
        so a warm fleet migrates by re-stamp/disk-load, not full P&R.

        Returns ``(migrated, lost)``; a program is lost when no healthy
        device can host even one replica (it stays released — its fabric on
        the dead device was already credited back, and the owner sees the
        standard released-program error on next use).

        Runs under the fleet lock with ``_rebalancing`` set, so release
        hooks fired by our own administrative releases don't recurse into
        re-inflation mid-migration.  Unlike :meth:`_resize` it needs no
        ledger lock across the rebuild: a victim that finds no host stays
        released, so nothing re-debits the source device, and the rebuild's
        debit on its new device is made under that device's lock."""
        from repro_torch.core.latency import LatencyError
        from repro_torch.core.place import PlacementError
        from repro_torch.core.route import RoutingError
        with self._lock:
            if name not in self.contexts:
                raise ValueError(f"unknown device {name!r}")
            src = self.contexts[name]
            victims = list(src.programs)
            prev = self._rebalancing
            self._rebalancing = True
            migrated = lost = 0
            try:
                for victim in victims:
                    ctx = src
                    with ctx.lock:
                        if victim.released:
                            continue
                        images = victim._take_images()
                        victim.release()
                        # that was OUR administrative release; True from
                        # here on means the owner asked mid-migration
                        victim.release_requested = False
                    rebuilt: Optional[Program] = None
                    for ctx in self._ranked():
                        if ctx is src:
                            continue
                        try:
                            rebuilt = ctx.build_program(
                                victim.source, opts=victim.opts,
                                tenant=victim.tenant)
                            break
                        except (PlacementError, RoutingError, LatencyError,
                                DeviceLostError):
                            continue
                    if rebuilt is None:
                        lost += 1
                        continue
                    ctx = rebuilt.ctx
                    with ctx.lock:
                        victim.compiled = rebuilt.compiled
                        victim.build_ms = rebuilt.build_ms
                        victim.ctx = ctx
                        victim.released = False
                        victim.grow_failed_free = None
                        victim._keep_images(images)
                        ctx.programs[ctx.programs.index(rebuilt)] = victim
                        pending = victim.release_requested
                    migrated += 1
                    if pending:
                        victim.release()
            finally:
                self._rebalancing = prev
            return migrated, lost

    # ----------------------------------------------------------- inspection
    def ledger(self) -> Dict[str, Dict[str, int]]:
        return {name: dict(fu_used=c.device.fu_used,
                           fu_free=c.device.fu_free,
                           io_used=c.device.io_used,
                           io_free=c.device.io_free,
                           programs=len(c.programs))
                for name, c in self.contexts.items()}

    def makespan_report(self) -> Dict[str, Dict[str, float]]:
        """Per-device view of the quantities the makespan ranking consumes
        (serving dashboards + ``benchmarks/queue_sched_perf.py``)."""
        return {name: dict(engine_end_us=c.engine_end_us,
                           pending_compile_us=c.pending_compile_us,
                           projected_makespan_us=c.projected_makespan_us(),
                           programs=len(c.programs))
                for name, c in self.contexts.items()}

    def ledger_consistent(self) -> bool:
        return all(c.ledger_consistent() for c in self.contexts.values())
