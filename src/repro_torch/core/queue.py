"""Command queues with events — clCommandQueue/clEvent for the overlay.

Execution is *functionally* eager (each enqueue launches the overlay
executor on the current CUDA stream at once, or runs its plain version on
CPU buffers; outputs are device Buffers) but carries a **modelled device
timeline** in microseconds, the same way the latency/bitstream modules model
hardware time.  The timestamps are the model's, never CUDA event times:

  queued  → the host submits the kernel (t_queued_us);
  submit  → all wait-events have completed and the device engine is free
            (t_submit_us);
  config  → if the kernel's bitstream differs from what is loaded on the
            overlay, a configuration load is charged at the paper's ~25 MB/s
            AXI rate (config_us; the 42 µs partial-reconfiguration analogue —
            back-to-back enqueues of the *same* program pay it once);
  exec    → pipeline fill + one work-item per replica per cycle at fclk
            (t_start_us … t_end_us).

An **in-order** queue serializes: each command implicitly waits on the one
enqueued before it.  An **out-of-order** queue respects only the explicit
``wait_for`` event list (and any barrier) and may backfill idle gaps in the
device timeline — many tenants can batch kernels against one overlay and the
short ones slot between the long ones.  Backfill is only allowed when the
configuration *active at that point of the timeline* already matches the
kernel's; a kernel needing a different configuration appends to the end of
the timeline, because loading its bitstream earlier would rewrite the config
history that already-scheduled kernels observed.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import math
from typing import List, Optional, Sequence, Tuple, TYPE_CHECKING

from repro_torch.core.faults import DeviceLostError, fault_point
from repro_torch.obs.trace import active_tracer

if TYPE_CHECKING:                                     # pragma: no cover
    from repro_torch.core.runtime import Buffer, Context, Kernel


@dataclasses.dataclass
class Event:
    """cl_event analogue: modelled timestamps (µs) + the kernel's outputs."""
    kernel_name: str
    t_queued_us: float
    t_submit_us: float = 0.0
    config_us: float = 0.0
    t_start_us: float = 0.0
    t_end_us: float = 0.0
    status: str = "queued"            # queued | complete
    outputs: Optional[Tuple["Buffer", ...]] = None
    deps: Tuple["Event", ...] = ()

    # --------------------------------------------------------------- timing
    @property
    def queue_delay_us(self) -> float:
        """Time spent waiting on dependencies + the device engine."""
        return self.t_submit_us - self.t_queued_us

    @property
    def exec_us(self) -> float:
        return self.t_end_us - self.t_start_us

    @property
    def latency_us(self) -> float:
        """End-to-end: enqueue → completion."""
        return self.t_end_us - self.t_queued_us

    def wait(self) -> Optional[Tuple["Buffer", ...]]:
        if self.status != "complete":
            raise RuntimeError(f"event for {self.kernel_name} incomplete")
        return self.outputs


def user_event(t_end_us: float, name: str = "user") -> Event:
    """A pre-completed event at an arbitrary modelled time — lets tests and
    clients express 'data ready at T' dependencies (clCreateUserEvent)."""
    return Event(kernel_name=name, t_queued_us=0.0, t_submit_us=t_end_us,
                 t_start_us=t_end_us, t_end_us=t_end_us, status="complete")


class CommandQueue:
    """One submission stream onto a device's overlay engine.

    Multiple queues may target the same :class:`~repro_torch.core.runtime.Context`;
    they share the device's engine timeline through the context's device
    object (``_engine_busy`` intervals live on the queue's context).
    """

    def __init__(self, context: "Context", in_order: bool = True,
                 use_overlay_executor: bool = True,
                 tenant: Optional[str] = None):
        self.ctx = context
        self.device = context.device
        self.in_order = in_order
        self.use_overlay_executor = use_overlay_executor
        # which tenant's submission stream this is (the Session keeps one
        # queue per (tenant, device)); purely a label for profiles/dashboards
        self.tenant = tenant
        self.events: List[Event] = []
        self._last_event: Optional[Event] = None
        self._fence: Optional[Event] = None    # last barrier, both flavours

    # ------------------------------------------------------------ modelling
    @staticmethod
    def _config_id(ck) -> str:
        # memoized on the CompiledKernel: the bitstream is immutable and this
        # sits on the per-enqueue hot path
        cid = getattr(ck, "_config_id", None)
        if cid is None:
            cid = hashlib.sha256(ck.bitstream.data).hexdigest()[:16]
            ck._config_id = cid
        return cid

    def _exec_model_us(self, ck, n_items: int) -> float:
        """Pipeline fill + (items / replicas) issue cycles at fclk."""
        replicas = max(1, ck.plan.replicas)
        cycles = ck.latency.pipeline_depth + math.ceil(n_items / replicas)
        return cycles / self.device.spec.fclk_mhz

    def _earliest_gap(self, ready_us: float, dur_us: float) -> float:
        """Earliest t >= ready_us where the engine is idle for dur_us.
        _engine_busy is kept sorted by insort; the scan is linear in the
        number of intervals at/after ready."""
        t = ready_us
        for (s, e) in self.ctx._engine_busy:
            if t + dur_us <= s:
                break
            if e > t:
                t = e
        return t

    def _active_config_at(self, t_us: float) -> Optional[str]:
        """Configuration loaded on the overlay at modelled time t_us.
        _config_switches is append-only ascending, so bisect applies."""
        switches = self.ctx._config_switches
        i = bisect.bisect_right(switches, (t_us, "￿"))
        return switches[i - 1][1] if i else None

    def _timeline_end(self) -> float:
        # busy intervals are appended/insorted with monotone end for appends;
        # a backfill never extends past an existing interval, so the running
        # max on the context is authoritative
        return self.ctx._engine_end

    # ------------------------------------------------------------- enqueue
    def enqueue_kernel(self, kernel: "Kernel",
                       wait_for: Sequence[Event] = (),
                       label: Optional[str] = None) -> Event:
        """Submit a kernel; returns its Event (already functionally complete,
        with modelled timestamps).  ``label`` overrides the event's kernel
        name — graph replay tags each fused partition launch with its
        partition identity so profiles stay readable."""
        from repro_torch.core.runtime import RuntimeError_
        if kernel.program.released:
            # reject before booking engine time: the program's fabric may
            # already belong to another tenant
            raise RuntimeError_(
                f"cannot enqueue {kernel.program.compiled.name}: program "
                f"was released")
        if kernel.program.ctx is not self.ctx:
            # a foreign program would be timed with this device's clock and
            # recorded in this device's config history — silently wrong
            raise RuntimeError_(
                f"kernel {kernel.program.compiled.name} was built on "
                f"{kernel.program.ctx.device.name}, not this queue's "
                f"{self.device.name}")
        if self.device.failed:
            # a lost device rejects new work before any side effect; the
            # Session's healing loop migrates the program and re-routes
            raise DeviceLostError(
                f"device {self.device.name} is failed; cannot enqueue "
                f"{kernel.program.compiled.name}")
        ck = kernel.program.compiled
        # chaos boundaries sit BEFORE the kernel runs and the timeline is
        # booked, so an injected submit/exec fault leaves no phantom busy
        # interval behind and a retry starts clean
        fault_point("queue_submit", ck.name)
        deps = tuple(wait_for)
        if self._fence is not None and self._fence not in deps:
            deps = deps + (self._fence,)
        if self.in_order and self._last_event is not None:
            deps = deps + (self._last_event,)

        # run (and thereby validate) the kernel BEFORE booking the shared
        # timeline: a failed enqueue must not leave a phantom busy interval
        # or config switch behind
        fault_point("device_exec", ck.name)
        outputs = kernel.enqueue(
            use_overlay_executor=self.use_overlay_executor)

        t_queued = 0.0
        ready = max([d.t_end_us for d in deps], default=0.0)

        config_id = self._config_id(ck)
        exec_us = self._exec_model_us(ck, kernel.work_items)
        # gap scan + booking are one atomic step: per-tenant queues run on
        # independent host threads under a Session, and a torn scan would
        # let two kernels claim the same idle gap
        with self.ctx.timeline_lock:
            t_backfill = self._earliest_gap(ready, exec_us)
            if self._active_config_at(t_backfill) == config_id:
                # the overlay already holds this configuration at that
                # point of the timeline: slot in, no reconfiguration
                t_submit, config_us = t_backfill, 0.0
            else:
                # loading a bitstream mid-history would invalidate the
                # config every later-scheduled kernel observed — append to
                # the end, where a matching live config still costs nothing
                t_submit = max(ready, self._timeline_end())
                if self._active_config_at(t_submit) == config_id:
                    config_us = 0.0
                else:
                    config_us = ck.bitstream.load_time_us()
                    self.ctx._config_switches.append((t_submit, config_id))
            dur = config_us + exec_us
            bisect.insort(self.ctx._engine_busy, (t_submit, t_submit + dur))
            self.ctx._engine_end = max(self.ctx._engine_end, t_submit + dur)

        ev = Event(kernel_name=label if label is not None else ck.name,
                   t_queued_us=t_queued,
                   t_submit_us=t_submit, config_us=config_us,
                   t_start_us=t_submit + config_us,
                   t_end_us=t_submit + dur,
                   status="complete", outputs=outputs, deps=deps)
        # retained so the Session can re-enqueue this command elsewhere if
        # the device is lost mid-trace (recovery: requeued_events)
        ev._kernel = kernel
        self.events.append(ev)
        self._last_event = ev
        tr = active_tracer()
        if tr is not None:
            # project the modelled device timeline into the trace: one
            # track per (device, tenant) submission stream, with the queue
            # wait, the config charge and the execution window as separate
            # slices at their *modelled* µs coordinates
            track = f"dev:{self.device.name}" + \
                (f"/{self.tenant}" if self.tenant else "")
            if t_submit > ready:
                # deps were done at `ready` but the engine (or a config
                # boundary) held the kernel back until t_submit
                tr.add_modelled(f"wait:{ev.kernel_name}", track, ready,
                                t_submit - ready, cat="queue",
                                gap_us=ev.queue_delay_us)
            if config_us > 0.0:
                tr.add_modelled(f"config:{ev.kernel_name}", track,
                                t_submit, config_us, cat="device",
                                config_id=config_id)
            tr.add_modelled(ev.kernel_name, track, ev.t_start_us, exec_us,
                            cat="device", items=kernel.work_items,
                            replicas=ck.plan.replicas)
        return ev

    def enqueue_barrier(self) -> Event:
        """All later commands wait for everything enqueued so far (both queue
        flavours)."""
        t = self.finish()
        ev = Event(kernel_name="barrier", t_queued_us=0.0, t_submit_us=t,
                   t_start_us=t, t_end_us=t, status="complete",
                   deps=tuple(self.events))
        self.events.append(ev)
        self._last_event = ev
        self._fence = ev
        return ev

    # ------------------------------------------------------------ inspection
    def finish(self) -> float:
        """clFinish: modelled time at which every enqueued command is done."""
        return max((e.t_end_us for e in self.events), default=0.0)

    def drain(self) -> List[Event]:
        """Hand back and forget the retained events, and compact the shared
        engine timeline.  Long-running serving loops should drain
        periodically — the queue keeps every Event alive for
        profile()/throughput otherwise.  Dependency links on the drained
        events are severed so the chain of implicit in-order deps (and
        barrier deps) cannot keep every past Event and its output buffers
        transitively reachable through _last_event."""
        done, self.events = self.events, []
        for ev in done:
            ev.deps = ()
        with self.ctx.timeline_lock:
            self._compact_timeline()
        return done

    def _compact_timeline(self) -> None:  # lock: held(timeline_lock)
        """Losslessly merge overlapping/adjacent busy intervals (gap-finding
        sees the identical idle structure) and drop config switches buried
        inside the merged prefix, keeping the one active entering each gap.
        Bounds timeline memory by the number of surviving gaps, not by the
        total kernels ever enqueued."""
        busy = self.ctx._engine_busy
        if len(busy) > 1:
            merged = [busy[0]]
            for (s, e) in busy[1:]:
                ls, le = merged[-1]
                if s <= le:
                    merged[-1] = (ls, max(le, e))
                else:
                    merged.append((s, e))
            self.ctx._engine_busy = merged
        if self.ctx._engine_busy and len(self.ctx._config_switches) > 1:
            first_gap = self.ctx._engine_busy[0][1]
            switches = self.ctx._config_switches
            i = bisect.bisect_right(switches, (first_gap, "￿"))
            if i > 1:
                self.ctx._config_switches = switches[i - 1:]

    @property
    def makespan_us(self) -> float:
        return self.finish()

    # ---------------------------------------------- config-charge accounting
    @property
    def config_charges(self) -> int:
        """Reconfigurations this queue's retained commands paid for — THE
        quantity graph replay amortizes (once per partition instead of once
        per node; ``benchmarks/graph_replay_perf.py`` gates on it)."""
        return sum(1 for e in self.events if e.config_us > 0.0)

    @property
    def config_us_total(self) -> float:
        """Total modelled µs this queue's commands spent loading bitstreams."""
        return sum(e.config_us for e in self.events)

    def throughput_kernels_per_sec(self) -> float:
        n = sum(1 for e in self.events if e.kernel_name != "barrier")
        span = self.makespan_us
        return n / (span * 1e-6) if span > 0 else 0.0

    def profile(self) -> List[dict]:
        return [dict(kernel=e.kernel_name, tenant=self.tenant,
                     queued=e.t_queued_us,
                     submit=e.t_submit_us, config=e.config_us,
                     start=e.t_start_us, end=e.t_end_us)
                for e in self.events]
