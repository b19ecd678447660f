"""Span-based tracing for the overlay JIT pipeline.

The tracer is *ambient*: like the fault plane (``repro_torch.core.faults``) it
is activated per-thread via a context manager, and every instrumentation
point in the runtime asks the thread-local slot whether a tracer is
active.  The disabled path is therefore exactly one TLS read — no locks,
no allocation, no branching beyond the ``None`` check — which is what
lets the probes live permanently on the warm hit path (gated at zero by
``benchmarks/trace_overhead_perf.py``).

Two kinds of spans share one record type:

* **wall spans** — ``with span("jit:place", "compile"): ...`` measures
  host wall time on the calling thread, nesting naturally (the per-thread
  open-span stack lives in tracer-owned TLS, so racing pool workers never
  see each other's parents);
* **modelled spans** — ``modelled("exec:k", "dev:fpga0", t0, dur)``
  books an interval on the *device* timeline using the simulator's µs
  clock (queue submit / config charge / kernel execution), so the
  exported Chrome trace shows host compile activity and modelled device
  occupancy side by side.

``Tracer(clock=...)`` accepts an injectable clock (µs since epoch of the
tracer) so tests can produce byte-stable golden traces.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "Span", "Tracer", "activate", "active_tracer", "modelled", "span",
    "CATEGORIES",
]

#: span categories used by the built-in instrumentation points
#: (``docs/observability.md`` documents the full taxonomy).
CATEGORIES = ("compile", "cache", "queue", "device", "serving", "session")


@dataclasses.dataclass
class Span:
    """One closed span: a named interval on a track.

    ``track`` is the thread name for wall spans and the caller-chosen
    device-track name for modelled spans; ``parent``/``depth`` encode
    the nesting at open time (modelled spans are always roots).
    """

    sid: int
    parent: Optional[int]
    name: str
    cat: str
    ts_us: float
    dur_us: float
    track: str
    depth: int
    args: Dict[str, Any]
    error: Optional[str] = None


class _SpanHandle:
    """Context manager for one wall span.  ``__enter__`` returns the
    span's mutable ``args`` dict so the body can record outcomes
    (``sp["hit"] = True``) that were unknown at open time."""

    __slots__ = ("_tracer", "name", "cat", "args", "_sid", "_parent",
                 "_depth", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self) -> Dict[str, Any]:
        tr = self._tracer
        stack = getattr(tr._stacks, "stack", None)
        if stack is None:
            stack = tr._stacks.stack = []
        self._parent = stack[-1] if stack else None
        self._depth = len(stack)
        with tr._lock:
            self._sid = tr._span_seq
            tr._span_seq += 1
        self._t0 = tr._clock()
        stack.append(self._sid)
        return self.args

    def __exit__(self, et, ev, tb):
        tr = self._tracer
        t1 = tr._clock()
        tr._stacks.stack.pop()
        err = None if et is None else f"{et.__name__}: {ev}"
        sp = Span(self._sid, self._parent, self.name, self.cat,
                  self._t0, max(0.0, t1 - self._t0),
                  threading.current_thread().name, self._depth,
                  self.args, err)
        with tr._lock:
            tr._spans.append(sp)
        return False


class Tracer:
    """Thread-safe recorder of nested spans.

    A tracer is passive until *activated* on a thread (see
    :func:`activate`); the :class:`~repro_torch.core.session.Session` activates
    its tracer on every pool worker and queue-submit path exactly where
    it activates the fault plane, so one tracer observes racing builds,
    hedged compiles and serving iterations coherently.
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._lock = threading.Lock()
        self._spans: List[Span] = []  # lock: _lock
        self._span_seq = 0  # lock: _lock
        self._stacks = threading.local()   # per-thread open-span stack
        if clock is None:
            t0 = time.perf_counter()
            clock = lambda: (time.perf_counter() - t0) * 1e6  # noqa: E731
        self._clock = clock

    # ------------------------------------------------------------- recording

    def span(self, name: str, cat: str = "", **args) -> _SpanHandle:
        """Open a wall span on the calling thread (context manager)."""
        return _SpanHandle(self, name, cat, args)

    def add_modelled(self, name: str, track: str, ts_us: float,
                     dur_us: float, cat: str = "device", **args) -> None:
        """Book a span on a modelled (device) timeline: the interval is
        in simulator µs, not host wall time."""
        with self._lock:
            sid = self._span_seq
            self._span_seq += 1
            self._spans.append(Span(sid, None, name, cat, float(ts_us),
                                    float(dur_us), track, 0, dict(args)))

    # ------------------------------------------------------------ inspection

    @property
    def n_spans(self) -> int:
        with self._lock:
            return len(self._spans)

    def spans(self) -> List[Span]:
        """Snapshot of all closed spans (open spans are not included)."""
        with self._lock:
            return list(self._spans)

    def counts_by_cat(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for s in self.spans():
            out[s.cat] = out.get(s.cat, 0) + 1
        return out

    def summary(self) -> List[Tuple[str, str, int, float]]:
        """Per-(cat, name) rollup: ``(cat, name, count, total_us)``."""
        agg: Dict[Tuple[str, str], List[float]] = {}
        for s in self.spans():
            cell = agg.setdefault((s.cat, s.name), [0, 0.0])
            cell[0] += 1
            cell[1] += s.dur_us
        return [(cat, name, int(n), total)
                for (cat, name), (n, total) in sorted(agg.items())]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def __repr__(self) -> str:
        return f"Tracer({self.n_spans} span(s))"


# ------------------------------------------------------- ambient activation
#
# Same shape as repro_torch.core.faults: a module-level TLS slot, a context
# manager that saves/restores it, and probe helpers that do one TLS read
# on the disabled path.

_TLS = threading.local()


def active_tracer() -> Optional[Tracer]:
    """The tracer activated on *this* thread, or None."""
    return getattr(_TLS, "tracer", None)


class _Activation:
    """Context manager of :func:`activate`: sets the thread's tracer on
    entry and restores the previous one on exit."""

    __slots__ = ("tracer", "_prev")

    def __init__(self, tracer: Optional[Tracer]):
        self.tracer = tracer

    def __enter__(self) -> Optional[Tracer]:
        self._prev = getattr(_TLS, "tracer", None)
        _TLS.tracer = self.tracer
        return self.tracer

    def __exit__(self, *exc) -> bool:
        _TLS.tracer = self._prev
        return False


class _NoActivation:
    """Shared no-op for activating ``None`` where no tracer is active:
    there is nothing to set or restore."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NO_ACTIVATION = _NoActivation()


def activate(tracer: Optional[Tracer]):
    """Make ``tracer`` ambient on this thread for the duration.  Nesting
    restores the previous tracer on exit; activating ``None`` explicitly
    disables tracing inside the block.  Activating ``None`` where no
    tracer is active is one TLS read and a shared no-op (the Session
    activates its tracer around every enqueue, so this is the warm hit
    path with tracing off)."""
    if tracer is None and getattr(_TLS, "tracer", None) is None:
        return _NO_ACTIVATION
    return _Activation(tracer)


class _NullSpan:
    """Shared no-op context manager returned by :func:`span` when no
    tracer is active — supports the same ``sp[...] = v`` outcome
    recording so call sites need no branches."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __setitem__(self, key, value):
        pass


_NULL_SPAN = _NullSpan()


def span(name: str, cat: str = "", **args):
    """Open a wall span against the ambient tracer; a shared no-op when
    tracing is disabled (one TLS read, no allocation)."""
    tr = getattr(_TLS, "tracer", None)
    if tr is None:
        return _NULL_SPAN
    return tr.span(name, cat, **args)


def modelled(name: str, track: str, ts_us: float, dur_us: float,
             cat: str = "device", **args) -> None:
    """Book a modelled span against the ambient tracer, if any."""
    tr = getattr(_TLS, "tracer", None)
    if tr is not None:
        tr.add_modelled(name, track, ts_us, dur_us, cat, **args)
