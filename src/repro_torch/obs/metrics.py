"""Counters, gauges and histograms for the overlay runtime.

A :class:`MetricsRegistry` is a flat namespace of named instruments,
each independently thread-safe.  Instruments are get-or-create — two
racing threads asking for ``counter("serving.slo_violations.rt")`` get
the same object — and the registry renders itself as one nested dict so
it plugs straight into ``Session.register_stats_section``::

    metrics = MetricsRegistry().install(session)   # stats()["obs"]

Histograms keep a bounded sample window (default 4096) plus exact
``n``/``sum`` totals; percentiles are nearest-rank over the window, the
same convention ``OverlayServer`` uses for latency percentiles.
"""

from __future__ import annotations

import collections
import math
import threading
from typing import Deque, Dict, List, Union

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class Counter:
    """Monotonic counter (floats allowed for µs totals)."""

    __slots__ = ("name", "_lock", "_mcount")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._mcount = 0.0  # lock: _lock

    def inc(self, n: Union[int, float] = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        with self._lock:
            self._mcount += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._mcount

    def __repr__(self) -> str:
        return f"Counter({self.name}={self.value:g})"


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "_lock", "_mvalue")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._mvalue = 0.0  # lock: _lock

    def set(self, value: float) -> None:
        with self._lock:
            self._mvalue = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._mvalue

    def __repr__(self) -> str:
        return f"Gauge({self.name}={self.value:g})"


def _nearest_rank(ordered: List[float], q: float) -> float:
    """Nearest-rank percentile over a sorted sample (q in [0, 100])."""
    if not ordered:
        return 0.0
    k = max(0, min(len(ordered) - 1,
                   math.ceil(q / 100.0 * len(ordered)) - 1))
    return ordered[k]


class Histogram:
    """Bounded-window distribution with exact totals.

    The window is a ring (``deque(maxlen=window)``): long-running
    servers keep recent behaviour without unbounded memory, while
    ``n``/``sum`` stay exact over the instrument's whole lifetime.
    """

    __slots__ = ("name", "window", "_lock", "_msamples", "_mtotal", "_msum")

    def __init__(self, name: str, window: int = 4096):
        if window < 1:
            raise ValueError(f"histogram {self.__class__.__name__}: "
                             f"window must be >= 1, got {window}")
        self.name = name
        self.window = int(window)
        self._lock = threading.Lock()
        self._msamples: Deque[float] = collections.deque(
            maxlen=self.window)  # lock: _lock
        self._mtotal = 0  # lock: _lock
        self._msum = 0.0  # lock: _lock

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._msamples.append(v)
            self._mtotal += 1
            self._msum += v

    def percentile(self, q: float) -> float:
        with self._lock:
            snap = sorted(self._msamples)
        return _nearest_rank(snap, q)

    def summary(self) -> dict:
        with self._lock:
            snap = sorted(self._msamples)
            n, total = self._mtotal, self._msum
        if not snap:
            return dict(n=0, mean=0.0, p50=0.0, p99=0.0, max=0.0)
        return dict(n=n, mean=total / n,
                    p50=_nearest_rank(snap, 50.0),
                    p99=_nearest_rank(snap, 99.0),
                    max=snap[-1])

    def __repr__(self) -> str:
        s = self.summary()
        return (f"Histogram({self.name}: n={s['n']} p50={s['p50']:g} "
                f"p99={s['p99']:g})")


class MetricsRegistry:
    """Get-or-create namespace of instruments, pluggable into
    ``Session.register_stats_section`` via :meth:`install`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}  # lock: _lock

    def _get(self, name: str, cls, *extra):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, *extra)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, window: int = 4096) -> Histogram:
        return self._get(name, Histogram, window)

    def as_dict(self) -> dict:
        """Deterministic (name-sorted) rendering for ``Session.stats()``."""
        with self._lock:
            insts = sorted(self._instruments.items())
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, inst in insts:
            if isinstance(inst, Counter):
                out["counters"][name] = inst.value
            elif isinstance(inst, Gauge):
                out["gauges"][name] = inst.value
            else:
                out["histograms"][name] = inst.summary()
        return out

    def install(self, session, section: str = "obs") -> "MetricsRegistry":
        """Register this registry as a ``Session.stats()`` section."""
        session.register_stats_section(section, self.as_dict)
        return self

    def __repr__(self) -> str:
        with self._lock:
            return f"MetricsRegistry({len(self._instruments)} instrument(s))"
