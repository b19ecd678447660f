"""The traced sub-window: torch.profiler over a few steps, read back into
plain records that the per-layer metrics' readers take."""

from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

# trace events that occupy the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation")
NAME_CHARS = 160


@dataclasses.dataclass
class Records:
    """What a traced sub-window leaves for the per-layer metrics.

    ``device``: (name, start_s, seconds) of every device operation;
    ``host``: (name, start_s, seconds) of the host's operations and the
    harness's annotations, on the same clock; ``window_s``: the host clock
    from the first traced step's start to the last one's read-back;
    ``steps``: traced steps; ``counts``: the benchmark's operations and
    bytes of one traced step (:mod:`bench.counts`); ``peak``: the chip's
    data-sheet peaks (None for a chip the table lacks)."""
    kind: str
    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    window_s: float
    steps: int
    counts: Dict[str, float]
    peak: Optional[Dict[str, float]]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, in order."""
        spans = sorted((s, s + d) for _, s, d in self.device)
        out: List[List[float]] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def kernel_seconds(self, *needles: str, without: Tuple[str, ...] = ()
                       ) -> Tuple[float, int]:
        """Seconds and launches of the device operations whose names hold
        any of ``needles`` and none of ``without``."""
        secs, n = 0.0, 0
        for name, _, d in self.device:
            if any(k in name for k in needles) and \
                    not any(k in name for k in without):
                secs += d
                n += 1
        return secs, n

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        """The device operations that took most time, and the longest idle
        gaps, each named by the innermost host operation under way when it
        began."""
        by_name: Dict[str, float] = {}
        for name, _, d in self.device:
            name = name[:NAME_CHARS]        # C++ template names run long
            by_name[name] = by_name.get(name, 0.0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        gaps = [(busy[i][1], busy[i + 1][0] - busy[i][1])
                for i in range(len(busy) - 1)]
        gaps = sorted(gaps, key=lambda g: -g[1])[:top]
        named = [[self._host_at(t), d] for t, d in gaps]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}

    def _host_at(self, t: float) -> str:
        inner = None
        for name, s, d in self.host:
            if s <= t <= s + d and (inner is None or d < inner[1]):
                inner = (name, d)
        return inner[0] if inner else "none"


class Tracer:
    """Profiles the steps between :meth:`start` and :meth:`stop`; the
    trace goes through a file at a fixed path inside the checkout, read
    and deleted at once."""

    def __init__(self, device: torch.device, path: Path):
        self.device, self.path = device, Path(path)
        self._prof = None
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        """Call after a step's read-back: the device is idle."""
        self.t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)

    @property
    def running(self) -> bool:
        return self._prof is not None and not self.t1

    def events(self):
        """(device ops, host ops) of the trace, seconds on one clock."""
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(self.path))
        try:
            with open(self.path) as f:
                trace = json.load(f)
        finally:
            os.unlink(self.path)
        dev, host = [], []
        for e in trace.get("traceEvents", []):
            if e.get("ph") != "X" or "dur" not in e:
                continue
            rec = (e.get("name", "?"), float(e["ts"]) * 1e-6,
                   float(e["dur"]) * 1e-6)
            if e.get("cat") in DEVICE_CATEGORIES:
                dev.append(rec)
            elif e.get("cat") in HOST_CATEGORIES:
                host.append(rec)
        return dev, host
