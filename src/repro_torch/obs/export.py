"""Chrome-trace (``chrome://tracing`` / Perfetto) export.

The exporter maps the tracer's two span kinds onto two trace processes:

* **pid 1 "host"** — wall spans, one trace thread per Python thread
  (pool workers, hedge racers, the serving loop);
* **pid 2 "overlay (modelled)"** — modelled device spans, one trace
  thread per device track (``dev:<device>/<tenant>`` queue rows and
  ``dev:<device>`` config/exec rows), in simulator µs.

Events are complete-duration (``ph: "X"``) records sorted by
``(ts, sid)``; thread/process names ride along as metadata events, so
the JSON loads directly in Perfetto with no post-processing.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

from repro_torch.obs.trace import Tracer

__all__ = ["chrome_trace", "render_summary", "write_chrome_trace"]

HOST_PID = 1
DEVICE_PID = 2


def chrome_trace(tracer: Tracer) -> dict:
    """Render all closed spans as a Chrome-trace JSON object."""
    spans = sorted(tracer.spans(), key=lambda s: (s.ts_us, s.sid))
    events: List[dict] = [
        {"ph": "M", "pid": HOST_PID, "tid": 0, "name": "process_name",
         "args": {"name": "host"}},
        {"ph": "M", "pid": DEVICE_PID, "tid": 0, "name": "process_name",
         "args": {"name": "overlay (modelled)"}},
    ]
    tids: Dict[Tuple[int, str], int] = {}

    def tid_for(pid: int, track: str) -> int:
        key = (pid, track)
        tid = tids.get(key)
        if tid is None:
            tid = tids[key] = len(tids) + 1
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name",
                           "args": {"name": track}})
        return tid

    for s in spans:
        pid = DEVICE_PID if s.cat == "device" or s.track.startswith("dev:") \
            else HOST_PID
        args = dict(s.args)
        args["sid"] = s.sid
        if s.parent is not None:
            args["parent"] = s.parent
        if s.error is not None:
            args["error"] = s.error
        events.append({
            "ph": "X", "pid": pid, "tid": tid_for(pid, s.track),
            "name": s.name, "cat": s.cat or "default",
            "ts": round(s.ts_us, 3), "dur": round(s.dur_us, 3),
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(tracer: Tracer, path: str) -> str:
    """Write :func:`chrome_trace` JSON to ``path``; returns ``path``."""
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(chrome_trace(tracer), fh, indent=1, sort_keys=True)
        fh.write("\n")
    return path


def render_summary(tracer: Tracer) -> str:
    """Text rollup (per cat/name count + total µs) for the CLI."""
    rows = tracer.summary()
    lines = [f"{'cat':<9} {'span':<34} {'count':>7} {'total_us':>12}",
             "-" * 65]
    for cat, name, n, total in rows:
        lines.append(f"{cat:<9} {name:<34} {n:>7} {total:>12.1f}")
    if not rows:
        lines.append("(no spans recorded)")
    return "\n".join(lines)
