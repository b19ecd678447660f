"""``python -m repro_torch.obs`` — trace a demo pipeline, export a Chrome
trace.

Records a small multi-stage kernel pipeline, replays it a few times with
tracing / metrics / profiling attached, runs the profile-guided
re-cutter, writes the Chrome-trace JSON (load it in ``chrome://tracing``
or https://ui.perfetto.dev) and prints the span/metric rollups.  Every
replay runs the overlay executor on the CUDA card (``--device cpu`` runs
its plain version on the CPU); the trace's device rows are the queues'
modelled µs.

  PYTHONPATH=src python -m repro_torch.obs --out obs_trace.json
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np

from repro_torch.configs.paper_suite import BENCHMARKS
from repro_torch.core.options import CompileOptions
from repro_torch.core.overlay import OverlaySpec
from repro_torch.core.runtime import Device
from repro_torch.core.session import Session
from repro_torch.device import target_device
from repro_torch.obs import (MetricsRegistry, ProfileStore, ReCutter, Tracer,
                       render_summary, write_chrome_trace)

SPEC = OverlaySpec(width=8, height=8, dsp_per_fu=2)
OPTS = CompileOptions(max_replicas=4)

STAGES = [
    ("normalize", lambda x: x * 0.5 - 1.0),
    ("poly1", BENCHMARKS["poly1"][0]),
    ("cheb", BENCHMARKS["chebyshev"][0]),
    ("rescale", lambda x: x * 0.125 + 2.0),
]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Trace a demo overlay pipeline and export a "
                    "Chrome-trace (Perfetto) JSON.")
    ap.add_argument("--out", default="obs_trace.json", metavar="PATH",
                    help="Chrome-trace output path (default: "
                         "obs_trace.json)")
    ap.add_argument("--replays", type=int, default=4,
                    help="pipeline replays to trace (default: 4)")
    ap.add_argument("--items", type=int, default=100_000,
                    help="work items per replay (default: 100000)")
    ap.add_argument("--cap", type=int, default=None, metavar="FUS",
                    help="max_partition_fus for the cut (default: "
                         "uncapped)")
    ap.add_argument("--no-recut", action="store_true",
                    help="skip the profile-guided re-cut pass")
    ap.add_argument("--device", default=None,
                    help="where the replays run (default: the CUDA card)")
    args = ap.parse_args(argv)

    tracer = Tracer()
    metrics = MetricsRegistry()
    rng = np.random.default_rng(0)
    with Session([Device("ovl0", SPEC)], tracer=tracer,
                 metrics=metrics, device=args.device) as sess:
        store = ProfileStore(cache=sess.cache)
        sess.profiles = store
        with sess.capture("demo", name="obs_pipeline") as g:
            buf = g.input("x")
            for name, src in STAGES:
                buf = g.call(src, OPTS.replace(
                    n_inputs=1, name=name,
                    max_partition_fus=args.cap), buf)
        gx = sess.instantiate(g)
        print(f"instantiated: {len(g.nodes)} nodes -> "
              f"{gx.n_partitions} partition(s)")
        for _ in range(max(1, args.replays)):
            x = rng.uniform(0, 2, args.items).astype(np.float32)
            ev = sess.launch(gx, x)
            ev.wait()
            metrics.counter("demo.replays").inc()
            metrics.histogram("demo.replay_latency_us").observe(
                ev.latency_us)
        if not args.no_recut:
            res = ReCutter(sess, store).consider(
                g, max_partition_fus=args.cap)
            print(f"re-cut: {res.reason} "
                  f"(old {res.old_est_us:.1f} us -> "
                  f"new {res.new_est_us:.1f} us per replay, "
                  f"gain {res.gain:.2f}x)")
            if res.swapped and res.gexec is not None:
                x = rng.uniform(0, 2, args.items).astype(np.float32)
                sess.launch(res.gexec, x).wait()
                res.gexec.release()
        obs = sess.stats().get("obs", {})
        gx.release()

    path = write_chrome_trace(tracer, args.out)
    print(f"\n{render_summary(tracer)}\n")
    print(f"metrics: {obs.get('counters', {})}")
    print(f"device: {target_device([], args.device)}")
    print(f"chrome trace: {path} ({tracer.n_spans} spans) — open in "
          f"chrome://tracing or ui.perfetto.dev")
    return 0


if __name__ == "__main__":
    sys.exit(main())
