"""Trace the PyTorch port's serving stack end-to-end, then let a profile
repair a cut, on one CUDA card unless ``--device cpu``.

Two zoo families share one overlay through
:class:`repro_torch.serve.InferenceServer` with the full observability
plane attached (``Session(tracer=, metrics=, profiles=)``): every compile
stage, cache probe, modelled queue/config/exec slice and serving iteration
lands in one Chrome trace you can open in ``chrome://tracing`` or
https://ui.perfetto.dev.  The trace is served in two waves — the second
wave is fully warm, so its spans show pure engine contention (queue-wait
slices) instead of compiles.  Spans hold the queues' modelled µs and the
host's clock, never a time read from the card.

The second half closes the loop: a pipeline tenant serves under a STALE
per-stage cut (say, adopted from a fleet profile recorded when batches were
small).  At streaming batch sizes the two fat partitions share the fabric
and alternate configs every replay; the measured :class:`ReplayProfile`
lets :class:`ReCutter` re-fuse the chain — the swap is taken only because
the co-resident estimate wins, the outputs stay bit-identical, and the
steady-state replay gets measurably faster on the modelled timeline.

    PYTHONPATH=src python examples/torch_trace_serving.py [--device cpu] \\
        [--trace serving_trace.json]
"""

import argparse
import collections

import numpy as np

from repro_torch.core.graph import partition_graph_grouped
from repro_torch.core.options import CompileOptions
from repro_torch.core.runtime import Device, OverlaySpec
from repro_torch.core.session import Session
from repro_torch.device import target_device
from repro_torch.obs import (MetricsRegistry, ProfileStore, ReCutter, Tracer,
                             write_chrome_trace)
from repro_torch.serve import InferenceServer, Request
from repro_torch.serve.models import PIPELINES

TENANTS = {"transformer": "realtime", "mamba2": "batch"}
SPEC = OverlaySpec(width=8, height=8, dsp_per_fu=2)


def wave(rng, t0, n=10):
    fams = sorted(TENANTS)
    return [Request(fams[i % 2],
                    rng.standard_normal(
                        PIPELINES[fams[i % 2]].state_dim)
                    .astype(np.float32),
                    decode_steps=int(rng.integers(3, 6)),
                    t_arrival_us=t0 + i * 3.0)
            for i in range(n)]


def serve_traced(dev, trace_path: str) -> Tracer:
    tracer, metrics = Tracer(), MetricsRegistry()
    rng = np.random.default_rng(7)
    with Session([Device("ovl0", SPEC)], tracer=tracer, metrics=metrics,
                 device=dev) as sess:
        sess.profiles = ProfileStore(cache=sess.cache)
        with InferenceServer(sess, TENANTS, max_batch=6) as srv:
            for m in srv.zoo.values():
                m.result()                     # cold compiles, traced
            for _ in range(2):                 # wave 2 is fully warm
                for r in wave(rng, sess.now_us()):
                    srv.submit(r)
                srv.run()
        serving = sess.stats()["serving"]
        obs = sess.stats()["obs"]

    cats = collections.Counter(s.cat for s in tracer.spans())
    print(f"served {serving['completed']} requests over 2 waves on {dev}; "
          f"span counts by category: {dict(sorted(cats.items()))}")
    print(f"slo violations: {serving['slo_violations']}  "
          f"(also counters: "
          f"{ {k: v for k, v in obs['counters'].items() if 'slo' in k} })")
    path = write_chrome_trace(tracer, trace_path)
    print(f"chrome trace: {path} ({tracer.n_spans} spans) — open in "
          f"chrome://tracing or ui.perfetto.dev\n")
    return tracer


def recut_demo(dev) -> None:
    """Before/after: a stale per-stage cut repaired from its profile."""
    opts = CompileOptions(max_replicas=4, n_inputs=1)

    def stage(k=18):
        def fn(x):
            for _ in range(k):
                x = x * 1.01 + 0.001
            return x
        return fn

    x = np.random.default_rng(0).uniform(0, 1, 2_000_000) \
        .astype(np.float32)
    with Session([Device("ovl0", SPEC)], device=dev) as sess:
        sess.profiles = ProfileStore(cache=sess.cache)
        with sess.capture("tenant-a", name="wide_chain") as g:
            b = g.input("x")
            b = g.call(stage(), opts.replace(name="s0"), b)
            b = g.call(stage(), opts.replace(name="s1"), b)
        # the stale plan: one partition per stage (fine when batches
        # were config-dominated; wrong at 2M items per replay)
        sess.adopt_graph_plan(g, partition_graph_grouped(
            g, sess.scheduler.partition_spec(), [[0], [1]]))
        gx = sess.instantiate(g)
        for _ in range(2):
            sess.launch(gx, x).wait()
        out_old = sess.launch(gx, x).outputs[0].read()
        ctx = next(iter(sess.contexts.values()))
        mark = ctx.engine_end_us
        sess.launch(gx, x).wait()
        old_us = ctx.engine_end_us - mark
        gx.release()                           # retire before the swap

        res = ReCutter(sess, sess.profiles).consider(g)
        print(f"re-cut: {res.reason}  {res.old_cut} -> {res.new_cut}  "
              f"(estimate {res.old_est_us:.0f} -> {res.new_est_us:.0f} "
              f"us/replay, gain {res.gain:.2f}x)")
        sess.launch(res.gexec, x).wait()       # pay the new config once
        out_new = sess.launch(res.gexec, x).outputs[0].read()
        mark = ctx.engine_end_us
        sess.launch(res.gexec, x).wait()
        new_us = ctx.engine_end_us - mark
        same = np.array_equal(out_old.view(np.uint32),
                              out_new.view(np.uint32))
        print(f"steady-state replay: {old_us:.0f} us (stale cut, "
              f"{len(res.old_cut)} configs/replay) -> {new_us:.0f} us "
              f"(re-fused) = {old_us / new_us:.2f}x, "
              f"bit-identical={same}")
        assert same, "the re-cut changed the outputs"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the serving runs (default: the CUDA card)")
    ap.add_argument("--trace", default="serving_trace.json",
                    help="where the Chrome trace is written")
    args = ap.parse_args()
    dev = target_device([], args.device)
    serve_traced(dev, args.trace)
    recut_demo(dev)


if __name__ == "__main__":
    main()
