"""Multi-tenant serving on a two-overlay fleet through the PyTorch port's
async Session API, on one CUDA card unless ``--device cpu``.

Several tenants submit kernels from the paper's benchmark suite through ONE
:class:`~repro_torch.core.session.Session`.  Compilation is asynchronous:
every ``compile`` returns a KernelFuture immediately and the JIT pipeline
runs on the worker pool, with identical concurrent requests single-flighted
into one build.  ``enqueue`` chains each execution onto its compile event,
so the modelled per-request latency includes JIT-compile time exactly as
the paper's Fig. 5 flow implies — and the queue-aware scheduler places each
build on the device with the smallest projected makespan, not merely the
most free fabric.  Every request runs the overlay executor once, held bit
for bit against ``CompiledKernel.run_reference``.

    PYTHONPATH=src python examples/torch_multi_tenant_serving.py [--device cpu]
"""

import argparse
import time

import numpy as np

from repro_torch.configs.paper_suite import BENCHMARKS
from repro_torch.core.cache import JITCache
from repro_torch.core.options import CompileOptions
from repro_torch.core.overlay import OverlaySpec
from repro_torch.core.runtime import Device
from repro_torch.core.session import Session
from repro_torch.device import target_device

SPEC = OverlaySpec(width=8, height=8, dsp_per_fu=2)

# tenant -> stream of kernel requests (name, work items)
TENANTS = {
    "tenant-a": ["poly1", "poly1", "chebyshev", "poly1"],
    "tenant-b": ["sgfilter", "sgfilter", "poly2"],
    "tenant-c": ["chebyshev", "mibench", "chebyshev", "qspline"],
}
OPTS = CompileOptions(max_replicas=6)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the requests run (default: the CUDA card)")
    args = ap.parse_args()
    dev = target_device([], args.device)
    rng = np.random.default_rng(0)
    with Session([Device("ovl0", SPEC), Device("ovl1", SPEC)],
                 cache=JITCache(capacity=32), max_workers=4,
                 device=dev) as sess:
        sess.set_priority("tenant-a", 1)     # tenant-a is shed last

        # phase 1: every tenant fires all its compiles up front — futures
        # come back immediately; identical kernels across tenants
        # single-flight into one pipeline run when their submissions
        # overlap a build still in flight
        futures = {}
        for tenant, stream in TENANTS.items():
            for kname in set(stream):
                futures[(tenant, kname)] = sess.compile(
                    BENCHMARKS[kname][0], OPTS, tenant=tenant)
        print(f"submitted {len(futures)} compiles "
              f"({sess.cache.stats.singleflight_hits} single-flighted)")

        # phase 2: enqueue the request streams; each execution chains onto
        # its compile event, so timestamps include JIT latency
        events = []
        for tenant, stream in TENANTS.items():
            for kname in stream:
                fut = futures[(tenant, kname)]
                n_in = len(fut.result().compiled.dfg.inputs)
                bufs = [rng.uniform(-1, 1, 2048).astype(np.float32)
                        for _ in range(n_in)]
                events.append((tenant, kname, bufs,
                               sess.enqueue(fut, *bufs, tenant=tenant)))

        for (tenant, kname), fut in sorted(futures.items()):
            prog = fut.result()
            print(f"[{tenant}] {kname:<10} on {prog.ctx.device.name} "
                  f"compile {fut.compile_us / 1e3:7.2f} ms "
                  f"({prog.compiled.plan.replicas} replicas)")

        print("\nper-request modelled latency (incl. JIT wait):")
        for tenant, kname, bufs, ev in events:
            (out,) = ev.wait()
            want = futures[(tenant, kname)].result().compiled \
                .run_reference(*bufs)
            assert np.array_equal(out.read().view(np.uint32),
                                  np.asarray(want, np.float32)
                                  .view(np.uint32)), (tenant, kname)
            print(f"  {tenant} {kname:<10} queue {ev.queue_delay_us:8.1f} us"
                  f" | config {ev.config_us:5.1f} us"
                  f" | exec {ev.exec_us:6.2f} us")
        print(f"every output on {dev}, bit-identical to run_reference")

        print("\nfleet ledger + makespan:")
        for name, row in sess.ledger().items():
            print(f"  {name}: {row}")
        for name, row in sess.makespan_report().items():
            print(f"  {name}: engine end {row['engine_end_us']:.0f} us")
        assert sess.ledger_consistent(), "resource ledger out of balance"

        total = len(events)
        makespan = sess.finish()
        print(f"\nserved {total} kernels, fleet makespan {makespan:.0f} us "
              f"-> {total / (makespan * 1e-6):.0f} kernels/s modelled")

        # tenant churn: everyone disconnects, then poly1 is requested again
        # at the same (now empty) fleet state — the fleet-wide cache
        # returns the compiled artifact without one compiler stage running
        for fut in futures.values():
            fut.result().release()
        t0 = time.perf_counter()
        sess.build(BENCHMARKS["poly1"][0], OPTS, tenant="tenant-a")
        print(f"after churn: poly1 re-served in "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms (cache hit)")
        print(f"JIT cache: {sess.cache.stats.as_dict()}")
        assert sess.cache.stats.hits >= 1


if __name__ == "__main__":
    main()
