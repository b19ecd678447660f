"""Graph capture & fused replay on the PyTorch port — serving a
small-kernel pipeline both ways, on one CUDA card unless ``--device cpu``.

A tenant whose requests run a pipeline of small pointwise kernels is the
worst case for per-kernel serving: every stage switch reloads the overlay
configuration, so the timeline fills with reconfigs instead of exec.  The
graph API records the pipeline ONCE (``session.capture``), compiles it into
packed overlay configurations (``session.instantiate`` — here the whole
pipeline fuses into a single config, with the stage-to-stage buffers elided
off the IO perimeter), and replays it per request at one configuration
charge per partition (``session.launch``), one executor launch each.

The demo serves the same deterministic trace node-at-a-time and as an
instantiated graph, then prints the timeline difference; both replays are
held bit for bit against each other and against the stages'
``run_reference`` chained.

    PYTHONPATH=src python examples/torch_graph_replay.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.configs.paper_suite import BENCHMARKS
from repro_torch.core.jit import jit_compile
from repro_torch.core.options import CompileOptions
from repro_torch.core.overlay import OverlaySpec
from repro_torch.core.runtime import Device
from repro_torch.core.session import Session
from repro_torch.device import target_device

SPEC = OverlaySpec(width=8, height=8, dsp_per_fu=2)
OPTS = CompileOptions(max_replicas=4)
N_REQUESTS = 5

# the pipeline: normalize -> polynomial feature -> activation -> rescale
STAGES = [
    ("normalize", lambda x: x * 0.5 - 1.0),
    ("poly1", BENCHMARKS["poly1"][0]),
    ("act", lambda x: x * x * 0.25 + x),
    ("rescale", lambda x: x * 0.125 + 2.0),
]


def record(sess):
    with sess.capture("tenant-a", name="pipeline") as g:
        buf = g.input("x")
        for name, src in STAGES:
            buf = g.call(src, OPTS.replace(n_inputs=1, name=name), buf)
    return g


def serve(mode: str, dev):
    rng = np.random.default_rng(0)
    with Session([Device("ovl0", SPEC)], device=dev) as sess:
        g = record(sess)
        gx = sess.instantiate(g) if mode == "graph" else None
        if gx is not None:
            print(f"instantiated: {len(g.nodes)} recorded nodes -> "
                  f"{gx.n_partitions} fused partition(s)")
        last = x = None
        for _ in range(N_REQUESTS):
            x = rng.uniform(0, 2, 100_000).astype(np.float32)
            ev = sess.launch(gx, x) if gx is not None else \
                sess.launch_nodewise(g, x)
            last = ev.wait()[0].read()
        charges = sess.config_charges()
        makespan = max(c.engine_end_us for c in sess.contexts.values())
        print(f"{mode:>9}: {charges['charges']:>2} config charges "
              f"({charges['config_us']:.1f} us of bitstream loads), "
              f"makespan {makespan/1e3:.2f} ms, "
              f"{sess.cache.stats.misses} cold builds")
        want = x
        for node in g.nodes:
            want = np.asarray(jit_compile(node.dfg, SPEC, opts=node.opts)
                              .run_reference(want), np.float32)
        return last, want, makespan


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the replays run (default: the CUDA card)")
    args = ap.parse_args()
    dev = target_device([], args.device)
    print(f"serving {N_REQUESTS} requests through a "
          f"{len(STAGES)}-stage pipeline on {dev}\n")
    out_node, want, t_node = serve("nodewise", dev)
    out_graph, _, t_graph = serve("graph", dev)
    assert np.array_equal(out_node.view(np.uint32),
                          out_graph.view(np.uint32)), "paths must agree"
    assert np.array_equal(out_graph.view(np.uint32), want.view(np.uint32)), \
        "the replays differ from run_reference chained"
    print(f"\nidentical results, bit for bit as run_reference chained; "
          f"graph replay finishes {t_node / t_graph:.2f}x sooner on the "
          f"modelled timeline")


if __name__ == "__main__":
    main()
