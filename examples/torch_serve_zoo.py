"""Serve the model zoo on the PyTorch port: two families, mixed SLO
tenants, one fleet, on one CUDA card unless ``--device cpu``.

A realtime transformer tenant and a batch-class mamba2 tenant share a
two-overlay fleet through :class:`repro_torch.serve.InferenceServer`.  Each
family's prefill/decode pipelines are captured kernel graphs compiled once
through the cached/fused JIT path; requests then join and leave the running
batch at decode-step boundaries (iteration-level continuous batching), and
the SLO class decides who books engine time first and how much queue the
door admits.  Every iteration runs the overlay executor on states that stay
on the Session's device.

The demo serves one bursty trace, verifies the continuous-batching outputs
are bit-identical to the request-at-a-time oracle, and prints batch
occupancy plus per-SLO-class modelled latency — the realtime class should
come out well ahead of batch despite sharing the fabric.

    PYTHONPATH=src python examples/torch_serve_zoo.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core.runtime import Device, OverlaySpec
from repro_torch.core.session import Session
from repro_torch.device import target_device
from repro_torch.serve import (InferenceServer, Request, build_zoo,
                               serve_sequential)
from repro_torch.serve.models import PIPELINES

TENANTS = {"transformer": "realtime", "mamba2": "batch"}
N_REQUESTS = 24
SPEC = dict(width=8, height=8, dsp_per_fu=2)


def make_trace(seed: int = 3):
    """Request kwargs: two arrival bursts, interleaved tenants."""
    rng = np.random.default_rng(seed)
    fams = sorted(TENANTS)
    return [dict(model=fams[i % 2],
                 prompt=rng.standard_normal(
                     PIPELINES[fams[i % 2]].state_dim).astype(np.float32),
                 decode_steps=int(rng.integers(3, 7)),
                 offset_us=(i // 12) * 60.0 + (i % 12) * 3.0)
            for i in range(N_REQUESTS)]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the zoo serves (default: the CUDA card)")
    args = ap.parse_args()
    dev = target_device([], args.device)
    trace = make_trace()
    spec = OverlaySpec(**SPEC)

    # -- continuous batching -------------------------------------------
    with Session([Device("ovl0", spec), Device("ovl1", spec)],
                 device=dev) as sess:
        with InferenceServer(sess, TENANTS, max_batch=6) as srv:
            for m in srv.zoo.values():
                m.result()                 # warm: compile off the clock
            t0 = sess.now_us()
            reqs = [Request(kw["model"], kw["prompt"], kw["decode_steps"],
                            t_arrival_us=t0 + kw["offset_us"])
                    for kw in trace]
            for r in reqs:
                srv.submit(r)
            makespan = srv.run() - t0
            serving = sess.stats()["serving"]
            batched_out = [r.output for r in reqs]

    # -- request-at-a-time oracle (same graphs, no batching) -----------
    with Session([Device("ovl0", spec), Device("ovl1", spec)],
                 device=dev) as sess:
        zoo = build_zoo(sess, sorted(TENANTS))
        for m in zoo.values():
            m.result()
        t0 = sess.now_us()
        solo = [Request(kw["model"], kw["prompt"], kw["decode_steps"],
                        t_arrival_us=t0 + kw["offset_us"]) for kw in trace]
        outputs, seq_end = serve_sequential(sess, zoo, solo)
        seq_makespan = seq_end - t0
        identical = all(np.array_equal(outputs[s.rid], b)
                        for s, b in zip(solo, batched_out))

    print(f"served {serving['completed']}/{serving['admitted']} requests "
          f"on 2 overlays of {dev} (rejected={serving['rejected']})")
    print(f"continuous batching {makespan:.0f}us vs sequential "
          f"{seq_makespan:.0f}us -> {seq_makespan / makespan:.1f}x, "
          f"bit-identical={identical}")
    for name in sorted(TENANTS):
        m = serving["models"][name]
        print(f"  {name:<12} slo={m['slo']:<8} occupancy_ewma="
              f"{m['occupancy_ewma']:.2f} iterations={m['iterations']}")
    for cls, lat in sorted(serving["latency_us"].items()):
        print(f"  {cls:<12} n={lat['n']:<3} p50={lat['p50']:8.1f}us "
              f"p99={lat['p99']:8.1f}us")
    assert identical, "batched serving must match the oracle bit-for-bit"


if __name__ == "__main__":
    main()
