#!/usr/bin/env python3
"""Queue-aware placement on the port's Session, on one CUDA card.

    PYTHONPATH=src python3 benchmarks/torch_queue_sched_perf.py \
        [--gate 1.0] [--device cuda] [--json out.json]

The port of ``benchmarks/queue_sched_perf.py``: one deterministic
mixed-tenant trace replayed twice on an identical two-overlay fleet
(``OverlaySpec(8, 8, 2)``, 24 FUs of static "other logic" reserved on
``ovl1``), once with the Session's queue-aware **makespan** placement and
once with the **free_fabric** best fit, compared on the fleet's modelled
makespan.  Gate (the process exits 1): makespan-aware placement at least
``--gate`` (1.0: never worse) times free-fabric.

Every run of the trace launches the executor on buffers on the card, and
each output is held bit for bit against ``run_reference`` (NaN positions
apart): the reference ran ``run_reference`` in numpy on the host.  The
Sessions build on one worker with the host clock held at 0 µs
(``port_bench.ModelledSession``), so the makespans are the queues' model
alone and equal the reference's under the same Session.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import port_bench  # noqa: E402
from port_bench import ModelledSession  # noqa: E402

from repro_torch.configs.paper_suite import BENCHMARKS  # noqa: E402
from repro_torch.core.cache import JITCache  # noqa: E402
from repro_torch.core.options import CompileOptions  # noqa: E402
from repro_torch.core.overlay import OverlaySpec  # noqa: E402
from repro_torch.core.runtime import Device  # noqa: E402

SPEC_KW = dict(width=8, height=8, dsp_per_fu=2)
# static "other logic" on ovl1: free-fabric best fit always ranks ovl0
# (64 free FUs against 40) first for the small builds below
RESERVE_FUS = 24

# (op, tenant, kernel, arg): "build" arg = max_replicas; "run" arg = items.
# tenant-a builds first and hammers ovl0 with a deep backlog; b/c/d then
# arrive mid-storm: a queue-aware scheduler routes them around it
TRACE = [
    ("build", "tenant-a", "poly1", 2),
    *[("run", "tenant-a", "poly1", 200_000)] * 8,
    ("build", "tenant-b", "chebyshev", 2),
    *[("run", "tenant-b", "chebyshev", 150_000)] * 6,
    *[("run", "tenant-a", "poly1", 200_000)] * 4,
    ("build", "tenant-c", "mibench", 2),
    *[("run", "tenant-c", "mibench", 150_000)] * 6,
    ("build", "tenant-d", "qspline", 1),
    *[("run", "tenant-d", "qspline", 100_000)] * 4,
    *[("run", "tenant-b", "chebyshev", 150_000)] * 3,
]


def run_trace(policy: str, device: str = "cuda", session=ModelledSession
              ) -> Dict:
    """Replay TRACE under ``policy``: the modelled fleet metrics, and
    whether every output equals ``run_reference``'s."""
    spec = OverlaySpec(**SPEC_KW)
    sess = session([Device("ovl0", spec), Device("ovl1", spec)],
                   cache=JITCache(capacity=64), policy=policy,
                   device=device)
    sess.contexts["ovl1"].reserve(fus=RESERVE_FUS)
    rng = np.random.default_rng(0)
    progs: Dict = {}
    runs = []
    for op, tenant, kname, arg in TRACE:
        if op == "build":
            progs[(tenant, kname)] = sess.build(
                BENCHMARKS[kname][0], CompileOptions(max_replicas=arg),
                tenant=tenant)
        else:
            prog = progs[(tenant, kname)]
            bufs = [rng.uniform(-1, 1, arg).astype(np.float32)
                    for _ in prog.compiled.dfg.inputs]
            runs.append((prog, bufs, sess.enqueue(prog, *bufs,
                                                  tenant=tenant)))
    makespan = max(c.engine_end_us for c in sess.contexts.values())
    per_dev = {n: round(c.engine_end_us, 1)
               for n, c in sess.contexts.items()}
    placements = {f"{t}/{k}": p.ctx.device.name
                  for (t, k), p in progs.items()}
    exact = all(
        port_bench.same_bits(b.read(), w) for prog, bufs, ev in runs
        for b, w in zip(ev.wait(), port_bench.as_list(
            prog.compiled.run_reference(*bufs))))
    sess.close()
    return dict(policy=policy, makespan_us=round(makespan, 1),
                device_end_us=per_dev, placements=placements,
                kernels_run=len(runs),
                kernels_per_sec=round(len(runs) / (makespan * 1e-6), 1),
                bit_exact=exact)


def bench(device: str = "cuda") -> Dict:
    ms = run_trace("makespan", device)
    ff = run_trace("free_fabric", device)
    return dict(
        spec=SPEC_KW, reserve_fus=RESERVE_FUS, trace_ops=len(TRACE),
        device=device, makespan=ms, free_fabric=ff,
        speedup=round(ff["makespan_us"] / max(ms["makespan_us"], 1e-9), 3))


def check_gate(result: Dict, gate: float) -> List[str]:
    """Makespan-aware placement never worse than free-fabric; every
    output equal to ``run_reference``'s."""
    failures = []
    if result["speedup"] < gate:
        failures.append(
            f"makespan-aware placement only {result['speedup']}x vs "
            f"free-fabric (gate {gate}x): "
            f"{result['makespan']['makespan_us']} vs "
            f"{result['free_fabric']['makespan_us']} us")
    for key in ("makespan", "free_fabric"):
        if not result[key]["bit_exact"]:
            failures.append(f"{key}: an output differs from run_reference")
    return failures


def run(device: str = "cuda", gate: float = 1.0) -> Dict:
    """``bench`` with the card's line and the gates' failures."""
    result = bench(device)
    result["card"] = port_bench.card_line(device)
    result["gate"] = gate
    result["gate_failures"] = check_gate(result, gate)
    return result


def rows(result: Dict) -> List[Dict]:
    """The reference's CSV rows."""
    out = [dict(
        name=f"queue_sched/{key}",
        us_per_call=result[key]["makespan_us"],
        derived=(f"fleet makespan {result[key]['makespan_us']:.0f}us "
                 f"{result[key]['kernels_per_sec']:.0f} kernels/s "
                 f"dev_end={result[key]['device_end_us']}"))
        for key in ("makespan", "free_fabric")]
    out.append(dict(
        name="queue_sched/speedup", us_per_call=0.0,
        derived=f"makespan-aware {result['speedup']}x vs free-fabric"))
    return out


def report(result: Dict) -> None:
    for key in ("makespan", "free_fabric"):
        r = result[key]
        print(f"{key:<12} fleet makespan {r['makespan_us']:>10.1f} us  "
              f"({r['kernels_per_sec']:.0f} kernels/s modelled; "
              f"{r['kernels_run']} executor runs, bit-exact "
              f"{r['bit_exact']})")
        for name, end in r["device_end_us"].items():
            print(f"  {name}: engine end {end:>10.1f} us")
        for prog, dev in r["placements"].items():
            print(f"  {prog:<22} -> {dev}")
    print(f"speedup: makespan-aware {result['speedup']}x vs free-fabric; "
          f"{result['card']}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gate", type=float, default=1.0,
                    help="fail unless makespan-aware >= GATE x free-fabric "
                         "(default 1.0: never worse)")
    return port_bench.bench_main("torch_queue_sched_perf", ap, argv, run,
                                 report)


if __name__ == "__main__":
    sys.exit(main())
