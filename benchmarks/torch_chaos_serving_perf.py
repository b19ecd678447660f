#!/usr/bin/env python3
"""Fault injection and device loss on the port's Session, on one CUDA card.

    PYTHONPATH=src python3 benchmarks/torch_chaos_serving_perf.py \
        [--gate 2.0] [--device cuda] [--json out.json]

The port of ``benchmarks/chaos_serving_perf.py``: one deterministic
mixed-tenant trace replayed twice on an identical two-overlay fleet
(``OverlaySpec(8, 8, 2)``):

  * **fault-free** — no fault plan;
  * **chaos** — a seeded ``FaultPlan`` injects about 5 % transient faults
    into place and route and 3 % into ``queue_submit`` and
    ``device_exec``, and halfway through the trace the device carrying
    the most resident programs is declared lost (``fail_device``) at the
    midpoint of its modelled timeline: its programs migrate and the
    commands it had not finished run again on the survivor.

Every run, the retried and the re-executed ones included, launches the
executor on buffers on the card.  The reference's three gates (the
process exits 1 on any): every request completes; every chaos output's
sha256 equals the fault-free run's; the chaos makespan is at most
``--gate`` (2.0) times the fault-free one.  Also: both runs leave the
resource ledger consistent, the chaos run injected faults, and every
fault-free output equals ``run_reference``'s bit for bit (NaN positions
apart), where the reference ran ``run_reference`` in numpy on the host.
The Sessions build on one worker with the host clock held at 0 µs
(``port_bench.ModelledSession``), so the makespans are the queues' model.
"""

from __future__ import annotations

import argparse
import hashlib
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import port_bench  # noqa: E402
from port_bench import ModelledSession  # noqa: E402

from repro_torch.configs.paper_suite import BENCHMARKS  # noqa: E402
from repro_torch.core.cache import JITCache  # noqa: E402
from repro_torch.core.faults import FaultPlan  # noqa: E402
from repro_torch.core.options import CompileOptions  # noqa: E402
from repro_torch.core.overlay import OverlaySpec  # noqa: E402
from repro_torch.core.recovery import RetryPolicy  # noqa: E402
from repro_torch.core.runtime import Device  # noqa: E402

SPEC_KW = dict(width=8, height=8, dsp_per_fu=2)
# the reference's seed: its rates fire on both planes over this trace
FAULT_SEED = 4
COMPILE_FAULT_RATE = 0.05       # per place/route visit
EXEC_FAULT_RATE = 0.03          # per submit/exec visit

# (op, tenant, kernel, arg): "build" arg = max_replicas; "run" arg = items
TRACE = [
    ("build", "tenant-a", "poly1", 2),
    *[("run", "tenant-a", "poly1", 100_000)] * 6,
    ("build", "tenant-b", "chebyshev", 2),
    *[("run", "tenant-b", "chebyshev", 80_000)] * 5,
    ("build", "tenant-c", "mibench", 2),
    *[("run", "tenant-c", "mibench", 80_000)] * 4,
    # -------- the device failure lands here (halfway) in the chaos run
    *[("run", "tenant-a", "poly1", 100_000)] * 5,
    ("build", "tenant-d", "qspline", 1),
    *[("run", "tenant-d", "qspline", 60_000)] * 4,
    *[("run", "tenant-b", "chebyshev", 80_000)] * 4,
]
FAIL_AT_OP = len(TRACE) // 2


def _chaos_plan() -> FaultPlan:
    return (FaultPlan(seed=FAULT_SEED)
            .add("place", rate=COMPILE_FAULT_RATE)
            .add("route", rate=COMPILE_FAULT_RATE)
            .add("queue_submit", rate=EXEC_FAULT_RATE)
            .add("device_exec", rate=EXEC_FAULT_RATE))


def run_trace(chaos: bool, device: str = "cuda", session=ModelledSession
              ) -> Dict:
    """Replay TRACE: modelled fleet metrics, each request's output digest
    (in trace order) and whether each output equals ``run_reference``'s."""
    spec = OverlaySpec(**SPEC_KW)
    sess = session([Device("ovl0", spec), Device("ovl1", spec)],
                   cache=JITCache(capacity=64),
                   faults=_chaos_plan() if chaos else None,
                   retry=RetryPolicy(backoff_us=100.0,
                                     max_backoff_us=2_000.0,
                                     enqueue_retries=6),
                   device=device)
    rng = np.random.default_rng(0)
    progs: Dict = {}
    runs = []
    failed_device: Optional[str] = None
    for i, (op, tenant, kname, arg) in enumerate(TRACE):
        if chaos and i == FAIL_AT_OP:
            # the device carrying the most resident programs, lost at the
            # midpoint of its modelled timeline: later work runs again
            by_dev = [p.ctx.device.name for p in progs.values()
                      if not p.released]
            failed_device = max(set(by_dev), key=by_dev.count)
            at = sess.contexts[failed_device].engine_end_us * 0.5
            sess.fail_device(failed_device, at_us=at)
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
    digests, exact = [], True
    for prog, bufs, ev in runs:
        h = hashlib.sha256()
        outs = [b.read() for b in ev.wait()]
        for out in outs:
            h.update(np.ascontiguousarray(out).tobytes())
        digests.append(h.hexdigest())
        exact &= all(port_bench.same_bits(o, w) for o, w in zip(
            outs, port_bench.as_list(prog.compiled.run_reference(*bufs))))
    makespan = max(c.engine_end_us for c in sess.contexts.values())
    stats = sess.stats()
    result = dict(chaos=chaos, makespan_us=round(makespan, 1),
                  requests=len(runs), digests=digests, bit_exact=exact,
                  recovery={k: v for k, v in stats["recovery"].items()
                            if k != "breakers"},
                  ledger_consistent=sess.ledger_consistent())
    if chaos:
        result["failed_device"] = failed_device
        result["faults"] = stats["faults"]
    sess.close()
    return result


def bench(device: str = "cuda") -> Dict:
    clean = run_trace(False, device)
    dirty = run_trace(True, device)
    n_runs = sum(1 for op, *_ in TRACE if op == "run")
    return dict(
        spec=SPEC_KW, trace_ops=len(TRACE), fail_at_op=FAIL_AT_OP,
        fault_seed=FAULT_SEED, device=device,
        fault_rates=dict(compile=COMPILE_FAULT_RATE, exec=EXEC_FAULT_RATE),
        fault_free=clean, chaos=dirty,
        all_complete=(dirty["requests"] == n_runs),
        bit_identical=(dirty["digests"] == clean["digests"]),
        degradation=round(dirty["makespan_us"] /
                          max(clean["makespan_us"], 1e-9), 3))


def check_gate(result: Dict, gate: float) -> List[str]:
    failures = []
    if not result["all_complete"]:
        failures.append(
            f"chaos run completed {result['chaos']['requests']} of "
            f"{sum(1 for op, *_ in TRACE if op == 'run')} requests")
    if not result["bit_identical"]:
        bad = sum(1 for a, b in zip(result["chaos"]["digests"],
                                    result["fault_free"]["digests"])
                  if a != b)
        failures.append(f"{bad} chaos outputs differ from fault-free run")
    if result["degradation"] > gate:
        failures.append(
            f"degraded makespan {result['degradation']}x fault-free "
            f"(gate {gate}x): {result['chaos']['makespan_us']} vs "
            f"{result['fault_free']['makespan_us']} us")
    for key in ("fault_free", "chaos"):
        if not result[key]["ledger_consistent"]:
            failures.append(f"{key} run left the resource ledger "
                            f"inconsistent")
    if not result["fault_free"]["bit_exact"]:
        failures.append("a fault-free output differs from run_reference")
    if not result["chaos"]["faults"]["injected"]:
        failures.append("chaos run injected no faults: the gate proved "
                        "nothing")
    return failures


def run(device: str = "cuda", gate: float = 2.0) -> Dict:
    """``bench`` with the card's line and the gates' failures."""
    result = bench(device)
    result["card"] = port_bench.card_line(device)
    result["gate"] = gate
    result["gate_failures"] = check_gate(result, gate)
    return result


def rows(result: Dict) -> List[Dict]:
    """The reference's CSV rows."""
    out = []
    for key in ("fault_free", "chaos"):
        r = result[key]
        rec = r["recovery"]
        healed = (rec["retries"] + rec["enqueue_retries"] +
                  rec["fallback_joint"] + rec["fallback_nodewise"] +
                  rec["requeued_events"])
        out.append(dict(
            name=f"chaos_serving/{key}", us_per_call=r["makespan_us"],
            derived=(f"fleet makespan {r['makespan_us']:.0f}us "
                     f"{r['requests']} requests, {healed} recoveries, "
                     f"migrated={rec['migrated_programs']}")))
    out.append(dict(
        name="chaos_serving/degradation", us_per_call=0.0,
        derived=(f"{result['degradation']}x fault-free makespan; "
                 f"bit_identical={result['bit_identical']} "
                 f"all_complete={result['all_complete']}")))
    return out


def report(result: Dict) -> None:
    for key in ("fault_free", "chaos"):
        r = result[key]
        nonzero = {k: v for k, v in r["recovery"].items()
                   if v and k != "breaker_trips"}
        print(f"{key:<11} fleet makespan {r['makespan_us']:>10.1f} us  "
              f"({r['requests']} requests, every one an executor launch); "
              f"recovery {nonzero}")
    chaos = result["chaos"]
    print(f"chaos: failed device {chaos['failed_device']} at op "
          f"{result['fail_at_op']}, injected {chaos['faults']['injected']}")
    print(f"degradation {result['degradation']}x, "
          f"bit_identical={result['bit_identical']}, "
          f"all_complete={result['all_complete']}, fault-free against "
          f"run_reference {result['fault_free']['bit_exact']}; "
          f"{result['card']}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gate", type=float, default=2.0,
                    help="max degraded/fault-free makespan ratio "
                         "(default 2.0)")
    return port_bench.bench_main("torch_chaos_serving_perf", ap, argv, run,
                                 report)


if __name__ == "__main__":
    sys.exit(main())
