#!/usr/bin/env python3
"""The port's benchmark harness: every suite of ``benchmarks/run.py`` that
the port has, on one CUDA card.

    PYTHONPATH=src python3 benchmarks/torch_run.py [--suite NAME] \
        [--json PATH] [--device cuda]

  par_time              → paper Fig. 7  (overlay PAR against torch.compile)
  replication_scaling   → paper Fig. 6  (modelled GOPS beside the executor's)
  resource_table        → paper Table III (and the executor's work-items/s)
  reconfig_time         → paper §IV     (a swap against a recompile)
  overlay_exec_perf     → the executor against its plain version
  template_build_perf   → template stamping against the joint annealer
  persistent_cache_perf → a process restart over the disk cache
  queue_sched_perf      → makespan-aware against free-fabric placement
  graph_replay_perf     → fused graph replay against node-at-a-time
  jit_cache_perf        → cold against warm builds, queue, verify levels
  chaos_serving_perf    → injected faults and a lost device
  fleet_warm_start_perf → the remote cache tier and the compile farm
  serving_perf          → continuous batching against one at a time
  trace_overhead_perf   → tracing off costs nothing; profile re-cuts
  model_step            → a reduced train and decode step per architecture

Each suite is ``benchmarks/torch_<name>.py``, run through its ``run``
(the template suite at the reference's ``--smoke`` sizes, as the
reference's harness runs it; the persistent cache at its four kernels,
where the reference recorded its 50x gate: at the smoke set's two even
the reference's recorded builds give 47.5x).  Prints the reference's
``name,us_per_call,derived`` CSV, after the card's name and power limit;
``--json PATH`` also writes the rows, one object per row with
``suite``/``name``/``us_per_call``/``derived``.  It never writes
``BENCH_compile.json``, which stays the reference's record.  Exits 1 when
a suite raises or any suite's gate failed (each failure is printed to
stderr), 2 without a card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import traceback
from pathlib import Path
from typing import Dict, List, Optional

sys.path.insert(0, str(Path(__file__).resolve().parent))

import port_bench  # noqa: E402
import torch  # noqa: E402

SUITES = ("par_time", "replication_scaling", "resource_table",
          "reconfig_time", "overlay_exec_perf", "template_build_perf",
          "persistent_cache_perf", "queue_sched_perf", "graph_replay_perf",
          "jit_cache_perf", "chaos_serving_perf", "fleet_warm_start_perf",
          "serving_perf", "trace_overhead_perf", "model_step")
# the reference harness runs the template suite at its CI size
RUN_KWARGS: Dict[str, Dict] = {"template_build_perf": dict(smoke=True)}


def run_suite(name: str, device: str) -> List[Dict]:
    """One suite's rows; raises when it raises or a gate failed."""
    mod = importlib.import_module(f"torch_{name}")
    result = mod.run(device, **RUN_KWARGS.get(name, {}))
    if result["gate_failures"]:
        raise RuntimeError(f"{len(result['gate_failures'])} gate(s) failed: "
                           + "; ".join(result["gate_failures"]))
    return [dict(suite=name, **row) for row in mod.rows(result)]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--suite", choices=SUITES, default=None,
                    help="run one suite (default: all)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write the rows as JSON")
    ap.add_argument("--device", default="cuda",
                    help="where the suites run (default: the CUDA card; "
                         "cpu rehearses on the CPU)")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("torch_run: no CUDA device (pass --device cpu to rehearse on "
              "the CPU)", file=sys.stderr)
        return 2
    print(port_bench.card_line(args.device), flush=True)
    print("name,us_per_call,derived")
    failed, out_rows = [], []
    for name in [args.suite] if args.suite else SUITES:
        try:
            rows = run_suite(name, args.device)
        except (Exception, SystemExit) as e:  # noqa: BLE001 - reported
            traceback.print_exc()
            print(f"{name}: FAILED: {type(e).__name__}: {e}",
                  file=sys.stderr)
            failed.append(name)
            continue
        for row in rows:
            print(f"{row['name']},{row['us_per_call']:.2f},"
                  f"\"{row['derived']}\"", flush=True)
        out_rows += rows
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out_rows, f, indent=1)
        print(f"wrote {len(out_rows)} rows to {args.json}", file=sys.stderr)
    if failed:
        print(f"failed suites: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
