#!/usr/bin/env python3
"""The paper's Fig. 6 on one CUDA card: throughput against replication.

    PYTHONPATH=src python3 benchmarks/torch_replication_scaling.py \
        [--device cuda] [--json out.json]

The port of ``benchmarks/replication_scaling.py``.  chebyshev is compiled
for ``OverlaySpec(s, s, dsp)``, s = 2 ... 8, dsp in {1, 2}, at
``place_effort=0.3``; a size whose placement fails
(``PlacementError``) is skipped, as in the reference.  Each size gives the
reference's modelled columns: replicas, ``throughput_gops`` (every
replica retires one iteration a cycle at the overlay's 300 MHz until the
perimeter I/O saturates), ``peak_gops``, their fraction and what limits
the replication.

Beside them it reads the H100 executor: the program
``compile_program(ck.dfg)`` (one replica's DFG, the image every launch of
the kernel runs) over 2^24 work-items, held bit for bit against
``run_reference`` and timed (the median of ``REPS`` launches, the L2
evicted by a read and the host's enqueue hidden before each).  Its GOPS
are ``len(dfg.op_nodes())`` x work-items / kernel seconds.  The image
does not depend on the overlay size, only on the FU fusion that ``dsp``
selects, so the card gives one reading per ``dsp`` and it cannot scale
with s: the executor interprets the program once per work-item whatever
overlay it was mapped to.  The ratio printed for each size, modelled
GOPS / measured GOPS, says how the modelled overlay of that size compares
with the card: below 1 the card out-runs it, and the size where it
crosses 1 is the overlay (at 300 MHz) whose throughput the H100 executor
matches.  It is not a scaling the card shows.

The process exits 1 when a launch differs from ``run_reference``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import port_bench  # noqa: E402

from repro_torch.configs.paper_suite import BENCHMARKS  # noqa: E402
from repro_torch.core.jit import jit_compile  # noqa: E402
from repro_torch.core.options import CompileOptions  # noqa: E402
from repro_torch.core.overlay import OverlaySpec  # noqa: E402
from repro_torch.core.place import PlacementError  # noqa: E402
from repro_torch.core.program import compile_program  # noqa: E402

KERNEL = "chebyshev"
SIZES = (2, 3, 4, 5, 6, 7, 8)
DSPS = (1, 2)
N_ITEMS = 1 << 24
REPS = 20


def sweep() -> List[Dict]:
    """The reference's rows: one per size that places."""
    src = BENCHMARKS[KERNEL][0]
    rows = []
    for dsp in DSPS:
        for size in SIZES:
            spec = OverlaySpec(width=size, height=size, dsp_per_fu=dsp)
            try:
                ck = jit_compile(src, spec,
                                 opts=CompileOptions(place_effort=0.3))
            except PlacementError:
                continue
            gops = ck.throughput_gops()
            peak = spec.peak_gops()
            rows.append(dict(
                size=size, dsp=dsp, replicas=ck.plan.replicas,
                throughput_gops=gops, peak_gops=peak, frac=gops / peak,
                limited_by=ck.plan.limited_by, par_time_ms=ck.par_time_ms,
                ops_per_item=len(ck.dfg.op_nodes()),
                program=compile_program(ck.dfg), ck=ck))
    return rows


def bench(device: str = "cuda", items: int = N_ITEMS,
          reps: int = REPS) -> Dict:
    """The sweep, and the executor read once per distinct program."""
    rows = sweep()
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, items).astype(np.float32)
    readings: Dict[str, Dict] = {}
    for row in rows:
        prog = row.pop("program")
        ck = row.pop("ck")
        key = prog.content_hash()
        if key not in readings:
            r = port_bench.executor_reading(
                prog, [x], port_bench.as_list(ck.run_reference(x)), device,
                reps)
            r.update(dsps=[], n_instr=prog.n_instr,
                     ops_per_item=row["ops_per_item"],
                     gops=row["ops_per_item"] * items / (r["ms"] * 1e6))
            readings[key] = r
        if row["dsp"] not in readings[key]["dsps"]:
            readings[key]["dsps"].append(row["dsp"])
        row["program_hash"] = key
        row["measured_gops"] = readings[key]["gops"]
        row["modelled_over_measured"] = \
            row["throughput_gops"] / row["measured_gops"]
    return dict(kernel=KERNEL, device=device, items=items, reps=reps,
                rows=rows, executor=readings)


def check_gate(result: Dict) -> List[str]:
    return [f"{KERNEL} (dsp {r['dsps']}): a launch differs from "
            f"run_reference" for r in result["executor"].values()
            if not r["bit_exact"]]


def run(device: str = "cuda", items: int = N_ITEMS, reps: int = REPS
        ) -> Dict:
    """``bench`` with the card's line and the gate's failures."""
    result = bench(device, items, reps)
    result["card"] = port_bench.card_line(device)
    result["gate_failures"] = check_gate(result)
    return result


def rows(result: Dict) -> List[Dict]:
    """The reference's CSV rows, the card's reading appended."""
    return [dict(
        name=f"replication/{KERNEL}_{r['size']}x{r['size']}_dsp{r['dsp']}",
        us_per_call=r["par_time_ms"] * 1e3,
        derived=(f"replicas={r['replicas']} "
                 f"gops={r['throughput_gops']:.2f} "
                 f"peak={r['peak_gops']:.1f} frac={r['frac']:.2f} "
                 f"limited_by={r['limited_by']} "
                 f"exec_gops={r['measured_gops']:.2f} "
                 f"modelled_over_exec={r['modelled_over_measured']:.4f}"))
        for r in result["rows"]]


def report(result: Dict) -> None:
    """The card's reading once per ``dsp``, each size's modelled GOPS and
    its ratio to that reading below it."""
    card = result["card"]
    for dsp in DSPS:
        sizes = [row for row in result["rows"] if row["dsp"] == dsp]
        for key in dict.fromkeys(row["program_hash"] for row in sizes):
            r = result["executor"][key]
            print(f"executor, dsp {dsp}: {r['n_instr']} instructions, "
                  f"{r['ops_per_item']} ops a work-item, {r['ms']:.4f} ms "
                  f"at {r['items']} work-items (median of "
                  f"{result['reps']}): {r['gops']:.2f} GOPS; bit-exact "
                  f"{r['bit_exact']}; {card}")
        for row in sizes:
            print(f"  {row['size']}x{row['size']}: replicas "
                  f"{row['replicas']:>2}, modelled "
                  f"{row['throughput_gops']:7.2f} of peak "
                  f"{row['peak_gops']:6.1f} GOPS ({row['frac']:.2f}, "
                  f"{row['limited_by']}); modelled / measured "
                  f"{row['modelled_over_measured']:.4f}")


def main(argv: Optional[List[str]] = None) -> int:
    return port_bench.bench_main("torch_replication_scaling",
                                 argparse.ArgumentParser(), argv, run, report)


if __name__ == "__main__":
    sys.exit(main())
