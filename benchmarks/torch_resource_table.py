#!/usr/bin/env python3
"""The paper's Table III on one CUDA card: what each kernel takes of the
overlay, and what the H100 executor does with it.

    PYTHONPATH=src python3 benchmarks/torch_resource_table.py \
        [--device cuda] [--json out.json]

The port of ``benchmarks/resource_table.py``.  The paper's six kernels
are compiled for ``OverlaySpec(8, 8, 2)`` at the paper's replica counts,
and each row gives the reference's host columns: PAR time, FUs, DSPs,
wires, configuration bytes, pipeline depth, the overlay's modelled Fmax,
and the paper's measured direct-FPGA figures (``PAPER_DIRECT``, quoted
constants from the paper's Table III, Vivado 2014.2 on an XC7Z020).

The card's leg runs each artifact's program once over 2^24 work-items on
the executor, held bit for bit against ``run_reference``, and prints the
work-items a second it reached (one CUDA-event window, the L2 evicted and
the host's enqueue hidden before it) beside the overlay's modelled rate,
replicas x ``fclk_mhz`` (each replica retires one work-item a cycle).
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

SPEC = OverlaySpec(width=8, height=8, dsp_per_fu=2)
N_ITEMS = 1 << 24

# paper Table III 'Direct FPGA implementations' (Vivado 2014.2, XC7Z020)
PAPER_DIRECT = {
    "chebyshev": dict(par_s=240, fmax=225, dsp=48, slices=251),
    "sgfilter": dict(par_s=396, fmax=185, dsp=100, slices=797),
    "mibench": dict(par_s=245, fmax=230, dsp=21, slices=403),
    "qspline": dict(par_s=242, fmax=165, dsp=36, slices=307),
    "poly1": dict(par_s=256, fmax=175, dsp=36, slices=425),
    "poly2": dict(par_s=270, fmax=172, dsp=40, slices=453),
}


def bench(device: str = "cuda", items: int = N_ITEMS) -> Dict:
    """The table's rows, each artifact launched once over ``items``."""
    rng = np.random.default_rng(0)
    rows = []
    for name, (src, paper_replicas, _) in sorted(BENCHMARKS.items()):
        ck = jit_compile(src, SPEC,
                         opts=CompileOptions(max_replicas=paper_replicas))
        xs = [rng.uniform(-1, 1, items).astype(np.float32)
              for _ in ck.dfg.inputs]
        r = port_bench.executor_reading(
            ck.program, xs, port_bench.as_list(ck.run_reference(*xs)),
            device, reps=1)
        res = ck.resources()
        rows.append(dict(
            kernel=name, replicas=ck.plan.replicas,
            par_time_ms=ck.par_time_ms, fus=res["fus"], dsp=res["dsp"],
            wires=res["wires"], config_bytes=res["config_bytes"],
            depth=ck.pipeline_depth, fmax_mhz=SPEC.fclk_mhz,
            paper_direct=PAPER_DIRECT[name],
            modelled_items_per_s=ck.plan.replicas * SPEC.fclk_mhz * 1e6,
            exec_ms=r["ms"], exec_items_per_s=items / (r["ms"] * 1e-3),
            bit_exact=r["bit_exact"]))
    return dict(spec=dict(width=SPEC.width, height=SPEC.height,
                          dsp_per_fu=SPEC.dsp_per_fu),
                device=device, items=items, rows=rows)


def check_gate(result: Dict) -> List[str]:
    return [f"{r['kernel']}: the launch differs from run_reference"
            for r in result["rows"] if not r["bit_exact"]]


def run(device: str = "cuda", items: int = N_ITEMS) -> Dict:
    """``bench`` with the card's line and the gate's failures."""
    result = bench(device, items)
    result["card"] = port_bench.card_line(device)
    result["gate_failures"] = check_gate(result)
    return result


def rows(result: Dict) -> List[Dict]:
    """The reference's CSV rows, the card's rate appended."""
    out = []
    for r in result["rows"]:
        direct = r["paper_direct"]
        out.append(dict(
            name=f"resource_table/{r['kernel']}({r['replicas']})",
            us_per_call=r["par_time_ms"] * 1e3,
            derived=(
                f"fus={r['fus']} dsp={r['dsp']} wires={r['wires']} "
                f"cfg_bytes={r['config_bytes']} "
                f"depth={r['depth']}cyc fmax={r['fmax_mhz']:.0f}MHz "
                f"paper_direct_par={direct['par_s']}s "
                f"paper_direct_fmax={direct['fmax']}MHz "
                f"par_speedup_vs_paper_direct="
                f"{direct['par_s'] * 1e3 / max(r['par_time_ms'], 1e-9):.0f}x "
                f"modelled_items_per_s={r['modelled_items_per_s']:.4g} "
                f"exec_items_per_s={r['exec_items_per_s']:.4g}")))
    return out


def report(result: Dict) -> None:
    card = result["card"]
    for row, r in zip(rows(result), result["rows"]):
        print(f"{row['name']}: {row['derived']}")
        print(f"  executor over {result['items']} work-items: "
              f"{r['exec_ms']:.4f} ms, {r['exec_items_per_s']:.4g} "
              f"work-items/s against the overlay's modelled "
              f"{r['modelled_items_per_s']:.4g} ({r['replicas']} replicas x "
              f"{r['fmax_mhz']:.0f} MHz): "
              f"{r['exec_items_per_s'] / r['modelled_items_per_s']:.2f}x; "
              f"bit-exact {r['bit_exact']}; {card}")


def main(argv: Optional[List[str]] = None) -> int:
    return port_bench.bench_main("torch_resource_table",
                                 argparse.ArgumentParser(), argv, run, report)


if __name__ == "__main__":
    sys.exit(main())
