#!/usr/bin/env python3
"""The paper's Fig. 7 on one CUDA card: overlay place and route against a
backend compile of the same kernel.

    PYTHONPATH=src python3 benchmarks/torch_par_time.py \
        [--device cuda] [--json out.json]

The port of ``benchmarks/par_time.py``, one row per paper kernel, compiled
for ``OverlaySpec(8, 8, 2)`` at the paper's replica counts:

  * ``overlay_par`` — the overlay's place and route (with stamping and
    gap fill) on the host, ``CompiledKernel.par_time_ms``, and the
    frontend's ms;
  * ``paper_vivado`` — the paper's measured direct-FPGA PAR time
    (``PAPER_DIRECT`` of ``torch_resource_table.py``, quoted constants)
    and the overlay's speed-up over it;
  * ``torch_compile`` — the reference's ``xla_elementwise`` column (a
    ``jax.jit(...).lower().compile()`` of the DFG) becomes a cold
    ``torch.compile(fullgraph=True, dynamic=False)`` of ``dfg.evaluate``
    on card tensors of 4096 work-items: first call minus a warm call,
    with Inductor's FX-graph cache off and its and Triton's caches in a
    fresh directory under ``build/par_time/``, after one throwaway
    compile has paid the compiler's set-up (``port_bench.recompile_ms``,
    the yardstick of ``torch_reconfig_time.py``).  Like the reference's,
    it is a floor of a program-as-code backend, not a vendor flow.

No gate: the process exits 0 unless a step raises.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import port_bench  # noqa: E402
from torch_resource_table import PAPER_DIRECT  # noqa: E402

from repro_torch.configs.paper_suite import BENCHMARKS  # noqa: E402
from repro_torch.core.jit import jit_compile  # noqa: E402
from repro_torch.core.options import CompileOptions  # noqa: E402
from repro_torch.core.overlay import OverlaySpec  # noqa: E402

SPEC = OverlaySpec(width=8, height=8, dsp_per_fu=2)
N_ITEMS = 4096


def recompile_ms(dfg, *xs: torch.Tensor) -> Dict[str, float]:
    return port_bench.recompile_ms(dfg, *xs, sub="par_time")


def bench(device: str = "cuda", recompile: Callable = recompile_ms) -> Dict:
    """One row per paper kernel: the overlay's PAR beside ``recompile`` of
    its DFG on ``device``."""
    dev = torch.device(device)
    x = torch.zeros(N_ITEMS, dtype=torch.float32, device=dev)
    port_bench.warm_compiler(recompile, x)
    rows = []
    for name, (src, paper_replicas, _oracle) in sorted(BENCHMARKS.items()):
        ck = jit_compile(src, SPEC,
                         opts=CompileOptions(max_replicas=paper_replicas))
        rc = recompile(ck.dfg, *([x] * len(ck.dfg.inputs)))
        vivado_s = PAPER_DIRECT[name]["par_s"]
        rows.append(dict(
            kernel=name, replicas=ck.plan.replicas,
            overlay_par_ms=ck.par_time_ms,
            frontend_ms=ck.stage_times_ms["frontend"],
            paper_vivado_s=vivado_s,
            speedup_vs_vivado=vivado_s * 1e3 / max(ck.par_time_ms, 1e-9),
            torch_compile=rc))
    return dict(spec=dict(width=SPEC.width, height=SPEC.height,
                          dsp_per_fu=SPEC.dsp_per_fu),
                device=device, items=N_ITEMS, rows=rows)


def run(device: str = "cuda") -> Dict:
    """``bench`` with the card's line (no gate)."""
    result = bench(device)
    result["card"] = port_bench.card_line(device)
    result["gate_failures"] = []
    return result


def rows(result: Dict) -> List[Dict]:
    """The reference's CSV rows, ``xla_elementwise`` now ``torch_compile``."""
    return [dict(
        name=f"par_time/{r['kernel']}({r['replicas']})",
        us_per_call=r["overlay_par_ms"] * 1e3,
        derived=(f"overlay_par={r['overlay_par_ms']:.1f}ms "
                 f"frontend={r['frontend_ms']:.1f}ms "
                 f"paper_vivado={r['paper_vivado_s']}s "
                 f"speedup_vs_vivado={r['speedup_vs_vivado']:.0f}x "
                 f"torch_compile={r['torch_compile']['compile_ms']:.1f}ms"))
        for r in result["rows"]]


def report(result: Dict) -> None:
    card = result["card"]
    for row, r in zip(rows(result), result["rows"]):
        rc = r["torch_compile"]
        print(f"{row['name']}: {row['derived']} (first call "
              f"{rc['first_ms']:.1f}, warm {rc['warm_ms']:.3f}; overlay PAR "
              f"{rc['compile_ms'] / max(r['overlay_par_ms'], 1e-9):.0f}x "
              f"faster); {card}")


def main(argv: Optional[List[str]] = None) -> int:
    return port_bench.bench_main("torch_par_time", argparse.ArgumentParser(),
                                 argv, run, report)


if __name__ == "__main__":
    sys.exit(main())
