#!/usr/bin/env python3
"""The overlay executor on one CUDA card, against its plain version and a
compiled program.

    PYTHONPATH=src python3 benchmarks/torch_overlay_exec_perf.py \
        [--device cuda] [--json out.json]

The port of ``benchmarks/overlay_exec_perf.py``, which timed the Pallas
executor in interpret mode against a ``jax.jit`` of the DFG.  chebyshev
and poly2, compiled for the default ``OverlaySpec()``, over the
reference's 2^16 work-items and over 2^24, each timed three ways on the
same card tensors (device ms, the median of ``REPS`` CUDA-event windows,
the L2 evicted by a read and the host's enqueue hidden before each):

  * ``executor`` — the CUDA overlay executor (``csrc/overlay_exec.cu``)
    on the program's image;
  * ``plain``    — its plain PyTorch version,
    ``kernels/overlay_exec/ref.py::execute_image`` (one torch op an
    instruction), which takes the place of the reference's Pallas
    interpret-mode column;
  * ``compiled`` — a warm ``torch.compile(fullgraph=True,
    dynamic=False)`` of ``dfg.evaluate`` (Inductor's caches in a fresh
    directory under ``build/overlay_exec_perf/``), the reference's
    ``compiled_mode`` column.

Both the executor and the plain version are held bit for bit against
``run_reference`` (NaN positions compared apart).  The modelled GOPS of
the mapped overlay is printed beside them.  The process exits 1 when an
output differs.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import port_bench  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.paper_suite import BENCHMARKS  # noqa: E402
from repro_torch.core.jit import jit_compile  # noqa: E402
from repro_torch.core.overlay import OverlaySpec  # noqa: E402
from repro_torch.kernels.overlay_exec import kernel, ops, ref  # noqa: E402

KERNELS = ("chebyshev", "poly2")
ITEMS = (1 << 16, 1 << 24)
REPS = 20


def cell(ck, n: int, device: str, reps: int) -> Dict:
    """One kernel at ``n`` work-items: the three ways, timed and checked."""
    dev = torch.device(device)
    xs = [np.linspace(-1, 1, n).astype(np.float32) for _ in ck.dfg.inputs]
    want = port_bench.as_list(ck.run_reference(*xs))
    image = ops.load_image(ck.program, dev)
    x = port_bench.stacked(xs, dev)
    rows = [x[i] for i in range(x.shape[0])]
    plain = lambda: ref.execute_image(image.instrs, image.imms,  # noqa: E731
                                      image.n_regs, x, image.n_out)
    execute = lambda: kernel.overlay_execute(image, x)  # noqa: E731
    exact = {
        "executor": all(port_bench.same_bits(o.cpu().numpy(), w)
                        for o, w in zip(execute(), want)),
        "plain": all(port_bench.same_bits(o.cpu().numpy(), w)
                     for o, w in zip(plain(), want))}
    times = {"executor": port_bench.device_times(execute, dev, reps),
             "plain": port_bench.device_times(plain, dev, reps)}
    with port_bench.compile_caches("overlay_exec_perf"):
        compiled = port_bench.compile_dfg(ck.dfg)
        times["compiled"] = port_bench.device_times(
            lambda: compiled(*rows), dev, reps)
    out = dict(kernel=ck.name, items=n, n_instr=image.n_instr,
               ops_per_item=len(ck.dfg.op_nodes()),
               model_gops=ck.throughput_gops(), bit_exact=exact)
    for key, ts in times.items():
        out[f"{key}_ms"] = statistics.median(ts)
        out[f"{key}_ms_all"] = ts
    return out


def bench(device: str = "cuda", items: Sequence[int] = ITEMS,
          reps: int = REPS) -> Dict:
    spec = OverlaySpec()
    cells = []
    for name in KERNELS:
        ck = jit_compile(BENCHMARKS[name][0], spec)
        cells += [cell(ck, n, device, reps) for n in items]
    return dict(device=device, reps=reps, cells=cells)


def check_gate(result: Dict) -> List[str]:
    return [f"{c['kernel']} at N={c['items']}: the {way} output differs "
            f"from run_reference"
            for c in result["cells"] for way, ok in c["bit_exact"].items()
            if not ok]


def run(device: str = "cuda", items: Sequence[int] = ITEMS,
        reps: int = REPS) -> Dict:
    """``bench`` with the card's line and the gate's failures."""
    result = bench(device, items, reps)
    result["card"] = port_bench.card_line(device)
    result["gate_failures"] = check_gate(result)
    return result


def rows(result: Dict) -> List[Dict]:
    """The reference's CSV rows: the compiled program's µs first, then the
    executor and the plain version in place of Pallas interpret mode."""
    return [dict(
        name=f"overlay_exec/{c['kernel']}@{c['items']}",
        us_per_call=c["compiled_ms"] * 1e3,
        derived=(f"compiled_mode={c['compiled_ms'] * 1e3:.1f}us "
                 f"executor={c['executor_ms'] * 1e3:.1f}us "
                 f"plain={c['plain_ms'] * 1e3:.1f}us items={c['items']} "
                 f"model_gops={c['model_gops']:.1f}"))
        for c in result["cells"]]


def report(result: Dict) -> None:
    card = result["card"]
    for c in result["cells"]:
        gops = c["ops_per_item"] * c["items"] / (c["executor_ms"] * 1e6)
        print(f"overlay_exec/{c['kernel']} at {c['items']} work-items "
              f"({c['n_instr']} instructions): executor "
              f"{c['executor_ms']:.4f} ms ({gops:.1f} GOPS), plain "
              f"{c['plain_ms']:.4f} ms, torch.compile {c['compiled_ms']:.4f}"
              f" ms (medians of {result['reps']}); modelled overlay "
              f"{c['model_gops']:.1f} GOPS; bit-exact {c['bit_exact']}; "
              f"{card}")


def main(argv: Optional[List[str]] = None) -> int:
    return port_bench.bench_main("torch_overlay_exec_perf",
                                 argparse.ArgumentParser(), argv, run, report)


if __name__ == "__main__":
    sys.exit(main())
