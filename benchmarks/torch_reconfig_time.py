#!/usr/bin/env python3
"""The paper's §IV claim on one CUDA card: swapping kernels on the overlay
is a configuration write, not a recompile.

    PYTHONPATH=src python3 benchmarks/torch_reconfig_time.py \
        [--rebuild] [--device cuda] [--json out.json]

The port of ``benchmarks/reconfig_time.py``.  The paper's overlay loads a
kernel in 42.4 µs where the FPGA fabric takes 31.6 ms.  Here the programs
poly1 → poly2 → chebyshev are compiled for ``OverlaySpec(8, 8, 2)`` at one
replica and padded to one signature (the reference's padding: the longest
program + 8 instructions, the largest register file + 3 slots), and each
is timed three ways:

  (a) **the swap**: ``ExecImage.write`` of the program into the one
      resident image, plus its first launch over 4096 work-items, on the
      executor built once (``kernel.LIBRARY.builds`` stays 1); the host
      clock around write, launch and a synchronise, the median of
      ``SWAP_ROUNDS`` rounds in turns over the three programs, and the
      first, cold swap;
  (b) **a recompile**, the yardstick the reference takes with
      ``jax.jit(...).lower().compile()``: ``torch.compile(fullgraph=True,
      dynamic=False)`` of the DFG's ``evaluate`` on card tensors, its first
      call minus a warm call, after ``torch._dynamo.reset()`` and with
      Inductor's and Triton's caches in a fresh directory under ``build/``
      and Inductor's FX-graph cache off, so it is a real compile and no
      cache hit; a first compile of another function has paid the
      compiler's once-a-process set-up (``port_bench.recompile_ms``,
      shared with ``torch_par_time.py``).  It ports nothing; it is the
      cost a program-as-code design would pay per kernel;
  (c) with ``--rebuild`` only, **an executor rebuild**: a cold ``nvcc``
      build of ``csrc/overlay_exec.cu`` into a fresh directory under
      ``build/`` through ``cuda_build.py``.

Every swapped launch is held bit for bit against ``run_reference``.  The
modelled FPGA configuration time (``Bitstream.load_time_us``) is printed
beside the readings with the paper's figures.  The first line is the
card's name and power limit; the last line is one JSON object.  The
process exits 1 when a gate fails: a swap that rebuilt the executor, or a
swapped launch that differs from ``run_reference``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import port_bench  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.paper_suite import BENCHMARKS  # noqa: E402
from repro_torch.core.jit import jit_compile  # noqa: E402
from repro_torch.core.options import CompileOptions  # noqa: E402
from repro_torch.core.overlay import OverlaySpec  # noqa: E402
from repro_torch.kernels.overlay_exec import kernel, ops  # noqa: E402

SPEC = OverlaySpec(width=8, height=8, dsp_per_fu=2)
NAMES = ("poly1", "poly2", "chebyshev")
N_ITEMS = 4096
SWAP_ROUNDS = 20
PAPER = "paper: 42.4 us overlay configuration vs 31.6 ms fabric"


def programs() -> Dict:
    """The three artifacts and the one signature they are padded to."""
    cks = {n: jit_compile(BENCHMARKS[n][0], SPEC,
                          opts=CompileOptions(max_replicas=1))
           for n in NAMES}
    pad_to = max(ck.program.n_instr for ck in cks.values()) + 8
    pad_regs = max(ck.program.n_regs for ck in cks.values()) + 1 + 2
    return dict(cks=cks, pad_to=pad_to, pad_regs=pad_regs)


def recompile_ms(dfg, *xs: torch.Tensor) -> Dict[str, float]:
    """``torch.compile`` of ``dfg.evaluate`` on ``xs``: first call minus a
    warm call, host ms, with every compile cache cold
    (``port_bench.recompile_ms``, caches under ``build/reconfig_time/``)."""
    return port_bench.recompile_ms(dfg, *xs, sub="reconfig_time")


def rebuild_ms() -> Dict:
    """A cold nvcc build of the executor's source into a fresh directory."""
    out = port_bench.fresh_dir("reconfig_time", "nvcc")
    t0 = time.perf_counter()
    kernel.LIBRARY.build(out)
    ms = (time.perf_counter() - t0) * 1e3
    shutil.rmtree(out, ignore_errors=True)
    return dict(nvcc_ms=ms)


def bench(device: str = "cuda", rebuild: bool = False,
          recompile: Callable = recompile_ms) -> Dict:
    """The three programs swapped into one resident image, each launch
    against ``run_reference``, beside ``recompile`` of each program and,
    with ``rebuild``, a cold build of the executor."""
    dev = torch.device(device)
    p = programs()
    cks = p["cks"]
    images = {n: ops.build_image(ck.program, pad_to=p["pad_to"],
                                 pad_regs=p["pad_regs"])
              for n, ck in cks.items()}
    x_np = np.linspace(-1, 1, N_ITEMS).astype(np.float32)
    x = torch.from_numpy(x_np).to(dev)[None]
    want = {n: np.asarray(ck.run_reference(x_np), np.float32)
            for n, ck in cks.items()}
    port_bench.warm_compiler(recompile, x[0])
    # the executor built once, warmed on the first program
    resident = ops.load_image(cks[NAMES[0]].program, dev,
                              pad_to=p["pad_to"], pad_regs=p["pad_regs"])
    kernel.overlay_execute(resident, x)
    port_bench.sync(dev)
    builds = kernel.LIBRARY.builds
    swaps: Dict[str, List[float]] = {n: [] for n in NAMES}
    exact = {n: True for n in NAMES}
    for _ in range(SWAP_ROUNDS):
        for n in NAMES[1:] + NAMES[:1]:
            port_bench.sync(dev)
            t0 = time.perf_counter()
            resident.write(*images[n])
            got = kernel.overlay_execute(resident, x)
            port_bench.sync(dev)
            swaps[n].append((time.perf_counter() - t0) * 1e3)
            exact[n] &= bool(np.array_equal(
                got[0].cpu().numpy().view(np.int32), want[n].view(np.int32)))
    rows = {}
    for n in NAMES:
        ck = cks[n]
        rows[n] = dict(
            n_instr=ck.program.n_instr, n_regs=ck.program.n_regs,
            config_us_modelled=ck.bitstream.load_time_us(),
            swap_first_ms=swaps[n][0],
            swap_ms=statistics.median(swaps[n]),
            swap_fastest_ms=min(swaps[n]),
            bit_exact=exact[n],
            recompile=recompile(ck.dfg, x[0]))
    result = dict(
        spec=dict(width=SPEC.width, height=SPEC.height,
                  dsp_per_fu=SPEC.dsp_per_fu),
        device=device, items=N_ITEMS, swap_rounds=SWAP_ROUNDS,
        pad_to=p["pad_to"], pad_regs=p["pad_regs"], programs=rows,
        builds_before=builds, builds_after=kernel.LIBRARY.builds,
        rebuild=rebuild_ms() if rebuild else None)
    return result


def check_gate(result: Dict) -> List[str]:
    failures = []
    if result["builds_after"] != result["builds_before"]:
        failures.append(f"a swap rebuilt the executor (builds "
                        f"{result['builds_before']} -> "
                        f"{result['builds_after']})")
    for n, row in result["programs"].items():
        if not row["bit_exact"]:
            failures.append(f"{n}: a swapped launch differs from "
                            f"run_reference")
    return failures


def run(device: str = "cuda", rebuild: bool = False) -> Dict:
    """``bench`` with the card's line and the gate's failures."""
    result = bench(device, rebuild=rebuild)
    result["card"] = port_bench.card_line(device)
    result["gate_failures"] = check_gate(result)
    return result


def rows(result: Dict) -> List[Dict]:
    """The reference's CSV rows: the swap against the recompile."""
    out = []
    for n, row in result["programs"].items():
        rc = row["recompile"]
        speedup = rc["compile_ms"] / max(row["swap_ms"], 1e-9)
        out.append(dict(
            name=f"reconfig/{n}", us_per_call=row["swap_ms"] * 1e3,
            derived=(f"program_swap={row['swap_ms']:.3f}ms "
                     f"torch_compile={rc['compile_ms']:.1f}ms "
                     f"speedup={speedup:.1f}x "
                     f"modelled_fpga_config={row['config_us_modelled']:.1f}us "
                     f"bit_exact={row['bit_exact']} ({PAPER})")))
    return out


def report(result: Dict) -> None:
    card = result["card"]
    for n, row in result["programs"].items():
        rc = row["recompile"]
        print(f"reconfig/{n:<9} swap {row['swap_ms'] * 1e3:8.1f} us "
              f"(median of {result['swap_rounds']}; first "
              f"{row['swap_first_ms'] * 1e3:.1f}) vs torch.compile "
              f"{rc['compile_ms']:9.1f} ms (first call {rc['first_ms']:.1f}, "
              f"warm {rc['warm_ms']:.3f}): "
              f"{rc['compile_ms'] / max(row['swap_ms'], 1e-9):.0f}x; "
              f"modelled FPGA config {row['config_us_modelled']:.1f} us "
              f"({PAPER}); bit-exact {row['bit_exact']}; {card}")
    if result["rebuild"] is not None:
        rb = result["rebuild"]
        print(f"executor rebuild: cold nvcc of csrc/overlay_exec.cu "
              f"{rb['nvcc_ms']:.0f} ms; {card}")
    print(f"executor builds: {result['builds_before']} before the swaps, "
          f"{result['builds_after']} after")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rebuild", action="store_true",
                    help="also time a cold nvcc build of the executor")
    ap.add_argument("--device", default="cuda",
                    help="where the executor runs (default: the CUDA card)")
    ap.add_argument("--json", metavar="PATH", default=None)
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("torch_reconfig_time: no CUDA device (pass --device cpu to "
              "rehearse on the CPU)", file=sys.stderr)
        return 2
    print(port_bench.card_line(args.device), flush=True)
    result = run(args.device, rebuild=args.rebuild)
    report(result)
    for f in result["gate_failures"]:
        print(f"GATE FAILED: {f}", file=sys.stderr)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 1 if result["gate_failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
