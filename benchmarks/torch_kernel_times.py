#!/usr/bin/env python3
"""Time the port's RMSNorm and overlay-executor kernels on one CUDA card.

    python3 benchmarks/torch_kernel_times.py [--src DIR] [--label NAME]
                                             [--alternatives]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src/``),
so two checkouts can be timed in turns on one card by one command, for
example a parent commit unpacked with ``git archive`` beside the change:
parent, change, change, parent.  It builds the two kernels from that
checkout's sources and times them at the shapes of ``chip_smoke.py``'s
main paths:

  - the overlay executor: the paper's six kernels (``configs/paper_suite``)
    on ``OverlaySpec(8, 8, 2)`` and ``(32, 8, 2)``, over N = 2^24 float32
    work-items each (phase (c));
  - RMSNorm: one qwen3-14b prefill step at B=4, S=4096 in bfloat16 (rows of
    5120, and rows of 128 through the transposed heads views of q and k),
    and the decode step's shapes, beside ``torch.nn.functional.rms_norm``
    (phase (e)).

Each time is the median of ``--reps`` CUDA-event windows.  Before each
window the L2 is evicted by reading a 100 MB scratch tensor and the card
sleeps while the host enqueues the call, so the window holds the kernel's
device time and not the wrapper's Python.  The executor is also timed as
``chip_smoke.py`` did before it hid the host (``with_host``).  Inputs come
from seeded generators.  The last line of output is one JSON object.

``--alternatives`` (for a checkout whose wrappers plan in Python:
``overlay_exec.kernel.PLANS`` and ``rmsnorm.kernel.launch_plan``) also
times, in two turns, the executor's 12 cells at each (work-items a thread,
block) of :data:`EXEC_PLANS`, and RMSNorm's rows of 5120 at each split of
:data:`RMS_SPLITS` (one row a block) and its q heads view at the planned
split, each beside the scalar path's two passes (the design before the
register kernel, one row per warp or block): the measurements behind the
plans the wrappers choose.  It also times chains of M adds of an
immediate, one input and one output, each add reading the one before
(forwarded in registers) or the input slot (read from shared memory):
the executor's cost per instruction.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MEM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
L2_FLUSH_BYTES = 100 << 20
HIDE_HOST_CYCLES = 1_000_000
N_EXEC = 1 << 24
SPECS = ((8, 8, 2), (32, 8, 2))
# qwen3-14b's widths, and one prefill step's calls of each shape
D, HQ, HKV, HD, LAYERS = 5120, 40, 8, 128, 40
PREFILL_B, PREFILL_S, DECODE_B = 4, 4096, 4
# --alternatives: executor (work-items a thread, block), RMSNorm (threads,
# vectors a thread) on rows of 5120 bf16
EXEC_PLANS = ((8, 128), (8, 256), (4, 256), (4, 128), (2, 256), (1, 256))
RMS_SPLITS = ((160, 4), (128, 5), (320, 2))
CHAIN_LENGTHS = (1, 4, 16)


def device_ms(fn, reps: int, scratch, hide: bool = True) -> float:
    """Median device time of ``fn`` in ms; with ``hide``, the L2 evicted
    and the host's enqueue hidden before each window."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if hide:
            scratch.sum()
            torch.cuda._sleep(HIDE_HOST_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_executor(reps: int, scratch) -> dict:
    import torch
    from repro_torch.kernels.overlay_exec import kernel
    cells = {}
    for name, img, x in executor_cells(
            torch.Generator(device="cuda").manual_seed(1)):
        byte_ms = (x.shape[0] + img.n_out) * N_EXEC * 4 \
            / MEM_BYTES_PER_S * 1e3
        cells[name] = {
            "ms": device_ms(lambda: kernel.overlay_execute(img, x), reps,
                            scratch),
            "with_host": device_ms(lambda: kernel.overlay_execute(img, x),
                                   reps, scratch, hide=False),
            "bound_ms": byte_ms}
        del x
    total = {key: sum(c[key] for c in cells.values())
             for key in ("ms", "with_host", "bound_ms")}
    return {"cells": cells, "total": total}


def executor_cells(gen):
    """(name, image, x) of the 12 cells, x drawn from ``gen``."""
    import torch
    from repro_torch.configs.paper_suite import BENCHMARKS
    from repro_torch.core.jit import jit_compile
    from repro_torch.core.overlay import OverlaySpec
    from repro_torch.kernels.overlay_exec import ops
    for spec in SPECS:
        for name, (src, _, _) in BENCHMARKS.items():
            ck = jit_compile(src, OverlaySpec(*spec))
            x = torch.rand((len(ck.dfg.inputs), N_EXEC), device="cuda",
                           generator=gen) * 2 - 1
            yield f"{name} {spec[0]}x{spec[1]}", \
                ops.load_image(ck.program, "cuda"), x


def chain_image(m: int, forwarded: bool):
    """M adds of 0.5: each reads the add before it, or input slot 0; the
    last result is the output."""
    import numpy as np
    from repro_torch.core.program import OP_ADD, OP_PASS
    from repro_torch.kernels.overlay_exec import kernel
    rows = [[OP_ADD, 1 + k, k if forwarded else 0, 0, 0, 1]
            for k in range(m)] + [[OP_PASS, m + 2, m, 0, 0, 0]]
    return kernel.ExecImage.from_arrays(
        np.array(rows, np.int32), np.full(len(rows), 0.5, np.float32),
        m + 3, 1, "cuda")


def time_alternatives(reps: int, scratch) -> dict:
    """The executor's cells at each of EXEC_PLANS and RMSNorm at each of
    RMS_SPLITS and as two passes, in two turns, each checked against the
    plain version."""
    import dataclasses
    import torch
    from repro_torch.kernels.overlay_exec import kernel as ox
    from repro_torch.kernels.overlay_exec import ref as ox_ref
    from repro_torch.kernels.rmsnorm import kernel as rn
    from repro_torch.kernels.rmsnorm import ref as rn_ref
    cells = list(executor_cells(torch.Generator(device="cuda").manual_seed(1)))
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16
    ln = torch.randn((PREFILL_B * PREFILL_S, D), generator=gen,
                     device="cuda").to(bf)
    q = torch.randn((PREFILL_B, PREFILL_S, HQ, HD), generator=gen,
                    device="cuda").to(bf).transpose(1, 2)
    plans, launch_plan = ox.PLANS, rn.launch_plan
    base = {d: launch_plan(d, bf, True) for d in (D, HD)}
    rms_plans = {f"ln {t}x{v}": (ln, dataclasses.replace(
        base[D], tpr=t, vpt=v, block=t)) for t, v in RMS_SPLITS}
    # the scalar path's two passes at 16-byte loads: a block per row of
    # 5120, a warp per row of 128
    two_passes = rn.Plan("loop", 8, 256, 1, 1, 256, False)
    rms_plans["ln two passes"] = (ln, two_passes)
    rms_plans["q_norm planned"] = (q, base[HD])
    rms_plans["q_norm two passes"] = (q, dataclasses.replace(two_passes,
                                                             tpr=32))
    out = {"executor": {}, "rmsnorm": {}, "chains": {}}
    x1 = torch.rand((1, N_EXEC), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(5))
    chains = {f"M={m} {kind}": chain_image(m, kind == "forwarded")
              for m in CHAIN_LENGTHS for kind in ("forwarded", "from slot")}
    try:
        for turn in range(2):
            for items, block in EXEC_PLANS:
                ox.PLANS = ((items, block),) + plans
                total = 0.0
                for _, img, x in cells:
                    got = ox.overlay_execute(img, x)
                    want = ox_ref.execute_image(img.instrs, img.imms,
                                                img.n_regs, x, img.n_out)
                    if not torch.equal(torch.isnan(got), torch.isnan(want)) \
                            or not torch.equal(got.nan_to_num(),
                                               want.nan_to_num()):
                        raise RuntimeError(f"({items}, {block}) != plain")
                    total += device_ms(lambda: ox.overlay_execute(img, x),
                                       reps, scratch)
                out["executor"].setdefault(f"({items}, {block})",
                                           []).append(total)
            ox.PLANS = plans                # chains at the planned launch
            for name, img in chains.items():
                out["chains"].setdefault(name, []).append(device_ms(
                    lambda: ox.overlay_execute(img, x1), reps, scratch))
            for name, (x, plan) in rms_plans.items():
                rn.launch_plan = lambda *_, plan=plan: plan
                w = torch.ones(x.shape[-1], dtype=bf, device="cuda")
                err = (rn.rmsnorm(x, w).float()
                       - rn_ref.rmsnorm(x, w).float()).abs()
                want = rn_ref.rmsnorm(x, w).float().abs()
                if not bool((err <= 3e-2 + 3e-2 * want).all()):
                    raise RuntimeError(f"{name} != plain")
                out["rmsnorm"].setdefault(name, []).append(
                    device_ms(lambda: rn.rmsnorm(x, w), reps, scratch))
                rn.launch_plan = launch_plan
    finally:
        ox.PLANS, rn.launch_plan = plans, launch_plan
    return out


def time_rmsnorm(reps: int, scratch) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import kernel
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf)
    b, s = PREFILL_B, PREFILL_S
    # (name, x, calls per prefill step; 0 for decode shapes)
    cases = [("ln1/ln2 (B*S, 5120)", lambda: randn(b * s, D), 2 * LAYERS),
             ("q_norm (B, 40, S, 128) view",
              lambda: randn(b, s, HQ, HD).transpose(1, 2), LAYERS),
             ("k_norm (B, 8, S, 128) view",
              lambda: randn(b, s, HKV, HD).transpose(1, 2), LAYERS),
             ("final (B, 1, 5120)", lambda: randn(b, 1, D), 1),
             ("decode ln (4, 1, 5120)", lambda: randn(DECODE_B, 1, D), 0),
             ("decode q_norm (4, 40, 1, 128) view",
              lambda: randn(DECODE_B, 1, HQ, HD).transpose(1, 2), 0)]
    shapes, step = {}, {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for name, make, calls in cases:
        x = make()
        w = (torch.randn(x.shape[-1], generator=gen, device="cuda") * 0.1
             + 1).to(bf)
        k_ms = device_ms(lambda: kernel.rmsnorm(x, w), reps, scratch)
        l_ms = device_ms(lambda: F.rms_norm(x, (x.shape[-1],), w, 1e-6),
                         reps, scratch)
        byte_ms = (2 * x.numel() + x.shape[-1]) * 2 / MEM_BYTES_PER_S * 1e3
        shapes[name] = {"ms": k_ms, "library_ms": l_ms, "bound_ms": byte_ms,
                        "share": byte_ms / k_ms, "calls_per_step": calls}
        for key, val in (("ms", k_ms), ("library_ms", l_ms),
                         ("bound_ms", byte_ms)):
            step[key] += calls * val
        del x
    step["share"] = step["bound_ms"] / step["ms"]
    return {"shapes": shapes, "prefill_step": step}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory whose repro_torch to time")
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--alternatives", action="store_true",
                    help="also time the plans the wrappers did not choose")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "not read"
    scratch = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    result = {"label": args.label, "package": repro_torch.__file__,
              "card": card, "reps": args.reps,
              "overlay_exec": time_executor(args.reps, scratch),
              "rmsnorm": time_rmsnorm(args.reps, scratch)}
    if args.alternatives:
        result["alternatives"] = time_alternatives(args.reps, scratch)
    ex, rms = result["overlay_exec"]["total"], \
        result["rmsnorm"]["prefill_step"]
    print(f"{args.label}: executor 12 cells {ex['ms']:.4f} ms "
          f"({ex['with_host']:.4f} with the host), RMSNorm per prefill step "
          f"{rms['ms']:.3f} ms (share {rms['share']:.3f}, rms_norm "
          f"{rms['library_ms']:.3f} ms); {card}")
    for kind, runs in result.get("alternatives", {}).items():
        print(f"{args.label}: {kind} alternatives, ms in two turns: "
              + "; ".join(f"{k} {v[0]:.4f}/{v[1]:.4f}"
                          for k, v in runs.items()))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
