#!/usr/bin/env python3
"""Time the port's RMSNorm, overlay-executor and SIMT attention kernels on one card.

    python3 benchmarks/torch_kernel_times.py [--src DIR] [--label NAME]
                                             [--parts P,...] [--alternatives]

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
    (phase (e));
  - RMSNorm's backward (``rmsnorm_bwd``): qwen3-14b's three training
    shapes at B=2, S=2048 in bfloat16 (rows of 5120; the q and k heads
    views of 128 with a contiguous gradient), beside autograd through
    ``torch.nn.functional.rms_norm`` (phase (n1));
  - the split-row RMSNorm (``rmsnorm_split``, Mamba2's gated norm with
    its rows cut over 'model' = 4): one rank's block of zamba2-7b's and
    mamba2-370m's, (16384, 1792) and (16384, 512) bfloat16, forward and
    backward through the public wrappers with an all-reduce that sums
    nothing, beside the plain versions (phases (f), (n1)).

  - the SIMT flash-attention route (``attention_simt``, the private
    ``_launch``/``_launch_bwd`` entries with ``route="simt"``, so a checkout
    from before their launch plans times too): the float32 forward at the
    prefill shape q (4, 40, 4096, 128), k/v (4, 8, 4096, 128) causal, the
    float32 backward at the training shape q (2, 40, 2048, 128), k/v (2, 8,
    2048, 128) causal with the forward's row statistics, zamba2-7b's D 112
    in float32 at q, k, v (4, 32, 4096, 112) causal, bfloat16 at D 32, q, k,
    v (4, 32, 4096, 32) causal, and the float32 agreement runs' shapes of
    phases (k) and (l) and bfloat16 at D 16 (SIMT_CASES); each beside its
    bound (4 D operations a visible pair forward, ten backward, at the
    card's rate for the inputs' type, float32 outside the tensor cores or
    bfloat16 on them, whatever route the kernel takes; or the bytes) and
    the library call: ``scaled_dot_product_attention`` in float32, autograd through it
    in float32, and in bfloat16 (phases (f), (n1)).

``--parts`` picks which of ``executor``, ``rmsnorm``, ``rmsnorm_bwd``,
``rmsnorm_split`` and ``attention_simt`` run (default: all five).

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
F32_OPS_PER_S = 67e12          # float32 FMAs outside the tensor cores
BF16_OPS_PER_S = 989e12        # bfloat16 on the tensor cores, dense
L2_FLUSH_BYTES = 100 << 20
HIDE_HOST_CYCLES = 1_000_000
N_EXEC = 1 << 24
SPECS = ((8, 8, 2), (32, 8, 2))
# qwen3-14b's widths, and one prefill step's calls of each shape
D, HQ, HKV, HD, LAYERS = 5120, 40, 8, 128, 40
PREFILL_B, PREFILL_S, DECODE_B = 4, 4096, 4
TRAIN_B, TRAIN_S, TRAIN_LAYERS = 2, 2048, 12
PARTS = ("executor", "rmsnorm", "rmsnorm_bwd", "rmsnorm_split",
         "attention_simt")
# attention_simt: (name, b, hq, hkv, sq, skv, d, dtype name, causal,
# backward); after the four main cases, the float32 agreement runs' shapes
# of phases (k) and (l) (qwen3-moe's prefill, zamba2's, whisper's decode
# steps: cross-attention and self-attention with one query row) and
# bfloat16 at D 16
SIMT_CASES = (
    ("forward float32, prefill shape", 4, 40, 8, 4096, 4096, 128, "float32",
     True, False),
    ("backward float32, training shape", 2, 40, 8, 2048, 2048, 128,
     "float32", True, True),
    ("forward float32, zamba2-7b D 112", 4, 32, 32, 4096, 4096, 112,
     "float32", True, False),
    ("forward bfloat16, D 32", 4, 32, 32, 4096, 4096, 32, "bfloat16", True,
     False),
    ("forward float32, qwen3-moe agreement", 1, 64, 4, 256, 256, 128,
     "float32", True, False),
    ("forward float32, zamba2-7b agreement", 1, 32, 32, 256, 256, 112,
     "float32", True, False),
    ("forward float32, whisper decode cross-attention", 4, 20, 20, 1, 1500,
     64, "float32", False, False),
    ("forward float32, whisper decode self-attention", 4, 20, 20, 1, 160,
     64, "float32", True, False),
    ("forward bfloat16, D 16", 4, 32, 32, 4096, 4096, 16, "bfloat16", True,
     False))
# the split rows: a rank's block (B*S, inner / 4) of each gated norm
SPLIT_BLOCKS = (("zamba2-7b", 7168), ("mamba2-370m", 2048))
SPLIT_WAYS = 4
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


def time_rmsnorm_bwd(reps: int, scratch) -> dict:
    """The backward at qwen3-14b's training shapes: kernel ms, its share of
    the byte bound (x, dy and dx once, w and dw once), autograd through
    ``F.rms_norm`` on the same inputs, and the shapes' calls a step of
    TRAIN_LAYERS layers."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import kernel
    gen = torch.Generator(device="cuda").manual_seed(4)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf)
    b, s = TRAIN_B, TRAIN_S
    cases = [("ln1/ln2/final (B*S, 5120)", lambda: randn(b, s, D),
              2 * TRAIN_LAYERS + 1),
             ("q_norm (B, 40, S, 128) view",
              lambda: randn(b, s, HQ, HD).transpose(1, 2), TRAIN_LAYERS),
             ("k_norm (B, 8, S, 128) view",
              lambda: randn(b, s, HKV, HD).transpose(1, 2), TRAIN_LAYERS)]
    shapes, step = {}, {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for name, make, calls in cases:
        x = make()
        dy = randn(*x.shape)
        w = (torch.randn(x.shape[-1], generator=gen, device="cuda") * 0.1
             + 1).to(bf)
        k_ms = device_ms(lambda: kernel.rmsnorm_bwd(x, w, dy), reps, scratch)
        xl, wl = (t.detach().requires_grad_() for t in (x, w))
        out = F.rms_norm(xl, (x.shape[-1],), wl, 1e-6)
        l_ms = device_ms(lambda: torch.autograd.grad(
            out, (xl, wl), dy, retain_graph=True), reps, scratch)
        byte_ms = (3 * x.numel() + 2 * x.shape[-1]) * 2 \
            / MEM_BYTES_PER_S * 1e3
        shapes[name] = {"ms": k_ms, "library_ms": l_ms, "bound_ms": byte_ms,
                        "share": byte_ms / k_ms, "calls_per_step": calls}
        for key, val in (("ms", k_ms), ("library_ms", l_ms),
                         ("bound_ms", byte_ms)):
            step[key] += calls * val
        del x, dy, xl, wl, out
    step["share"] = step["bound_ms"] / step["ms"]
    return {"shapes": shapes, "train_step": step}


def time_rmsnorm_split(reps: int, scratch) -> dict:
    """The split-row RMSNorm on one rank's block of each gated norm:
    forward (``rmsnorm_split``, no grad) and backward
    (``rmsnorm_split_bwd``) kernel ms, the plain versions' ms, and the
    byte bounds: x read and y written; x and dy read and dx written, and
    the two-pass bound (x and dy read twice: dx waits for the
    all-reduce)."""
    import torch
    from repro_torch.kernels.rmsnorm import kernel, ref
    gen = torch.Generator(device="cuda").manual_seed(5)
    eps, out = 1e-6, {}
    for name, n in SPLIT_BLOCKS:
        d = n // SPLIT_WAYS
        x, dy = (torch.randn(PREFILL_B * PREFILL_S, d, generator=gen,
                             device="cuda").to(torch.bfloat16)
                 for _ in range(2))
        w = (torch.randn(d, generator=gen, device="cuda") * 0.1
             + 1).to(torch.bfloat16)
        total = ref.split_sumsq(x) * SPLIT_WAYS
        dot = ref.split_dot(x, w, dy)
        size = x.numel() * x.element_size()
        times = {
            "forward": device_ms(lambda: kernel.rmsnorm_split(
                x, w, eps, n, lambda t: t), reps, scratch),
            "forward_plain": device_ms(lambda: ref.rmsnorm_split(
                x, w, ref.split_sumsq(x), n, eps), 3, scratch),
            "backward": device_ms(lambda: kernel.rmsnorm_split_bwd(
                x, w, dy, total, eps, n, lambda t: t), reps, scratch),
            "backward_plain": device_ms(lambda: ref.rmsnorm_split_bwd(
                x, w, dy, total, dot, n, eps), 3, scratch)}
        bounds = {"forward": 2 * size, "backward": 3 * size,
                  "backward_two_pass": 5 * size}
        times.update({f"{k}_bound_ms": v / MEM_BYTES_PER_S * 1e3
                      for k, v in bounds.items()})
        out[f"{name} ({x.shape[0]}, {d})"] = times
        del x, dy
    return out


def time_attention_simt(reps: int, scratch) -> dict:
    """The SIMT attention kernels at SIMT_CASES (causal, heads views of
    (B, S, H*D) projections), each beside its bound and the library call
    on the same inputs.  The backward is given the forward's row
    statistics, as autograd gives them."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for name, b, hq, hkv, sq, skv, d, dname, causal, backward in SIMT_CASES:
        dt = getattr(torch, dname)

        def heads(h, s):
            return torch.randn((b, s, h * d), generator=gen, device="cuda"
                               ).to(dt).view(b, s, h, d).transpose(1, 2)
        q, k, v = heads(hq, sq), heads(hkv, skv), heads(hkv, skv)
        # visible pairs: row i (at position i + skv - sq) sees keys
        # 0 .. its position, or all of them
        pairs = b * hq * (sum(min(skv, i + skv - sq + 1)
                              for i in range(sq)) if causal else sq * skv)
        size = q.element_size()
        io = 2 * (q.numel() + k.numel()) * size
        if backward:
            do = heads(hq, sq)
            stats = torch.empty((2, b, hq, sq), device="cuda")
            o = kernel._launch(q, k, v, route="simt", stats=stats)
            k_ms = device_ms(lambda: kernel._launch_bwd(
                q, k, v, o, do, stats, route="simt"), reps, scratch)
            qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
            lo = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                enable_gqa=True)
            l_ms = device_ms(lambda: torch.autograd.grad(
                lo, (qs, ks, vs), do, retain_graph=True), reps, scratch)
            ops, n_bytes = 10 * d * pairs, 2 * io + 2 * b * hq * sq * 4
            extra = {"bound_ms_seven_products":
                     14 * d * pairs / F32_OPS_PER_S * 1e3}
            del do, stats, o, qs, ks, vs, lo
        else:
            k_ms = device_ms(lambda: kernel._launch(
                q, k, v, causal=causal, route="simt"), reps, scratch)
            # SDPA's causal mask is aligned at the start; the kernels' at
            # the end (equal where Sq = Skv): an explicit mask otherwise
            mask = None
            if causal and sq != skv:
                mask = (torch.arange(skv, device="cuda")[None, :]
                        <= torch.arange(sq, device="cuda")[:, None]
                        + skv - sq)
            l_ms = device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=True), reps, scratch)
            ops, n_bytes, extra = 4 * d * pairs, io, {}
        byte_ms = n_bytes / MEM_BYTES_PER_S * 1e3
        # the card's least time for this work is at its rate for the
        # inputs' type; for bfloat16 the bound at the float32 rate the SIMT
        # route runs at is kept beside it
        if dt == torch.bfloat16:
            op_ms = ops / BF16_OPS_PER_S * 1e3
            extra["bound_ms_float32_rate"] = max(
                ops / F32_OPS_PER_S * 1e3, byte_ms)
        else:
            op_ms = ops / F32_OPS_PER_S * 1e3
        bound = max(op_ms, byte_ms)
        out[name] = {"shape": f"q ({b},{hq},{sq},{d}) k/v "
                              f"({b},{hkv},{skv},{d}) {dname}"
                              + (" causal" if causal else ""),
                     "ms": k_ms, "library_ms": l_ms, "bound_ms": bound,
                     "bound_by": "operations" if op_ms >= byte_ms else
                     "bytes", "share": bound / k_ms, **extra}
        del q, k, v
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory whose repro_torch to time")
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parts", default=",".join(PARTS),
                    help="comma-separated: " + ", ".join(PARTS))
    ap.add_argument("--alternatives", action="store_true",
                    help="also time the plans the wrappers did not choose")
    args = ap.parse_args()
    parts = args.parts.split(",")
    if not set(parts) <= set(PARTS):
        ap.error(f"--parts takes {', '.join(PARTS)}")
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
              "card": card, "reps": args.reps}
    if "executor" in parts:
        result["overlay_exec"] = time_executor(args.reps, scratch)
        ex = result["overlay_exec"]["total"]
        print(f"{args.label}: executor 12 cells {ex['ms']:.4f} ms "
              f"({ex['with_host']:.4f} with the host); {card}")
    if "rmsnorm" in parts:
        result["rmsnorm"] = time_rmsnorm(args.reps, scratch)
        rms = result["rmsnorm"]["prefill_step"]
        print(f"{args.label}: RMSNorm per prefill step {rms['ms']:.3f} ms "
              f"(share {rms['share']:.3f}, rms_norm "
              f"{rms['library_ms']:.3f} ms); {card}")
    if "rmsnorm_bwd" in parts:
        result["rmsnorm_bwd"] = time_rmsnorm_bwd(args.reps, scratch)
        for name, r in result["rmsnorm_bwd"]["shapes"].items():
            print(f"{args.label}: RMSNorm backward {name} {r['ms']:.4f} ms "
                  f"(share {r['share']:.3f} of {r['bound_ms']:.4f}; "
                  f"autograd through rms_norm {r['library_ms']:.4f}); "
                  f"{card}")
    if "rmsnorm_split" in parts:
        result["rmsnorm_split"] = time_rmsnorm_split(args.reps, scratch)
        for name, r in result["rmsnorm_split"].items():
            print(f"{args.label}: split-row RMSNorm {name} forward "
                  f"{r['forward']:.4f} ms (bound "
                  f"{r['forward_bound_ms']:.4f}, plain "
                  f"{r['forward_plain']:.4f}), backward "
                  f"{r['backward']:.4f} ms (bounds "
                  f"{r['backward_bound_ms']:.4f} and two-pass "
                  f"{r['backward_two_pass_bound_ms']:.4f}, plain "
                  f"{r['backward_plain']:.4f}); {card}")
    if "attention_simt" in parts:
        result["attention_simt"] = time_attention_simt(args.reps, scratch)
        for name, r in result["attention_simt"].items():
            seven = r.get("bound_ms_seven_products")
            f32 = r.get("bound_ms_float32_rate")
            print(f"{args.label}: SIMT attention {name}, {r['shape']}: "
                  f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms, "
                  f"{r['bound_by']}, share {r['share']:.3f}"
                  + (f"; seven-product bound {seven:.4f}, share "
                     f"{seven / r['ms']:.3f}" if seven else "")
                  + (f"; at the float32 rate {f32:.4f}, share "
                     f"{f32 / r['ms']:.3f}" if f32 else "")
                  + f"; library {r['library_ms']:.4f} ms); {card}")
    if args.alternatives:
        result["alternatives"] = time_alternatives(args.reps, scratch)
    for kind, runs in result.get("alternatives", {}).items():
        print(f"{args.label}: {kind} alternatives, ms in two turns: "
              + "; ".join(f"{k} {v[0]:.4f}/{v[1]:.4f}"
                          for k, v in runs.items()))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
