#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card; it builds the
port's CUDA kernels from ``src/repro_torch/csrc/`` with nvcc (the overlay
executor, RMSNorm, and flash attention's two routes: the bfloat16
tensor-core kernel and the float32 SIMT kernel).  Phases:

  (a) set-up: the card's name and power limit, the four kernel builds,
      one nvcc each, all started together, with ptxas's registers, shared
      memory and spills;
  (b) the executor kernel against its plain PyTorch version on the card,
      bit for bit, on hand-built images covering all 14 opcodes and both
      immediate ports, inputs holding NaN, +-0, +-inf and denormals,
      register files of 3 slots up to ones that force a smaller block and
      one work-item a thread, 1 to 6 inputs, ragged N from 1 to 2^20+37 and
      an x that starts one element past 16 bytes; it prints the work-items
      a thread and the block each image took;
  (c) the main path: ``jit_compile`` of the paper's six kernels on two
      overlay sizes, then ``CompiledKernel.run_overlay`` over N = 2^24
      work-items each, held bit for bit against the plain version on the
      card and against ``run_reference`` (numpy), with times and bounds and
      the work-items a thread, block and grid of each launch;
  (d) reconfiguration: six programs padded to one signature are swapped
      into one resident image of the one build, also under one captured
      CUDA graph;
  (e) the RMSNorm kernel against its plain version on the card (1e-4 in
      float32, 3e-2 in bfloat16) at the shapes of a qwen3-14b prefill step
      and of phase (k)'s two models
      (rows of 5120, and rows of 128 read through the transposed heads
      view), at decode shapes, ragged row counts and the shapes of
      ``tests/test_kernels.py``; timed beside ``torch.nn.functional.rms_norm``
      and the byte bound, with the L2 evicted before each timed launch, and
      each main shape's share of that bound printed;
  (f) the flash-attention kernels against their plain version on the
      card: bfloat16 on the tensor-core route within
      1e-4 + 2^-7 |plain| + 2^-7 plain(|v|), float32 on the SIMT route
      within 2e-3; GQA groups 1, 4, 5, 6, 8 and 16, causal and not,
      windows 32, 64, 128 and 256, Sq < Skv, Sq > Skv, ragged lengths,
      head dims 64 and 128; then at the prefill shape q (4, 40, 4096, 128)
      through the path's heads views, and timed there in turns with the
      SIMT kernel and ``scaled_dot_product_attention`` against the
      operations bound, and at phase (k)'s q (4, 64, 4096, 128) with k/v
      of 4 heads, timed in turns with ``scaled_dot_product_attention``;
  (g) the dense serving path: qwen3-14b at full width and depth in
      bfloat16 with random weights from a seeded generator, one
      ``make_prefill_step`` on 4 prompts of 4096 tokens, then the
      ``launch/serve.py`` loop (4 requests, prompt 128, 32 tokens greedy),
      with launches counted per kernel (and per flash-attention route),
      times, and the logits held against
      the prefill step, ``forward_train`` and the plain attention path, at
      two bfloat16 weight seeds and in float32 at full depth; each limit
      must also fail two faults planted in the attention;
  (h) the runtime seam at N = 2^24 work-items per buffer on an 8x8
      overlay, every execution through the executor on a resident image,
      every output bit for bit against ``run_reference`` and still on the
      card: (h1) the OpenCL host flow of ``examples/opencl_runtime_demo.py``
      for the six kernels (build and ledger debit, three enqueues with one
      image load and one config charge, release and credit, rebuild from
      the cache); (h2) the three tenants of
      ``examples/multi_tenant_serving.py`` on two overlay devices, one
      launch per enqueue; (h3) ``examples/graph_replay.py``'s five
      requests, one launch per partition, the fused replay equal to the
      nodewise one and to chained ``run_reference``; (h4) a second Session
      on the same ``persist_dir`` with no cold build; then the host µs per
      ``Session.enqueue`` and ``Session.launch`` at 2^24 and 2048
      work-items, their device ms, the host µs of each layer below
      ``Session.enqueue``, ``run_overlay`` from numpy, and for each of the
      six kernels the device ms of a ``Session.enqueue`` at 2^24 beside
      the executor alone, the copy that stacks its inputs, and phase (c)'s
      time of the cell;
  (i) continuous-batching serving (``repro_torch.serve``) on two 8x8
      overlay devices, every iteration one executor launch per partition
      on states that stay on the card: (i1) ``benchmarks/serving_perf.py``'s
      trace (36 requests of three families under three SLO classes, max
      batch 8), served warm batched and with ``serve_sequential``, bit for
      bit against each other and against the same runs on the CPU port,
      with the CPU run's modelled makespans and latencies; (i2) all five
      families, 8 requests each; (i3) 256 transformer requests (the batch
      class's admission cap) in one burst at max batch 256, 16,384
      work-items a decode launch, with the (work-items a thread, block)
      of each launch; (i4) the (i1) trace again with the tracer, metrics
      and replay profiles attached, the Chrome trace written to
      ``build/traces/serve_trace.json``; then, at max batch 8 and 256, a
      profiled window of decode iterations that must hold no
      device-to-host copy, the host µs per decode iteration and per served
      token, each layer of an iteration called alone, the device ms per
      iteration, launches per iteration, the tracer's cost on against
      off, and the image loads of a resize;
  (j) the static verifier and the paper's benchmarks: (j1) the six paper
      kernels on both overlays at ``verify_level`` off, "fused" and
      "full", with zero findings, one bitstream and program hash at every
      level and the verify stage's host ms, then each "full" artifact
      through a Session at N = 2^24, bit for bit against
      ``run_reference``; (j2) a "full" cache hit corrupted in memory is
      quarantined, rebuilt and launched bit-exact on an image keyed on the
      new artifact; (j3) phase (h3)'s pipeline with every node asking for
      "fused", fused against nodewise bit for bit, and a planted alias
      refused before any build or launch; (j4) ``python -m
      repro_torch.analysis --verify`` and the lock lint, clean; (j5)
      ``benchmarks/torch_graph_replay_perf.py`` (the reference's four
      gates, then fused against nodewise replay in host µs, device ms and
      launches at 200,000 and 2^24 work-items) and
      ``benchmarks/torch_reconfig_time.py`` (a swap into the resident
      image against a ``torch.compile`` of the program), without the cold
      nvcc rebuild;
  (k) the moe and ssm families, after (g) and in its manner, in bfloat16
      with random weights from a seeded generator: qwen3-moe-235b-a22b at
      full width (128 experts of d_ff 1536, top 8, heads 64/4 x 128,
      ``qk_norm``) cut to ``MOE_LAYERS`` of its 94 layers, the deepest cut
      that leaves ``FREE_GB`` of the card free at the peak, and
      mamba2-370m whole; for each one ``make_prefill_step`` on 4 x 4096
      tokens and the serve loop (4 x (128 + 32)), launches counted per
      kernel and per flash-attention route, times, one decode step under
      torch's sync debug mode, a profiled prefill and decode, the peak
      memory, and three logits checks at two bfloat16 weight seeds and in
      float32 (qwen3-moe cut to ``MOE_F32_LAYERS`` there), each limit also
      held against planted faults (attention and the expert map for the
      moe family, the SSD decay and the conv taps for the ssm family).
      Phase (e) adds those models' RMSNorm rows (1024, 2048, 4096 and the
      64- and 4-head views) and phase (f) GQA groups 6 and 16 at D 128.

Exits non-zero, printing no result, without a card or when any check
fails.  The last line is ``{"ok": true, "device": {...}}``; the line
before it lists each ported kernel with its launches on the main paths
(phases (c), (h), (i) and (j) for the executor, phases (g) and (k) for
RMSNorm and flash attention).
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "build" / "traces"     # profiler traces (gitignored)

DEVICE = "cuda"
SPECS = ((8, 8, 2), (32, 8, 2))
N_MAIN = 1 << 24
# N of each width: odd (1 work-item a thread), 2 mod 4 (2), 4 mod 8 (4)
# and 0 mod 8 (8)
N_CHECK = (1, 5, 127, 4094, 4095, 4096, (1 << 20) + 3, (1 << 20) + 4,
           (1 << 20) + 8, (1 << 20) + 37)
N_SWAP = 1 << 20
# phase (h): work-items per buffer, the small N of the host-cost reading,
# and the calls timed on the host clock for each reading
N_RUNTIME = 1 << 24
N_RUNTIME_SMALL = 2048
RUNTIME_REPS = 50
# phase (h4)'s persistent cache (gitignored, emptied first)
PERSIST_DIR = ROOT / "build" / "chip_smoke_jit"
REPS = 10
# read before each timed RMSNorm launch to evict the 50 MB L2 (a read
# leaves clean lines; a write would leave dirty ones whose write-back lands
# in the timed window)
L2_FLUSH_BYTES = 100 << 20
# cycles the card sleeps before a timed launch, so the host's enqueue of the
# wrapper (tens of microseconds of Python) happens while the card is busy
# and the start event fires only when the launch is queued
HIDE_HOST_CYCLES = 1_000_000
# H100 SXM data-sheet rates (NVIDIA): device memory, and float32 outside
# the tensor cores
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# and bfloat16 in the tensor cores, dense
BF16_OPS_PER_S = 989e12

# the wrapper of each kernel, whose ``launches`` counts its launches
LAUNCHER = {"overlay_exec": "overlay_execute", "rmsnorm": "rmsnorm",
            "flash_attention": "flash_attention"}
# qwen3-14b's widths (src/repro_torch/configs/qwen3_14b.py)
QWEN = dict(layers=40, d=5120, hq=40, hkv=8, hd=128)
PREFILL_B, PREFILL_S = 4, 4096
SERVE_B, SERVE_PROMPT, SERVE_GEN = 4, 128, 32
AGREE_S = 1024
# kernel against plain version: the tolerances of tests/test_kernels.py
# for RMSNorm, and for flash attention's float32 (SIMT) route
RMS_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
FA_TOL_F32 = 2e-3
# (b, hq, hkv, sq, skv, d, causal, window)
FA_CASES = (
    (2, 8, 8, 512, 512, 128, True, None),        # group 1
    (2, 32, 8, 512, 512, 128, True, None),       # group 4
    (2, 40, 8, 1000, 1000, 128, True, None),     # group 5, ragged
    (1, 64, 8, 256, 256, 64, True, None),        # group 8, D 64
    (2, 40, 8, 300, 300, 128, False, None),      # not causal
    (1, 40, 8, 1024, 1024, 128, True, 32),       # window 32
    (1, 40, 8, 1024, 1024, 128, True, 128),      # window 128
    (4, 40, 8, 1, 200, 128, True, None),         # Sq < Skv, one row
    (2, 40, 8, 100, 700, 64, True, None),        # Sq < Skv
    (1, 40, 8, 300, 100, 128, True, None),       # Sq > Skv
    (1, 8, 8, 129, 257, 64, False, 100),         # window, not causal
    (1, 16, 16, 200, 200, 64, True, 64),         # window 64, D 64
    (2, 64, 4, 1000, 1000, 128, True, None),     # group 16 (qwen3-moe)
    (1, 48, 8, 1024, 1024, 128, True, 256),      # group 6 (mixtral), window
    (1, 48, 8, 300, 300, 128, False, None),      # group 6, not causal
)
# bfloat16 on the tensor-core route against the plain version (phase (f)),
# |kernel - plain| <= 1e-4 + 2^-7 |plain| + 2^-7 plain(|v|), where plain(|v|)
# is the plain attention of |v|.  Both sum in float32 and round the output
# to bfloat16 once, so they may differ by one bfloat16 rounding: 2^-7 of
# the value, plus 1e-4 for outputs near 0 where the float32 sums' order
# shows.  The tensor cores add one rounding, P -> bfloat16 before P V (the
# products q k and p v of bfloat16 values are exact in float32): its unit
# roundoff 2^-8 moves an output by at most 2^-8 sum(p |v|) / l, the plain
# attention of |v|; the third term allows it with the same factor 2 of
# margin.  It replaces the one-rounding limit 1e-4 + 2^-7 |plain| at the
# prefill shape and 2e-2 + 2e-2 |plain| on the small cases.
FA_BF16_LIMIT = (1e-4, 2.0 ** -7, 2.0 ** -7)
# timing at the prefill shape: CUDA-event medians of this many runs, in
# two turns of (tensor-core kernel, SIMT kernel, scaled_dot_product_attention)
FA_REPS = 10
# qwen3-14b logits held against each other (phase (g)), each check read at
# two weight seeds in bfloat16 at full depth and at one in float32 at full
# depth, and each against two faults planted in the attention that feeds one
# side (``planted_faults``): a limit must pass both seeds and fail both
# faults, or the run fails.  In bfloat16 the JAX package's 5e-2 (decode
# against forward, tests/test_models.py, two layers) does not hold at 40
# layers: on an H100 seeds 0 and 1 read 0.094 and 0.102 (decode vs
# prefill), 0.117 and 0.117 (decode vs forward), 0.086 and 0.083 (kernel vs
# plain attention) on logits whose largest is about 5, while the planted
# faults read 2.96-7.63 and, for the kernel against plain attention with
# the last 64 keys dropped, 1.24 (PERF.md, section 6).  0.25 sits between:
# twice the largest clean reading, a fifth of the smallest faulty one.
AGREE_TOL = {"decode_vs_prefill": 0.25, "decode_vs_forward": 0.25,
             "kernel_vs_plain_attention": 0.25}
# the same checks in float32, where only the order of sums differs (two
# layers read 1.4e-05 and 1.6e-05 on an H100)
AGREE_TOL_F32 = {"decode_vs_prefill": 1e-3, "decode_vs_forward": 1e-3,
                 "kernel_vs_plain_attention": 1e-3}
# keys the planted fault drops at the end of the sequence: 64, half the
# tensor-core kernel's 128-key tile and 1/64 of the 4096-key prefill
FAULT_KEYS = 64

class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ----------------------------------------------------------------- helpers
def same_bits(a, b) -> bool:
    """Bit-equal float32 tensors, NaN payloads aside: NaN positions equal
    and every other element's bits equal."""
    import torch
    if a.shape != b.shape:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    eq = (a.view(torch.int32) == b.view(torch.int32)) | (na & nb)
    return bool(torch.equal(na, nb) and eq.all())


def max_abs_err(a, b) -> float:
    import torch
    a, b = a.double(), b.double()
    both_nan = torch.isnan(a) & torch.isnan(b)
    same = (a == b) | both_nan          # also equal infinities
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    d = torch.nan_to_num(d, nan=float("inf"))
    return float(d.max()) if d.numel() else 0.0


def hide_host(evict=None, cycles: int = HIDE_HOST_CYCLES):
    """A ``before`` hook for :func:`cuda_ms`: read ``evict`` (a scratch
    tensor larger than the L2) if given, then keep the card busy for
    ``cycles`` while the host enqueues the timed call."""
    import torch

    def before():
        if evict is not None:
            evict.sum()
        torch.cuda._sleep(cycles)
    return before


def cuda_ms(fn, reps: int = REPS, warm: int = 2, before=None):
    """Device times of ``fn`` over ``reps`` runs, by CUDA events, after
    ``warm`` runs: → (median, fastest, slowest) in ms.  ``before``, if
    given, runs ahead of each run, outside the timed window."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), min(times), max(times)


def program_ops(instrs) -> int:
    """Arithmetic operations one work-item needs: fused multiply-adds count
    two, moves and immediate loads none."""
    from repro_torch.core.program import (OP_IMULADD, OP_IMULSUB, OP_MULADD,
                                          OP_MULSUB, OP_NOP, OP_PASS)
    two = (OP_MULADD, OP_MULSUB, OP_IMULADD, OP_IMULSUB)
    return sum(2 if int(op) in two else 0 if int(op) in (OP_NOP, OP_PASS)
               else 1 for op in instrs[:, 0])


def bound_ms(n_in: int, n_out: int, n: int, ops_per_item: int):
    """→ (ms to move each input and output once at the memory rate,
    ms to do the work's float32 operations at the card's peak)."""
    byte_ms = (n_in + n_out) * n * 4 / MEM_BYTES_PER_S * 1e3
    op_ms = ops_per_item * n / F32_OPS_PER_S * 1e3
    return byte_ms, op_ms


def special_inputs(rng, n_in: int, n: int):
    """Normals with NaN, -NaN, +-0, +-inf, denormals and near-overflow
    values sprinkled in."""
    import numpy as np
    x = rng.standard_normal((n_in, n)).astype(np.float32)
    specials = np.array([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf,
                         1e-40, -3e-42, 1.4e-45, 3e38, -3e38],
                        np.float32)
    mask = rng.random((n_in, n)) < 0.08
    x[mask] = rng.choice(specials, size=int(mask.sum()))
    if n >= len(specials):
        x[:, :len(specials)] = specials     # every special, whatever n
    return x


def random_image(rng, n_in: int, n_regs: int, n_out: int, m_random: int,
                 chain: float = 0.0):
    """An execution image whose first rows cover every (opcode, port)
    pair, followed by ``m_random`` random rows, then moves parking the
    outputs in the last ``n_out`` slots.  With ``chain``, that share of the
    rows read the row before's result as a (the chains the kernel forwards
    in registers)."""
    import numpy as np
    from repro_torch.core.program import N_OPCODES, OP_PASS
    rows, imms = [], []
    writable = n_regs - n_out
    pairs = [(op, port) for op in range(N_OPCODES) for port in (0, 1, 2)]
    pairs += [(int(rng.integers(N_OPCODES)), int(rng.integers(3)))
              for _ in range(m_random)]
    imm_pool = np.array([2.5, -0.75, 0.0, -0.0, 1e-40, 3e38, np.inf,
                         np.nan, 0.044715], np.float32)
    for op, port in pairs:
        d, a, b, c = (int(v) for v in rng.integers(0, writable, 4))
        if rows and rng.random() < chain:
            a = rows[-1][1]
        rows.append([op, d, a, b, c, port])
        imms.append(rng.choice(imm_pool) if rng.random() < 0.1
                    else np.float32(rng.standard_normal()))
    for j in range(n_out):
        rows.append([OP_PASS, writable + j,
                     int(rng.integers(writable)), 0, 0, 0])
        imms.append(0.0)
    return np.asarray(rows, np.int32), np.asarray(imms, np.float32)


# ------------------------------------------------------------------ phases
def kernel_modules():
    """name → the binding module of each ported kernel."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.overlay_exec import kernel as ox
    from repro_torch.kernels.rmsnorm import kernel as rn
    return {"overlay_exec": ox, "rmsnorm": rn, "flash_attention": fa}


def kernel_libraries():
    """name → each CUDA library: one per source in ``csrc/``."""
    mods = kernel_modules()
    fa = mods["flash_attention"]
    return {"overlay_exec": mods["overlay_exec"].LIBRARY,
            "rmsnorm": mods["rmsnorm"].LIBRARY,
            "flash_attention (wgmma)": fa.LIBRARY_WGMMA,
            "flash_attention (SIMT)": fa.LIBRARY}


def kernel_name(symbol: str) -> str:
    """A mangled kernel symbol → ``name<template arguments>``, for the
    integer, float and bfloat16 arguments the port's kernels take."""
    i, name = 3, symbol
    while i < len(symbol) and symbol[i].isdigit():    # nested names
        j = i
        while symbol[j].isdigit():
            j += 1
        name, i = symbol[j:j + int(symbol[i:j])], j + int(symbol[i:j])
    args = []
    if symbol[i:i + 1] == "I":
        j = i + 1
        while j < len(symbol) and symbol[j] != "E":
            if symbol.startswith("13__nv_bfloat16", j):
                args.append("bf16")
                j += 15
            elif symbol[j] == "f":
                args.append("f32")
                j += 1
            elif symbol.startswith("Li", j):
                k = symbol.index("E", j)
                args.append(symbol[j + 2:k])
                j = k + 1
            else:
                break
    return name + (f"<{','.join(args)}>" if args else "")


def ptxas_report(build_log: str):
    """nvcc's ``-Xptxas=-v`` output → one line per kernel instance:
    ``name<template arguments>: registers ...; stack and spills``."""
    import re
    name, spill = None, ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_name(m.group(1))
        elif "spill stores" in line:
            spill = line.split(":")[-1].strip()
        elif "Used" in line and "registers" in line and name:
            yield f"{name}: {line.split('Used', 1)[1].strip()}; {spill}"
            name, spill = None, ""
        elif any(w in line for w in ("Performance Loss", "setmaxnreg")):
            yield line.strip()


def phase_setup():
    from concurrent.futures import ThreadPoolExecutor
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "not read"
    log(card)

    def build(lib):
        t0 = time.perf_counter()
        lib.get()
        return time.perf_counter() - t0

    # one nvcc per source, all started together
    libs = kernel_libraries()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as ex:
        futs = {name: ex.submit(build, lib) for name, lib in libs.items()}
        secs = {name: f.result() for name, f in futs.items()}
    log(f"(a) built {len(libs)} kernel libraries for sm_90a in parallel in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, lib in libs.items():
        log(f"    {name}: {secs[name]:.1f} s (libraries built or loaded: "
            f"{lib.builds})")
        for line in ptxas_report(lib.build_log):
            log(f"      ptxas: {line}")
        check(lib.builds == 1, f"{name} library not built once")
    from repro_torch.kernels.flash_attention import kernel as fa
    smem = fa.LIBRARY_WGMMA.get().flash_attention_wgmma_smem_bytes
    log(f"    flash_attention (wgmma): dynamic shared memory per block "
        f"{smem(64)} bytes at D 64, {smem(128)} at D 128 (ptxas counts it "
        f"nowhere: it is set at launch)")
    return card


def phase_kernel_vs_plain(max_err: list) -> int:
    import numpy as np
    import torch
    from repro_torch.core.program import N_OPCODES, OP_PASS
    from repro_torch.kernels.overlay_exec import kernel, ref
    rng = np.random.default_rng(0)
    dev = torch.device(DEVICE)
    cases = 0
    # (n_in, n_regs, n_out, random rows); n_regs 300 and 1200 force one
    # work-item a thread in blocks of 128 and 32 under the opt-in
    # shared-memory limit; 6 inputs are more than the kernel loads ahead
    shapes = [(2, 3, 1, 4), (3, 8, 1, 20), (4, 17, 2, 40), (6, 24, 2, 60),
              (3, 64, 3, 120), (4, 300, 2, 200), (2, 1200, 1, 300)]
    # and chains, 1 to 3 inputs (each prefetch depth)
    shapes = [s + (0.0,) for s in shapes] + [
        (1, 12, 1, 40, 0.6), (2, 16, 2, 60, 0.6), (3, 20, 1, 60, 0.6)]
    for n_in, n_regs, n_out, m, chain in shapes:
        instrs, imms = random_image(rng, n_in, n_regs, n_out, m, chain)
        img = kernel.ExecImage.from_arrays(instrs, imms, n_regs, n_out, dev)
        plans = set()
        for n, offset in [(n, 0) for n in N_CHECK] + [(N_CHECK[-1], 1)]:
            x_host = torch.from_numpy(special_inputs(rng, n_in, n))
            # offset 1: x starts one element past 16 bytes
            x = torch.empty(n_in * n + offset, device=dev)[offset:]
            x = x.view(n_in, n).copy_(x_host)
            plans.add(kernel.plan(img, x)[:2])
            got = kernel.overlay_execute(img, x)
            plain = ref.execute_image(img.instrs, img.imms, n_regs, x, n_out)
            torch.cuda.synchronize()
            check(same_bits(got, plain),
                  f"kernel != plain on the card: n_regs={n_regs} n={n}")
            max_err.append(max_abs_err(got, plain))
            if n < (1 << 20):
                host = ref.execute_image(instrs, imms, n_regs, x_host, n_out)
                check(same_bits(got.cpu(), host),
                      f"kernel != plain on the CPU: n_regs={n_regs} n={n}")
            cases += 1
        log(f"(b) n_in={n_in} n_regs={n_regs:5d} M={img.n_instr:4d} "
            f"chain={chain} (items a thread, block) "
            f"{sorted(plans, reverse=True)}: "
            f"bit-exact at N={list(N_CHECK)} and with x offset by one "
            f"element")
    # one image per (opcode, port) pair at the largest N (one work-item a
    # thread) and at 2^20 (eight)
    for n in (N_CHECK[-1], 1 << 20):
        x = torch.from_numpy(special_inputs(rng, 3, n)).to(dev)
        for op in range(N_OPCODES):
            for port in (0, 1, 2):
                instrs = np.array([[op, 3, 0, 1, 2, port],
                                   [OP_PASS, 4, 3, 0, 0, 0]], np.int32)
                imms = np.array([-1.5, 0.0], np.float32)
                img = kernel.ExecImage.from_arrays(instrs, imms, 5, 1, dev)
                got = kernel.overlay_execute(img, x)
                plain = ref.execute_image(img.instrs, img.imms, 5, x, 1)
                check(same_bits(got, plain),
                      f"opcode {op} port {port} differs at N={n}")
                max_err.append(max_abs_err(got, plain))
                cases += 1
    torch.cuda.synchronize()
    log(f"(b) every (opcode, port) pair bit-exact at N={N_CHECK[-1]} and "
        f"{1 << 20}; {cases} cases in all")
    return cases


def phase_main_path(max_err: list):
    import numpy as np
    import torch
    from repro_torch.configs.paper_suite import BENCHMARKS
    from repro_torch.core.jit import jit_compile
    from repro_torch.core.overlay import OverlaySpec
    from repro_torch.kernels.overlay_exec import kernel, ops, ref

    rng = np.random.default_rng(1)
    dev = torch.device(DEVICE)
    runs = []
    kernel.overlay_execute.launches = 0            # main path starts here
    for w, h, d in SPECS:
        spec = OverlaySpec(w, h, d)
        for name, (src, _, _) in BENCHMARKS.items():
            t0 = time.perf_counter()
            ck = jit_compile(src, spec)
            compile_ms = (time.perf_counter() - t0) * 1e3
            n_in = len(ck.dfg.inputs)
            xs = [rng.uniform(-1, 1, N_MAIN).astype(np.float32)
                  for _ in range(n_in)]
            before = kernel.overlay_execute.launches
            t0 = time.perf_counter()
            got = ck.run_overlay(*xs)
            torch.cuda.synchronize()
            run_ms = (time.perf_counter() - t0) * 1e3
            launches = kernel.overlay_execute.launches - before
            runs.append((spec, name, ck, xs, got, compile_ms, run_ms,
                         launches))
    main_launches = kernel.overlay_execute.launches   # main path ends here
    check(main_launches >= len(runs),
          f"main path launched the executor {main_launches} times for "
          f"{len(runs)} run_overlay calls")

    totals = dict(ms=0.0, ms_with_host=0.0, plain_ms=0.0, bound_ms=0.0,
                  byte_ms=0.0, op_ms=0.0)
    cell_ms = {}
    for spec, name, ck, xs, got, compile_ms, run_ms, launches in runs:
        check(launches >= 1, f"{name}: run_overlay never launched the kernel")
        check(got.device.type == DEVICE and got.shape == (N_MAIN,)
              and got.dtype == torch.float32,
              f"{name}: run_overlay gave {got.device} {tuple(got.shape)}")
        want = torch.from_numpy(np.ascontiguousarray(ck.run_reference(*xs)))
        check(same_bits(got.cpu(), want),
              f"{name} {spec.width}x{spec.height}: run_overlay != "
              f"run_reference")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        x = torch.stack([torch.from_numpy(a) for a in xs]).to(dev)
        img = ops.load_image(ck.program, dev)
        plain = ref.execute_image(img.instrs, img.imms, img.n_regs, x,
                                  img.n_out)
        check(same_bits(got, plain[0]), f"{name}: kernel != plain on card")
        max_err.append(max_abs_err(got, plain[0]))
        max_err.append(max_abs_err(got.cpu(), want))
        k_ms, k_lo, k_hi = cuda_ms(lambda: kernel.overlay_execute(img, x),
                                   before=hide_host())
        # as earlier versions of this script timed it: the wrapper's host
        # time inside the window
        h_ms = cuda_ms(lambda: kernel.overlay_execute(img, x))[0]
        p_ms = cuda_ms(lambda: ref.execute_image(
            img.instrs, img.imms, img.n_regs, x, img.n_out), reps=3)[0]
        xs_dev = list(x)
        c_ms = cuda_ms(lambda: ck(*xs_dev), reps=3)[0]
        cm = ck(*xs_dev)
        check(same_bits(cm, got), f"{name}: compiled mode != run_overlay")
        byte_ms, op_ms = bound_ms(x.shape[0], img.n_out, N_MAIN,
                                  program_ops(img.instrs.cpu().numpy()))
        launch = kernel.plan(img, x)
        b_ms = max(byte_ms, op_ms)
        b_by = "bytes" if byte_ms >= op_ms else "operations"
        totals["ms"] += k_ms
        cell_ms[(spec.width, spec.height, spec.dsp_per_fu, name)] = k_ms
        totals["ms_with_host"] += h_ms
        totals["plain_ms"] += p_ms
        totals["bound_ms"] += b_ms
        totals["byte_ms"] += byte_ms
        totals["op_ms"] += op_ms
        log(f"(c) {name:9s} {spec.width:2d}x{spec.height}: "
            f"replicas={ck.plan.replicas:3d} compile={compile_ms:7.1f} ms "
            f"run_overlay={run_ms:6.1f} ms "
            f"n_instr={img.n_instr:2d} n_regs={img.n_regs:2d} "
            f"items={launch.items} block={launch.block} "
            f"depth={launch.depth} grid={launch.grid} "
            f"kernel={k_ms:.4f} ms (n={REPS}, {k_lo:.4f}-{k_hi:.4f}; "
            f"{h_ms:.4f} with the host's enqueue) "
            f"plain={p_ms:.3f} ms "
            f"compiled_mode={c_ms:.3f} ms bound={b_ms:.4f} ms ({b_by}; "
            f"ops {op_ms:.5f} ms) "
            f"share={b_ms / k_ms:.2f} launches={launches} bit-exact")
        del x, plain, cm
    log(f"(c) the {len(runs)} cells: kernel {totals['ms']:.4f} ms "
        f"({totals['ms_with_host']:.4f} ms with the host's enqueue, as "
        f"earlier versions of this script timed it), bound "
        f"{totals['bound_ms']:.4f} ms (share "
        f"{totals['bound_ms'] / totals['ms']:.3f}), plain "
        f"{totals['plain_ms']:.3f} ms")
    return main_launches, totals, len(runs), cell_ms


def phase_reconfig(max_err: list) -> None:
    import numpy as np
    import torch
    from repro_torch.configs.paper_suite import BENCHMARKS
    from repro_torch.core.jit import jit_compile
    from repro_torch.core.overlay import OverlaySpec
    from repro_torch.kernels.overlay_exec import kernel, ops, ref

    dev = torch.device(DEVICE)
    spec = OverlaySpec(*SPECS[0])
    cks = [jit_compile(src, spec) for src, _, _ in BENCHMARKS.values()]
    plain_images = [ops.build_image(ck.program) for ck in cks]
    pad_to = max(im[0].shape[0] for im in plain_images)
    pad_regs = max(im[2] for im in plain_images)
    images = [ops.build_image(ck.program, pad_to=pad_to, pad_regs=pad_regs)
              for ck in cks]
    resident = ops.load_image(cks[0].program, dev, pad_to=pad_to,
                              pad_regs=pad_regs)
    builds = kernel.LIBRARY.builds
    rng = np.random.default_rng(2)
    swap_ms = []
    for ck, (instrs, imms, n_regs, n_out) in zip(cks, images):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resident.write(instrs, imms, n_regs, n_out)
        torch.cuda.synchronize()
        swap_ms.append((time.perf_counter() - t0) * 1e3)
        xs = [rng.uniform(-1, 1, N_SWAP).astype(np.float32)
              for _ in range(len(ck.dfg.inputs))]
        x = torch.stack([torch.from_numpy(a) for a in xs]).to(dev)
        got = kernel.overlay_execute(resident, x)
        plain = ref.execute_image(resident.instrs, resident.imms, n_regs, x,
                                  n_out)
        want = torch.from_numpy(np.ascontiguousarray(ck.run_reference(*xs)))
        check(same_bits(got, plain), f"{ck.name}: swapped image != plain")
        check(same_bits(got[0].cpu(), want),
              f"{ck.name}: swapped image != run_reference")
        max_err.append(max_abs_err(got, plain))
    for _ in range(3):                      # steady-state swap times
        for image in images:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            resident.write(*image)
            torch.cuda.synchronize()
            swap_ms.append((time.perf_counter() - t0) * 1e3)
    # one CUDA graph, captured once, serves every swapped program of one
    # input (n_in is a launch argument the graph keeps)
    one_input = [i for i, ck in enumerate(cks) if len(ck.dfg.inputs) == 1]
    x1 = torch.from_numpy(
        rng.uniform(-1, 1, N_SWAP).astype(np.float32))[None].to(dev)
    resident.write(*images[one_input[0]])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        graph_out = kernel.overlay_execute(resident, x1)
    for i in one_input:
        resident.write(*images[i])
        graph.replay()
        want = torch.from_numpy(cks[i].run_reference(x1[0].cpu().numpy()))
        check(same_bits(graph_out[0].cpu(), want),
              f"{cks[i].name}: CUDA graph replay after a swap differs")
    check(kernel.LIBRARY.builds == builds == 1,
          f"reconfiguration rebuilt the kernel ({kernel.LIBRARY.builds})")
    log(f"(d) {len(cks)} programs padded to M={pad_to} n_regs={pad_regs} "
        f"swapped into one image: builds={kernel.LIBRARY.builds}, "
        f"swap median {statistics.median(swap_ms) * 1e3:.1f} us "
        f"(host clock, write + synchronize; first {swap_ms[0] * 1e3:.1f} "
        f"us), all bit-exact at N={N_SWAP}; one CUDA graph replayed after "
        f"swaps among {len(one_input)} one-input programs, bit-exact")


# ------------------------------------------------ (h) the runtime seam
class Refs:
    """``run_reference`` (numpy, on the host) of each artifact on inputs
    drawn from one pool, computed once per (artifact, inputs)."""

    def __init__(self, pool):
        self.pool = pool
        self._memo = {}

    def __call__(self, ck, n_in: int):
        key = (ck.program.content_hash(), n_in)
        if key not in self._memo:
            self._memo[key] = ck.run_reference(*self.pool[:n_in])
        return self._memo[key]


def check_resident(buf, want, what: str) -> None:
    """A Buffer holds ``want``'s bits and still lies on the card."""
    import numpy as np
    import torch
    check(buf.data.device.type == "cuda" and buf.data.dtype == torch.float32,
          f"{what}: output on {buf.data.device} {buf.data.dtype}")
    check(same_bits(buf.data.cpu(), torch.from_numpy(
        np.ascontiguousarray(want))), f"{what}: != run_reference")


def runtime_opencl_flow(spec, bufs, refs):
    """(h1) ``examples/opencl_runtime_demo.py`` for the six kernels: build
    (ledger debit), enqueue three times, release (credit), then rebuild
    each from the cache."""
    from repro_torch.configs.paper_suite import BENCHMARKS
    from repro_torch.core.cache import JITCache
    from repro_torch.core.options import CompileOptions
    from repro_torch.core.runtime import Context, Device, Platform
    from repro_torch.kernels.overlay_exec import kernel, ops

    dev = Platform([Device("zynq-overlay", spec)]).devices[0]
    cache = JITCache()
    ctx = Context(dev, cache=cache)
    q = ctx.create_queue()
    check(q.use_overlay_executor, "the queue does not run the executor")
    cold, warm, charges = {}, {}, []
    for rebuild in (False, True):
        for name, (src, _, _) in BENCHMARKS.items():
            loads, launches = ops.image_loads, kernel.overlay_execute.launches
            prog = ctx.build_program(src, opts=CompileOptions())
            plan = prog.compiled.plan
            check((dev.fu_used, dev.io_used) == (plan.fus_used, plan.io_used),
                  f"(h1) {name}: the build did not debit the ledger")
            n_in = len(prog.compiled.dfg.inputs)
            reps = 1 if rebuild else 3
            evs = [q.enqueue_kernel(prog.create_kernel().set_args(
                *bufs[:n_in])) for _ in range(reps)]
            want = refs(prog.compiled, n_in)
            for ev in evs:
                check_resident(ev.outputs[0], want, f"(h1) {name}")
            check(ops.image_loads - loads == 1,
                  f"(h1) {name}: {ops.image_loads - loads} image loads")
            check(kernel.overlay_execute.launches - launches == reps,
                  f"(h1) {name}: launches != enqueues")
            charges.append([ev.config_us > 0.0 for ev in evs])
            (warm if rebuild else cold)[name] = prog.build_ms
            prog.release()
            check(dev.fu_used == dev.io_used == 0 and ctx.ledger_consistent()
                  and prog._images == {},
                  f"(h1) {name}: release did not credit the ledger")
    check(cache.stats.hits == len(BENCHMARKS),
          f"(h1) rebuilds were not cache hits: {cache.stats.as_dict()}")
    check(all(c[0] and not any(c[1:]) for c in charges[:len(BENCHMARKS)]),
          f"(h1) config charges {charges}")
    check(kernel.LIBRARY.builds == 1, "(h1) the executor was rebuilt")
    log(f"(h1) OpenCL flow, six kernels at N={bufs[0].data.numel()}: "
        f"bit-exact, outputs on the card, one image load and one config "
        f"charge per program over 3 enqueues, ledger debited and credited; "
        f"cold build ms " + ", ".join(f"{k} {v:.1f}" for k, v in cold.items())
        + "; rebuild from the cache ms "
        + ", ".join(f"{k} {v:.3f}" for k, v in warm.items()))


# examples/multi_tenant_serving.py's request streams
TENANTS = {
    "tenant-a": ["poly1", "poly1", "chebyshev", "poly1"],
    "tenant-b": ["sgfilter", "sgfilter", "poly2"],
    "tenant-c": ["chebyshev", "mibench", "chebyshev", "qspline"],
}


def runtime_multi_tenant(spec, bufs, refs):
    """(h2) ``examples/multi_tenant_serving.py``: three tenants on two
    overlay devices of the one card."""
    from repro_torch.configs.paper_suite import BENCHMARKS
    from repro_torch.core.cache import JITCache
    from repro_torch.core.options import CompileOptions
    from repro_torch.core.runtime import Device
    from repro_torch.core.session import Session
    from repro_torch.kernels.overlay_exec import kernel

    opts = CompileOptions(max_replicas=6)
    with Session([Device("ovl0", spec), Device("ovl1", spec)],
                 cache=JITCache(capacity=32), max_workers=4) as sess:
        sess.set_priority("tenant-a", 1)
        futures = {(t, k): sess.compile(BENCHMARKS[k][0], opts, tenant=t)
                   for t, stream in TENANTS.items() for k in set(stream)}
        n = 0
        for tenant, stream in TENANTS.items():
            for kname in stream:
                fut = futures[(tenant, kname)]
                ck = fut.result().compiled
                n_in = len(ck.dfg.inputs)
                before = kernel.overlay_execute.launches
                ev = sess.enqueue(fut, *bufs[:n_in], tenant=tenant)
                check(kernel.overlay_execute.launches - before == 1,
                      f"(h2) {tenant} {kname}: not one launch")
                check_resident(ev.outputs[0], refs(ck, n_in),
                               f"(h2) {tenant} {kname}")
                n += 1
        check(sess.ledger_consistent(), "(h2) ledger out of balance")
        devices = sorted({f.result().ctx.device.name
                          for f in futures.values()})
        makespan = sess.finish()
        for fut in futures.values():
            fut.result().release()
        sess.build(BENCHMARKS["poly1"][0], opts, tenant="tenant-a")
        check(sess.cache.stats.hits >= 1, "(h2) no cache hit after churn")
        log(f"(h2) multi-tenant flow: {n} requests of 3 tenants on "
            f"{devices}, one executor launch each, bit-exact, ledger "
            f"consistent; modelled makespan {makespan:.0f} us, "
            f"config {sess.config_charges()}")


PIPELINE_STAGES = ("normalize", "poly1", "act", "rescale")


def record_pipeline(sess, opts):
    """``examples/graph_replay.py``'s four-stage pipeline."""
    from repro_torch.configs.paper_suite import BENCHMARKS
    srcs = (lambda x: x * 0.5 - 1.0, BENCHMARKS["poly1"][0],
            lambda x: x * x * 0.25 + x, lambda x: x * 0.125 + 2.0)
    with sess.capture("tenant-a", name="pipeline") as g:
        buf = g.input("x")
        for name, src in zip(PIPELINE_STAGES, srcs):
            buf = g.call(src, opts.replace(n_inputs=1, name=name), buf)
    return g


def runtime_graph_replay(spec, xs):
    """(h3) ``examples/graph_replay.py``: five requests, replayed as an
    instantiated graph and node by node, each in its own Session."""
    import numpy as np
    from repro_torch.core.jit import jit_compile
    from repro_torch.core.options import CompileOptions
    from repro_torch.core.runtime import Device
    from repro_torch.core.session import Session
    from repro_torch.kernels.overlay_exec import kernel

    opts = CompileOptions(max_replicas=4)
    outs, charges = {}, {}
    for mode in ("graph", "nodewise"):
        with Session([Device("ovl0", spec)]) as sess:
            g = record_pipeline(sess, opts)
            gx = sess.instantiate(g) if mode == "graph" else None
            outs[mode] = []
            for x in xs:
                before = kernel.overlay_execute.launches
                ev = sess.launch(gx, x) if gx is not None else \
                    sess.launch_nodewise(g, x)
                n = kernel.overlay_execute.launches - before
                want = gx.n_partitions if gx is not None else len(g.nodes)
                check(n == want, f"(h3) {mode}: {n} launches for {want} "
                      f"partitions")
                outs[mode].append(ev.outputs[0])
            charges[mode] = (sess.config_charges(),
                             gx.n_partitions if gx is not None else None)
            stages = [jit_compile(node.dfg, spec, opts=node.opts)
                      for node in g.nodes]
    for x, got, node in zip(xs, outs["graph"], outs["nodewise"]):
        want = x.read()
        for ck in stages:
            want = np.asarray(ck.run_reference(want), np.float32)
        check_resident(got, want, "(h3) graph replay")
        check_resident(node, want, "(h3) nodewise replay")
    log(f"(h3) graph replay, {len(xs)} requests at N={xs[0].data.numel()}: "
        f"{charges['graph'][1]} partition(s), one executor launch each; "
        f"fused = nodewise = chained run_reference, bit-exact; modelled "
        f"config charges: graph {charges['graph'][0]}, nodewise "
        f"{charges['nodewise'][0]}")


def runtime_persistence(spec, bufs, refs, persist: Path):
    """(h4) a second Session on the same ``persist_dir`` warm-loads every
    artifact with no cold build, and its outputs are equal."""
    import shutil
    from repro_torch.configs.paper_suite import BENCHMARKS
    from repro_torch.core.options import CompileOptions
    from repro_torch.core.runtime import Device
    from repro_torch.core.session import Session

    shutil.rmtree(persist, ignore_errors=True)
    opts = CompileOptions(max_replicas=4)
    runs = []
    for _ in range(2):
        with Session([Device("ovl0", spec)], persist_dir=str(persist)) as s:
            outs = []
            for name, (src, _, _) in BENCHMARKS.items():
                prog = s.build(src, opts)
                n_in = len(prog.compiled.dfg.inputs)
                ev = s.enqueue(prog, *bufs[:n_in])
                check_resident(ev.outputs[0], refs(prog.compiled, n_in),
                               f"(h4) {name}")
                outs.append(ev.outputs[0].data)
                prog.release()
            gx = s.instantiate(record_pipeline(s, opts)).result()
            outs.append(s.launch(gx, bufs[0]).outputs[0].data)
            runs.append((s.cache.stats.as_dict(), outs))
    (cold, first), (warm, second) = runs
    check(warm["misses"] == 0 and warm["disk_hits"] == cold["misses"],
          f"(h4) restart was not warm: {warm}")
    check(all(same_bits(a, b) for a, b in zip(first, second)),
          "(h4) outputs after the restart differ")
    log(f"(h4) persistence: {cold['misses']} cold builds, then a second "
        f"Session on the same persist_dir: {warm['misses']} cold builds, "
        f"{warm['disk_hits']} disk hits, outputs bit-identical")


def host_us(call, drain, reps: int = RUNTIME_REPS) -> float:
    """Median host µs of ``call`` (the host clock around the call, the
    launch left queued) over ``reps`` calls.  A first pass of as many
    calls leaves the allocator holding the outputs' memory, so the timed
    pass reads the runtime, not cudaMalloc; the card is synchronised and
    ``drain`` run after each pass."""
    import torch
    for timed in (False, True):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            call()
            times.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
        drain()
    return statistics.median(times)


def runtime_times(spec, card: str, cell_ms: dict):
    """The runtime's own cost, poly1 on a 1-partition pipeline graph:

      - the host µs per Session.enqueue and Session.launch and their device
        ms (CUDA events, the host's enqueue hidden), at 2^24 and 2048;
      - at 2048, the host µs of each layer under Session.enqueue called
        alone: CommandQueue.enqueue_kernel, Kernel.enqueue, the executor's
        wrapper, and one torch add_ (a launch's floor);
      - run_overlay from numpy (host clock, copies to and from the card);
      - for each of the six kernels at 2^24, the device ms of a
        Session.enqueue beside the executor alone on the same inputs, the
        copy that stacks a multi-input kernel's buffers, and phase (c)'s
        kernel ms of the same cell."""
    import numpy as np
    import torch
    from repro_torch.configs.paper_suite import BENCHMARKS
    from repro_torch.core.options import CompileOptions
    from repro_torch.core.runtime import Buffer, Device
    from repro_torch.core.session import Session
    from repro_torch.kernels.overlay_exec import kernel

    out = {}
    rng = np.random.default_rng(6)
    opts = CompileOptions(max_replicas=4)
    with Session([Device("ovl0", spec)]) as sess:
        prog = sess.build(BENCHMARKS["poly1"][0], opts)
        gx = sess.instantiate(record_pipeline(sess, opts)).result()
        queue = sess.queue_for("tenant-a", "ovl0")
        for n in (N_RUNTIME, N_RUNTIME_SMALL):
            x_np = rng.uniform(-1, 1, n).astype(np.float32)
            buf = Buffer(x_np)
            for what, call in (("enqueue", lambda: sess.enqueue(
                    prog, buf, tenant="tenant-a")),
                    ("launch", lambda: sess.launch(gx, buf))):
                out[f"{what}_host_us_{n}"] = host_us(call, queue.drain)
                out[f"{what}_device_ms_{n}"] = cuda_ms(
                    call, before=hide_host())[0]
                queue.drain()
            run_ms = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prog.compiled.run_overlay(x_np).cpu()
                run_ms.append((time.perf_counter() - t0) * 1e3)
            out[f"run_overlay_numpy_ms_{n}"] = statistics.median(run_ms)
            log(f"(h) N={n}: Session.enqueue {out[f'enqueue_host_us_{n}']:.1f}"
                f" us host (median of {RUNTIME_REPS}), "
                f"{out[f'enqueue_device_ms_{n}']:.4f} ms device; "
                f"Session.launch ({gx.n_partitions} partition) "
                f"{out[f'launch_host_us_{n}']:.1f} us host, "
                f"{out[f'launch_device_ms_{n}']:.4f} ms device; "
                f"run_overlay from numpy "
                f"{out[f'run_overlay_numpy_ms_{n}']:.3f} ms host (poly1, "
                f"8x8; {card})")
        # each layer under Session.enqueue alone, at the small N, in turns
        # (three rounds, the median of each layer's three readings): the
        # host clock drifts between readings far apart
        kern = prog.create_kernel().set_args(buf)
        kern.enqueue()
        (_, image), = prog._images.values()
        x2 = buf.data.reshape(1, -1)
        calls = {
            "Session.enqueue": lambda: sess.enqueue(
                prog, buf, tenant="tenant-a"),
            "CommandQueue.enqueue_kernel": lambda: queue.enqueue_kernel(
                prog.create_kernel().set_args(buf)),
            "Kernel.enqueue": kern.enqueue,
            "overlay_execute": lambda: kernel.overlay_execute(image, x2),
            "torch add_": lambda: x2.add_(0.0),
        }
        rounds = [{k: host_us(c, queue.drain) for k, c in calls.items()}
                  for _ in range(3)]
        layers = {k: statistics.median(r[k] for r in rounds) for k in calls}
        names = list(layers)
        own = {a: layers[a] - (layers[b] if b else 0.0)
               for a, b in zip(names, names[1:] + [None])}
        out["layers_host_us_2048"] = layers
        log(f"(h) N={N_RUNTIME_SMALL}, host us of each layer called alone "
            f"(its own share): " + ", ".join(
                f"{k} {v:.1f} ({own[k]:.1f})" for k, v in layers.items())
            + f"; {card}")
        # the six kernels at 2^24: a Session.enqueue's device time is the
        # executor's plus, for more than one input, the copy stacking them
        bufs = [Buffer(rng.uniform(-1, 1, N_RUNTIME).astype(np.float32))
                for _ in range(4)]
        cells = {}
        for name, (src, _, _) in BENCHMARKS.items():
            p = sess.build(src, opts)
            n_in = len(p.compiled.dfg.inputs)
            args = bufs[:n_in]
            enq = cuda_ms(lambda: sess.enqueue(p, *args, tenant="tenant-a"),
                          before=hide_host())[0]
            queue.drain()
            x = torch.stack([b.data for b in args])
            (_, img), = p._images.values()
            exe = cuda_ms(lambda: kernel.overlay_execute(img, x),
                          before=hide_host())[0]
            stack = cuda_ms(lambda: torch.stack([b.data for b in args]),
                            before=hide_host())[0] if n_in > 1 else 0.0
            cells[name] = dict(
                n=N_RUNTIME, n_in=n_in, enqueue_device_ms=enq,
                executor_ms=exe, stack_ms=stack, phase_c_kernel_ms=cell_ms.get(
                    (spec.width, spec.height, spec.dsp_per_fu, name)))
            log(f"(h) {name:9s} N={N_RUNTIME} n_in={n_in}: Session.enqueue "
                f"{enq:.4f} ms device = executor {exe:.4f} + stack copy "
                f"{stack:.4f} (phase (c) kernel "
                f"{cells[name]['phase_c_kernel_ms']:.4f}); {card}")
            p.release()
            del x
        out["by_kernel"] = cells
    return out


def phase_runtime(card: str, cell_ms: dict):
    """(h) the runtime seam on the card: device Buffers, command queues,
    Sessions, graph replay and the persistent cache, every execution
    through the executor on resident images."""
    import numpy as np
    import torch
    from repro_torch.core.overlay import OverlaySpec
    from repro_torch.core.runtime import Buffer
    from repro_torch.kernels.overlay_exec import kernel

    t0 = time.perf_counter()
    spec = OverlaySpec(*SPECS[0])
    rng = np.random.default_rng(4)
    pool = [rng.uniform(-1, 1, N_RUNTIME).astype(np.float32)
            for _ in range(4)]
    refs = Refs(pool)
    bufs = [Buffer(x) for x in pool]
    requests = [Buffer(rng.uniform(0, 2, N_RUNTIME).astype(np.float32))
                for _ in range(5)]
    builds = kernel.LIBRARY.builds
    # ---- the main path: counts set to 0 just before, read just after
    kernel.overlay_execute.launches = 0
    runtime_opencl_flow(spec, bufs, refs)
    runtime_multi_tenant(spec, bufs, refs)
    runtime_graph_replay(spec, requests)
    runtime_persistence(spec, bufs, refs, PERSIST_DIR)
    launches = kernel.overlay_execute.launches
    # ----
    check(launches > 0, "(h) the runtime never launched the executor")
    check(kernel.LIBRARY.builds == builds == 1,
          f"(h) the executor was built {kernel.LIBRARY.builds} times")
    times = runtime_times(spec, card, cell_ms)
    del bufs, requests
    torch.cuda.empty_cache()
    log(f"(h) runtime seam: {launches} executor launches, builds "
        f"{kernel.LIBRARY.builds}, {time.perf_counter() - t0:.1f} s")
    return launches, times


# ------------------------------------------------- (i) serving on the card
# benchmarks/serving_perf.py's trace: three families under mixed SLO
# classes, 36 requests in three bursts of 12 (2 us apart within a burst, 40
# us between bursts), decode steps 4-7 from seed 7, max batch 8, two 8x8
# overlay devices
SERVE_TENANTS = {"transformer": "realtime", "mamba2": "standard",
                 "moe": "batch"}
SERVE_REQUESTS, SERVE_BURST = 36, 12
SERVE_MAX_BATCH = 8
# (i2): every family, this many requests each
SERVE_PER_FAMILY = 8
# (i3): the batch class's admission cap, all in one burst, in one batch
SERVE_CAP = 256
# the readings: decode iterations timed per reading, and the window of
# decode iterations profiled for device-to-host copies
SERVE_REPS = 50
SERVE_WINDOW = 6
# phase (i4)'s persistent cache and trace (gitignored, emptied first)
SERVE_PERSIST = ROOT / "build" / "chip_smoke_serve_jit"
SERVE_TRACE = OUT / "serve_trace.json"
# modelled times of the card's run against the CPU run's: equal but for the
# rounding of the host-clock anchor both are offset from (as exec_us in
# tests/torch_runtime_pair.py)
MODEL_TOL_US = 1e-6


def serve_trace(families, n, seed=7, burst=SERVE_BURST, gap_us=40.0,
                spacing_us=2.0):
    """Request kwargs (offsets from the Session's warm anchor): families in
    turn, ``burst`` requests ``spacing_us`` apart, bursts ``gap_us``
    apart."""
    import numpy as np
    from repro_torch.serve.models import PIPELINES
    rng = np.random.default_rng(seed)
    fams = sorted(families)
    out = []
    for i in range(n):
        fam = fams[i % len(fams)]
        out.append(dict(model=fam, prompt=rng.standard_normal(
            PIPELINES[fam].state_dim).astype(np.float32),
            decode_steps=int(rng.integers(4, 8)),
            offset_us=(i // burst) * gap_us + (i % burst) * spacing_us))
    return out


def serving_session(device, **kw):
    """Two 8x8 overlay devices, one build worker."""
    from repro_torch.core.overlay import OverlaySpec
    from repro_torch.core.runtime import Device
    from repro_torch.core.session import Session
    spec = OverlaySpec(*SPECS[0])
    return Session([Device(f"ovl{i}", spec) for i in range(2)],
                   max_workers=1, device=device, **kw)


def warm(sess, build):
    """``build()`` with every build it submits placed in submission order
    and landed before it returns: the one build worker is held until all
    are submitted (so each placement sees every booking, the same in every
    run), then drained.  Returns what ``build`` returns."""
    import threading
    gate = threading.Event()
    held = sess._pool.submit(gate.wait, 300)
    try:
        out = build()
    finally:
        gate.set()
        held.result()
    sess._pool.submit(lambda: None).result()
    return out


def serve_leg(device, families, trace, max_batch, sequential=False, **kw):
    """Serve ``trace`` warm on a fresh Session: batched through
    InferenceServer, or request at a time through serve_sequential.  → a
    dict of the outputs by trace order, the modelled makespan and (batched)
    latencies in us from the warm anchor, stats()["serving"] (batched) and
    the seconds the serve took on the host clock."""
    import torch
    from repro_torch.serve import (InferenceServer, Request, build_zoo,
                                   serve_sequential)
    with serving_session(device, **kw) as sess:
        if sequential:
            zoo = warm(sess, lambda: build_zoo(sess, sorted(families)))
        else:
            srv = warm(sess, lambda: InferenceServer(
                sess, families, max_batch=max_batch))
        t0 = sess.now_us()
        reqs = [Request(t["model"], t["prompt"], t["decode_steps"],
                        t_arrival_us=t0 + t["offset_us"]) for t in trace]
        if device != "cpu":
            torch.cuda.synchronize()
        t_host = time.perf_counter()
        if sequential:
            outs, makespan = serve_sequential(sess, zoo, reqs)
            outputs = [outs[r.rid] for r in reqs]
            lat = None
        else:
            for r in reqs:
                check(srv.submit(r), f"(i) request {r.rid} rejected")
            makespan = srv.run()
            outputs = [r.output for r in reqs]
            lat = [r.latency_us for r in reqs]
        if device != "cpu":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t_host
        serving = sess.stats().get("serving")
        if not sequential:
            srv.close()
    return dict(outputs=outputs, makespan=makespan - t0, latency=lat,
                serving=serving, seconds=secs)


def same_model_us(a, b) -> bool:
    """Modelled us equal within MODEL_TOL_US, recursively."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_model_us(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_model_us(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return abs(a - b) <= MODEL_TOL_US
    return a == b


def same_outputs(a, b) -> bool:
    import numpy as np
    return len(a) == len(b) and all(
        isinstance(x, np.ndarray) and isinstance(y, np.ndarray)
        and x.dtype == y.dtype == np.float32
        and np.array_equal(x.view(np.int32), y.view(np.int32))
        for x, y in zip(a, b))


class PlanLog:
    """Records the (work-items a thread, block) of each executor launch by
    N while installed over ``kernel.plan``."""

    def __init__(self):
        from repro_torch.kernels.overlay_exec import kernel
        self.kernel, self.plan = kernel, kernel.plan
        self.seen = {}

    def __enter__(self):
        def plan(image, x):
            p = self.plan(image, x)
            self.seen.setdefault(x.shape[1], set()).add((p.items, p.block))
            return p
        self.kernel.plan = plan
        return self

    def __exit__(self, *exc):
        self.kernel.plan = self.plan


def serving_checks(card: str, plans: "PlanLog"):
    """(i1)-(i4): the main path of phase (i); returns its readings.
    ``plans`` records each executor launch's plan by N."""
    import shutil
    from repro_torch.core.cache import JITCache
    from repro_torch.obs import (MetricsRegistry, ProfileStore, Tracer,
                                 write_chrome_trace)
    from repro_torch.serve.models import PIPELINES

    out = {}
    # (i1) the reference benchmark's trace, batched and sequential
    trace = serve_trace(SERVE_TENANTS, SERVE_REQUESTS)
    legs = {(dev, seq): serve_leg(dev, SERVE_TENANTS, trace, SERVE_MAX_BATCH,
                                  sequential=seq)
            for dev in (DEVICE, "cpu") for seq in (False, True)}
    card_b, card_s = legs[(DEVICE, False)], legs[(DEVICE, True)]
    cpu_b, cpu_s = legs[("cpu", False)], legs[("cpu", True)]
    check(same_outputs(card_b["outputs"], card_s["outputs"]),
          "(i1) batched != serve_sequential on the card")
    check(same_outputs(card_b["outputs"], cpu_b["outputs"]),
          "(i1) the card's outputs != the CPU port's")
    check(same_outputs(card_s["outputs"], cpu_s["outputs"]),
          "(i1) serve_sequential: the card != the CPU port")
    for what, a, b in (("batched", card_b, cpu_b),
                       ("sequential", card_s, cpu_s)):
        check(same_model_us([a["makespan"], a["latency"], a["serving"]],
                            [b["makespan"], b["latency"], b["serving"]]),
              f"(i1) {what}: modelled times on the card != the CPU run's: "
              f"{a['makespan']} / {b['makespan']}")
    check(card_b["serving"]["completed"] == SERVE_REQUESTS
          and card_b["serving"]["rejected"] == 0
          and card_b["serving"]["degraded_steps"] == 0,
          f"(i1) {card_b['serving']}")
    ratio = card_s["makespan"] / card_b["makespan"]
    lat = card_b["serving"]["latency_us"]
    log(f"(i1) serving_perf's trace, {SERVE_REQUESTS} requests of "
        f"{sorted(SERVE_TENANTS)}: batched = serve_sequential = the CPU "
        f"port, bit for bit; modelled makespan batched "
        f"{card_b['makespan']:.3f} us, sequential {card_s['makespan']:.3f} "
        f"us ({ratio:.2f}x), equal to the CPU run's; p50/p99 " + ", ".join(
            f"{c} {v['p50']:.1f}/{v['p99']:.1f}" for c, v in lat.items())
        + f" us; host s batched {card_b['seconds']:.3f}, sequential "
        f"{card_s['seconds']:.3f} ({card})")
    out["i1"] = dict(makespan_us=card_b["makespan"],
                     sequential_makespan_us=card_s["makespan"],
                     latency_us=lat, host_s=card_b["seconds"],
                     sequential_host_s=card_s["seconds"])

    # (i2) every family, batched against serve_sequential
    fams = {f: "standard" for f in PIPELINES}
    trace = serve_trace(fams, SERVE_PER_FAMILY * len(fams))
    b = serve_leg(DEVICE, fams, trace, SERVE_MAX_BATCH)
    s = serve_leg(DEVICE, fams, trace, SERVE_MAX_BATCH, sequential=True)
    c = serve_leg("cpu", fams, trace, SERVE_MAX_BATCH)
    check(same_outputs(b["outputs"], s["outputs"]),
          "(i2) batched != serve_sequential on the card")
    check(same_outputs(b["outputs"], c["outputs"]),
          "(i2) the card's outputs != the CPU port's")
    check(same_model_us([b["makespan"], b["latency"]],
                        [c["makespan"], c["latency"]]),
          "(i2) modelled times on the card != the CPU run's")
    log(f"(i2) all five families, {len(trace)} requests: batched = "
        f"serve_sequential = the CPU port, bit for bit; modelled makespan "
        f"{b['makespan']:.3f} us (sequential {s['makespan']:.3f})")
    out["i2"] = dict(makespan_us=b["makespan"],
                     sequential_makespan_us=s["makespan"])

    # (i3) the batch class at its admission cap, one burst, one batch
    trace = serve_trace({"transformer": "batch"}, SERVE_CAP,
                        burst=SERVE_CAP, spacing_us=0.0)
    tenant = {"transformer": "batch"}
    b = serve_leg(DEVICE, tenant, trace, SERVE_CAP)
    s = serve_leg(DEVICE, tenant, trace, SERVE_CAP, sequential=True)
    c = serve_leg("cpu", tenant, trace, SERVE_CAP)
    check(same_outputs(b["outputs"], s["outputs"]),
          "(i3) batched != serve_sequential on the card")
    check(same_outputs(b["outputs"], c["outputs"]),
          "(i3) the card's outputs != the CPU port's")
    check(same_model_us([b["makespan"], b["latency"]],
                        [c["makespan"], c["latency"]]),
          "(i3) modelled times on the card != the CPU run's")
    dim = PIPELINES["transformer"].state_dim
    check(SERVE_CAP * dim in plans.seen,
          f"(i3) no launch over {SERVE_CAP * dim} work-items: "
          f"{sorted(plans.seen)}")
    wide = sorted(plans.seen[SERVE_CAP * dim])
    log(f"(i3) the batch class at its cap: {SERVE_CAP} transformer "
        f"requests in one burst, max_batch {SERVE_CAP}: batched = "
        f"serve_sequential = the CPU port, bit for bit; modelled makespan "
        f"{b['makespan']:.3f} us (sequential {s['makespan']:.3f}); "
        f"host s {b['seconds']:.3f} (sequential {s['seconds']:.3f})")
    out["i3"] = dict(makespan_us=b["makespan"], host_s=b["seconds"],
                     sequential_host_s=s["seconds"],
                     plan_at_cap=wide)

    # (i4) traced: the tracer, metrics and profiles attached, on a
    # persistent cache; outputs equal the untraced run's
    shutil.rmtree(SERVE_PERSIST, ignore_errors=True)
    cache = JITCache(persist_dir=str(SERVE_PERSIST))
    tracer, store = Tracer(), ProfileStore(cache=cache)
    traced = serve_leg(DEVICE, SERVE_TENANTS,
                       serve_trace(SERVE_TENANTS, SERVE_REQUESTS),
                       SERVE_MAX_BATCH, tracer=tracer, cache=cache,
                       metrics=MetricsRegistry(), profiles=store)["outputs"]
    profiles = store.stats_dict()
    check(same_outputs(traced, card_b["outputs"]),
          "(i4) traced outputs != the untraced run's")
    cats = tracer.counts_by_cat()
    missing = [c for c in ("compile", "cache", "queue", "device", "serving")
               if not cats.get(c)]
    check(not missing, f"(i4) the trace has no {missing} spans: {cats}")
    SERVE_TRACE.parent.mkdir(parents=True, exist_ok=True)
    write_chrome_trace(tracer, str(SERVE_TRACE))
    log(f"(i4) traced serve: outputs = the untraced run's; spans by "
        f"category {cats}; {profiles['records']} replay profiles recorded; "
        f"Chrome trace {SERVE_TRACE.relative_to(ROOT)}")
    out["i4"] = dict(spans=cats, profiles=profiles)
    return out


def decode_server(sess, batch: int):
    """A transformer server whose ``batch`` requests have all joined and
    decode far longer than any reading: every step() from here is one
    decode iteration of ``batch`` states, with no join and no retirement."""
    import numpy as np
    from repro_torch.serve import InferenceServer, Request
    srv = warm(sess, lambda: InferenceServer(
        sess, {"transformer": "batch"}, max_batch=batch, iter_quantum=1))
    rng = np.random.default_rng(9)
    t0 = sess.now_us()
    for _ in range(batch):
        check(srv.submit(Request("transformer", rng.standard_normal(
            64).astype(np.float32), decode_steps=1 << 30,
            t_arrival_us=t0)), "(i) reading request rejected")
    srv.step()              # one batched prefill, then the first decode
    b = srv.batch("transformer")
    check(len(b.members) == batch, f"(i) {len(b.members)} of {batch} joined")
    return srv, b


def residency_window(srv, trace_path: Path):
    """Profile SERVE_WINDOW decode iterations (:func:`profile_window`): →
    (the device-to-host copies in the trace, kernels, host ms, device ms
    in which kernels ran, the kernels with the most time as (name, ms))."""
    wall_ms, busy_ms, n_kernels, top = profile_window(
        lambda i: srv.step(), SERVE_WINDOW, trace_path)
    events = json.loads(trace_path.read_text()).get("traceEvents", [])
    d2h = [e["name"] for e in events if "dur" in e and any(
        s in e.get("name", "") for s in ("DtoH", "Device -> Host",
                                          "Device -> Pageable"))]
    return d2h, n_kernels, wall_ms, busy_ms or 0.0, top


def serving_readings(card: str):
    """Where a served token's time goes, at max_batch 8 and 256: host us
    per decode iteration and per token, each layer of one iteration alone
    (with the server's per-request bookkeeping: the split into views and
    the retirement scan), device ms per iteration, launches per iteration,
    the tracer's cost, a profiled window with no device-to-host copy, and
    image loads per resize."""
    import torch
    from repro_torch.kernels.overlay_exec import kernel, ops
    from repro_torch.obs import Tracer
    from repro_torch.serve import server

    out = {}
    for batch in (SERVE_MAX_BATCH, SERVE_CAP):
        with serving_session(DEVICE) as sess:
            srv, b = decode_server(sess, batch)
            model = b.model
            gx = model.decode_exec
            check(gx.n_partitions == 1, f"(i) decode graph in "
                  f"{gx.n_partitions} partitions")

            def drain():
                for q in sess._queues.values():
                    q.drain()

            # launches per iteration
            before = kernel.overlay_execute.launches
            srv.step()
            launches = kernel.overlay_execute.launches - before
            check(launches == gx.n_partitions,
                  f"(i) {launches} launches per iteration")
            # residency: no device-to-host copy in a window of iterations
            d2h, n_kernels, win_ms, win_busy, top = residency_window(
                srv, OUT / f"serve_decode_b{batch}.json")
            check(not d2h, f"(i) device-to-host copies while decoding: "
                  f"{d2h[:4]}")
            # each layer called alone, in turns (three rounds)
            deps = (b.last_event,)
            x = torch.cat(b.states)
            sizes = [s.numel() for s in b.states]
            fut = gx.futures[0]
            prog = fut.result()
            (_, image), = prog._images.values()
            x2 = x.reshape(1, -1)
            calls = {
                "InferenceServer.step": srv.step,
                "InferenceServer._step_model": lambda: srv._step_model(b),
                "_launch_batched": lambda: srv._launch_batched(
                    gx, b.states, deps),
                "Session.launch": lambda: sess.launch(gx, x, wait_for=deps),
                "Session.enqueue": lambda: sess.enqueue(fut, x,
                                                        wait_for=deps),
                "overlay_execute": lambda: kernel.overlay_execute(image, x2),
                "torch.cat": lambda: torch.cat(b.states),
                "_split (torch.split views)": lambda: server._split(x, sizes),
                "ModelBatch.retire_finished": b.retire_finished,
            }
            with srv._lock:
                rounds = [{k: host_us(c, drain, SERVE_REPS)
                           for k, c in calls.items()} for _ in range(3)]
            layers = {k: statistics.median(r[k] for r in rounds)
                      for k in calls}
            # the tracer on against off, in turns (three rounds of off,
            # on, on, off)
            turns = []
            for on in (False, True, True, False) * 3:
                sess.tracer = Tracer() if on else None
                turns.append((on, host_us(srv.step, drain, SERVE_REPS)))
            sess.tracer = None
            off = statistics.median(t for on, t in turns if not on)
            on_ = statistics.median(t for on, t in turns if on)
            it_us = layers["InferenceServer.step"]
            # before each timed iteration the card sleeps four times the
            # slowest host reading of an iteration so far (at about 2
            # cycles a ns; the host clock drifts within a run), so the
            # window holds the iteration's device time and not its enqueue
            slowest = max([it_us] + [us for _, us in turns])
            dev_ms = cuda_ms(srv.step, reps=SERVE_REPS, before=hide_host(
                cycles=max(HIDE_HOST_CYCLES, int(8000 * slowest))))[0]
            drain()
            out[batch] = dict(
                work_items=x.numel(), launches_per_iteration=launches,
                host_us_per_iteration=it_us,
                host_us_per_token=it_us / batch, layers_host_us=layers,
                device_ms_per_iteration=dev_ms,
                device_busy_ms_per_iteration=win_busy / SERVE_WINDOW,
                tracer_host_us=dict(off=off, on=on_, turns=turns),
                window=dict(iterations=SERVE_WINDOW, host_ms=win_ms,
                            device_busy_ms=win_busy, kernels=n_kernels,
                            d2h_copies=len(d2h),
                            kernel_ms_per_iteration={
                                k: ms / SERVE_WINDOW for k, ms in top}))
            log(f"(i) max_batch {batch} ({x.numel()} work-items a decode "
                f"launch): {it_us:.1f} us host per iteration, "
                f"{it_us / batch:.3f} us per served token; device "
                f"{dev_ms:.4f} ms per iteration (CUDA events, the host's "
                f"enqueue hidden); {launches} executor launch per "
                f"iteration; {card}")
            log(f"(i) max_batch {batch}, host us of each layer called alone"
                f" (median of 3 rounds of {SERVE_REPS}): " + ", ".join(
                    f"{k} {us:.1f}" for k, us in layers.items()))
            log(f"(i) max_batch {batch}, tracer off/on: {off:.1f} / "
                f"{on_:.1f} us host per iteration (medians; in turns off, "
                f"on, on, off, three times: " + ", ".join(
                    f"{t:.1f}" for _, t in turns) + ")")
            log(f"(i) max_batch {batch}, profiled window of {SERVE_WINDOW} "
                f"decode iterations: no device-to-host copy; {n_kernels} "
                f"kernels, device busy {win_busy:.4f} of {win_ms:.3f} ms "
                f"({win_busy / SERVE_WINDOW:.4f} ms an iteration; idle "
                f"{1 - win_busy / win_ms:.3f}; profiler on); ms an "
                f"iteration by kernel: " + "; ".join(
                    f"{k} {ms / SERVE_WINDOW:.4f}" for k, ms in top))
            if batch == SERVE_MAX_BATCH:
                # image loads per resize: the old Programs release with
                # their images, the new ones load at their first launch
                loads = ops.image_loads
                warm(sess, lambda: model.resize(model.max_replicas + 2))
                probe = torch.zeros(64, device=DEVICE)
                sess.launch(model.prefill_exec, probe)
                sess.launch(model.decode_exec, probe)
                n = ops.image_loads - loads
                want = (model.prefill_exec.n_partitions
                        + model.decode_exec.n_partitions)
                check(n == want, f"(i) {n} image loads after a resize, "
                      f"want {want}")
                out["image_loads_per_resize"] = n
                log(f"(i) resize to {model.max_replicas} replicas: {n} "
                    f"image loads (one per partition of the two graphs)")
            srv.close()
        torch.cuda.empty_cache()
    return out


def phase_serving(card: str):
    """(i) continuous-batching serving on the card: the JAX package's
    serving benchmark trace, every family, the batch class at its cap and
    a traced run, on states that stay on the card; then the readings."""
    import torch
    from repro_torch.kernels.overlay_exec import kernel

    t0 = time.perf_counter()
    builds = kernel.LIBRARY.builds
    # ---- the main path: counts set to 0 just before, read just after
    kernel.overlay_execute.launches = 0
    with PlanLog() as plans:
        checks = serving_checks(card, plans)
    launches = kernel.overlay_execute.launches
    # ----
    by_plan = {}
    for n, ps in plans.seen.items():
        for p in ps:
            by_plan.setdefault(p, []).append(n)
    log("(i) executor launches by (work-items a thread, block): " + "; ".join(
        f"{p}: {len(ns)} sizes of N, {min(ns)}-{max(ns)}"
        for p, ns in sorted(by_plan.items())))
    checks["plans"] = {f"{p[0]}x{p[1]}": sorted(ns)
                       for p, ns in by_plan.items()}
    check(launches > 0, "(i) serving never launched the executor")
    check(kernel.LIBRARY.builds == builds == 1,
          f"(i) the executor was built {kernel.LIBRARY.builds} times")
    readings = serving_readings(card)
    torch.cuda.empty_cache()
    log(f"(i) serving: {launches} executor launches, "
        f"{time.perf_counter() - t0:.1f} s")
    return launches, dict(checks, readings=readings)


# ---------------------------- (j) the verifier and the paper's benchmarks
VERIFY_LEVELS = ("off", "fused", "full")
N_VERIFY = 1 << 24
# the lock annotations of the port's lint targets: every one of the JAX
# package's, plus the port's resident image lock (core/runtime.py)
LOCK_ATTRS = 72


def verified_builds(card: str, bufs, refs):
    """(j1) the six paper kernels on both overlays at each verify level:
    zero findings, the same bitstream and program at every level, the
    verify stage's host ms; then each "full" artifact through a Session at
    N_VERIFY work-items against run_reference."""
    from repro_torch.analysis import verify_artifact
    from repro_torch.configs.paper_suite import BENCHMARKS
    from repro_torch.core.jit import jit_compile
    from repro_torch.core.options import CompileOptions
    from repro_torch.core.overlay import OverlaySpec
    from repro_torch.core.runtime import Device
    from repro_torch.core.session import Session

    verify_ms = {}
    for w, h, d in SPECS:
        spec = OverlaySpec(w, h, d)
        for name, (src, _, _) in BENCHMARKS.items():
            cks = {lvl: jit_compile(src, spec, opts=CompileOptions(
                verify_level=lvl)) for lvl in VERIFY_LEVELS}
            off = cks["off"]
            for lvl, ck in cks.items():
                what = f"(j1) {name} {w}x{h} verify_level={lvl}"
                check(verify_artifact(ck) == [], f"{what}: findings")
                check(ck.bitstream.data == off.bitstream.data and
                      ck.program.content_hash() == off.program.content_hash(),
                      f"{what}: the artifact differs from the unverified one")
                check(("verify" in ck.stage_times_ms) == (lvl != "off"),
                      f"{what}: verify stage booked "
                      f"{sorted(ck.stage_times_ms)}")
            verify_ms[f"{name} {w}x{h}"] = dict(
                fused=cks["fused"].stage_times_ms["verify"],
                full=cks["full"].stage_times_ms["verify"],
                compile_off=off.compile_time_ms)
        with Session([Device("ovl0", spec)]) as sess:
            for name, (src, _, _) in BENCHMARKS.items():
                prog = sess.build(src, CompileOptions(verify_level="full"))
                n_in = len(prog.compiled.dfg.inputs)
                ev = sess.enqueue(prog, *bufs[:n_in])
                check_resident(ev.outputs[0], refs(prog.compiled, n_in),
                               f"(j1) {name} {w}x{h} full, Session")
                prog.release()
    for key, ms in verify_ms.items():
        log(f"(j1) {key:15s} verify fused {ms['fused']:.3f} ms, full "
            f"{ms['full']:.3f} ms host (unverified compile "
            f"{ms['compile_off']:.1f} ms); {card}")
    full = [ms["full"] for ms in verify_ms.values()]
    log(f"(j1) {len(verify_ms)} kernel x overlay cells at "
        f"{len(VERIFY_LEVELS)} levels: zero findings, one artifact per cell "
        f"at every level, \"full\" runs through a Session bit-exact at "
        f"N={N_VERIFY}; full re-proof {min(full):.3f}-{max(full):.3f} ms")
    return verify_ms


def verified_quarantine(bufs, refs):
    """(j2) a "full" cache hit corrupted in memory is quarantined and
    rebuilt; the rebuilt artifact launches bit-exact on an image of its
    own."""
    from repro_torch.analysis import verify_artifact
    from repro_torch.configs.paper_suite import BENCHMARKS
    from repro_torch.core.options import CompileOptions
    from repro_torch.core.overlay import OverlaySpec
    from repro_torch.core.runtime import Device
    from repro_torch.core.session import Session

    opts = CompileOptions(max_replicas=4, verify_level="full")
    src = BENCHMARKS["poly1"][0]
    with Session([Device("ovl0", OverlaySpec(*SPECS[0]))]) as sess:
        first = sess.build(src, opts)
        sess.enqueue(first, bufs[0]).wait()
        bad = first.compiled
        bad.routing.nets[0].path.insert(1, (99, 99))
        first.release()
        prog = sess.build(src, opts)
        stats = sess.cache.stats.as_dict()
        check(stats["verify_quarantined"] == 1 and prog.compiled is not bad,
              f"(j2) the corrupted hit was not quarantined: {stats}")
        check(verify_artifact(prog.compiled) == [],
              "(j2) the rebuilt artifact has findings")
        ev = sess.enqueue(prog, bufs[0])
        check_resident(ev.outputs[0], refs(prog.compiled, 1),
                       "(j2) rebuilt poly1")
        (img_ck, _), = prog._images.values()
        check(img_ck is prog.compiled,
              "(j2) the resident image is not the rebuilt artifact's")
    log(f"(j2) a corrupted \"full\" hit: quarantined "
        f"{stats['verify_quarantined']}, rebuilt (misses {stats['misses']}, "
        f"hits {stats['hits']}), launched bit-exact at N={N_VERIFY} on an "
        f"image keyed on the new artifact")
    return stats


def verified_graph(xs):
    """(j3) phase (h3)'s pipeline with every node asking for "fused": it
    instantiates and launches bit-exact against the nodewise replay; a
    planted alias raises before any build is submitted or launch made."""
    import copy
    from repro_torch.analysis import VerificationError
    from repro_torch.core.options import CompileOptions
    from repro_torch.core.overlay import OverlaySpec
    from repro_torch.core.runtime import Device
    from repro_torch.core.session import Session
    from repro_torch.kernels.overlay_exec import kernel

    opts = CompileOptions(max_replicas=4, verify_level="fused")
    with Session([Device("ovl0", OverlaySpec(*SPECS[0]))]) as sess:
        g = record_pipeline(sess, opts)
        gx = sess.instantiate(g).result()
        for x in xs:
            fused = sess.launch(gx, x).outputs[0]
            node = sess.launch_nodewise(g, x).outputs[0]
            check(same_bits(fused.data, node.data),
                  "(j3) verified graph: fused != nodewise")
        bad = copy.deepcopy(sess.graph_plan(g))
        bad[0].ext = bad[0].ext * 2               # one buffer, two slots
        submitted, launches = [], kernel.overlay_execute.launches
        build = sess.compile
        sess.compile = lambda *a, **kw: submitted.append(a) or build(*a, **kw)
        try:
            sess.instantiate(g, plan=bad)
            codes = None
        except VerificationError as e:
            codes = sorted({d.code for d in e.diagnostics})
        check(codes is not None and "A108" in codes,
              f"(j3) a planted alias was not refused: {codes}")
        check(not submitted and kernel.overlay_execute.launches == launches,
              f"(j3) the refused plan submitted {len(submitted)} builds")
    log(f"(j3) verifying graph: {gx.n_partitions} partition(s), fused = "
        f"nodewise bit-exact on {len(xs)} requests; planted alias refused "
        f"with {codes} before any build or launch")
    return codes


def verified_cli():
    """(j4) the analysis CLI's sweep and the lock lint."""
    import ast
    from repro_torch.analysis.cli import main as analysis_main
    from repro_torch.analysis.locklint import (DEFAULT_TARGETS,
                                               _scan_declarations,
                                               lint_files)
    t0 = time.perf_counter()
    rc = analysis_main(["--verify"])
    cli_s = time.perf_counter() - t0
    check(rc == 0, f"(j4) python -m repro_torch.analysis --verify: {rc}")
    diags = lint_files(DEFAULT_TARGETS, root=str(ROOT))
    check(diags == [], f"(j4) lock lint: {[str(d) for d in diags]}")
    attrs = 0
    for rel in DEFAULT_TARGETS:
        text = (ROOT / rel).read_text()
        attrs += len(_scan_declarations(rel, ast.parse(text),
                                        text.splitlines()).attrs)
    check(attrs >= LOCK_ATTRS, f"(j4) only {attrs} lock-annotated "
          f"attributes")
    log(f"(j4) analysis CLI --verify: exit {rc} in {cli_s:.1f} s; lock "
        f"lint clean over {len(DEFAULT_TARGETS)} files, {attrs} annotated "
        f"attributes")
    return dict(cli_exit=rc, cli_s=cli_s, lock_attrs=attrs)


def load_benchmark(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def verified_benchmarks():
    """(j5) the paper's graph replay and reconfiguration benchmarks (no
    executor rebuild: a cold nvcc build would eat the time limit)."""
    out = {}
    for name in ("torch_graph_replay_perf", "torch_reconfig_time"):
        bench = load_benchmark(name)
        res = out[name] = bench.run(DEVICE)
        log(f"(j5) benchmarks/{name}.py:")
        bench.report(res)
        check(res["gate_failures"] == [],
              f"(j5) {name} gates: {res['gate_failures']}")
    return out


def phase_verified(card: str):
    """(j) the static verifier on the card's main path, the analysis CLI
    and the paper's reconfiguration and graph replay benchmarks."""
    import numpy as np
    import torch
    from repro_torch.core.runtime import Buffer
    from repro_torch.kernels.overlay_exec import kernel

    t0 = time.perf_counter()
    rng = np.random.default_rng(9)
    pool = [rng.uniform(-1, 1, N_VERIFY).astype(np.float32)
            for _ in range(4)]
    refs = Refs(pool)
    bufs = [Buffer(x) for x in pool]
    requests = [Buffer(rng.uniform(0, 2, N_VERIFY).astype(np.float32))
                for _ in range(2)]
    builds = kernel.LIBRARY.builds
    # ---- the main path: counts set to 0 just before, read just after
    kernel.overlay_execute.launches = 0
    out = dict(verify_ms=verified_builds(card, bufs, refs),
               quarantine=verified_quarantine(bufs, refs),
               refused_alias=verified_graph(requests),
               analysis=verified_cli(),
               benchmarks=verified_benchmarks())
    launches = kernel.overlay_execute.launches
    # ----
    check(launches > 0, "(j) the verified path never launched the executor")
    check(kernel.LIBRARY.builds == builds == 1,
          f"(j) the executor was built {kernel.LIBRARY.builds} times")
    del bufs, requests
    torch.cuda.empty_cache()
    log(f"(j) verifier and paper benchmarks: {launches} executor launches, "
        f"{time.perf_counter() - t0:.1f} s")
    return launches, out


def close_enough(got, want, tol: float, rtol: float = None):
    """→ (within ``tol`` as torch.testing.assert_close counts it, with
    atol = tol and rtol = ``rtol`` or tol; the max abs error), compared in
    float32."""
    import torch
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    rtol = tol if rtol is None else rtol
    ok = bool(torch.isfinite(g).all()) and bool(
        (diff <= tol + rtol * w.abs()).all())
    return ok, float(diff.max()) if diff.numel() else 0.0


def tol_of(table, dtype) -> float:
    return table[str(dtype).removeprefix("torch.")]


def randn(gen, shape, dtype):
    import torch
    return torch.randn(shape, generator=gen, device=DEVICE,
                       dtype=torch.float32).to(dtype)


def phase_rmsnorm():
    """(e) the RMSNorm kernel against its plain version on the card."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.rmsnorm import kernel, ref

    bf, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    d, hd, hq, hkv = QWEN["d"], QWEN["hd"], QWEN["hq"], QWEN["hkv"]
    b, s, n_layers = PREFILL_B, PREFILL_S, QWEN["layers"]
    # the shapes of one prefill step, with their calls per step
    main_cases = [
        ("ln1/ln2 (B*S, 5120)", randn(gen, (b * s, d), bf), 2 * n_layers),
        ("q_norm, heads view (B, 40, S, 128)",
         randn(gen, (b, s, hq, hd), bf).transpose(1, 2), n_layers),
        ("k_norm, heads view (B, 8, S, 128)",
         randn(gen, (b, s, hkv, hd), bf).transpose(1, 2), n_layers),
        ("final (B, 1, 5120)", randn(gen, (b, 1, d), bf), 1),
    ]
    # phase (k)'s shapes, with their calls per prefill step of each model
    moe, ssm = get_arch(MOE_ARCH), get_arch(MAMBA_ARCH)
    moe_heads = (moe.n_heads, moe.n_kv_heads)
    family_cases = [
        (f"{moe.arch_id} ln1/ln2 (B*S, {moe.d_model})",
         randn(gen, (b * s, moe.d_model), bf), 2 * MOE_LAYERS, "moe"),
        (f"{moe.arch_id} q_norm, heads view (B, {moe_heads[0]}, S, "
         f"{moe.hd})", randn(gen, (b, s, moe_heads[0], moe.hd),
                             bf).transpose(1, 2), MOE_LAYERS, "moe"),
        (f"{moe.arch_id} k_norm, heads view (B, {moe_heads[1]}, S, "
         f"{moe.hd})", randn(gen, (b, s, moe_heads[1], moe.hd),
                             bf).transpose(1, 2), MOE_LAYERS, "moe"),
        (f"{ssm.arch_id} ln (B*S, {ssm.d_model})",
         randn(gen, (b * s, ssm.d_model), bf), ssm.n_layers, "ssm"),
        (f"{ssm.arch_id} gated norm (B*S, {ssm.ssm_expand * ssm.d_model})",
         randn(gen, (b * s, ssm.ssm_expand * ssm.d_model), bf),
         ssm.n_layers, "ssm"),
    ]
    other_cases = [
        ("decode ln (4, 1, 5120)", randn(gen, (4, 1, d), bf)),
        ("decode q_norm view (4, 40, 1, 128)",
         randn(gen, (4, 1, hq, hd), bf).transpose(1, 2)),
        ("ragged rows (1001, 5120) f32", randn(gen, (1001, d), f32)),
        ("ragged rows (37, 128) bf16", randn(gen, (37, hd), bf)),
        ("width of 25 vectors (3, 100) f32", randn(gen, (3, 100), f32)),
        ("unaligned width, scalar path (3, 102) f32",
         randn(gen, (3, 102), f32)),
        ("unaligned width, scalar path (3, 100) bf16",
         randn(gen, (3, 100), bf)),
    ] + [(f"{shape} {str(dt)[6:]}", randn(gen, shape, dt))
         for shape in ((4, 64), (2, 3, 128), (1, 257, 512))
         for dt in (f32, bf)]
    errs = {f32: 0.0, bf: 0.0}

    def zeros():
        return dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                    byte_ms=0.0, op_ms=0.0)
    totals = zeros()
    by_model = {"moe": zeros(), "ssm": zeros()}
    shares = {}
    scratch = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    evict_l2 = hide_host(evict=scratch)
    for name, x, *per_step in main_cases + family_cases + other_cases:
        w = (randn(gen, (x.shape[-1],), f32) * 0.1 + 1.0).to(x.dtype)
        got = kernel.rmsnorm(x, w)
        want = ref.rmsnorm(x, w)
        torch.cuda.synchronize()
        ok, err = close_enough(got, want, tol_of(RMS_TOL, x.dtype))
        log(f"(e) {name}: max abs err {err:.3g} "
            f"(tolerance {tol_of(RMS_TOL, x.dtype):g})")
        check(ok and got.shape == x.shape,
              f"RMSNorm kernel != plain at {name}: max abs err {err}")
        errs[x.dtype] = max(errs[x.dtype], err)
        if not per_step:
            continue
        n = per_step[0]
        into = by_model[per_step[1]] if len(per_step) > 1 else totals
        k_ms = cuda_ms(lambda: kernel.rmsnorm(x, w), before=evict_l2)[0]
        p_ms = cuda_ms(lambda: ref.rmsnorm(x, w), reps=3,
                       before=evict_l2)[0]
        l_ms = cuda_ms(lambda: F.rms_norm(x, (x.shape[-1],), w, 1e-6),
                       before=evict_l2)[0]
        n_el = x.numel()
        byte_ms = (2 * n_el + x.shape[-1]) * x.element_size() \
            / MEM_BYTES_PER_S * 1e3
        op_ms = 4 * n_el / F32_OPS_PER_S * 1e3     # x*x, sum, two products
        shares[name] = byte_ms / k_ms
        log(f"(e) {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"torch rms_norm {l_ms:.4f} ms, byte bound {byte_ms:.4f} ms, "
            f"share of the bound {shares[name]:.3f} (L2 evicted and the "
            f"host's enqueue hidden before each timed launch); {n} calls per "
            f"prefill step")
        for key, val in (("ms", k_ms), ("plain_ms", p_ms),
                         ("library_ms", l_ms), ("byte_ms", byte_ms),
                         ("op_ms", op_ms),
                         ("bound_ms", max(byte_ms, op_ms))):
            into[key] += n * val
    del main_cases, family_cases, other_cases, scratch
    for label, t in (("qwen3-14b (161 calls)", totals),
                     (f"{moe.arch_id} at {MOE_LAYERS} layers "
                      f"({4 * MOE_LAYERS} calls; the final norm untimed)",
                      by_model["moe"]),
                     (f"{ssm.arch_id} ({2 * ssm.n_layers} calls; the final "
                      f"norm untimed)", by_model["ssm"])):
        log(f"(e) per prefill step of {label}: kernel {t['ms']:.3f} ms, "
            f"plain {t['plain_ms']:.3f} ms, torch rms_norm "
            f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms "
            f"(share {t['bound_ms'] / t['ms']:.3f})")
    totals["shares"] = shares
    totals["per_prefill_step_of"] = by_model
    return totals, errs


def attention_bound_ms(b, hq, sq, skv, d, causal, window, itemsize,
                       hkv=QWEN["hkv"]):
    """→ (ms to move q, k, v and out once, ms for 4*D operations per
    visible (query, key) pair at the bfloat16 tensor-core rate)."""
    import numpy as np
    q_pos = np.arange(sq)[:, None] + (skv - sq)
    k_pos = np.arange(skv)[None, :]
    mask = np.ones((sq, skv), bool)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    pairs = int(mask.sum()) * b * hq
    n_bytes = (2 * b * hq * sq * d + 2 * b * hkv * skv * d) * itemsize
    return (n_bytes / MEM_BYTES_PER_S * 1e3,
            4 * d * pairs / BF16_OPS_PER_S * 1e3)


def fa_bf16_limit(q, k, v, want, causal=True, window=None):
    """FA_BF16_LIMIT for the bfloat16 tensor-core route against the plain
    version ``want``, elementwise."""
    from repro_torch.kernels.flash_attention import ref
    a, r, rv = FA_BF16_LIMIT
    w_abs = ref.attention(q, k, v.abs(), causal=causal, window=window)
    return a + r * want.float().abs() + rv * w_abs.float()


def limit_share(got, want, limit) -> float:
    """The largest |got - want| / limit; inf where got is not finite."""
    import torch
    g = got.float()
    if not bool(torch.isfinite(g).all()):
        return float("inf")
    return float(((g - want.float()).abs() / limit).max())


def phase_flash_attention():
    """(f) the flash-attention kernels against their plain version on the
    card, then the tensor-core kernel timed at the prefill shape beside the
    SIMT kernel and scaled_dot_product_attention."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention import kernel, ref

    gen = torch.Generator(device=DEVICE).manual_seed(4)
    errs, shares = {}, {}
    by_route = kernel.flash_attention.launches_by_route
    for dt in (torch.float32, torch.bfloat16):
        routes = set()
        for case in FA_CASES:
            b, hq, hkv, sq, skv, d, causal, window = case
            q = randn(gen, (b, hq, sq, d), dt)
            k = randn(gen, (b, hkv, skv, d), dt)
            v = randn(gen, (b, hkv, skv, d), dt)
            route = kernel.route(dt, d)
            before = by_route[route]
            got = kernel.flash_attention(q, k, v, causal=causal,
                                         window=window)
            want = ref.attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            check(by_route[route] == before + 1,
                  f"flash attention at {case} {dt} did not take the "
                  f"{route} route")
            routes.add(route)
            if route == "wgmma":
                limit = fa_bf16_limit(q, k, v, want, causal, window)
            else:
                limit = FA_TOL_F32 + FA_TOL_F32 * want.float().abs()
            share = limit_share(got, want, limit)
            err = float((got.float() - want.float()).abs().max())
            check(share <= 1.0, f"flash attention != plain at {case} {dt}: "
                                f"max abs err {err}, share of the limit "
                                f"{share}")
            errs[dt] = max(errs.get(dt, 0.0), err)
            shares[dt] = max(shares.get(dt, 0.0), share)
        check(routes == ({"wgmma"} if dt == torch.bfloat16 else {"simt"}),
              f"{dt} cases took the routes {routes}")
        limit = ("1e-4 + 2^-7 |plain| + 2^-7 plain(|v|)"
                 if dt == torch.bfloat16 else
                 f"{FA_TOL_F32:g} + {FA_TOL_F32:g} |plain|")
        log(f"(f) {len(FA_CASES)} cases in {str(dt)[6:]} on the "
            f"{routes.pop()} route (GQA groups 1/4/5/6/8/16, causal and not, "
            f"windows 32/64/128/256, Sq < Skv, Sq > Skv, ragged, D 64/128): max "
            f"abs err {errs[dt]:.3g}, largest share of the limit {limit} "
            f"{shares[dt]:.3g}")

    b, s = PREFILL_B, PREFILL_S
    hq, hkv, d = QWEN["hq"], QWEN["hkv"], QWEN["hd"]

    def heads(h, dt):
        """The path's heads view (B, H, S, D) of a (B, S, H*D) projection."""
        return randn(gen, (b, s, h * d), dt).view(b, s, h, d).transpose(1, 2)
    # float32 then bfloat16, at the prefill shape, through the heads views
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = heads(hq, dt), heads(hkv, dt), heads(hkv, dt)
        route = kernel.route(dt, d)
        before = by_route[route]
        got = kernel.flash_attention(q, k, v)
        check(by_route[route] == before + 1,
              f"the prefill shape in {dt} did not take the {route} route")
        err = share = 0.0
        for i in range(b):        # the plain version one sequence at a time
            one = slice(i, i + 1)
            want = ref.attention(q[one], k[one], v[one])
            if route == "wgmma":
                limit = fa_bf16_limit(q[one], k[one], v[one], want)
            else:
                limit = FA_TOL_F32 + FA_TOL_F32 * want.float().abs()
            sh = limit_share(got[one], want, limit)
            e = float((got[one].float() - want.float()).abs().max())
            check(sh <= 1.0, f"flash attention != plain at the prefill "
                             f"shape, {dt}, sequence {i}: max abs err {e}, "
                             f"share of the limit {sh}")
            err, share = max(err, e), max(share, sh)
        del want, limit
        log(f"(f) prefill shape q ({b},{hq},{s},{d}) {str(dt)[6:]} causal, "
            f"q/k/v as heads views of (B, S, H*D), {route} route: max abs "
            f"err {err:.3g}, largest share of the limit {share:.3g}; output "
            f"std {float(got.float().std()):.3g}")
        if dt == torch.float32:
            errs[dt] = max(errs[dt], err)
        else:
            errs["prefill"] = err
            shares["prefill"] = share

    # in turns: the tensor-core kernel, the SIMT kernel, SDPA, twice
    times = {"wgmma": [], "simt": [], "sdpa": []}
    runs = {
        "wgmma": lambda: kernel.flash_attention(q, k, v),
        "simt": lambda: kernel._launch(q, k, v, route="simt"),
        "sdpa": lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True),
    }
    for turn in range(2):
        for name, fn in runs.items():
            med, lo, hi = cuda_ms(fn, reps=FA_REPS, warm=2)
            times[name].append(med)
            log(f"(f) turn {turn}: {name} {med:.4f} ms (median of "
                f"{FA_REPS}, {lo:.4f}-{hi:.4f})")
    k_ms, simt_ms, l_ms = (statistics.mean(times[n])
                           for n in ("wgmma", "simt", "sdpa"))

    def plain():
        for i in range(b):
            ref.attention(q[i:i + 1], k[i:i + 1], v[i:i + 1])
    p_ms = cuda_ms(plain, reps=3, warm=1)[0]
    byte_ms, op_ms = attention_bound_ms(b, hq, s, s, d, True, None, 2)
    b_ms = max(byte_ms, op_ms)
    flop = 4 * d * (s * (s + 1) // 2) * b * hq
    log(f"(f) prefill shape q ({b},{hq},{s},{d}) bf16 causal, mean of the "
        f"two turns' medians: tensor-core kernel {k_ms:.4f} ms "
        f"({flop / k_ms / 1e9:.1f} TFLOP/s, share of the bound "
        f"{b_ms / k_ms:.3f}, {k_ms / l_ms:.3f} x SDPA); SIMT kernel "
        f"{simt_ms:.3f} ms ({flop / simt_ms / 1e9:.1f} TFLOP/s); "
        f"scaled_dot_product_attention {l_ms:.4f} ms "
        f"({flop / l_ms / 1e9:.1f} TFLOP/s); plain {p_ms:.3f} ms ({b} calls "
        f"at B=1); bound {b_ms:.4f} ms (operations; bytes {byte_ms:.4f} ms)")
    del q, k, v, got

    # phase (k)'s qwen3-moe prefill shape, GQA group 16: held against the
    # plain version on one sequence, then timed in turns with SDPA
    moe = get_arch(MOE_ARCH)
    hq, hkv = moe.n_heads, moe.n_kv_heads
    q, k, v = (heads(h, torch.bfloat16) for h in (hq, hkv, hkv))
    got = kernel.flash_attention(q, k, v)
    want = ref.attention(q[:1], k[:1], v[:1])
    share = limit_share(got[:1], want, fa_bf16_limit(q[:1], k[:1], v[:1],
                                                     want))
    check(share <= 1.0, f"flash attention != plain at q ({b},{hq},{s},{d}): "
                        f"share of the limit {share}")
    del want
    moe_times = {"wgmma": [], "sdpa": []}
    for turn in range(2):
        moe_times["wgmma"].append(cuda_ms(
            lambda: kernel.flash_attention(q, k, v), reps=FA_REPS)[0])
        moe_times["sdpa"].append(cuda_ms(
            lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), reps=FA_REPS)[0])
    mk_ms, ml_ms = (statistics.mean(moe_times[n]) for n in ("wgmma", "sdpa"))
    m_bound = max(attention_bound_ms(b, hq, s, s, d, True, None, 2, hkv))
    log(f"(f) {moe.arch_id}'s prefill shape q ({b},{hq},{s},{d}), k/v "
        f"({b},{hkv},{s},{d}) bf16 causal (group {hq // hkv}): largest "
        f"share of the limit on sequence 0 {share:.3g}; tensor-core kernel "
        f"{mk_ms:.4f} ms (turns {moe_times['wgmma']}), share of the bound "
        f"{m_bound / mk_ms:.3f}, {mk_ms / ml_ms:.3f} x SDPA "
        f"({ml_ms:.4f} ms, turns {moe_times['sdpa']}); bound {m_bound:.4f} "
        f"ms (operations)")
    del q, k, v, got
    return dict(ms=k_ms, simt_ms=simt_ms, plain_ms=p_ms, library_ms=l_ms,
                bound_ms=b_ms, ratio_to_library=k_ms / l_ms,
                bound_by="operations" if op_ms >= byte_ms else "bytes",
                ms_turns=times, moe_shape=dict(
                    ms=mk_ms, library_ms=ml_ms, bound_ms=m_bound,
                    share_of_limit=share)), errs, shares


def profile_window(fn, n: int, trace_path: Path):
    """Run ``fn(i)`` for i < n under torch.profiler and keep its Chrome
    trace at ``trace_path`` → (host ms for the window, ms in which the
    device ran kernels — the union of their intervals in the trace — the
    number of kernels, and the eight kernels with the most time as
    (name, ms)).  The device ms is None when the trace holds no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text()).get("traceEvents", [])
    kernels = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                     for e in events
                     if e.get("cat") == "kernel" and "dur" in e)
    if not kernels:
        return wall_ms, None, 0, []
    busy, end, by_name = 0.0, float("-inf"), {}
    for start, stop, name in kernels:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[name[:48]] = by_name.get(name[:48], 0.0) + stop - start
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return wall_ms, busy / 1e3, len(kernels), [(k, us / 1e3)
                                               for k, us in top]


def counts():
    """Launches per kernel, and flash attention's per route under
    "flash_attention_by_route"."""
    from repro_torch.kernels.flash_attention import kernel as fa
    out = {name: getattr(m, LAUNCHER[name]).launches
           for name, m in kernel_modules().items()}
    out["flash_attention_by_route"] = dict(
        fa.flash_attention.launches_by_route)
    return out


def reset_counts() -> None:
    from repro_torch.kernels.flash_attention import kernel as fa
    for name, m in kernel_modules().items():
        getattr(m, LAUNCHER[name]).launches = 0
    for route in fa.flash_attention.launches_by_route:
        fa.flash_attention.launches_by_route[route] = 0


def planted_faults():
    """name → a faulty attention that wraps the real dispatch (the kernel
    on the card, or the plain version when asked for): the key/value head
    map shifted by one head, or the last key/value tile of a causal
    prefill dropped for the rows that see it."""
    from repro_torch.kernels.flash_attention import kernel
    real = kernel.flash_attention

    def shifted_heads(q, k, v, **kw):
        return real(q, k.roll(-1, 1), v.roll(-1, 1), **kw)

    def last_tile_dropped(q, k, v, **kw):
        check(q.shape[2] == k.shape[2] > FAULT_KEYS,
              "the planted fault needs Sq == Skv")
        out = real(q, k, v, **kw)
        t = FAULT_KEYS                # those rows see every earlier key
        out[:, :, -t:] = real(q[:, :, -t:], k[:, :, :-t], v[:, :, :-t],
                              **{**kw, "causal": False})
        return out
    return {"GQA map shifted by one head": shifted_heads,
            f"last {FAULT_KEYS} keys dropped": last_tile_dropped}


def agreement_readings(model, params, prompt, res, one, run: str,
                       faults: bool = False):
    """The serving path's three logits comparisons for one set of weights
    → [(check, run, fault or None, max abs err)], each printed.  ``res`` is
    the serve loop's result on ``prompt``, or None to run it here.  The
    second side of each comparison runs flash attention (the kernel, or
    the plain version), so with ``faults`` each is read again with every
    planted fault patched into that side."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models.registry import build_model
    from repro_torch.train.step import make_prefill_step

    dev = one.device
    n_prompt = prompt.shape[1]
    if res is None:
        res = serve_loop(model, params, prompt, SERVE_GEN)
    p = torch.from_numpy(prompt).to(dev)
    full = torch.cat([p, res.tokens], dim=1)
    plain = build_model(model.cfg, attn_impl="ref")
    prefill = make_prefill_step(model)
    with torch.inference_mode():
        checks = {
            "decode_vs_prefill": (
                "decode vs make_prefill_step at the last prompt position",
                res.logits[n_prompt - 1],
                lambda: prefill(params, {"tokens": p})),
            "decode_vs_forward": (
                f"decode vs forward_train over the {full.shape[1]} tokens at "
                f"positions {n_prompt - 1}..{full.shape[1] - 1}",
                res.logits[n_prompt - 1:].transpose(0, 1),
                lambda: model.forward_train(params, full)[:, n_prompt - 1:]),
            "kernel_vs_plain_attention": (
                f"forward_train(last_only) B=1 S={one.shape[1]}, flash "
                f"kernel vs attn_impl='ref'",
                model.forward_train(params, one, last_only=True),
                lambda: plain.forward_train(params, one, last_only=True)),
        }
        patches = {name: (fa_ops, "attention", fn)
                   for name, fn in planted_faults().items()} if faults else {}
        return read_checks(checks, patches, run, f"(g) {run}")


def read_checks(checks, faults, run: str, prefix: str):
    """Read each check, ``key → (label, got, want_fn)``, as it is and with
    every fault, ``name → (object, attribute, stand-in)``, patched in while
    ``want_fn`` runs → [(key, run, fault or None, max abs err)], each
    printed with the logit scale and the share of positions whose top-1
    token agrees."""
    from unittest import mock
    out = []
    for key, (label, got, want_fn) in checks.items():
        for fault, patch in {None: None, **faults}.items():
            if patch is None:
                want = want_fn()
            else:
                with mock.patch.object(*patch):
                    want = want_fn()
            g, w = got.float(), want.float()
            err = float((g - w).abs().max())
            top1 = float((g.argmax(-1) == w.argmax(-1)).float().mean())
            log(f"{prefix}: {label}" + (f", fault '{fault}'" if fault else "")
                + f": max abs err {err:.4g}, logit scale (max |ref|) "
                f"{float(w.abs().max()):.3g}, same top-1 token at "
                f"{top1:.3f} of positions")
            out.append((key, run, fault, err))
            del want, g, w
    return out


def phase_model():
    """(g) the main path: qwen3-14b at full width and depth, bf16, random
    weights — a blockwise prefill step, then the serve loop — with the
    agreement checks."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models.registry import build_model
    from repro_torch.train.step import make_prefill_step, make_serve_step

    dev = torch.device(DEVICE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch("qwen3-14b")
    check(cfg.dtype == torch.bfloat16 and cfg.n_layers == QWEN["layers"],
          "qwen3-14b config changed")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    def leaves(node):
        for val in node.values():
            yield from leaves(val) if isinstance(val, dict) else (val,)
    n_params = sum(t.numel() for t in leaves(params))
    w_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    embed_bytes = params["lm"]["embed"].numel() * 2
    log(f"(g) qwen3-14b: {cfg.n_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.hd}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_padded}: {n_params / 1e9:.3f} B parameters, "
        f"{w_bytes / 1e9:.2f} GB bf16, drawn in {init_s:.1f} s")

    rng = np.random.default_rng(0)
    b, s = PREFILL_B, PREFILL_S
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab, (b, s)).astype(np.int64)).to(dev)
    prompt = rng.integers(0, cfg.vocab, (SERVE_B, SERVE_PROMPT)
                          ).astype(np.int64)
    prefill_step = make_prefill_step(model)

    # ---- the main path: counts set to 0 just before, read just after
    reset_counts()
    logits = prefill_step(params, {"tokens": tokens})
    torch.cuda.synchronize()
    per_prefill = counts()
    res = serve_loop(model, params, prompt, SERVE_GEN)
    launches = counts()
    # ----
    n_steps = SERVE_PROMPT + SERVE_GEN
    serve_counts = {k: launches[k] - per_prefill[k] for k in LAUNCHER}
    log(f"(g) launches in one prefill step: {per_prefill}; in the serve "
        f"loop ({n_steps} decode steps): {serve_counts}")
    check(per_prefill["flash_attention"] == cfg.n_layers,
          f"prefill launched flash attention "
          f"{per_prefill['flash_attention']} times, not {cfg.n_layers}")
    check(per_prefill["flash_attention_by_route"]
          == {"wgmma": cfg.n_layers, "simt": 0},
          f"prefill's flash-attention routes: "
          f"{per_prefill['flash_attention_by_route']}, not {cfg.n_layers} "
          f"on the tensor-core route")
    n_norm = 4 * cfg.n_layers + 1
    check(per_prefill["rmsnorm"] == n_norm,
          f"prefill launched RMSNorm {per_prefill['rmsnorm']} times, "
          f"not {n_norm}")
    check(serve_counts["rmsnorm"] == n_norm * n_steps,
          f"serve loop launched RMSNorm {serve_counts['rmsnorm']} times")
    check(tuple(logits.shape) == (b, cfg.vocab_padded)
          and logits.dtype == torch.bfloat16
          and bool(torch.isfinite(logits).all()),
          f"prefill logits {tuple(logits.shape)} {logits.dtype}")
    check(tuple(res.logits.shape) == (n_steps, SERVE_B, cfg.vocab_padded)
          and bool(torch.isfinite(res.logits).all())
          and tuple(res.tokens.shape) == (SERVE_B, SERVE_GEN)
          and int(res.tokens.min()) >= 0
          and int(res.tokens.max()) < cfg.vocab_padded,
          "serve loop gave bad logits or tokens")

    pre_ms, pre_lo, pre_hi = cuda_ms(
        lambda: prefill_step(params, {"tokens": tokens}), reps=3, warm=1)
    decode_ms = res.decode_s / SERVE_GEN * 1e3
    # a decode step reads every weight but the embedding table, and the
    # KV cache once
    cache_bytes = 2 * cfg.n_layers * SERVE_B * cfg.n_kv_heads * n_steps \
        * cfg.hd * 2
    read_ms = (w_bytes - embed_bytes + cache_bytes) / MEM_BYTES_PER_S * 1e3
    log(f"(g) prefill step B={b} S={s}: {pre_ms:.1f} ms median of 3 "
        f"({pre_lo:.1f}-{pre_hi:.1f}), {b * s / pre_ms * 1e3:.0f} tokens/s")
    log(f"(g) serve B={SERVE_B} prompt {SERVE_PROMPT} gen {SERVE_GEN} "
        f"greedy: token-recurrent prefill {res.prefill_s * 1e3:.1f} ms "
        f"({res.prefill_s / SERVE_PROMPT * 1e3:.2f} ms/step); decode "
        f"{decode_ms:.2f} ms/step, {SERVE_B * SERVE_GEN / res.decode_s:.1f} "
        f"tokens/s; weight-read bound {read_ms:.2f} ms/step "
        f"(share {read_ms / decode_ms:.2f}); all weights "
        f"{w_bytes / MEM_BYTES_PER_S * 1e3:.2f} ms")

    # ---- where the time goes: one prefill step and three decode steps
    # under torch.profiler (it adds host time, so the host clock above is
    # the one to quote; the device's kernel time is read from the trace)
    serve_step = make_serve_step(model)
    cache = model.init_cache(SERVE_B, n_steps, device=dev)
    step_tok = torch.from_numpy(prompt[:, :1]).to(dev)
    windows = (
        ("prefill step", 1, lambda i: prefill_step(params,
                                                   {"tokens": tokens})),
        ("decode step", 3, lambda i: serve_step(params, cache, step_tok, i)))
    for name, n, fn in windows:
        wall, busy, n_kernels, top = profile_window(
            fn, n, OUT / f"{name.replace(' ', '_')}_trace.json")
        if busy is None:
            log(f"(g) {name}: the profiler's trace holds no kernel; device "
                f"time not measured")
            continue
        log(f"(g) {name}, profiled: host {wall / n:.1f} ms, device busy "
            f"{busy / n:.1f} ms per step, idle share {1 - busy / wall:.2f}, "
            f"{n_kernels / n:.0f} kernels per step; largest kernels per "
            f"step: " + "; ".join(
                f"{k} {ms / n:.2f} ms" for k, ms in top))
    del cache

    # ---- agreement: logits, not tokens, read at two bfloat16 weight
    # seeds and in float32, each against planted faults; every reading is
    # printed before any is checked
    one = tokens[:1, :AGREE_S]
    readings = agreement_readings(model, params, prompt, res, one,
                                  "bf16 seed 0", faults=True)
    del params, res, logits
    torch.cuda.empty_cache()
    p1 = model.init(torch.Generator(device=dev).manual_seed(1))
    readings += agreement_readings(model, p1, prompt, None, one,
                                   "bf16 seed 1")
    del p1
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    m32 = build_model(cfg32)
    p32 = m32.init(torch.Generator(device=dev).manual_seed(2))
    readings += agreement_readings(m32, p32, prompt, None, one,
                                   "float32 seed 2", faults=True)
    del p32
    errors = {}
    for f32 in (False, True):
        errors.update(check_limits(
            AGREE_TOL_F32 if f32 else AGREE_TOL,
            [r for r in readings if r[1].startswith("float32") == f32],
            f"(g) {'float32' if f32 else 'bf16'}"))
    log(f"(g) peak device memory {torch.cuda.max_memory_allocated() / 1e9:.1f}"
        f" GB")
    torch.cuda.empty_cache()
    return launches, errors


# ------------------------------------------------------ (k) moe and ssm
# qwen3-moe-235b-a22b at full width, cut in depth to MOE_LAYERS of its 94
# layers: the deepest cut that leaves FREE_GB of the card free at the
# phase's peak (one layer is 4.97 GB of bf16 weights, 2.42 B of them in
# its 128 experts; embed and unembed 2.49 GB)
MOE_ARCH, MOE_LAYERS = "qwen3-moe-235b-a22b", 13
MAMBA_ARCH = "mamba2-370m"
FREE_GB = 8.0
# the capacity factor at which no token drops: E/k = 128/8, so a group's
# capacity is its size.  Capacity is per dispatch group (B*S tokens in a
# forward pass, B in a decode step), so at the config's 1.25 the two modes
# rightly differ; decode against forward is read at this factor
MOE_NO_DROP = 16.0
# the moe family's kernel-vs-plain check reads one sequence of this many
# tokens, not AGREE_S: a bfloat16 rounding that reorders an expert at the
# top-k edge moves a token's output by a whole expert's share, and over
# 1024 tokens such flips read as much as the planted 64-key fault (at 14
# layers, 0.215 clean against 0.159 faulty on an H100); over 256 the fault
# drops a quarter of the last row's keys, not a sixteenth
MOE_AGREE_S = 256
# mamba2's agreement run: a prompt of 480 and 32 generated tokens make 512,
# two SSD chunks of 256, so the forward side crosses a chunk boundary
MAMBA_AGREE_PROMPT = 480
# qwen3-moe's float32 agreement run, cut further to fit (9.95 GB a layer)
MOE_F32_LAYERS = 4
# limits of phase (k)'s agreement checks, each set between the clean
# readings at two bfloat16 weight seeds and the smallest planted fault's
# (PERF.md, section 6).  On an H100 the moe family read 0.17 and 0.37
# (decode vs prefill), 0.50 and 0.51 (decode vs forward), 0.063 and 0.098
# (kernel vs plain attention, over MOE_AGREE_S tokens), against faults of
# at least 1.85, 1.68 and 0.63; the ssm family read 0.64 and 0.73, 1.24
# and 1.48, 0.28 and 0.48 against at least 6.0, 7.8 and 5.5.  Routing is
# discontinuous (see MOE_AGREE_S), so the moe readings have a heavier tail
# than phase (g)'s; a random-weight mamba2 magnifies a bfloat16 rounding
# over its 48 layers (its float32 readings are 100 times the moe
# model's).  Each limit is about twice the larger clean reading
AGREE_TOL_K = {
    "moe": {"decode_vs_prefill": 0.75, "decode_vs_forward": 1.0,
            "kernel_vs_plain_attention": 0.2},
    "ssm": {"decode_vs_prefill": 1.5, "decode_vs_forward": 3.0,
            "kernel_vs_plain_norm": 1.0},
}
# the same checks in float32, where only the order of sums differs: the
# moe family at MOE_F32_LAYERS read 8.6e-06, 1.04e-05 and 6.7e-06 on an
# H100 (phase (g)'s 1e-3 holds), mamba2 at its 48 layers 4.7e-04, 1.1e-03
# and 3.7e-04, so 1e-2 there; every planted fault read 1.09 or more
AGREE_TOL_K_F32 = {
    "moe": {"decode_vs_prefill": 1e-3, "decode_vs_forward": 1e-3,
            "kernel_vs_plain_attention": 1e-3},
    "ssm": {"decode_vs_prefill": 1e-2, "decode_vs_forward": 1e-2,
            "kernel_vs_plain_norm": 1e-2},
}


def family_faults(kind: str):
    """name → (module, attribute, faulty stand-in) planted into the side
    of a comparison that runs ``forward_train``: for the moe family the
    attention faults of phase (g) and the expert map shifted by one expert
    (expert e's products end with e - 1's down projection); for the ssm
    family the SSD's decay rates dropped (``A_log`` read as A, a slip that
    keeps every state forever), and the causal conv's taps reversed.  (The
    state carried between chunks is no use as a fault here: with the
    initial ``A_log`` of 0 a state decays by about exp(-0.7) a token, so
    nothing of it is left after a 256-token chunk.)"""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import mamba2, moe
    if kind == "moe":
        real_moe = moe.moe_mlp

        def experts_shifted(p, x, cfg, grouped=False):
            return real_moe(dict(p, w_down=p["w_down"].roll(1, 0)), x, cfg,
                            grouped)
        out = {name: (fa_ops, "attention", fn)
               for name, fn in planted_faults().items()}
        out["expert map shifted by one expert"] = (moe, "moe_mlp",
                                                   experts_shifted)
        return out
    real_ssd, real_conv = mamba2.ssd_chunked, mamba2._causal_conv

    def no_decay(xh, dt, A, Bm, Cm, chunk, compute_dtype=torch.float32):
        return real_ssd(xh, dt, torch.zeros_like(A), Bm, Cm, chunk,
                        compute_dtype)

    def taps_reversed(x, w):
        return real_conv(x, w.flip(0))
    return {"decay rates dropped (A = 0)": (mamba2, "ssd_chunked", no_decay),
            "conv taps reversed": (mamba2, "_causal_conv", taps_reversed)}


def family_readings(kind: str, model, params, one, run: str,
                    faults: bool = False):
    """Phase (k)'s three logits comparisons for one set of weights →
    [(check, run, fault or None, max abs err)], each printed.  moe: the
    serve loop at the no-drop capacity factor against the prefill step and
    ``forward_train``, and the flash kernel against ``attn_impl="ref"``;
    ssm: the serve loop over 512 tokens against the prefill step and
    ``forward_train`` over them, and the RMSNorm kernel against its plain
    version."""
    from functools import partial
    from unittest import mock
    import numpy as np
    import torch
    from repro_torch.kernels.rmsnorm import kernel as rn
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models import layers
    from repro_torch.models.registry import build_model
    from repro_torch.train.step import make_prefill_step

    cfg, dev = model.cfg, one.device
    rng = np.random.default_rng(5)
    with torch.inference_mode():
        if kind == "moe":
            nd = build_model(dataclasses.replace(
                cfg, capacity_factor=MOE_NO_DROP))
            prompt = rng.integers(0, cfg.vocab, (SERVE_B, SERVE_PROMPT))
            res = serve_loop(nd, params, prompt, SERVE_GEN)
            p = torch.from_numpy(prompt).to(dev)
            full = torch.cat([p, res.tokens], dim=1)
            n = SERVE_PROMPT
            plain = build_model(cfg, attn_impl="ref")
            checks = {
                "decode_vs_prefill": (
                    f"decode vs make_prefill_step at position {n - 1}, "
                    f"capacity factor {MOE_NO_DROP:g}", res.logits[n - 1],
                    lambda: make_prefill_step(nd)(params, {"tokens": p})),
                "decode_vs_forward": (
                    f"decode vs forward_train over {full.shape[1]} tokens "
                    f"at positions {n - 1}..{full.shape[1] - 1}, capacity "
                    f"factor {MOE_NO_DROP:g}",
                    res.logits[n - 1:].transpose(0, 1),
                    lambda: nd.forward_train(params, full)[:, n - 1:]),
                "kernel_vs_plain_attention": (
                    f"forward_train(last_only) B=1 S={one.shape[1]}, flash "
                    f"kernel vs attn_impl='ref'",
                    model.forward_train(params, one, last_only=True),
                    lambda: plain.forward_train(params, one,
                                                last_only=True)),
            }
        else:
            prompt = rng.integers(0, cfg.vocab,
                                  (SERVE_B, MAMBA_AGREE_PROMPT))
            res = serve_loop(model, params, prompt, SERVE_GEN)
            full = torch.cat([torch.from_numpy(prompt).to(dev), res.tokens],
                             dim=1)
            s = full.shape[1]
            plain_norm = partial(rn.rmsnorm, impl="ref")

            def plain_forward():
                with mock.patch.object(layers, "rmsnorm", plain_norm):
                    return model.forward_train(params, one, last_only=True)
            checks = {
                "decode_vs_prefill": (
                    f"decode vs make_prefill_step over {s} tokens at "
                    f"position {s - 1}", res.logits[s - 1],
                    lambda: make_prefill_step(model)(params,
                                                     {"tokens": full})),
                "decode_vs_forward": (
                    f"decode vs forward_train over {s} tokens at every "
                    f"position", res.logits[:s].transpose(0, 1),
                    lambda: model.forward_train(params, full)),
                "kernel_vs_plain_norm": (
                    f"forward_train(last_only) B=1 S={one.shape[1]}, "
                    f"RMSNorm kernel vs its plain version",
                    model.forward_train(params, one, last_only=True),
                    plain_forward),
            }
        return read_checks(checks, family_faults(kind) if faults else {},
                           run, f"(k) {cfg.arch_id} {run}")


def check_limits(table, readings, what: str):
    """Each limit must pass every clean reading and fail every planted
    fault → {check (run): clean error}."""
    failures, errors = [], {}
    for key, limit in table.items():
        clean = [e for k, _, f, e in readings if k == key and f is None]
        faulty = [e for k, _, f, e in readings if k == key and f]
        errors.update({f"{key} ({run})": e for k, run, f, e in readings
                       if k == key and f is None})
        log(f"{what} {key}: limit {limit:g}; clean readings {clean}, with a "
            f"planted fault {faulty}")
        if not max(clean) <= limit:
            failures.append(f"{key}: {max(clean)} > {limit}")
        if not faulty:
            failures.append(f"{key}: no planted fault was read")
        elif not min(faulty) > limit:
            failures.append(f"{key}: a planted fault reads {min(faulty)} <= "
                            f"{limit}")
    check(not failures, "; ".join(failures))
    return errors


def decode_syncs(serve_step, params, cache, tok, pos: int) -> str:
    """Run one decode step with torch's sync debug mode at "error" → ""
    when no operation synchronised with the host, else the error."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        serve_step(params, cache, tok, pos)
        return ""
    except RuntimeError as e:
        return str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


def phase_family(kind: str, card: str):
    """(k) one family at full width on the card: a prefill step and the
    serve loop (the main path, launches counted), times, a profile, the
    peak memory and the agreement checks at two weight seeds."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models.registry import build_model
    from repro_torch.train.step import make_prefill_step, make_serve_step

    dev = torch.device(DEVICE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if kind == "moe":
        full_cfg = get_arch(MOE_ARCH)
        cfg = dataclasses.replace(full_cfg, n_layers=MOE_LAYERS)
        cut = (f"{MOE_LAYERS} of its {full_cfg.n_layers} layers, every "
               f"width as published")
    else:
        cfg = get_arch(MAMBA_ARCH)
        cut = "whole: every layer and width"
    check(cfg.family == kind and cfg.dtype == torch.bfloat16,
          f"{cfg.arch_id} config changed")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def leaves(node):
        for val in node.values():
            yield from leaves(val) if isinstance(val, dict) else (val,)
    n_params = sum(t.numel() for t in leaves(params))
    w_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    log(f"(k) {cfg.arch_id}, {cut}: d {cfg.d_model}, vocab "
        f"{cfg.vocab_padded}, "
        + (f"heads {cfg.n_heads}/{cfg.n_kv_heads} x {cfg.hd}, {cfg.n_experts} "
           f"experts of d_ff {cfg.moe_d_ff}, top {cfg.top_k}, capacity "
           f"factor {cfg.capacity_factor:g}" if kind == "moe" else
           f"d_inner {cfg.ssm_expand * cfg.d_model}, state {cfg.ssm_state}, "
           f"head dim {cfg.ssm_head_dim}, chunk {cfg.ssm_chunk}")
        + f": {n_params / 1e9:.3f} B parameters, {w_bytes / 1e9:.2f} GB, "
        f"drawn in {init_s:.1f} s")

    rng = np.random.default_rng(0)
    b, s = PREFILL_B, PREFILL_S
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab, (b, s)).astype(np.int64)).to(dev)
    prompt = rng.integers(0, cfg.vocab, (SERVE_B, SERVE_PROMPT)
                          ).astype(np.int64)
    prefill_step = make_prefill_step(model)

    # ---- the main path: counts set to 0 just before, read just after
    reset_counts()
    logits = prefill_step(params, {"tokens": tokens})
    torch.cuda.synchronize()
    per_prefill = counts()
    res = serve_loop(model, params, prompt, SERVE_GEN)
    launches = counts()
    # ----
    n_steps = SERVE_PROMPT + SERVE_GEN
    serve_counts = {k: launches[k] - per_prefill[k] for k in LAUNCHER}
    log(f"(k) {cfg.arch_id} launches in one prefill step: {per_prefill}; in "
        f"the serve loop ({n_steps} decode steps): {serve_counts}")
    n_attn = cfg.n_layers if kind == "moe" else 0
    n_norm = (4 * cfg.n_layers + 1) if kind == "moe" else \
        (2 * cfg.n_layers + 1)
    check(per_prefill["flash_attention_by_route"]
          == {"wgmma": n_attn, "simt": 0}
          and per_prefill["flash_attention"] == n_attn,
          f"{cfg.arch_id} prefill's flash-attention launches "
          f"{per_prefill['flash_attention_by_route']}, not {n_attn} on the "
          f"tensor-core route")
    check(per_prefill["rmsnorm"] == n_norm,
          f"{cfg.arch_id} prefill launched RMSNorm {per_prefill['rmsnorm']} "
          f"times, not {n_norm}")
    check(serve_counts["rmsnorm"] == n_norm * n_steps
          and serve_counts["flash_attention"] == 0,
          f"{cfg.arch_id} serve loop launches {serve_counts}")
    check(tuple(logits.shape) == (b, cfg.vocab_padded)
          and logits.dtype == torch.bfloat16
          and bool(torch.isfinite(logits).all()),
          f"{cfg.arch_id} prefill logits {tuple(logits.shape)} "
          f"{logits.dtype}")
    check(tuple(res.logits.shape) == (n_steps, SERVE_B, cfg.vocab_padded)
          and bool(torch.isfinite(res.logits).all())
          and tuple(res.tokens.shape) == (SERVE_B, SERVE_GEN)
          and int(res.tokens.min()) >= 0
          and int(res.tokens.max()) < cfg.vocab_padded,
          f"{cfg.arch_id} serve loop gave bad logits or tokens")

    pre_ms, pre_lo, pre_hi = cuda_ms(
        lambda: prefill_step(params, {"tokens": tokens}), reps=3, warm=1)
    decode_ms = res.decode_s / SERVE_GEN * 1e3
    embed_bytes = params["lm"]["embed"].numel() * 2
    log(f"(k) {cfg.arch_id} prefill step B={b} S={s}: {pre_ms:.1f} ms median "
        f"of 3 ({pre_lo:.1f}-{pre_hi:.1f}), {b * s / pre_ms * 1e3:.0f} "
        f"tokens/s; {card}")
    log(f"(k) {cfg.arch_id} serve B={SERVE_B} prompt {SERVE_PROMPT} gen "
        f"{SERVE_GEN} greedy: token-recurrent prefill "
        f"{res.prefill_s * 1e3:.1f} ms ({res.prefill_s / SERVE_PROMPT * 1e3:.2f}"
        f" ms/step); decode {decode_ms:.2f} ms/step, "
        f"{SERVE_B * SERVE_GEN / res.decode_s:.1f} tokens/s; reading every "
        f"weight but the embedding once takes "
        f"{(w_bytes - embed_bytes) / MEM_BYTES_PER_S * 1e3:.2f} ms; {card}")

    serve_step = make_serve_step(model)
    cache = model.init_cache(SERVE_B, n_steps, device=dev)
    step_tok = torch.from_numpy(prompt[:, :1]).to(dev)
    synced = decode_syncs(serve_step, params, cache, step_tok, 0)
    log(f"(k) {cfg.arch_id} one decode step under torch's sync debug mode: "
        + (f"a host sync: {synced}" if synced else "no host sync"))
    check(not synced, f"{cfg.arch_id} decode synchronised with the host")
    windows = (
        ("prefill step", 1, lambda i: prefill_step(params,
                                                   {"tokens": tokens})),
        ("decode step", 3, lambda i: serve_step(params, cache, step_tok,
                                                i + 1)))
    breakdown = {}
    for name, n, fn in windows:
        wall, busy, n_kernels, top = profile_window(
            fn, n, OUT / f"{kind}_{name.replace(' ', '_')}_trace.json")
        if busy is None:
            log(f"(k) {cfg.arch_id} {name}: the profiler's trace holds no "
                f"kernel; device time not measured")
            continue
        breakdown[name] = dict(host_ms=wall / n, busy_ms=busy / n,
                               idle=1 - busy / wall)
        log(f"(k) {cfg.arch_id} {name}, profiled: host {wall / n:.1f} ms, "
            f"device busy {busy / n:.1f} ms per step, idle share "
            f"{1 - busy / wall:.2f}, {n_kernels / n:.0f} kernels per step; "
            f"largest kernels per step: " + "; ".join(
                f"{k} {ms / n:.2f} ms" for k, ms in top))
    del cache

    # ---- agreement at two bfloat16 weight seeds and in float32, planted
    # faults at the first and in float32; every reading is printed before
    # any is checked
    one = tokens[:1, :MOE_AGREE_S if kind == "moe" else AGREE_S]
    readings = family_readings(kind, model, params, one, "bf16 seed 0",
                               faults=True)
    del params, res, logits
    torch.cuda.empty_cache()
    p1 = model.init(torch.Generator(device=dev).manual_seed(1))
    readings += family_readings(kind, model, p1, one, "bf16 seed 1")
    del p1

    total = torch.cuda.get_device_properties(0).total_memory
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    free_gb = (total - reserved) / 1e9
    log(f"(k) {cfg.arch_id} peak device memory {peak / 1e9:.2f} GB allocated, "
        f"{reserved / 1e9:.2f} GB reserved of {total / 1e9:.2f} GB: "
        f"{free_gb:.2f} GB free at the peak; {card}")
    check(free_gb >= FREE_GB, f"{cfg.arch_id} leaves {free_gb:.2f} GB free, "
                              f"under {FREE_GB:g}")

    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    if kind == "moe":
        cfg32 = dataclasses.replace(cfg32, n_layers=MOE_F32_LAYERS)
    m32 = build_model(cfg32)
    p32 = m32.init(torch.Generator(device=dev).manual_seed(2))
    readings += family_readings(kind, m32, p32, one, "float32 seed 2",
                                faults=True)
    del p32
    errors = {}
    for f32 in (False, True):
        errors.update(check_limits(
            (AGREE_TOL_K_F32 if f32 else AGREE_TOL_K)[kind],
            [r for r in readings if r[1].startswith("float32") == f32],
            f"(k) {cfg.arch_id} {'float32' if f32 else 'bf16'}"))
    torch.cuda.empty_cache()
    return launches, dict(
        prefill_ms=pre_ms, prefill_tokens_per_s=b * s / pre_ms * 1e3,
        decode_ms=decode_ms, peak_gb=peak / 1e9, free_gb=free_gb,
        host_sync=synced or None, profile=breakdown,
        agreement_max_abs_err=errors)


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    max_err: list = []
    card = phase_setup()
    phase_kernel_vs_plain(max_err)
    launches, totals, n_runs, cell_ms = phase_main_path(max_err)
    phase_reconfig(max_err)
    runtime_launches, runtime = phase_runtime(card, cell_ms)
    serving_launches, serving = phase_serving(card)
    verified_launches, verified = phase_verified(card)
    err = max(max_err)
    check(err == 0.0, f"max abs error {err}")
    rms, rms_errs = phase_rmsnorm()
    fa, fa_errs, fa_shares = phase_flash_attention()
    model_launches, agree_errs = phase_model()
    for name in ("rmsnorm", "flash_attention"):
        check(model_launches[name] > 0,
              f"the serving path never launched {name}")
    moe_launches, moe = phase_family("moe", card)
    ssm_launches, ssm = phase_family("ssm", card)
    by_path = {name: {"(g) qwen3-14b": model_launches[name],
                      f"(k) {MOE_ARCH} ({MOE_LAYERS} layers)":
                          moe_launches[name],
                      f"(k) {MAMBA_ARCH}": ssm_launches[name]}
               for name in ("rmsnorm", "flash_attention")}
    fa_by_route = {route: model_launches["flash_attention_by_route"][route]
                   + moe_launches["flash_attention_by_route"][route]
                   + ssm_launches["flash_attention_by_route"][route]
                   for route in model_launches["flash_attention_by_route"]}
    log("(k) readings " + json.dumps({MOE_ARCH: moe, MAMBA_ARCH: ssm}))
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": [{
        "name": "overlay_exec",
        "route": "cuda",
        "source": "src/repro_torch/csrc/overlay_exec.cu",
        "replaces": "src/repro/kernels/overlay_exec/kernel.py:30",
        "launches": (launches + runtime_launches + serving_launches
                     + verified_launches),
        "launches_by_path": {"(c) run_overlay": launches,
                             "(h) runtime seam": runtime_launches,
                             "(i) serving": serving_launches,
                             "(j) verified": verified_launches},
        "match": "bit-exact",
        "max_abs_err": err,
        "ms": totals["ms"],
        "ms_with_host_enqueue": totals["ms_with_host"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": ("bytes" if totals["byte_ms"] >= totals["op_ms"]
                     else "operations"),
        "library_ms": None,
        "main_path_programs": n_runs,
        "work_items_per_launch": N_MAIN,
        "runtime_seam": runtime,
        "serving": serving,
        "verified": verified,
    }, {
        "name": "rmsnorm",
        "route": "cuda",
        "source": "src/repro_torch/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm/kernel.py:17",
        "launches": sum(by_path["rmsnorm"].values()),
        "launches_by_path": by_path["rmsnorm"],
        "match": "within 1e-4 (float32) and 3e-2 (bfloat16) of the plain "
                 "version",
        "max_abs_err": rms_errs[torch.bfloat16],
        "max_abs_err_float32": rms_errs[torch.float32],
        "ms": rms["ms"],
        "plain_ms": rms["plain_ms"],
        "bound_ms": rms["bound_ms"],
        "bound_by": "bytes" if rms["byte_ms"] >= rms["op_ms"]
                    else "operations",
        "library_ms": rms["library_ms"],
        "shares_of_bound": rms["shares"],
        "per": "one qwen3-14b prefill step at B=4, S=4096: 161 calls, "
               "each timed with the L2 evicted",
        "per_prefill_step_of": rms["per_prefill_step_of"],
    }, {
        "name": "flash_attention",
        "route": "cuda (wgmma + TMA)",
        "source": "src/repro_torch/csrc/flash_attention_wgmma.cu",
        "source_simt": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:25",
        "launches": sum(by_path["flash_attention"].values()),
        "launches_by_path": by_path["flash_attention"],
        "launches_by_route": fa_by_route,
        "match": "bfloat16 (tensor-core route) within 1e-4 + 2^-7 |plain| + "
                 "2^-7 plain(|v|) of the plain version; float32 (SIMT "
                 "route) within 2e-3",
        "max_abs_err": fa_errs["prefill"],
        "max_share_of_limit": fa_shares["prefill"],
        "max_share_of_limit_cases": fa_shares[torch.bfloat16],
        "max_abs_err_float32": fa_errs[torch.float32],
        "ms": fa["ms"],
        "ms_turns": fa["ms_turns"],
        "simt_ms": fa["simt_ms"],
        "ratio_to_library": fa["ratio_to_library"],
        "plain_ms": fa["plain_ms"],
        "bound_ms": fa["bound_ms"],
        "bound_by": fa["bound_by"],
        "library_ms": fa["library_ms"],
        "per": "one call at q (4, 40, 4096, 128) bfloat16 causal; 40 calls "
               "per prefill step",
        "at_qwen3_moe_prefill_shape": fa["moe_shape"],
        "model_agreement_max_abs_err": agree_errs,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
