#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card; it builds the
port's CUDA kernels from ``src/repro_torch/csrc/`` with nvcc (the overlay
executor, RMSNorm forward and backward, and flash attention's two routes,
each a forward and a backward: the bfloat16 tensor-core kernels and the
float32 SIMT kernels).  Phases:

  (a) set-up: the card's name and power limit, the six kernel builds,
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
      head dims 64, 112 and 128; then at the prefill shape q (4, 40,
      4096, 128) through the path's heads views, and timed there in turns with the
      SIMT kernel and ``scaled_dot_product_attention`` against the
      operations bound, and at phase (k)'s q (4, 64, 4096, 128) with k/v
      of 4 heads, timed in turns with ``scaled_dot_product_attention``;
      each case is run again writing the row statistics (m and l, what
      autograd's forward asks for), which must leave the output's bits
      as they were and lie within ``STATS_TOL`` of ``ref.attention_stats``;
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
      64- and 4-head views) and phase (f) GQA groups 6 and 16 at D 128;
  (l) the hybrid and audio families, after (k) and in its manner, whole:
      zamba2-7b (81 Mamba2 layers, d 3584, d_inner 7168, 112 SSM heads of
      64, state 64, chunk 256, and one shared attention block, 32/32
      heads of 112, after every sixth layer: 14 sites, each with its own
      KV cache) and whisper-large-v3 (32 encoder and 32 decoder layers, d
      1280, 20 heads of 64, vocab 51,866); ``make_prefill_step`` on 4 x
      4096 tokens (zamba2) and on 4 x 1500 float32 frames with 448
      decoder tokens (whisper), the serve loop (4 x (128 + 32); whisper's
      decoder against its zero cross-attention KV, as in the JAX package,
      with flash attention launched for the cross-attention of every
      decode step), launches per kernel and route, times, a decode step
      under torch's sync debug mode, profiles, the peak memory, and three
      logits checks at two bfloat16 weight seeds and in float32 (zamba2
      cut to ``ZAMBA_F32_LAYERS`` there): zamba2 over 256 tokens, decode
      against the prefill step and ``forward_train`` and the flash kernel
      against ``attn_impl="ref"``, with faults planted (the shared block
      after the wrong layers, the last keys dropped, and in the decode
      side each site reading the neighbouring site's KV); whisper with
      the cross-attention KV filled from the encoder's memory by harness
      code (``cross_kv_filled``), with a causal encoder and, in the decode
      side, layer l's cross-KV from layer l + 1's projections.  Phase (e)
      adds their RMSNorm rows (3584, 7168, 1280) and phase (f) head dim
      112 in bfloat16 (the tensor-core kernel on its 128-column tile) and
      float32 (SIMT), whisper's non-causal Sq != Skv shapes, and times the
      kernel at zamba2's prefill shape q (4, 32, 4096, 112) and at
      whisper's four shapes in turns with ``scaled_dot_product_attention``.

  (m) the paper's benchmarks and the reference's benchmark suite, after
      (l): ``run("cuda")`` of the ten suites of ``benchmarks/`` the port
      added last (``torch_{replication_scaling, par_time, resource_table,
      overlay_exec_perf, jit_cache_perf, queue_sched_perf,
      chaos_serving_perf, template_build_perf, persistent_cache_perf,
      fleet_warm_start_perf}.py``; the template builds at the reference's
      ``--smoke`` sizes, the persistent cache at its four kernels), every
      gate held and every executor launch bit for bit against
      ``run_reference``, then ``benchmarks/torch_run.py --suite
      resource_table --json`` in its own process (exit code, CSV and JSON
      rows); the executor stays built once.
  (n) training, after (m): (n1) the backward kernels against their
      plain versions (``ref.rmsnorm_bwd``, ``ref.attention_bwd``) and
      against autograd through the plain forwards, each run twice and bit
      for bit the same: RMSNorm at qwen3-14b's training rows (5120 wide,
      and q_norm's and k_norm's heads views) and in float32, unaligned,
      wide and ragged; attention, given the statistics its forward wrote,
      at qwen3-14b's training shape q (2, 40, 2048, 128), k/v (2, 8, 2048,
      128) bf16 causal, a window, rows that see no key, whisper's
      non-causal 448 -> 1500 at D 64, D 112 at group 1, group 16 and a
      D 64 window on the tensor-core backward (``BWD_TC_LIMIT``, with two
      faults planted in it that the limit must catch), D 32 and float32
      on the SIMT one (``BWD_TOL``); then timed at the training shapes
      beside the plain versions, the SIMT attention backward (in turns,
      at every case of the tensor-core route too), autograd through
      ``scaled_dot_product_attention`` and ``F.rms_norm`` (yardsticks
      only), and their bounds.  (n2) qwen3-14b at full width, cut to
      ``TRAIN_LAYERS`` of its 40 layers (the deepest that leaves
      ``FREE_GB`` free), trained through ``TrainLoop`` for six steps of
      B=2 x S=2048 ``SyntheticTokens`` with full remat and AdamW, a
      checkpoint at step 3 and a restart from it (the restored state
      bit-identical to the saved one): launches of all four kernels
      counted, ms per step, tokens/s, peak memory, a profiled step with
      the backward kernels' share; then one step from two weight seeds
      against the same step through both kernels' plain versions (loss,
      grad_norm, the updated first moment and parameters), each limit
      also held against planted faults (attention's key/value head map
      shifted, one key/value head's dk zeroed, RMSNorm's dw without its
      last rows).  Every training forward writes the row statistics and
      every backward takes the tensor-core route; the serving phases
      (g), (k) and (l) write none.
  (o) training across ranks, after (n), on a one-rank NCCL group
      (``make_host_mesh(device="cuda")``, destroyed at the end): qwen3-14b
      at full width cut to ``DP_LAYERS`` of its 40 layers (the deepest
      that leaves ``DP_FREE_GB`` free at the compressed step's 18 bytes a
      parameter), B=2 x S=2048 ``SyntheticTokens``, full remat, phase
      (n)'s AdamW: the uncompressed ``make_train_step`` and the int8
      error-feedback ``make_compressed_dp_train_step`` from one initial
      state on the same 8 batches (the first loss bit-equal, both curves
      falling, the last losses within the reference's 0.35), launches of
      all four kernels counted in the compressed run, its step timed
      (CUDA events, the host hidden) in turns with the uncompressed one
      (uncompressed, compressed, compressed, uncompressed), the
      compression's device ms (events around it, and its kernels in a
      profiled step) against its 14-bytes-a-parameter bound, the peak
      memory, one step under torch's sync debug mode; the ef after a step
      against (g + ef) - deq bit for bit, which must fail with the ef not
      carried (planted); the compression's invariants on a leaf of the
      real gradients (q int8 in [-127, 127], |deq - (g + e)| <= scale/2,
      the mean sent over 20 repeats within the error feedback's bound,
      which must fail with the error not carried); and
      ``make_pipeline_train_step`` with one stage over 4 microbatches
      through the cut's layers (the layer body, so both forward kernels
      run), bit for bit against the layers applied to each microbatch in
      turn.  ``python3 chip_smoke.py --phase o`` runs (a) and (o) alone.
  (p) tensor, expert and data parallelism through DTensor, after (o):
      TP_RANKS (4) spawned processes share the card over a gloo group
      with CUDA tensors and a FileStore (NCCL refuses two ranks on one
      device; gloo stages each collective through the host), the parent
      taking each one-rank reading first and freeing it: (p1) qwen3-14b
      at full width and depth in bfloat16 on a (1, 4) mesh, the ranks
      drawing the seeded weights in turns, one ``make_prefill_step`` on 4
      x 4096 tokens and the serve loop (a
      prompt of TP_PROMPT, TP_GEN steps fed the one-rank run's tokens,
      each rank's greedy pick read from the vocab-sharded logits and
      equal, every one, to the argmax of the gathered logits), the
      logits within ``AGREE_TOL`` of the one-rank run's; (p2)
      qwen3-moe-235b-a22b at full width cut to TP_MOE_LAYERS (32 experts
      a rank), its prefill within ``AGREE_TOL_K``; (p3) qwen3-14b at full
      width cut per mesh (TP_TRAIN_LAYERS), B=2 x S=2048, full remat,
      TP_TRAIN_STEPS steps on (1, 4) and on (2, 2) at seed 0 and one at
      seed 1, the first loss, every grad norm and each gradient leaf's
      norm after the first step within TP_TRAIN_TOL of the one-rank
      step's; and a planted fault on (1, 4) at seed 1 (a replicated
      weight's gradient on sharded heads labelled replicated, so q_norm's
      and k_norm's stay partial sums) must break the leaf limit.  Every
      rank reports its launches of the four kernels (by route), the
      shapes they saw (q heads 10 and KV heads 2 at model=4) and its
      memory, and each kernel must have launched on every rank as on one
      rank with a quarter of the heads.
      ``python3 chip_smoke.py --phase p`` runs (a) and (p) alone.

Exits non-zero, printing no result, without a card or when any check
fails.  The last line is ``{"ok": true, "device": {...}}``; the line
before it lists each ported kernel with its launches on the main paths
(phases (c), (h), (i), (j) and (m) for the executor, phases (g), (k),
(l), (n), (o) and (p) for RMSNorm and flash attention, phases (n), (o)
and (p) for their backward kernels).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
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
    (2, 32, 32, 1000, 1000, 112, True, None),    # D 112 (zamba2), ragged
    (1, 32, 32, 300, 700, 112, False, None),     # D 112, not causal, Sq < Skv
    (1, 32, 32, 200, 130, 112, True, None),      # D 112, Sq > Skv
    (4, 20, 20, 1500, 1500, 64, False, None),    # whisper's encoder
    (4, 20, 20, 448, 448, 64, True, None),       # whisper's decoder
    (4, 20, 20, 448, 1500, 64, False, None),     # whisper's cross-attention
    (4, 20, 20, 1, 1500, 64, False, None),       # ... in a decode step
)
# phase (f) times the kernel at these shapes of phase (l)'s whisper-large-v3
# in turns with scaled_dot_product_attention: (b, hq, sq, skv, d, causal)
FA_WHISPER = {
    "encoder self-attention": (4, 20, 1500, 1500, 64, False),
    "decoder self-attention": (4, 20, 448, 448, 64, True),
    "cross-attention": (4, 20, 448, 1500, 64, False),
    "cross-attention in a decode step": (4, 20, 1, 1500, 64, False),
}
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
# the forwards' row statistics against ref.attention_stats: |m - plain m|
# over 1 + |plain m|, and |l - plain l| over plain l.  Both sum the scores
# in float32 in another order (the tensor cores' m also makes a trip
# through the log2 domain, its l sums ex2.approx terms): on an H100 they
# read up to 6.9e-7 and 2.3e-6; the limits leave a factor of 14 and 43
STATS_TOL = (1e-5, 1e-4)
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
            "rmsnorm (forward and backward)": mods["rmsnorm"].LIBRARY,
            "flash_attention (wgmma)": fa.LIBRARY_WGMMA,
            "flash_attention (SIMT)": fa.LIBRARY,
            "flash_attention (backward, wgmma)": fa.LIBRARY_BWD_WGMMA,
            "flash_attention (backward, SIMT)": fa.LIBRARY_BWD}


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
            elif symbol.startswith("Lb", j):
                args.append("true" if symbol[j + 2] == "1" else "false")
                j += 4
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
        f"{smem(64)} bytes at D 64, {smem(112)} at D 112 (the D 128 tile), "
        f"{smem(128)} at D 128 (ptxas counts it nowhere: it is set at "
        f"launch)")
    bwd = fa.LIBRARY_BWD_WGMMA.get().flash_attention_bwd_wgmma_smem_bytes
    log(f"    flash_attention (backward, wgmma): dynamic shared memory per "
        f"block of fa_bwd_dkv_wgmma and fa_bwd_dq_wgmma {bwd(64, 0)} and "
        f"{bwd(64, 1)} bytes at D 64, {bwd(128, 0)} and {bwd(128, 1)} at D "
        f"112 and 128")
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


# phase (m): the ten suites of slice 10, with the reference's CI sizes for
# the template builds (the persistent cache at its four kernels, where the
# reference recorded its 50x gate), then the harness on one suite
PAPER_SUITES = (("torch_replication_scaling", {}), ("torch_par_time", {}),
                ("torch_resource_table", {}), ("torch_overlay_exec_perf", {}),
                ("torch_jit_cache_perf", {}), ("torch_queue_sched_perf", {}),
                ("torch_chaos_serving_perf", {}),
                ("torch_template_build_perf", dict(smoke=True)),
                ("torch_persistent_cache_perf", {}),
                ("torch_fleet_warm_start_perf", {}))
HARNESS_JSON = ROOT / "build" / "chip_smoke_torch_run.json"


def paper_readings(name: str, res: dict) -> dict:
    """The few numbers of a suite's result that PERF.md reads."""
    if name == "torch_replication_scaling":
        return {f"dsp{d}": {"exec_gops": r["gops"], "ms": r["ms"]}
                for r in res["executor"].values() for d in r["dsps"]}
    if name == "torch_par_time":
        return {r["kernel"]: {"overlay_par_ms": r["overlay_par_ms"],
                              "torch_compile_ms":
                                  r["torch_compile"]["compile_ms"]}
                for r in res["rows"]}
    if name == "torch_resource_table":
        return {r["kernel"]: {"exec_items_per_s": r["exec_items_per_s"],
                              "modelled_items_per_s":
                                  r["modelled_items_per_s"]}
                for r in res["rows"]}
    if name == "torch_overlay_exec_perf":
        return {f"{c['kernel']}@{c['items']}": {
            k: c[f"{k}_ms"] for k in ("executor", "plain", "compiled")}
            for c in res["cells"]}
    if name == "torch_persistent_cache_perf":
        return {"speedup_total": res["speedup_total"]}
    return {}


def paper_harness() -> dict:
    """(m) ``benchmarks/torch_run.py`` on one suite in its own process: its
    exit code, CSV and JSON rows."""
    HARNESS_JSON.unlink(missing_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "benchmarks" / "torch_run.py"),
         "--suite", "resource_table", "--json", str(HARNESS_JSON)],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(SRC)})
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"(m) torch_run.py exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    rows = json.loads(HARNESS_JSON.read_text())
    csv = proc.stdout.strip().splitlines()
    check(len(rows) == 6 and {r["suite"] for r in rows} == {"resource_table"}
          and csv[1] == "name,us_per_call,derived"
          and [line.split(",")[0] for line in csv[2:]] ==
          [r["name"] for r in rows],
          f"(m) torch_run.py rows: {csv}")
    log(f"(m) benchmarks/torch_run.py --suite resource_table: exit 0, "
        f"{len(rows)} rows, {secs:.1f} s")
    return dict(exit=proc.returncode, rows=len(rows), s=secs)


def phase_paper_benchmarks(card: str):
    """(m) the paper's Fig. 6, Fig. 7 and Table III and the reference's
    runtime suites through their ``run`` on the card, every gate held."""
    from repro_torch.kernels.overlay_exec import kernel

    t0 = time.perf_counter()
    builds = kernel.LIBRARY.builds
    out = {}
    # ---- the main path: counts set to 0 just before, read just after
    kernel.overlay_execute.launches = 0
    for name, kw in PAPER_SUITES:
        t = time.perf_counter()
        bench = load_benchmark(name)
        res = bench.run(DEVICE, **kw)
        secs = time.perf_counter() - t
        log(f"(m) benchmarks/{name}.py ({secs:.1f} s):")
        bench.report(res)
        check(res["gate_failures"] == [],
              f"(m) {name} gates: {res['gate_failures']}")
        out[name] = dict(s=secs, **paper_readings(name, res))
    launches = kernel.overlay_execute.launches
    # ----
    out["torch_run"] = paper_harness()
    check(launches > 0, "(m) the paper benchmarks never launched the "
          "executor")
    check(kernel.LIBRARY.builds == builds == 1,
          f"(m) the executor was built {kernel.LIBRARY.builds} times")
    secs = time.perf_counter() - t0
    log(f"(m) paper benchmarks: {launches} executor launches, {secs:.1f} s; "
        f"{card}")
    return launches, dict(s=secs, suites=out)


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
    # phase (l)'s shapes: zamba2's layer norms and the shared block's
    # ln1/ln2 at its 14 sites, its gated norms; whisper's encoder norms over
    # 1500 frames and its decoder's over 448 tokens
    zam, wh = get_arch(ZAMBA_ARCH), get_arch(WHISPER_ARCH)
    sites = -(-zam.n_layers // zam.attn_every)
    family_cases += [
        (f"{zam.arch_id} ln, shared ln1/ln2 (B*S, {zam.d_model})",
         randn(gen, (b * s, zam.d_model), bf), zam.n_layers + 2 * sites,
         "hybrid"),
        (f"{zam.arch_id} gated norm (B*S, {zam.ssm_expand * zam.d_model})",
         randn(gen, (b * s, zam.ssm_expand * zam.d_model), bf),
         zam.n_layers, "hybrid"),
        (f"{wh.arch_id} encoder ln1/ln2 (B*{WHISPER_FRAMES}, {wh.d_model})",
         randn(gen, (b * WHISPER_FRAMES, wh.d_model), bf),
         2 * wh.enc_layers, "audio"),
        (f"{wh.arch_id} decoder ln1/ln2/ln3 (B*{WHISPER_TOKENS}, "
         f"{wh.d_model})", randn(gen, (b * WHISPER_TOKENS, wh.d_model), bf),
         3 * wh.n_layers, "audio"),
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
    by_model = {kind: zeros() for kind in ("moe", "ssm", "hybrid", "audio")}
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
                      f"norm untimed)", by_model["ssm"]),
                     (f"{zam.arch_id} ({2 * zam.n_layers + 2 * sites} calls;"
                      f" the final norm untimed)", by_model["hybrid"]),
                     (f"{wh.arch_id} ({2 * wh.enc_layers + 3 * wh.n_layers} "
                      f"calls; the final norm untimed)", by_model["audio"])):
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
    errs, shares, stats_errs = {}, {}, {}
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
            # the row statistics autograd's forward asks for: the same
            # output bits, and m and l against ref.attention_stats
            stats = torch.empty((2, b, hq, sq), device=DEVICE)
            again = kernel._launch(q, k, v, causal=causal, window=window,
                                   route=route, stats=stats)
            check(torch.equal(again, got), f"flash attention at {case} "
                                           f"{dt} with statistics changed "
                                           f"its output")
            m, l = ref.attention_stats(q, k, v, causal=causal, window=window)
            st_err = (float(((stats[0] - m).abs() / (1 + m.abs())).max()),
                      float(((stats[1] - l).abs() / l).max()))
            check(st_err[0] <= STATS_TOL[0] and st_err[1] <= STATS_TOL[1],
                  f"flash attention's statistics at {case} {dt}: m, l off "
                  f"by {st_err} (limits {STATS_TOL})")
            stats_errs[route] = tuple(max(a, c) for a, c in zip(
                stats_errs.get(route, (0.0, 0.0)), st_err))
            del stats, again, m, l
        check(routes == ({"wgmma"} if dt == torch.bfloat16 else {"simt"}),
              f"{dt} cases took the routes {routes}")
        routes_l = sorted(routes)
        limit = ("1e-4 + 2^-7 |plain| + 2^-7 plain(|v|)"
                 if dt == torch.bfloat16 else
                 f"{FA_TOL_F32:g} + {FA_TOL_F32:g} |plain|")
        log(f"(f) {len(FA_CASES)} cases in {str(dt)[6:]} on the "
            f"{routes.pop()} route (GQA groups 1/4/5/6/8/16, causal and not, "
            f"windows 32/64/128/256, Sq < Skv, Sq > Skv, ragged, D "
            f"64/112/128, whisper's non-causal shapes): max abs err "
            f"{errs[dt]:.3g}, largest share of the limit {limit} "
            f"{shares[dt]:.3g}; with the row statistics written, the same "
            f"output bits, and m and l within {stats_errs[routes_l[0]]} "
            f"(relative to 1 + |m| and to l) of ref.attention_stats")

    b, s = PREFILL_B, PREFILL_S
    hq, hkv, d = QWEN["hq"], QWEN["hkv"], QWEN["hd"]

    def heads(h, dt, d=d):
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

    # phase (l)'s zamba2-7b prefill shape, head dim 112 on the padded tile:
    # held against the plain version on one sequence, then timed in turns
    # with SDPA and beside the plain version
    zam = get_arch(ZAMBA_ARCH)
    hq, hkv, dz = zam.n_heads, zam.n_kv_heads, zam.hd
    q, k, v = (heads(h, torch.bfloat16, dz) for h in (hq, hkv, hkv))
    before = by_route["wgmma"]
    got = kernel.flash_attention(q, k, v)
    check(by_route["wgmma"] == before + 1,
          "zamba2's prefill shape did not take the tensor-core route")
    want = ref.attention(q[:1], k[:1], v[:1])
    z_share = limit_share(got[:1], want, fa_bf16_limit(q[:1], k[:1], v[:1],
                                                       want))
    check(z_share <= 1.0, f"flash attention != plain at q ({b},{hq},{s},"
                          f"{dz}): share of the limit {z_share}")
    del want
    # yardsticks in the same turns: the same call on contiguous
    # (B, H, S, 112) copies, and D 128 at zamba2's heads (the padded tile's
    # work with every column real)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    q8, k8, v8 = (heads(h, torch.bfloat16, 128) for h in (hq, hkv, hkv))
    z_runs = {
        "wgmma": lambda: kernel.flash_attention(q, k, v),
        "wgmma_contiguous": lambda: kernel.flash_attention(qc, kc, vc),
        "wgmma_d128": lambda: kernel.flash_attention(q8, k8, v8),
        "sdpa": lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True),
    }
    z_times = {name: [] for name in z_runs}
    for turn in range(2):
        for name, fn in z_runs.items():
            z_times[name].append(cuda_ms(fn, reps=FA_REPS)[0])
    zk_ms, zc_ms, z8_ms, zl_ms = (statistics.mean(z_times[n])
                                  for n in z_runs)
    del qc, kc, vc, q8, k8, v8

    def z_plain():
        for i in range(b):
            ref.attention(q[i:i + 1], k[i:i + 1], v[i:i + 1])
    zp_ms = cuda_ms(z_plain, reps=3, warm=1)[0]
    z_bytes, z_ops = attention_bound_ms(b, hq, s, s, dz, True, None, 2, hkv)
    z_bound = max(z_bytes, z_ops)
    log(f"(f) {zam.arch_id}'s prefill shape q ({b},{hq},{s},{dz}) bf16 "
        f"causal, D {dz} on the 128-column tile: largest share of the limit "
        f"on sequence 0 {z_share:.3g}; tensor-core kernel {zk_ms:.4f} ms "
        f"(turns {z_times['wgmma']}), share of the bound "
        f"{z_bound / zk_ms:.3f}, {zk_ms / zl_ms:.3f} x SDPA ({zl_ms:.4f} ms, "
        f"turns {z_times['sdpa']}); on contiguous (B, H, S, {dz}) copies "
        f"{zc_ms:.4f} ms; at D 128 with the same heads {z8_ms:.4f} ms "
        f"(D {dz} / D 128 {zk_ms / z8_ms:.3f}); plain {zp_ms:.3f} ms ({b} "
        f"calls at B=1); bound {z_bound:.4f} ms (operations at the true D "
        f"{dz}; bytes {z_bytes:.4f} ms)")
    del q, k, v, got

    # phase (l)'s whisper-large-v3 shapes, in turns with SDPA
    whisper = {}
    for name, (wb, wh, sq, skv, wd, causal) in FA_WHISPER.items():
        q = randn(gen, (wb, wh, sq, wd), torch.bfloat16)
        k, v = (randn(gen, (wb, wh, skv, wd), torch.bfloat16) for _ in "kv")
        w_times = {"wgmma": [], "sdpa": []}
        for turn in range(2):
            w_times["wgmma"].append(cuda_ms(lambda: kernel.flash_attention(
                q, k, v, causal=causal), reps=FA_REPS)[0])
            w_times["sdpa"].append(cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal), reps=FA_REPS)[0])
        wk_ms, wl_ms = (statistics.mean(w_times[n])
                        for n in ("wgmma", "sdpa"))
        w_bytes, w_ops = attention_bound_ms(wb, wh, sq, skv, wd, causal,
                                            None, 2, wh)
        whisper[name] = dict(
            shape=f"q ({wb},{wh},{sq},{wd}), k/v ({wb},{wh},{skv},{wd})"
                  + (" causal" if causal else ""),
            ms=wk_ms, library_ms=wl_ms, bound_ms=max(w_bytes, w_ops),
            bound_by="operations" if w_ops >= w_bytes else "bytes")
        log(f"(f) {WHISPER_ARCH}'s {name}, {whisper[name]['shape']} bf16: "
            f"tensor-core kernel {wk_ms:.4f} ms (turns {w_times['wgmma']}), "
            f"{wk_ms / wl_ms:.3f} x SDPA ({wl_ms:.4f} ms, turns "
            f"{w_times['sdpa']}); bound {max(w_bytes, w_ops):.4f} ms "
            f"({whisper[name]['bound_by']}), share "
            f"{max(w_bytes, w_ops) / wk_ms:.3f}")
        del q, k, v
    return dict(ms=k_ms, simt_ms=simt_ms, plain_ms=p_ms, library_ms=l_ms,
                bound_ms=b_ms, ratio_to_library=k_ms / l_ms,
                bound_by="operations" if op_ms >= byte_ms else "bytes",
                ms_turns=times, moe_shape=dict(
                    ms=mk_ms, library_ms=ml_ms, bound_ms=m_bound,
                    share_of_limit=share), zamba2_shape=dict(
                    ms=zk_ms, library_ms=zl_ms, plain_ms=zp_ms,
                    bound_ms=z_bound, share_of_limit=z_share,
                    ms_contiguous=zc_ms, ms_d128_same_heads=z8_ms,
                    ms_turns=z_times),
                whisper_shapes=whisper, max_stats_err=stats_errs), errs, \
        shares


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
    """Launches per kernel, flash attention's per route under
    "flash_attention_by_route", and its launches that wrote the row
    statistics under "flash_attention_with_stats"."""
    from repro_torch.kernels.flash_attention import kernel as fa
    out = {name: getattr(m, LAUNCHER[name]).launches
           for name, m in kernel_modules().items()}
    out["flash_attention_by_route"] = dict(
        fa.flash_attention.launches_by_route)
    out["flash_attention_with_stats"] = fa.flash_attention.stats_launches
    return out


def reset_counts() -> None:
    from repro_torch.kernels.flash_attention import kernel as fa
    for name, m in kernel_modules().items():
        getattr(m, LAUNCHER[name]).launches = 0
    for route in fa.flash_attention.launches_by_route:
        fa.flash_attention.launches_by_route[route] = 0
    fa.flash_attention.stats_launches = 0


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
            out.append(reading(key, label, got, want, run, prefix, fault))
            del want
    return out


def reading(key, label, got, want, run: str, prefix: str, fault=None):
    """One logits comparison, printed → (key, run, fault, max abs err)."""
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    top1 = float((g.argmax(-1) == w.argmax(-1)).float().mean())
    log(f"{prefix}: {label}" + (f", fault '{fault}'" if fault else "")
        + f": max abs err {err:.4g}, logit scale (max |ref|) "
        f"{float(w.abs().max()):.3g}, same top-1 token at "
        f"{top1:.3f} of positions")
    return key, run, fault, err


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
    check(launches["flash_attention_with_stats"] == 0,
          f"serving launched {launches['flash_attention_with_stats']} "
          f"forwards that wrote row statistics")
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

# ----------------------------------------------- (l) hybrid and audio
# zamba2-7b and whisper-large-v3 whole, in phase (k)'s manner
ZAMBA_ARCH, WHISPER_ARCH = "zamba2-7b", "whisper-large-v3"
# whisper's prefill: the encoder's 30-second window of 1500 frames (the
# reference's enc_len) and the decoder's published text context of 448
WHISPER_FRAMES, WHISPER_TOKENS = 1500, 448
# zamba2's agreement run: a prompt of 224 and 32 generated tokens make 256,
# one SSD chunk (the forward side needs S a multiple of 256)
ZAMBA_AGREE_PROMPT = 224
# zamba2's float32 agreement model: full width, 12 of its 81 layers, so two
# attention sites (after layers 0 and 6)
ZAMBA_F32_LAYERS = 12
# zamba2's kernel-vs-plain check reads one sequence of this many tokens: at
# 1024 the planted 64-key fault read 2.73 against clean readings of 1.66
# and 1.02 on an H100; over 256 it drops a quarter of the last row's keys
ZAMBA_AGREE_S = 256
# limits of phase (l)'s agreement checks, each between the clean readings
# at two bfloat16 weight seeds and the smallest planted fault's (PERF.md,
# section 6).  On an H100 zamba2 read 1.41 and 1.54 (decode vs prefill),
# 2.14 and 1.97 (decode vs forward), 1.53 and 1.37 (kernel vs plain
# attention over ZAMBA_AGREE_S tokens) against faults of at least 4.84,
# 5.47 and 4.53; whisper 0.70 and 0.91, 1.04 and 1.07, and 1.95 and 2.10
# (kernel vs plain attention over 448 tokens and 1500 frames) against at
# least 6.44, 7.94 and 5.59.  These random-weight stacks are deep (81 Mamba2 layers;
# 32 + 32 layers over 1500 random frames) and magnify a bfloat16 rounding
# as mamba2 does: their float32 readings, 1e-4 to 5e-4, are 10 to 30
# times qwen3-14b's.  Each limit sits near the geometric mean of the
# larger clean reading and the smallest fault's
AGREE_TOL_K["hybrid"] = {"decode_vs_prefill": 2.75, "decode_vs_forward": 3.5,
                         "kernel_vs_plain_attention": 2.5}
AGREE_TOL_K["audio"] = {"decode_vs_prefill": 2.0, "decode_vs_forward": 2.5,
                        "kernel_vs_plain_attention": 3.5}
# in float32 zamba2 at 12 layers read 1.8e-04, 3.3e-04 and 6.5e-05 and
# whisper 1.2e-04, 1.7e-04 and 4.5e-04 on an H100, against faults of 0.29
# and more
AGREE_TOL_K_F32["hybrid"] = {"decode_vs_prefill": 1e-2,
                             "decode_vs_forward": 1e-2,
                             "kernel_vs_plain_attention": 1e-2}
AGREE_TOL_K_F32["audio"] = {"decode_vs_prefill": 1e-2,
                            "decode_vs_forward": 1e-2,
                            "kernel_vs_plain_attention": 1e-2}


def family_faults(kind: str):
    """name → (module, attribute, faulty stand-in) planted into the side
    of a comparison that runs ``forward_train``: for the moe family the
    attention faults of phase (g) and the expert map shifted by one expert
    (expert e's products end with e - 1's down projection); for the ssm
    family the SSD's decay rates dropped (``A_log`` read as A, a slip that
    keeps every state forever), and the causal conv's taps reversed.  (The
    state carried between chunks is no use as a fault here: with the
    initial ``A_log`` of 0 a state decays by about exp(-0.7) a token, so
    nothing of it is left after a 256-token chunk.)  For the hybrid family
    the shared block run after the wrong layers (``i % attn_every == 1``)
    and the last keys dropped from its attention; for the audio family a
    causal encoder."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import layers, mamba2, moe, zamba2
    if kind == "hybrid":
        def wrong_sites(self, i):
            every = self.cfg.attn_every
            return i // every if i % every == 1 else None
        dropped = f"last {FAULT_KEYS} keys dropped"
        return {"shared block after the wrong layers (i % attn_every == 1)":
                (zamba2.HybridLM, "attn_site", wrong_sites),
                dropped: (fa_ops, "attention", planted_faults()[dropped])}
    if kind == "audio":
        real_attention = layers.attention

        def causal_encoder(p, x, cfg, *, pos, causal=True, attn_impl=None,
                           memory=None):
            return real_attention(p, x, cfg, pos=pos,
                                  causal=causal or memory is None,
                                  attn_impl=attn_impl, memory=memory)
        return {"causal encoder": (layers, "attention", causal_encoder)}
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


def decode_faults(kind: str, model, params, frames):
    """name → a context in which the serve loop runs with a fault planted in
    the decode side: for the hybrid family each site but the first reading
    and writing the KV of the site before it; for the audio family the
    cross-attention KV of decoder layer l computed with layer l + 1's
    projections."""
    from unittest import mock
    from repro_torch.models import zamba2
    if kind == "hybrid":
        def neighbour_kv(self, i):
            every = self.cfg.attn_every
            return max(i // every - 1, 0) if i % every == 0 else None
        return {"decode reads the neighbouring site's KV":
                lambda: mock.patch.object(zamba2.HybridLM, "attn_site",
                                          neighbour_kv)}
    return {"cross-KV of layer l from layer l + 1":
            lambda: cross_kv_filled(model, params, frames, shift=1)}


def cross_kv_filled(model, params, frames, shift: int = 0):
    """A context in which ``model.init_cache`` (whisper's) fills the
    cross-attention KV from the encoder's memory of ``frames``, through each
    decoder layer's own ``xattn.wk``/``wv``: the keys and values
    ``layers.attention(memory=)`` computes.  Harness code, not a model
    feature: the model's cache starts as zeros, as in the JAX package.
    ``shift`` 1 plants a fault: layer l takes layer l + 1's projections."""
    from unittest import mock
    import torch
    from repro_torch.models.transformer import layer_params
    cfg = model.cfg
    real = model.init_cache
    with torch.inference_mode():
        memory = model.encode(params, frames)
    b, e, _ = memory.shape

    def init_cache(batch, seq, dtype=None, device=None):
        cache = real(batch, seq, dtype, enc_len=e, device=device)
        for i in range(cfg.n_layers):
            xp = layer_params(params["dec"],
                              (i + shift) % cfg.n_layers)["xattn"]
            for name, w in (("xk", xp["wk"]), ("xv", xp["wv"])):
                cache[name][i] = (memory @ w).view(
                    b, e, cfg.n_kv_heads, cfg.hd).transpose(1, 2)
        return cache
    return mock.patch.object(model, "init_cache", init_cache)


def family_readings(kind: str, model, params, one, run: str,
                    faults: bool = False):
    """Phase (k)'s three logits comparisons for one set of weights →
    [(check, run, fault or None, max abs err)], each printed.  moe: the
    serve loop at the no-drop capacity factor against the prefill step and
    ``forward_train``, and the flash kernel against ``attn_impl="ref"``;
    ssm: the serve loop over 512 tokens against the prefill step and
    ``forward_train`` over them, and the RMSNorm kernel against its plain
    version; hybrid: the serve loop over 256 tokens against the prefill
    step and ``forward_train`` over them, and the flash kernel against
    ``attn_impl="ref"``; audio: the serve loop with the cross-attention KV
    filled from the encoder (``cross_kv_filled``) against the prefill step
    and ``forward_train`` on the same frames, and the flash kernel against
    ``attn_impl="ref"``.  ``one`` is the batch (``tokens``, and
    ``input_embeds`` for audio) of the kernel check.  With ``faults`` the
    decode side of the first two checks is also read again under each of
    :func:`decode_faults`, fed the clean run's tokens."""
    from functools import partial
    from unittest import mock
    import numpy as np
    import torch
    from repro_torch.kernels.rmsnorm import kernel as rn
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models import layers
    from repro_torch.models.registry import build_model
    from repro_torch.train.step import make_prefill_step

    cfg, dev = model.cfg, one["tokens"].device
    rng = np.random.default_rng(5)

    def kernel_forward(m):
        return m.forward_train(params, one["tokens"], one.get("input_embeds"),
                               last_only=True)
    decode_runs, prefix = {}, f"(k) {cfg.arch_id} {run}"
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
                    f"forward_train(last_only) B=1 S={one['tokens'].shape[1]},"
                    f" flash kernel vs attn_impl='ref'",
                    kernel_forward(model), lambda: kernel_forward(plain)),
            }
        elif kind == "ssm":
            prompt = rng.integers(0, cfg.vocab,
                                  (SERVE_B, MAMBA_AGREE_PROMPT))
            res = serve_loop(model, params, prompt, SERVE_GEN)
            full = torch.cat([torch.from_numpy(prompt).to(dev), res.tokens],
                             dim=1)
            s = full.shape[1]
            plain_norm = partial(rn.rmsnorm, impl="ref")

            def plain_forward():
                with mock.patch.object(layers, "rmsnorm", plain_norm):
                    return kernel_forward(model)
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
                    f"forward_train(last_only) B=1 S={one['tokens'].shape[1]},"
                    f" RMSNorm kernel vs its plain version",
                    kernel_forward(model), plain_forward),
            }
        else:
            prefix = f"(l) {cfg.arch_id} {run}"
            plain = build_model(cfg, attn_impl="ref")
            n = ZAMBA_AGREE_PROMPT if kind == "hybrid" else SERVE_PROMPT
            prompt = rng.integers(0, cfg.vocab, (SERVE_B, n))
            p = torch.from_numpy(prompt).to(dev)
            if kind == "hybrid":
                def decoded(ctx=None, pick=None):
                    with ctx or contextlib.nullcontext():
                        return serve_loop(model, params, prompt, SERVE_GEN,
                                          **({"pick": pick} if pick else {}))
                extra, at = {}, n + SERVE_GEN - 1
            else:
                frames = torch.from_numpy(rng.standard_normal(
                    (SERVE_B, WHISPER_FRAMES, cfg.d_model)).astype(
                        np.float32)).to(dev)

                def decoded(ctx=None, pick=None):
                    with ctx or cross_kv_filled(model, params, frames):
                        return serve_loop(model, params, prompt, SERVE_GEN,
                                          **({"pick": pick} if pick else {}))
                extra, at = {"input_embeds": frames}, n - 1
            res = decoded()
            full = torch.cat([p, res.tokens], dim=1)
            s = full.shape[1]
            # the decode side as a function of a serve loop's result, and
            # the side it is held against
            sides = {
                "decode_vs_prefill": (
                    f"decode vs make_prefill_step over {at + 1} tokens at "
                    f"position {at}", lambda r: r.logits[at],
                    lambda: make_prefill_step(model)(
                        params, {"tokens": full[:, :at + 1], **extra})),
                "decode_vs_forward": (
                    f"decode vs forward_train over {s} tokens at positions "
                    f"{n - 1}..{s - 1}",
                    lambda r: r.logits[n - 1:s].transpose(0, 1),
                    lambda: model.forward_train(params, full,
                                                extra.get("input_embeds")
                                                )[:, n - 1:]),
            }
            checks = {key: (label, got(res), want)
                      for key, (label, got, want) in sides.items()}
            checks["kernel_vs_plain_attention"] = (
                f"forward_train(last_only) B=1 S={one['tokens'].shape[1]}"
                + (f" with {one['input_embeds'].shape[1]} frames"
                   if "input_embeds" in one else "")
                + ", flash kernel vs attn_impl='ref'",
                kernel_forward(model), lambda: kernel_forward(plain))
            if faults:
                forced = res.tokens
                for fault, ctx in decode_faults(
                        kind, model, params,
                        extra.get("input_embeds")).items():
                    decode_runs[fault] = (decoded(
                        ctx(), pick=lambda logits, i: forced[:, i]), sides)
        out = read_checks(checks, family_faults(kind) if faults else {},
                          run, prefix)
        for fault, (r, sides) in decode_runs.items():
            for key, (label, got, want) in sides.items():
                out.append(reading(key, label, got(r), want(), run, prefix,
                                   fault))
        return out


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


def family_config(kind: str):
    """→ (config, how it was cut) of the model phase (k) or (l) runs for
    ``kind``."""
    from repro_torch.configs.registry import get_arch
    if kind == "moe":
        full = get_arch(MOE_ARCH)
        return (dataclasses.replace(full, n_layers=MOE_LAYERS),
                f"{MOE_LAYERS} of its {full.n_layers} layers, every width as "
                f"published")
    arch = {"ssm": MAMBA_ARCH, "hybrid": ZAMBA_ARCH,
            "audio": WHISPER_ARCH}[kind]
    return get_arch(arch), "whole: every layer and width"


def family_launches(kind: str, cfg):
    """→ (flash-attention launches of a prefill step, of a decode step,
    RMSNorm launches of a prefill step, of a decode step)."""
    n = cfg.n_layers
    if kind == "moe":
        return n, 0, 4 * n + 1, 4 * n + 1
    if kind == "ssm":
        return 0, 0, 2 * n + 1, 2 * n + 1
    if kind == "hybrid":
        # Mamba's layer norm and gated norm, and ln1/ln2 at every site
        sites = -(-n // cfg.attn_every)
        return sites, 0, 2 * n + 2 * sites + 1, 2 * n + 2 * sites + 1
    # audio: the encoder's self-attention, the decoder's self- and
    # cross-attention; a decode step's cross-attention is the kernel
    e = cfg.enc_layers
    return e + 2 * n, n, 2 * e + 3 * n + 1, 3 * n + 1


def family_shape(kind: str, cfg) -> str:
    if kind == "moe":
        return (f"heads {cfg.n_heads}/{cfg.n_kv_heads} x {cfg.hd}, "
                f"{cfg.n_experts} experts of d_ff {cfg.moe_d_ff}, top "
                f"{cfg.top_k}, capacity factor {cfg.capacity_factor:g}")
    ssm = (f"d_inner {cfg.ssm_expand * cfg.d_model}, state {cfg.ssm_state}, "
           f"head dim {cfg.ssm_head_dim}, chunk {cfg.ssm_chunk}")
    if kind == "ssm":
        return ssm
    attn = f"heads {cfg.n_heads}/{cfg.n_kv_heads} x {cfg.hd}, d_ff {cfg.d_ff}"
    if kind == "hybrid":
        return (f"{cfg.n_layers} layers, {ssm}, a shared block ({attn}) "
                f"after layer i when i % {cfg.attn_every} == 0")
    return f"{cfg.enc_layers} + {cfg.n_layers} layers, {attn}"


def phase_family(kind: str, card: str):
    """(k) and (l) one family at full width on the card: a prefill step and
    the serve loop (the main path, launches counted), times, a profile, the
    peak memory and the agreement checks at two weight seeds."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models.registry import build_model
    from repro_torch.train.step import make_prefill_step, make_serve_step

    dev = torch.device(DEVICE)
    phase = "(k)" if kind in ("moe", "ssm") else "(l)"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, cut = family_config(kind)
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

    def n_bytes(tree):
        return sum(t.numel() * t.element_size() for t in leaves(tree))
    n_params = sum(t.numel() for t in leaves(params))
    w_bytes = n_bytes(params)
    tag = f"{phase} {cfg.arch_id}"
    log(f"{tag}, {cut}: d {cfg.d_model}, vocab {cfg.vocab_padded}, "
        f"{family_shape(kind, cfg)}: {n_params / 1e9:.3f} B parameters, "
        f"{w_bytes / 1e9:.2f} GB, drawn in {init_s:.1f} s")

    rng = np.random.default_rng(0)
    b, s = PREFILL_B, WHISPER_TOKENS if kind == "audio" else PREFILL_S
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab, (b, s)).astype(np.int64)).to(dev)
    batch = {"tokens": tokens}
    if kind == "audio":
        batch["input_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, WHISPER_FRAMES, cfg.d_model)).astype(np.float32)).to(dev)
    prompt = rng.integers(0, cfg.vocab, (SERVE_B, SERVE_PROMPT)
                          ).astype(np.int64)
    prefill_step = make_prefill_step(model)

    # ---- the main path: counts set to 0 just before, read just after
    reset_counts()
    logits = prefill_step(params, batch)
    torch.cuda.synchronize()
    per_prefill = counts()
    res = serve_loop(model, params, prompt, SERVE_GEN)
    launches = counts()
    # ----
    n_steps = SERVE_PROMPT + SERVE_GEN
    serve_counts = {k: launches[k] - per_prefill[k] for k in LAUNCHER}
    serve_routes = {r: launches["flash_attention_by_route"][r]
                    - per_prefill["flash_attention_by_route"][r]
                    for r in per_prefill["flash_attention_by_route"]}
    log(f"{tag} launches in one prefill step: {per_prefill}; in the serve "
        f"loop ({n_steps} decode steps): {serve_counts}, flash attention by "
        f"route {serve_routes}")
    n_attn, n_attn_decode, n_norm, n_norm_decode = family_launches(kind, cfg)
    check(launches["flash_attention_with_stats"] == 0,
          f"{cfg.arch_id} served with "
          f"{launches['flash_attention_with_stats']} forwards that wrote row "
          f"statistics")
    check(per_prefill["flash_attention_by_route"]
          == {"wgmma": n_attn, "simt": 0}
          and per_prefill["flash_attention"] == n_attn,
          f"{cfg.arch_id} prefill's flash-attention launches "
          f"{per_prefill['flash_attention_by_route']}, not {n_attn} on the "
          f"tensor-core route")
    check(per_prefill["rmsnorm"] == n_norm,
          f"{cfg.arch_id} prefill launched RMSNorm {per_prefill['rmsnorm']} "
          f"times, not {n_norm}")
    check(serve_counts["rmsnorm"] == n_norm_decode * n_steps
          and serve_counts["flash_attention"] == n_attn_decode * n_steps
          and serve_routes["simt"] == 0,
          f"{cfg.arch_id} serve loop launches {serve_counts}, by route "
          f"{serve_routes}")
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

    pre_ms, pre_lo, pre_hi = cuda_ms(lambda: prefill_step(params, batch),
                                     reps=3, warm=1)
    decode_ms = res.decode_s / SERVE_GEN * 1e3
    # a decode step reads every weight but the embedding table (and, for
    # the audio family, the encoder's), and its cache
    step_bytes = w_bytes - params["lm"]["embed"].numel() * 2 \
        - (n_bytes(params["enc"]) if kind == "audio" else 0)
    cache_bytes = n_bytes(model.init_cache(SERVE_B, n_steps, device="meta"))
    read_ms = step_bytes / MEM_BYTES_PER_S * 1e3
    cache_ms = cache_bytes / MEM_BYTES_PER_S * 1e3
    frames = (f" and {b * WHISPER_FRAMES} frames" if kind == "audio"
              else "")
    log(f"{tag} prefill step B={b} S={s}{frames}: {pre_ms:.1f} ms median "
        f"of 3 ({pre_lo:.1f}-{pre_hi:.1f}), {b * s / pre_ms * 1e3:.0f} "
        f"tokens/s; {card}")
    log(f"{tag} serve B={SERVE_B} prompt {SERVE_PROMPT} gen "
        f"{SERVE_GEN} greedy: token-recurrent prefill "
        f"{res.prefill_s * 1e3:.1f} ms ({res.prefill_s / SERVE_PROMPT * 1e3:.2f}"
        f" ms/step); decode {decode_ms:.2f} ms/step, "
        f"{SERVE_B * SERVE_GEN / res.decode_s:.1f} tokens/s; reading every "
        f"weight a decode step uses once takes {read_ms:.2f} ms and its "
        f"cache {cache_ms:.2f} ms (share of the bound "
        f"{(read_ms + cache_ms) / decode_ms:.3f}); {card}")

    serve_step = make_serve_step(model)
    cache = model.init_cache(SERVE_B, n_steps, device=dev)
    step_tok = torch.from_numpy(prompt[:, :1]).to(dev)
    synced = decode_syncs(serve_step, params, cache, step_tok, 0)
    log(f"{tag} one decode step under torch's sync debug mode: "
        + (f"a host sync: {synced}" if synced else "no host sync"))
    check(not synced, f"{cfg.arch_id} decode synchronised with the host")
    windows = (
        ("prefill step", 1, lambda i: prefill_step(params, batch)),
        ("decode step", 3, lambda i: serve_step(params, cache, step_tok,
                                                i + 1)))
    breakdown = {}
    for name, n, fn in windows:
        wall, busy, n_kernels, top = profile_window(
            fn, n, OUT / f"{kind}_{name.replace(' ', '_')}_trace.json")
        if busy is None:
            log(f"{tag} {name}: the profiler's trace holds no kernel; "
                f"device time not measured")
            continue
        breakdown[name] = dict(host_ms=wall / n, busy_ms=busy / n,
                               idle=1 - busy / wall)
        log(f"{tag} {name}, profiled: host {wall / n:.1f} ms, "
            f"device busy {busy / n:.1f} ms per step, idle share "
            f"{1 - busy / wall:.2f}, {n_kernels / n:.0f} kernels per step; "
            f"largest kernels per step: " + "; ".join(
                f"{k} {ms / n:.2f} ms" for k, ms in top))
    del cache

    # ---- agreement at two bfloat16 weight seeds and in float32, planted
    # faults at the first and in float32; every reading is printed before
    # any is checked
    n_one = {"moe": MOE_AGREE_S, "hybrid": ZAMBA_AGREE_S,
             "audio": WHISPER_TOKENS}.get(kind, AGREE_S)
    one = {key: val[:1, :n_one] if key == "tokens" else val[:1]
           for key, val in batch.items()}
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
    log(f"{tag} peak device memory {peak / 1e9:.2f} GB allocated, "
        f"{reserved / 1e9:.2f} GB reserved of {total / 1e9:.2f} GB: "
        f"{free_gb:.2f} GB free at the peak; {card}")
    check(free_gb >= FREE_GB, f"{cfg.arch_id} leaves {free_gb:.2f} GB free, "
                              f"under {FREE_GB:g}")

    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    f32_layers = {"moe": MOE_F32_LAYERS, "hybrid": ZAMBA_F32_LAYERS}
    if kind in f32_layers:
        cfg32 = dataclasses.replace(cfg32, n_layers=f32_layers[kind])
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
            f"{tag} {'float32' if f32 else 'bf16'}"))
    torch.cuda.empty_cache()
    return launches, dict(
        prefill_ms=pre_ms, prefill_tokens_per_s=b * s / pre_ms * 1e3,
        decode_ms=decode_ms, decode_bound_ms=read_ms + cache_ms,
        peak_gb=peak / 1e9, free_gb=free_gb, host_sync=synced or None,
        profile=breakdown, agreement_max_abs_err=errors)


# ---------------------------------------------------------------- phase (n)
TRAIN_ARCH = "qwen3-14b"
# layers kept of qwen3-14b's 40 for training on one card: the deepest cut
# that leaves FREE_GB of the card free at the training loop's peak
# (reserved), read with benchmarks/torch_family_depth.py --family train
# --no-checkpoint (on an H100: 12 layers 9.71 GB free, 13 layers 5.01)
TRAIN_LAYERS = 12
# the cut the checkpoint and the restart run at: the train state is 10
# bytes a parameter (bf16 parameters, float32 mu and nu), 22.2 GB at 2
# layers (42.0 GB at 8 took 136 s to write and restore, a seventh of the
# script; the machine the card sits in takes at most 45 GiB of writes to
# its disk in a run)
TRAIN_CKPT_LAYERS = 2
# the cut the agreement runs at, where its limits (TRAIN_TOL) were read
TRAIN_AGREE_LAYERS = 8
TRAIN_B, TRAIN_S = 2, 2048
# the loop's steps, the step whose checkpoint the run restarts from, the
# schedule's warmup, and the step that runs under the profiler
TRAIN_STEPS, TRAIN_CKPT_STEP, TRAIN_WARMUP, TRAIN_PROFILE_STEP = 6, 3, 2, 4
TRAIN_LR = 3e-4
# where the checkpoint goes (gitignored); None skips the checkpoint run
# (benchmarks/torch_family_depth.py --no-checkpoint)
TRAIN_CKPT_DIR = ROOT / "build" / "chip_smoke_train_ckpt"
# a backward kernel against its plain version: max |kernel - plain| over
# max |plain| of each gradient.  In float32 the two differ only in the
# order of their float32 sums; in bfloat16 both sum in float32 and round
# once, so they may differ by one rounding of the largest value, 2^-8,
# allowed twice over
BWD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
# the tensor-core attention backward against the plain one (and autograd),
# elementwise: |kernel - plain| <= a max|plain| + r |plain| + ra plain(|.|).
# Beside the output's rounding to bfloat16 (r: 2^-8, twice over), it rounds
# P and dS to bfloat16 as the A operands of dv = P^T do, dk = scale dS^T q
# and dq = scale dS k (the products of bfloat16 values are exact in
# float32): unit roundoff 2^-8 moves a gradient by at most 2^-8 times the
# same product over absolute values, plain(|.|) = (P^T |do|, scale
# |dS|^T |q|, scale |dS| |k|).  Against autograd, whose Di = rowsum(do o)
# takes the unrounded float32 output, Di moves by up to 2^-8 rowsum(|do|
# |o|), so |dS| there counts P rowsum(|do| |o|) beside itself.  ra allows
# both with the factor 2 of margin the forward's limit has; a covers the
# float32 sums' order near 0.  The normwise 2^-7 of max |plain| held the
# SIMT backward, whose only bfloat16 rounding is the output's; the
# tensor-core one reads up to 7.7e-3 of max |plain| there, at the edge of
# it.  On an H100 the clean cases read at most 0.47 of this limit and the
# planted faults at least 40 times it.
BWD_TC_LIMIT = (1e-5, 2.0 ** -7, 2.0 ** -7)
# (b, hq, hkv, sq, skv, d, causal, window, dtype): qwen3-14b's training
# shape, then a small case of every other path the forwards take; bfloat16
# at D 64, 112 and 128 on the tensor-core route, the rest on the SIMT one
FA_BWD_CASES = (
    (2, 40, 8, 2048, 2048, 128, True, None, "bfloat16"),  # the training step
    (1, 40, 8, 1024, 1024, 128, True, 128, "bfloat16"),   # window
    (1, 40, 8, 300, 100, 128, True, None, "bfloat16"),    # rows seeing no key
    (4, 20, 20, 448, 1500, 64, False, None, "bfloat16"),  # whisper's cross
    (1, 32, 32, 300, 300, 112, True, None, "bfloat16"),   # D 112, group 1
    (1, 64, 4, 256, 256, 128, True, None, "bfloat16"),    # group 16
    (1, 8, 2, 200, 330, 64, True, 64, "bfloat16"),        # D 64, window
    (1, 16, 16, 200, 130, 112, True, None, "bfloat16"),   # D 112, no key
    (1, 16, 8, 130, 130, 32, False, 40, "bfloat16"),      # D 32, window
    (1, 8, 2, 200, 330, 128, True, 64, "float32"),        # window, Sq < Skv
    (1, 6, 2, 130, 70, 64, True, None, "float32"),        # rows seeing no key
    (1, 4, 4, 100, 100, 16, False, None, "float32"),      # D 16
    (1, 4, 4, 64, 64, 112, True, None, "float32"),        # D 112
)


def bwd_error(got, want) -> float:
    """max |got - want| / max(1e-30, max |want|); inf where got is not
    finite."""
    import torch
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        return float("inf")
    return float((g - w).abs().max()) / max(1e-30, float(w.abs().max()))


def abs_error(pairs) -> float:
    """The largest max |got - want| over (got, want) pairs."""
    return max(float((g.float() - w.float()).abs().max()) for g, w in pairs)


def attention_bwd_bound_ms(b, hq, hkv, sq, skv, d, causal, window,
                           itemsize):
    """→ (ms to read q, k, v, o, do and the forward's row statistics and
    write dq, dk and dv once, ms for the backward's five products — S, dP,
    dq, dk, dv — of 2 D operations per visible (query, key) pair at the
    bfloat16 tensor-core rate)."""
    # the forward's bound: q, k, v and out once, 4 D operations a pair
    fwd_bytes, fwd_ops = attention_bound_ms(b, hq, sq, skv, d, causal,
                                            window, itemsize, hkv)
    stats_ms = 2 * b * hq * sq * 4 / MEM_BYTES_PER_S * 1e3
    return 2 * fwd_bytes + stats_ms, fwd_ops * 10 / 4


def bwd_tc_limits(q, k, v, o, do, want, causal, window):
    """BWD_TC_LIMIT for the tensor-core backward against ``want`` (the
    plain backward's or autograd's (dq, dk, dv)), elementwise."""
    import torch
    from repro_torch.kernels.flash_attention import ref
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    g, scale = hq // hkv, d ** -0.5
    logits, _, mask = ref._masked_logits(q, k, causal, window, None)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p /= p.sum(dim=-1, keepdim=True)
    del logits
    dof, of = (t.float().reshape(b, hkv, g, sq, d) for t in (do, o))
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, v.float())
    di = (dof * of).sum(-1, keepdim=True)
    di_abs = (dof.abs() * of.abs()).sum(-1, keepdim=True)
    ds_abs = torch.where(mask, p * (dp - di), 0.0).abs_()
    ds_abs += torch.where(mask, p * di_abs, 0.0)
    del dp
    absq, absk = q.float().abs().reshape(b, hkv, g, sq, d), k.float().abs()
    plain_abs = (
        scale * torch.einsum("bhgqk,bhkd->bhgqd", ds_abs, absk).reshape(
            b, hq, sq, d),
        scale * torch.einsum("bhgqk,bhgqd->bhkd", ds_abs, absq),
        torch.einsum("bhgqk,bhgqd->bhkd", p, dof.abs()))
    a, r, ra = BWD_TC_LIMIT
    return [a * float(w.float().abs().max()) + r * w.float().abs() + ra * pa
            for w, pa in zip(want, plain_abs)]


def limit_shares(got, want, limits):
    """The largest |got - want| / limit of each gradient."""
    return [limit_share(g, w, lim) for g, w, lim in zip(got, want, limits)]


def train_bwd_cases(gen, n_layers: int):
    """The RMSNorm rows of one qwen3-14b training step, as (name, x, dy,
    calls a step): ln1/ln2 and the final norm over (B*S, 5120), q_norm's
    and k_norm's heads views of the projections."""
    import torch
    bf = torch.bfloat16
    d, hd, hq, hkv = QWEN["d"], QWEN["hd"], QWEN["hq"], QWEN["hkv"]
    b, s = TRAIN_B, TRAIN_S
    return [
        ("ln1/ln2/final (B*S, 5120)", randn(gen, (b, s, d), bf),
         randn(gen, (b, s, d), bf), 2 * n_layers + 1),
        ("q_norm, heads view (B, 40, S, 128)",
         randn(gen, (b, s, hq, hd), bf).transpose(1, 2),
         randn(gen, (b, hq, s, hd), bf), n_layers),
        ("k_norm, heads view (B, 8, S, 128)",
         randn(gen, (b, s, hkv, hd), bf).transpose(1, 2),
         randn(gen, (b, hkv, s, hd), bf), n_layers),
    ]


def phase_backward_kernels():
    """(n1) the two backward kernels against their plain versions (and
    autograd through the plain forwards), twice for determinism, then
    timed at qwen3-14b's training shapes beside the plain versions and
    autograd through the library calls."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.rmsnorm import ref as rref

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    # (kernel, dtype name, "rel" or "abs") → the largest error against the
    # plain backward
    worst = {}

    def note(kind, dtype, err, tol, what):
        key = (kind, str(dtype).removeprefix("torch."), "rel")
        worst[key] = max(worst.get(key, 0.0), err)
        check(err <= tol, f"{what}: {err} > {tol}")

    def note_abs(kind, dtype, pairs):
        key = (kind, str(dtype).removeprefix("torch."), "abs")
        worst[key] = max(worst.get(key, 0.0), abs_error(pairs))

    # ---- RMSNorm: the training rows, then f32, unaligned, wide and ragged
    cases = [(name, x, dy) for name, x, dy, _ in train_bwd_cases(gen, 1)]
    cases += [(f"{tuple(shape)} {dt}", randn(gen, shape, dt),
               randn(gen, shape, dt), )
              for shape, dt in (((4096, 5120), torch.float32),
                                ((33, 7168), torch.float32),
                                ((6, 37), torch.float32),
                                ((5, 20000), torch.float32),
                                ((3, 7, 1280), torch.bfloat16))]
    rms_faults = {}         # planted fault → its smallest error
    for name, x, dy in cases:
        dt = x.dtype
        tol = tol_of(BWD_TOL, dt)
        w = randn(gen, (x.shape[-1],), dt)
        dx, dw = rk.rmsnorm_bwd(x, w, dy)
        dx2, dw2 = rk.rmsnorm_bwd(x, w, dy)
        check(torch.equal(dx, dx2) and torch.equal(dw, dw2),
              f"RMSNorm backward {name}: two runs differ")
        check(dx.stride() == rk.grad_like(x).stride(),
              f"RMSNorm backward {name}: dx strides {dx.stride()}, x's "
              f"{x.stride()}")
        rx, rw = rref.rmsnorm_bwd(x, w, dy)
        xa, wa = (t.detach().requires_grad_() for t in (x, w))
        ax, aw = torch.autograd.grad(rref.rmsnorm(xa, wa), (xa, wa), dy)
        errs = [bwd_error(dx, rx), bwd_error(dw, rw), bwd_error(dx, ax),
                bwd_error(dw, aw)]
        for err, what in zip(errs, ("dx vs rmsnorm_bwd", "dw vs rmsnorm_bwd",
                                    "dx vs autograd", "dw vs autograd")):
            note("rmsnorm", dt, err, tol, f"RMSNorm backward {name} {what}")
        note_abs("rmsnorm", dt, ((dx, rx), (dw, rw)))
        # the ring kernel's planted faults: each beyond the limit
        plan = rk.bwd_plan(x.shape[-1], dt,
                           rk.bwd_operands(x, dy, w, dw)[3])
        caught = {}
        for fault, code in (rk.BWD_FAULTS.items()
                            if plan.kind == "ring" else ()):
            fx, fw = rk._launch_bwd(x, w, dy, 1e-6, fault=code)
            caught[fault] = max(bwd_error(fx, rx), bwd_error(fw, rw))
            check(caught[fault] > tol, f"RMSNorm backward {name}: the limit "
                                       f"misses the planted fault '{fault}' "
                                       f"({caught[fault]} <= {tol})")
            rms_faults[fault] = min(rms_faults.get(fault, float("inf")),
                                    caught[fault])
            del fx, fw
        log(f"(n1) RMSNorm backward {name}, {plan.kind} kernel"
            f"{f' ({plan.load})' if plan.load else ''}: dx, dw against "
            f"ref.rmsnorm_bwd {errs[0]:.3g}, {errs[1]:.3g} and autograd "
            f"through ref.rmsnorm {errs[2]:.3g}, {errs[3]:.3g} of max "
            f"|plain| (limit {tol:g}); two runs bit-equal; dx strides "
            f"{dx.stride()}"
            + ("; planted faults " + ", ".join(
                f"{f} {e:.3g}" for f, e in caught.items()) if caught else ""))
        del dx, dw, dx2, dw2, rx, rw, ax, aw
    check(set(rms_faults) == set(rk.BWD_FAULTS),
          f"the RMSNorm backward's faults planted: {sorted(rms_faults)}")
    worst["rmsnorm planted fault errors (smallest)"] = rms_faults

    # ---- attention: each case on its route (bfloat16 at D 64/112/128 on
    # the tensor cores, the rest SIMT), with the statistics the forward
    # wrote, twice for determinism; the tensor-core route also with each
    # planted fault
    by_route = fa.flash_attention_bwd.launches_by_route
    routes_seen, shares, fault_shares = set(), {}, {}
    for case in FA_BWD_CASES:
        b, hq, hkv, sq, skv, d, causal, window, dname = case
        dt = getattr(torch, dname)
        tol = tol_of(BWD_TOL, dt)
        route = fa.route(dt, d)
        q, k, v, do, o, stats = bwd_inputs(gen, case)
        kw = dict(causal=causal, window=window)
        before = by_route[route]
        got = fa.flash_attention_bwd(q, k, v, o, do, stats=stats, **kw)
        again = fa.flash_attention_bwd(q, k, v, o, do, stats=stats, **kw)
        check(by_route[route] == before + 2,
              f"attention backward {case} did not take the {route} route")
        routes_seen.add(route)
        check(all(torch.equal(a, c) for a, c in zip(got, again)),
              f"attention backward {case}: two runs differ")
        want = fref.attention_bwd(q, k, v, o, do, **kw)
        qa, ka, va = (t.detach().requires_grad_() for t in (q, k, v))
        auto = torch.autograd.grad(fref.attention(qa, ka, va, **kw),
                                   (qa, ka, va), do)
        errs = [bwd_error(g, w) for g, w in zip(got, want)]
        errs_auto = [bwd_error(g, w) for g, w in zip(got, auto)]
        shape = (f"q ({b},{hq},{sq},{d}) k/v ({b},{hkv},{skv},{d}) {dname}"
                 f"{' causal' if causal else ''}"
                 f"{f' window {window}' if window else ''}")
        note_abs("flash_attention", dt, zip(got, want))
        for err, what in zip(errs + errs_auto,
                             ("dq", "dk", "dv", "dq (autograd)",
                              "dk (autograd)", "dv (autograd)")):
            key = ("flash_attention", dname, "rel")
            worst[key] = max(worst.get(key, 0.0), err)
            if route == "simt":
                check(err <= tol, f"attention backward {shape} {what}: "
                                  f"{err} > {tol}")
        if route == "simt":
            log(f"(n1) attention backward {shape}, SIMT route: dq, dk, dv "
                f"against ref.attention_bwd "
                f"{', '.join(f'{e:.3g}' for e in errs)} and autograd "
                f"through ref.attention "
                f"{', '.join(f'{e:.3g}' for e in errs_auto)} of max |plain| "
                f"(limit {tol:g}); two runs bit-equal")
            del q, k, v, do, o, stats, got, again, want, auto, qa, ka, va
            continue
        limits = bwd_tc_limits(q, k, v, o, do, want, causal, window)
        sh = limit_shares(got, want, limits)
        sh_auto = limit_shares(got, auto, bwd_tc_limits(q, k, v, o, do, auto,
                                                        causal, window))
        for share, what in zip(sh + sh_auto,
                               ("dq", "dk", "dv", "dq (autograd)",
                                "dk (autograd)", "dv (autograd)")):
            check(share <= 1.0, f"attention backward {shape} {what}: share "
                                f"of the tensor-core limit {share}")
        shares[case] = max(sh + sh_auto)
        # planted faults: each must exceed the limit somewhere; the mask's
        # only shows where the case masks a pair
        caught = {}
        for fault, code in fa.BWD_FAULTS.items():
            if code == 1 and not (causal or window):
                continue
            bad = fa._launch_bwd(q, k, v, o, do, stats, route="wgmma",
                                 fault=code, **kw)
            caught[fault] = max(limit_shares(bad, want, limits))
            check(caught[fault] > 1.0,
                  f"attention backward {shape}: the limit misses the "
                  f"planted fault '{fault}' (share {caught[fault]})")
            fault_shares[fault] = min(fault_shares.get(fault, float("inf")),
                                      caught[fault])
            del bad
        log(f"(n1) attention backward {shape}, tensor-core route: dq, dk, "
            f"dv against ref.attention_bwd "
            f"{', '.join(f'{e:.3g}' for e in errs)} and autograd through "
            f"ref.attention {', '.join(f'{e:.3g}' for e in errs_auto)} of "
            f"max |plain|; largest shares of the limit "
            f"{BWD_TC_LIMIT[0]:g} max|plain| + 2^-7 |plain| + 2^-7 "
            f"plain(|.|) {', '.join(f'{e:.3g}' for e in sh)} and "
            f"{', '.join(f'{e:.3g}' for e in sh_auto)}; planted faults' "
            f"shares {', '.join(f'{f} {c:.3g}' for f, c in caught.items())};"
            f" two runs bit-equal")
        del q, k, v, do, o, stats, got, again, want, auto, qa, ka, va
        del limits
        torch.cuda.empty_cache()
    check(routes_seen == {"wgmma", "simt"},
          f"the backward cases took the routes {routes_seen}")
    worst["tensor-core limit shares"] = max(shares.values())
    worst["planted fault shares (smallest)"] = fault_shares

    # ---- times at the training shapes, the L2 evicted before each launch
    evict = torch.empty(L2_FLUSH_BYTES // 4, device=DEVICE)
    before = hide_host(evict)
    # per call at each shape, measured; summed over a step's calls only as
    # a figure derived from them (the profiled step of (n2) measures the
    # step's RMSNorm backward time itself)
    rms = dict(shapes={}, derived_per_step=dict(
        ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0))
    for name, x, dy, calls in train_bwd_cases(gen, TRAIN_LAYERS):
        w = randn(gen, (x.shape[-1],), x.dtype)
        k_ms = cuda_ms(lambda: rk.rmsnorm_bwd(x, w, dy), before=before)[0]
        p_ms = cuda_ms(lambda: rref.rmsnorm_bwd(x, w, dy), reps=3)[0]
        xl, wl = (t.detach().requires_grad_() for t in (x, w))
        out = F.rms_norm(xl, (x.shape[-1],), wl, eps=1e-6)
        l_ms = cuda_ms(lambda: torch.autograd.grad(
            out, (xl, wl), dy, retain_graph=True), before=before)[0]
        n = x.numel()
        b_ms = (3 * n + 2 * x.shape[-1]) * x.element_size() \
            / MEM_BYTES_PER_S * 1e3
        rms["shapes"][name] = dict(
            ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
            share_of_bound=b_ms / k_ms, ratio_to_library=k_ms / l_ms,
            calls_per_step=calls)
        if not rms.get("ms"):               # the first shape: ln1/ln2/final
            rms.update(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                       bound_ms=b_ms)
        for key, val in (("ms", k_ms), ("plain_ms", p_ms),
                         ("library_ms", l_ms), ("bound_ms", b_ms)):
            rms["derived_per_step"][key] += val * calls
        log(f"(n1) RMSNorm backward {name} bf16: kernel {k_ms:.4f} ms, share "
            f"of the byte bound {b_ms / k_ms:.3f} ({b_ms:.4f} ms), "
            f"{k_ms / l_ms:.3f} x autograd through F.rms_norm ({l_ms:.4f} "
            f"ms); plain {p_ms:.3f} ms; {calls} calls a training step "
            f"(launches a call: (n2)'s profiled step)")
        del x, dy, xl, wl, out
    per = rms["derived_per_step"]
    log(f"(n1) RMSNorm backward per training step ({TRAIN_LAYERS} layers), "
        f"derived as each shape's time per call times its calls a step: "
        f"kernel {per['ms']:.3f} ms, bound {per['bound_ms']:.3f} ms (share "
        f"{per['bound_ms'] / per['ms']:.3f}), F.rms_norm's backward "
        f"{per['library_ms']:.3f} ms, plain {per['plain_ms']:.3f} ms")

    # the tensor-core backward against the SIMT one at every bfloat16 case
    # on its route, in turns, with the forward's statistics given to both
    # and, as for every timed launch here, the L2 evicted and the host's
    # enqueue hidden before each
    vs_simt = {}
    for case in FA_BWD_CASES[1:]:
        b, hq, hkv, sq, skv, d, causal, window, dname = case
        if fa.route(getattr(torch, dname), d) != "wgmma":
            continue
        q, k, v, do, o, stats = bwd_inputs(gen, case)
        kw = dict(causal=causal, window=window)
        ms = {route: [] for route in ("wgmma", "simt")}
        for turn in range(2):
            for route in ms:
                ms[route].append(cuda_ms(lambda: fa._launch_bwd(
                    q, k, v, o, do, stats, route=route, **kw), reps=5,
                    before=before)[0])
        t_tc, t_simt = (statistics.mean(ms[r]) for r in ("wgmma", "simt"))
        vs_simt[str(case)] = dict(ms=t_tc, simt_ms=t_simt)
        log(f"(n1) attention backward {case}: tensor-core kernel "
            f"{t_tc:.4f} ms (turns {ms['wgmma']}), SIMT kernel {t_simt:.4f} "
            f"ms (turns {ms['simt']}), {t_simt / t_tc:.1f} x faster")
        check(t_tc < t_simt, f"the tensor-core backward is not faster than "
                             f"the SIMT one at {case}")
        del q, k, v, do, o, stats

    # the training shape: the tensor-core kernel, the SIMT kernel and
    # autograd through SDPA, in turns
    b, hq, hkv, sq, skv, d, causal, window, _ = FA_BWD_CASES[0]
    q, k, v, do, o, stats = bwd_inputs(gen, FA_BWD_CASES[0])
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                         enable_gqa=True)
    runs = {"kernel": lambda: fa.flash_attention_bwd(q, k, v, o, do,
                                                     stats=stats),
            "simt": lambda: fa._launch_bwd(q, k, v, o, do, stats,
                                           route="simt"),
            "library": lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                                   retain_graph=True)}
    turns = {name: [] for name in runs}
    for turn in range(2):
        for name, fn in runs.items():
            turns[name].append(cuda_ms(fn, reps=FA_REPS, before=before)[0])
    k_ms, simt_ms, l_ms = (statistics.mean(turns[n]) for n in runs)
    p_ms = cuda_ms(lambda: fref.attention_bwd(q, k, v, o, do, stats=stats),
                   reps=3)[0]
    byte_ms, op_ms = attention_bwd_bound_ms(b, hq, hkv, sq, skv, d, causal,
                                            window, 2)
    b_ms = max(byte_ms, op_ms)
    log(f"(n1) attention backward at q ({b},{hq},{sq},{d}) k/v "
        f"({b},{hkv},{skv},{d}) bf16 causal, the forward's statistics "
        f"given: tensor-core kernel {k_ms:.4f} ms (turns {turns['kernel']}), "
        f"share of the bound {b_ms / k_ms:.4f} (the bound counts five "
        f"products; the kernel does seven, S and dP twice), "
        f"{k_ms / l_ms:.3f} x autograd through SDPA ({l_ms:.4f} ms, turns "
        f"{turns['library']}); SIMT kernel {simt_ms:.4f} ms (turns "
        f"{turns['simt']}), {simt_ms / k_ms:.1f} x the tensor-core one; "
        f"plain {p_ms:.3f} ms; bound {b_ms:.4f} ms (operations: five "
        f"products at the bf16 tensor-core rate; bytes {byte_ms:.4f} ms); "
        f"{TRAIN_LAYERS} calls a training step")
    check(k_ms < simt_ms, "the tensor-core backward is not faster than the "
                          "SIMT one at the training shape")
    del q, k, v, do, o, stats, qs, ks, vs, out, evict
    torch.cuda.empty_cache()
    fa_bwd = dict(ms=k_ms, ms_turns=turns["kernel"], simt_ms=simt_ms,
                  simt_ms_turns=turns["simt"], plain_ms=p_ms,
                  library_ms=l_ms, ratio_to_library=k_ms / l_ms,
                  bound_ms=b_ms,
                  bound_by="operations" if op_ms >= byte_ms else "bytes",
                  at_other_cases=vs_simt)
    return rms, fa_bwd, worst


def bwd_inputs(gen, case):
    """q, k, v, do (heads views), the forward's output and its row
    statistics for one FA_BWD_CASES case."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa
    b, hq, hkv, sq, skv, d, causal, window, dname = case
    dt = getattr(torch, dname)
    q = randn(gen, (b, sq, hq, d), dt).transpose(1, 2)
    k = randn(gen, (b, skv, hkv, d), dt).transpose(1, 2)
    v = randn(gen, (b, skv, hkv, d), dt).transpose(1, 2)
    do = randn(gen, (b, sq, hq, d), dt).transpose(1, 2)
    stats = torch.empty((2, b, hq, sq), device=DEVICE)
    o = fa._launch(q, k, v, causal=causal, window=window,
                   route=fa.route(dt, d), stats=stats)
    return q, k, v, do, o, stats


def train_faults():
    """name → (object, attribute, stand-in) patched into the kernel route
    of one training step: one forward fault (phase (g)'s key/value head
    map shifted by one head) and two backward faults (the attention
    backward's dk of key/value head 0 zeroed; the RMSNorm backward's dw
    summing all but the last quarter of its rows).  A stand-in for a
    backward wrapper carries its own launch counts: the real wrapper, which
    it calls, counts through its module's name, which the patch rebinds."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.rmsnorm import ref as rref
    from repro_torch.models import layers
    real_fa, real_fa_bwd = fa.flash_attention, fa.flash_attention_bwd
    real_rms_bwd = rk.rmsnorm_bwd

    def shifted_heads(q, k, v, **kw):
        return real_fa(q, k.roll(-1, 1), v.roll(-1, 1), **kw)

    def dk_head_zeroed(*args, **kw):
        dq, dk, dv = real_fa_bwd(*args, **kw)
        dk[:, 0] = 0
        return dq, dk, dv

    def dw_rows_dropped(x, w, dy, eps=1e-6):
        dx, dw = real_rms_bwd(x, w, dy, eps)
        d = x.shape[-1]
        xr, gr = x.reshape(-1, d), dy.reshape(-1, d)
        n = xr.shape[0] // 4
        _, tail = rref.rmsnorm_bwd(xr[-n:], w, gr[-n:], eps=eps)
        return dx, (dw.float() - tail.float()).to(dw.dtype)

    dk_head_zeroed.launches = dw_rows_dropped.launches = 0
    dk_head_zeroed.launches_by_route = {"wgmma": 0, "simt": 0}
    return {"GQA map shifted by one head":
            (layers.fa_ops, "attention", shifted_heads),
            "attention backward: dk of key/value head 0 zeroed":
            (fa, "flash_attention_bwd", dk_head_zeroed),
            "RMSNorm backward: dw without the last quarter of the rows":
            (rk, "rmsnorm_bwd", dw_rows_dropped)}


# the planted faults each training reading is held against: the loss is
# the forward's, so only the forward fault moves it
TRAIN_FAULTS_READ = {
    "loss": ("GQA map shifted by one head",),
    "grad_norm": ("GQA map shifted by one head",
                  "attention backward: dk of key/value head 0 zeroed"),
    "mu": ("GQA map shifted by one head",
           "attention backward: dk of key/value head 0 zeroed",
           "RMSNorm backward: dw without the last quarter of the rows"),
    "params": ("GQA map shifted by one head",
               "attention backward: dk of key/value head 0 zeroed"),
}
# the training step against the same step through both kernels' plain
# versions (phase (n2), 8 layers): |loss difference|; |grad_norm
# difference| over the plain grad_norm; the largest over leaves of the
# updated first moment's relative L2 difference (mu = 0.1 x the clipped
# gradient after the first step); the largest share, over leaves, of
# updated parameter elements that differ (the first AdamW step moves each
# element by about lr times the sign of its gradient, so near-zero
# gradients that flip sign set the clean reading).  On an H100, with the
# tensor-core attention backward, the clean readings at seeds 0 and 1 were
# 1.345e-4 and 1.373e-4 (loss), 9.78e-5 and 2.41e-4 (grad_norm), 0.0246
# and 0.0251 (mu), 0.0649 and 0.0657 (params); the planted faults read
# 0.0232 (loss, GQA map), 2.93e-3 and 0.0153 (grad_norm), 0.355 to 1.48
# (mu), 0.180 and 0.776 (params) (PERF.md section 6; the SIMT backward's
# readings differed by under 0.003 in mu).  Each limit sits near the
# geometric mean of the largest clean reading and the smallest fault's.
TRAIN_TOL = {"loss": 2e-3, "grad_norm": 1e-3, "mu": 0.1, "params": 0.11}


def train_readings(model, plain_model, opt_cfg, batch, seed: int,
                   faults: bool):
    """One training step from the weights of ``seed`` through the kernels
    (as they are, and with each planted fault) against the same step
    through both kernels' plain versions → readings
    [(check, run, fault or None, value)], each printed."""
    from unittest import mock

    import torch
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.models import layers
    from repro_torch.train.step import init_state, make_train_step
    from repro_torch.models.common import leaves

    dev = torch.device(DEVICE)
    run = f"bf16 seed {seed}"

    def fresh():
        return init_state(model, torch.Generator(device=dev).manual_seed(seed))

    def plain_rms(x, w, eps=1e-6, impl=None):
        return rk.rmsnorm(x, w, eps, impl="ref")

    state = fresh()
    with mock.patch.object(layers, "rmsnorm", plain_rms):
        state, met = make_train_step(plain_model, opt_cfg)(state, batch)
    ref_loss, ref_gn = float(met["loss"]), float(met["grad_norm"])
    ref_mu = [t.to("cpu", copy=True) for t in leaves(state["opt"]["mu"])]
    ref_p = [t.to("cpu", copy=True) for t in leaves(state["params"])]
    del state, met
    torch.cuda.empty_cache()
    out = []
    patches = train_faults() if faults else {}
    for fault, patch in {None: None, **patches}.items():
        state = fresh()
        with contextlib.ExitStack() as stack:
            if patch is not None:
                stack.enter_context(mock.patch.object(*patch))
            state, met = make_train_step(model, opt_cfg)(state, batch)
        loss, gn = float(met["loss"]), float(met["grad_norm"])
        mu_err, p_share = 0.0, 0.0
        for got, want in zip(leaves(state["opt"]["mu"]), ref_mu):
            w = want.to(dev)
            mu_err = max(mu_err, float(torch.linalg.vector_norm(got - w))
                         / max(1e-30, float(torch.linalg.vector_norm(w))))
        for got, want in zip(leaves(state["params"]), ref_p):
            p_share = max(p_share, int(torch.count_nonzero(
                got != want.to(dev))) / got.numel())
        vals = {"loss": abs(loss - ref_loss),
                "grad_norm": abs(gn - ref_gn) / ref_gn,
                "mu": mu_err, "params": p_share}
        log(f"(n2) {run}" + (f", fault '{fault}'" if fault else "")
            + f": loss {loss:.6f} (plain {ref_loss:.6f}), grad_norm "
            f"{gn:.6f} (plain {ref_gn:.6f}); readings " + ", ".join(
                f"{k} {v:.4g}" for k, v in vals.items()))
        out += [(k, run, fault, v) for k, v in vals.items()]
        del state, met
        torch.cuda.empty_cache()
    return out


def train_loop_run(layers: int, ckpt, tag: str, card: str):
    """qwen3-14b at full width cut to ``layers``, trained through
    ``TrainLoop`` for TRAIN_STEPS steps from the weights of seed 0; with a
    checkpoint directory ``ckpt``, in two loops: the first writes the
    checkpoint at TRAIN_CKPT_STEP, the second restores it (held bit for bit
    against the state it was written from) and trains on → readings."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models.common import leaves, tree_map
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import TrainLoop, TrainLoopConfig
    from repro_torch.train.step import init_state, make_train_step

    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.rmsnorm import kernel as rk

    dev = torch.device(DEVICE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full = get_arch(TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=layers)
    check(cfg.d_model == QWEN["d"] and cfg.dtype == torch.bfloat16,
          f"{TRAIN_ARCH} config changed")
    model = build_model(cfg, remat_policy="full")
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                          total_steps=TRAIN_STEPS)
    ds = SyntheticTokens(cfg.vocab, TRAIN_S, TRAIN_B, seed=0)
    state = init_state(model, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(state["params"]))
    s_bytes = sum(t.numel() * t.element_size() for t in leaves(state))
    log(f"{tag}, {layers} of its {full.n_layers} layers at full width "
        f"(d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_padded}): "
        f"{n_params / 1e9:.3f} B parameters, train state {s_bytes / 1e9:.2f} "
        f"GB (bf16 parameters, float32 mu and nu); B={TRAIN_B} S={TRAIN_S}, "
        f"remat full, AdamW lr {TRAIN_LR} warmup {TRAIN_WARMUP}")

    step_fn = make_train_step(model, opt_cfg)
    # per step: device ms, and the peak allocated so far (GB)
    step_ms, step_peak, profiled = [], [], {}

    def timed(st, batch):
        if len(step_ms) == TRAIN_PROFILE_STEP and ckpt is None:
            res = []
            before = (fa.flash_attention_bwd.launches,
                      rk.rmsnorm_bwd.launches)
            with heads_view_copies() as copies:
                wall, busy, n_k, top = profile_window(
                    lambda _: res.append(step_fn(st, batch)), 1,
                    OUT / "train_step_trace.json")
            # the backward wrappers' calls in the profiled step
            calls = {"attention backward":
                     fa.flash_attention_bwd.launches - before[0],
                     "RMSNorm backward": rk.rmsnorm_bwd.launches - before[1]}
            profiled.update(wall=wall, busy=busy, kernels=n_k, top=top,
                            calls=calls, heads_view_copies=copies)
            step_ms.append(None)
        else:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = [step_fn(st, batch)]
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
        step_peak.append(round(torch.cuda.max_memory_allocated() / 1e9, 2))
        return res[0]

    if ckpt is not None:
        shutil.rmtree(ckpt, ignore_errors=True)
    first = TrainLoop(timed, state, ds, TrainLoopConfig(
        total_steps=TRAIN_CKPT_STEP if ckpt else TRAIN_STEPS,
        checkpoint_every=TRAIN_CKPT_STEP,
        checkpoint_dir=str(ckpt) if ckpt else None, log_every=1))
    t0 = time.perf_counter()
    out = first.run()
    run1_s = time.perf_counter() - t0
    metrics, last, restore_s = out["metrics"], first, None
    opt_ms = None
    if ckpt is not None:
        # the saved state's bits summed per leaf; then it leaves the card
        # and the restart restores the checkpoint there, each array checked
        # against the SHA-256 its write recorded (no host copy of the
        # state: the host holds a few arrays at once)
        saved = [bit_sums(t) for t in leaves(first.state)]
        like = tree_map(lambda t: torch.empty(0, device=t.device),
                        first.state)
        del state, first, last
        torch.cuda.empty_cache()
        last = TrainLoop(timed, like, ds, TrainLoopConfig(
            total_steps=TRAIN_STEPS, checkpoint_dir=str(ckpt), log_every=1))
        t0 = time.perf_counter()
        resumed = last.try_restore()
        restore_s = time.perf_counter() - t0
        check(resumed and last.start_step == TRAIN_CKPT_STEP,
              f"restart resumed={resumed} at step {last.start_step}")
        check([bit_sums(t) for t in leaves(last.state)] == saved,
              "the restored train state differs from the saved one")
        log(f"{tag} checkpoint at step {TRAIN_CKPT_STEP} "
            f"({s_bytes / 1e9:.1f} GB): written with the first loop's last "
            f"step ({run1_s:.1f} s for {TRAIN_CKPT_STEP} steps and the "
            f"write), restored in {restore_s:.1f} s, every array's digest "
            f"and every leaf's bit sums equal to the saved state's")
        del like, saved
        last.ckpt = None          # the restart writes no second checkpoint
        out = last.run()
        metrics = metrics + out["metrics"]
        shutil.rmtree(ckpt, ignore_errors=True)
        # the optimizer alone, on zero gradients: its share of a step
        from repro_torch.optim.adamw import adamw_update
        grads = tree_map(torch.zeros_like, last.state["params"])
        opt_ms = cuda_ms(lambda: adamw_update(
            opt_cfg, last.state["params"], grads, last.state["opt"]),
            reps=3, warm=1)[0]
        del grads
        log(f"{tag} AdamW update alone ({n_params / 1e9:.3f} B parameters): "
            f"{opt_ms:.1f} ms; moving each parameter's bf16 value and "
            f"gradient and float32 mu and nu in and out once takes "
            f"{n_params * 22 / MEM_BYTES_PER_S * 1e3:.1f} ms")
    total = torch.cuda.get_device_properties(0).total_memory
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    free_gb = (total - reserved) / 1e9
    losses = [m["loss"] for m in metrics]
    log(f"{tag} steps {[m['step'] for m in metrics]}: loss "
        f"{[round(v, 4) for v in losses]}, grad_norm "
        f"{[round(m['grad_norm'], 4) for m in metrics]}; peak allocated "
        f"after each step (GB) {step_peak}")
    check(out["final_step"] == TRAIN_STEPS and len(metrics) == TRAIN_STEPS
          and all(np.isfinite(losses))
          and all(np.isfinite(m["grad_norm"]) for m in metrics),
          f"{tag} training gave {len(metrics)} steps, losses {losses}")
    check(all(bool(torch.isfinite(t.float()).all())
              for t in leaves(last.state["params"])),
          f"{tag} parameters not finite after training")
    timed_ms = [ms for i, ms in enumerate(step_ms) if i > 0 and ms]
    med = statistics.median(timed_ms)
    toks = TRAIN_B * TRAIN_S
    log(f"{tag} train step: {med:.1f} ms median of steps after the first "
        f"({[round(v, 1) for v in timed_ms]}; first {step_ms[0]:.1f} ms), "
        f"{toks / med * 1e3:.0f} tokens/s; peak device memory "
        f"{peak / 1e9:.2f} GB allocated, {reserved / 1e9:.2f} GB reserved "
        f"of {total / 1e9:.2f} GB: {free_gb:.2f} GB free; {card}")
    check(free_gb >= FREE_GB, f"{tag} leaves {free_gb:.2f} GB free, under "
                              f"{FREE_GB:g}")
    breakdown = None
    if profiled and profiled["busy"] is None:
        log(f"{tag} profiled step: the trace holds no kernel; device time "
            f"not measured")
    elif profiled:
        parts, n_parts = kernel_parts(OUT / "train_step_trace.json")
        bwd_ms = parts["attention backward"] + parts["RMSNorm backward"]
        per_call = {name: n_parts[name] / n if n else None
                    for name, n in profiled["calls"].items()}
        copies = profiled["heads_view_copies"]
        # the RMSNorm backward's calls at each shape: q_norm's and k_norm's
        # heads views (two a layer, tensor-map route), the rows of d_model
        # (ln1, ln2, the final norm; bulk route)
        routes = rms_bwd_routes(OUT / "train_step_trace.json")
        heads = 2 * layers
        rows = profiled["calls"]["RMSNorm backward"] - heads
        by_route = {
            route: dict(calls=calls, kernels=routes[route][0],
                        kernels_per_call=routes[route][0] / calls,
                        own_ms_per_kernel=routes[route][1]
                        / max(1, routes[route][0]))
            for route, calls in (("map", heads), ("bulk", rows))}
        log(f"{tag} profiled step's RMSNorm backward: the heads views "
            f"(tensor maps) {by_route['map']['kernels']} kernels for "
            f"{heads} calls, {by_route['map']['own_ms_per_kernel']:.4f} ms "
            f"a kernel's own run; the rows of {QWEN['d']} (bulk copies) "
            f"{by_route['bulk']['kernels']} kernels for {rows} calls, "
            f"{by_route['bulk']['own_ms_per_kernel']:.4f} ms; the loop "
            f"kernel {routes['loop'][0]}")
        check(routes["map"][0] == heads and routes["bulk"][0] == rows
              and routes["loop"][0] == 0,
              f"{tag}: RMSNorm backward kernels by route {routes}, expected "
              f"one a call: {heads} heads views, {rows} rows")
        breakdown = dict(host_ms=profiled["wall"], busy_ms=profiled["busy"],
                         idle=1 - profiled["busy"] / profiled["wall"],
                         backward_kernels_ms=bwd_ms,
                         backward_kernels_share=bwd_ms / profiled["busy"],
                         parts_ms=parts, parts_kernels=n_parts,
                         backward_calls=profiled["calls"],
                         kernels_per_backward_call=per_call,
                         heads_view_copies=copies,
                         rmsnorm_bwd_by_route=by_route)
        log(f"{tag} profiled step: autograd's backward of the q and k heads "
            f"views (_split_heads) ran {copies['calls']} times and copied "
            f"the RMSNorm backward's dx {copies['copies']} times")
        check(copies["calls"] == 2 * layers and copies["copies"] == 0,
              f"{tag}: the heads views' backward {copies}; expected "
              f"{2 * layers} runs and no copy")
        log(f"{tag} profiled step {TRAIN_PROFILE_STEP}: host "
            f"{profiled['wall']:.1f} ms, device busy {profiled['busy']:.1f} "
            f"ms, idle share {breakdown['idle']:.3f}, {profiled['kernels']} "
            f"kernels; the backward kernels {bwd_ms:.2f} ms, "
            f"{breakdown['backward_kernels_share']:.3f} of the busy time; "
            f"backward wrapper calls {profiled['calls']}, kernels in the "
            f"trace per call {per_call}; "
            f"device ms by part: " + ", ".join(
                f"{k} {ms:.2f}" for k, ms in parts.items())
            + "; largest kernels: " + "; ".join(
                f"{k} {ms:.2f} ms" for k, ms in profiled["top"]))
    return model, ds, opt_cfg, dict(
        layers=layers, step_ms=med, step_ms_all=step_ms,
        tokens_per_s=toks / med * 1e3, peak_gb=peak / 1e9,
        reserved_gb=reserved / 1e9, free_gb=free_gb, losses=losses,
        profile=breakdown, checkpoint_gb=s_bytes / 1e9 if ckpt else None,
        checkpoint_restore_s=restore_s, adamw_ms=opt_ms)


@contextlib.contextmanager
def heads_view_copies():
    """Within the block, each ``layers.rmsnorm`` call on a heads view (a
    4-d x whose autograd node is the transpose of ``_split_heads``' view)
    hooks the view's backward node → a dict: ``calls`` counts the view
    backwards that ran, ``copies`` those whose output is not a view of
    the gradient they got (autograd copied the RMSNorm backward's dx into
    the projection's (B, S, H*D) layout)."""
    from unittest import mock

    from repro_torch.models import layers
    real = layers.rmsnorm
    out = dict(calls=0, copies=0)

    def hook(grad_inputs, grad_outputs):
        out["calls"] += 1
        out["copies"] += int(grad_inputs[0].data_ptr()
                             != grad_outputs[0].data_ptr())

    def rmsnorm(x, w, eps=1e-6, impl=None):
        node = x.grad_fn
        if x.dim() == 4 and node is not None \
                and type(node).__name__.startswith("TransposeBackward"):
            view = node.next_functions[0][0]
            if view is not None:
                view.register_hook(hook)
        return real(x, w, eps, impl=impl)

    with mock.patch.object(layers, "rmsnorm", rmsnorm):
        yield out


# kernel-name fragments → the part of a training step they are
TRAIN_KERNEL_PARTS = (
    ("attention backward", ("fa_bwd_",)),
    ("RMSNorm backward", ("rmsnorm_bwd_",)),
    ("attention forward", ("flash_attention",)),
    ("RMSNorm forward", ("rmsnorm_rows", "rmsnorm_loop")),
    ("matrix products", ("gemm", "nvjet", "sm90_", "cutlass", "xmma",
                         "splitK")),
    ("elementwise", ("elementwise",)),
    ("reductions", ("reduce", "Reduce")),
)


def kernel_parts(trace_path):
    """Device ms, and the number of kernels, of a profiled window by part
    of the step (TRAIN_KERNEL_PARTS, the first match; "other" for the
    rest) → (ms by part, kernels by part)."""
    events = json.loads(Path(trace_path).read_text()).get("traceEvents", [])
    out = {name: 0.0 for name, _ in TRAIN_KERNEL_PARTS}
    out["other"] = 0.0
    n = dict.fromkeys(out, 0)
    for e in events:
        if e.get("cat") != "kernel" or "dur" not in e:
            continue
        name = e.get("name", "")
        part = next((p for p, keys in TRAIN_KERNEL_PARTS
                     if any(k in name for k in keys)), "other")
        out[part] += e["dur"] / 1e3
        n[part] += 1
    return out, n


def rms_bwd_routes(trace_path):
    """The RMSNorm backward's kernels in a profiled window, by route →
    {route: [kernels, ms of their own runs]}: "map" (rows through tensor
    maps: the heads views), "bulk" (rows by bulk copies: d_model), "loop"
    (the scalar kernel)."""
    events = json.loads(Path(trace_path).read_text()).get("traceEvents", [])
    out = {route: [0, 0.0] for route in ("map", "bulk", "loop")}
    for e in events:
        name = e.get("name", "")
        if e.get("cat") != "kernel" or "dur" not in e \
                or "rmsnorm_bwd_" not in name:
            continue
        route = ("loop" if "rmsnorm_bwd_loop" in name
                 else "map" if "true>" in name else "bulk")
        out[route][0] += 1
        out[route][1] += e["dur"] / 1e3
    return out


def bit_sums(t):
    """Two sums over a tensor's bits read as integers, the second weighted
    by position, with its shape and dtype: equal for equal tensors; for a
    restored state (beside the digests the restore checks) the check that
    no array went to the wrong leaf or changed a bit on its way."""
    import torch
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}[t.element_size()]
    flat, plain, weighted = t.reshape(-1).view(ints), 0, 0
    for lo in range(0, flat.numel(), 1 << 26):     # 2^26 elements at once
        bits = flat[lo:lo + (1 << 26)].long()
        pos = torch.arange(lo + 1, lo + 1 + bits.numel(),
                           device=t.device) % 65521
        plain += int(bits.sum())
        weighted += int((bits * pos).sum())
    return plain, weighted, tuple(t.shape), t.dtype


def phase_train(card: str):
    """(n2) qwen3-14b at full width trained through ``TrainLoop`` (the
    main path: launches counted): TRAIN_LAYERS of its 40 layers for six
    steps (times, memory, a profiled step), then TRAIN_CKPT_LAYERS with a
    checkpoint at TRAIN_CKPT_STEP and a restart from it; then agreement
    with the plain route at two weight seeds at TRAIN_AGREE_LAYERS, each
    limit held against planted faults."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.models.registry import build_model

    t_phase = time.perf_counter()
    # as launch/train.py runs: segments that grow in place, so a step's
    # changing temporaries do not strand the card's memory in fragments
    # (with fixed segments 14 GB sat reserved but unallocated at 8 layers)
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    runs = [(TRAIN_LAYERS, None, "(n2) qwen3-14b")]
    if TRAIN_CKPT_DIR is not None:
        runs.append((TRAIN_CKPT_LAYERS, TRAIN_CKPT_DIR,
                     "(n2) qwen3-14b, checkpoint and restart"))
    # ---- the main path: counts set to 0 just before, read just after
    reset_counts()
    rk.rmsnorm_bwd.launches = 0
    fa.flash_attention_bwd.launches = 0
    for route in fa.flash_attention_bwd.launches_by_route:
        fa.flash_attention_bwd.launches_by_route[route] = 0
    readings = {}
    for layers, ckpt, tag in runs:
        model, ds, opt_cfg, readings[tag] = train_loop_run(layers, ckpt, tag,
                                                           card)
    launches = counts()
    bwd_launches = {"rmsnorm_bwd": rk.rmsnorm_bwd.launches,
                    "flash_attention_bwd": fa.flash_attention_bwd.launches}
    bwd_by_route = dict(fa.flash_attention_bwd.launches_by_route)
    # ----
    n_l = sum(layers for layers, _, _ in runs) * TRAIN_STEPS
    n_s = len(runs) * TRAIN_STEPS
    want = {"flash_attention": 2 * n_l, "rmsnorm": 8 * n_l + n_s,
            "flash_attention_bwd": n_l, "rmsnorm_bwd": 4 * n_l + n_s}
    have = {"flash_attention": launches["flash_attention"],
            "rmsnorm": launches["rmsnorm"], **bwd_launches}
    log(f"(n2) launches in {n_s} steps: {have} (flash attention by route "
        f"{launches['flash_attention_by_route']}, "
        f"{launches['flash_attention_with_stats']} of them writing the row "
        f"statistics; the forwards twice a layer, once more in the "
        f"recompute of full remat; the attention backward by route "
        f"{bwd_by_route})")
    check(have == want and launches["flash_attention_by_route"]["simt"] == 0
          and bwd_by_route == {"wgmma": n_l, "simt": 0}
          and launches["flash_attention_with_stats"]
          == launches["flash_attention"],
          f"(n2) launches {have}, backward by route {bwd_by_route}, "
          f"forwards with statistics "
          f"{launches['flash_attention_with_stats']}; expected {want}, all "
          f"on the tensor-core routes, every forward writing statistics")

    # ---- agreement with both kernels' plain versions, one step from the
    # weights of two seeds at TRAIN_AGREE_LAYERS; planted faults at the
    # first
    tag = runs[-1][2]
    batch = ds.batch_at(0)
    agree_cfg = dataclasses.replace(model.cfg, n_layers=TRAIN_AGREE_LAYERS)
    model = build_model(agree_cfg, remat_policy="full")
    plain = build_model(agree_cfg, remat_policy="full", attn_impl="ref")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    agree = train_readings(model, plain, opt_cfg, batch, 0, faults=True)
    agree += train_readings(model, plain, opt_cfg, batch, 1, faults=False)
    kept = [r for r in agree
            if r[2] is None or r[2] in TRAIN_FAULTS_READ[r[0]]]
    errors = check_limits(TRAIN_TOL, kept,
                          f"(n2) agreement at {model.cfg.n_layers} layers")
    log(f"(n2) agreement's peak device memory "
        f"{torch.cuda.max_memory_reserved() / 1e9:.2f} GB reserved; phase "
        f"(n2) {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    main = readings[runs[0][2]]
    bwd_launches["flash_attention_bwd_by_route"] = bwd_by_route
    return launches, bwd_launches, dict(
        main, checkpoint_run=readings.get(tag) if len(runs) > 1 else None,
        agreement=errors, agreement_layers=model.cfg.n_layers,
        seconds=time.perf_counter() - t_phase)


# ---------------------------------------------------------------- phase (o)
# qwen3-14b's compressed data-parallel step on a one-rank NCCL group.  The
# cut, reckoned before the first run: at the peak the compressed step holds
# 18 bytes a parameter (bf16 parameters 2, float32 mu and nu 8, ef 4, the
# reduced float32 gradients 4) and the bf16 gradient of the leaf being
# reduced (the unembed, 1.56 GB, reduced last), P(L) = 1.557e9 + 0.3303e9 L
# parameters: 71.2 GB allocated at 7 layers, 77.2 at 8.  Phase (n2)'s
# reserved memory stood 6.9 GB above its allocated peak (68.46 GB
# allocated, 9.7 GB of 85.0 free), so 7 layers leave about 6.9 GB free and
# 8 about 0.9: 7 is the deepest cut that leaves DP_FREE_GB (PERF.md
# section 4)
DP_LAYERS = 7
DP_FREE_GB = 5.0
# the steps each run takes on the same batches; the step that runs under
# the profiler and the one under torch's sync debug mode (neither timed);
# the steps of the second timing turn
DP_STEPS, DP_PROFILE_STEP, DP_SYNC_STEP, DP_TURN_STEPS = 8, 3, 5, 3
# the last losses of the compressed and the uncompressed step, within the
# reference's bound (tests/test_compressed_dp.py)
DP_LOSS_TOL = 0.35
# the one-stage pipeline's microbatches (of one sequence each)
DP_MICRO = 4
# bytes a parameter the compression must move: read g (bf16) and e, write
# e and the payload (float32)
DP_BYTES_PER_PARAM = 14
# the leaf of the real gradients the compression's invariants are read on
DP_LEAF = ("layers", "attn", "wk")
DP_REPEATS = 20
# |deq - (g + e)| over scale/2: at most 1 + 3e-5 (g/s rounded to float32
# moves it by up to 127 ulp of 1, the product q s by as much again)
DP_HALF_SCALE_LIMIT = 1 + 2 ** -14
# |mean sent - g| over the error feedback's bound max(scale)/(2 repeats):
# 5% for the float32 rounding of g + e over the repeats (at most 0.6%);
# with the error not carried the worst element reads about repeats
DP_MEAN_LIMIT = 1.05


def leaf_at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def range_kernel_ms(trace_path, name: str):
    """Device ms of the kernels launched inside the ``record_function``
    ranges called ``name`` in a profiled window (matched to their launches
    by correlation id) → (ms, kernels)."""
    events = json.loads(Path(trace_path).read_text()).get("traceEvents", [])
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == name]
    corr = {e["args"]["correlation"] for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and "correlation" in e.get("args", {})
            and any(a <= e["ts"] <= b for a, b in spans)}
    ms, n = 0.0, 0
    for e in events:
        if e.get("cat") == "kernel" and e.get("args", {}).get(
                "correlation") in corr:
            ms += e["dur"] / 1e3
            n += 1
    return ms, n


@contextlib.contextmanager
def timed_compression(out: list):
    """Within the block, each compressed reduction of the step runs
    between two CUDA events; ``out`` gets the (start, end) pairs."""
    from unittest import mock

    import torch
    from repro_torch.train import dp_compressed
    real = dp_compressed.error_feedback_allreduce

    def timed(grads, error, group=None):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = real(grads, error, group)
        end.record()
        out.append((start, end))
        return res

    with mock.patch.object(dp_compressed, "error_feedback_allreduce", timed):
        yield


def ef_not_carried():
    """The planted fault: the step's reduction starts every leaf from zero
    error feedback, so the old ef is not carried."""
    from unittest import mock

    from repro_torch.models.common import leaves
    from repro_torch.train import dp_compressed
    real = dp_compressed.error_feedback_allreduce

    def dropped(grads, error, group=None):
        for e in leaves(error):
            e.zero_()
        return real(grads, error, group)
    return mock.patch.object(dp_compressed, "error_feedback_allreduce",
                             dropped)


def dp_run(step_fn, fresh, batches, n_steps, tag, profile=None,
           sync=None):
    """``n_steps`` steps of ``step_fn`` from ``fresh()`` on ``batches``
    (on the card already), each timed by CUDA events with the host hidden
    (except the profiled and the sync-checked one) → (state, readings)."""
    import torch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = fresh()
    torch.cuda.synchronize()
    losses, norms, ms, syncs, prof = [], [], [], None, None
    for i in range(n_steps):
        if i == profile:
            res = []
            wall, busy, n_k, top = profile_window(
                lambda _: res.append(step_fn(state, batches[i])), 1,
                OUT / "dp_step_trace.json")
            state, met = res[0]
            prof = dict(wall=wall, busy=busy, kernels=n_k, top=top)
        elif i == sync:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                state, met = step_fn(state, batches[i])
                syncs = ""
            except RuntimeError as e:
                syncs = str(e).splitlines()[0]
            finally:
                torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
            check(syncs == "", f"{tag}: the step synchronised with the "
                               f"host: {syncs}")
        else:
            hide_host()()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, met = step_fn(state, batches[i])
            end.record()
            end.synchronize()
            ms.append((i, start.elapsed_time(end)))
        losses.append(met["loss"])
        norms.append(met["grad_norm"])
    torch.cuda.synchronize()
    total = torch.cuda.get_device_properties(0).total_memory
    out = dict(losses=[float(v) for v in losses],
               grad_norms=[float(v) for v in norms],
               step_ms={i: t for i, t in ms},
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
               free_gb=(total - torch.cuda.max_memory_reserved()) / 1e9,
               total_gb=total / 1e9, profile=prof, syncs=syncs)
    timed = [t for i, t in ms if i > 0]
    out["ms"] = statistics.median(timed) if timed else None
    log(f"(o) {tag}: losses {[round(v, 4) for v in out['losses']]}, "
        f"grad_norm {[round(v, 4) for v in out['grad_norms']]}; step ms "
        f"{ {i: round(t, 1) for i, t in ms} } (median after the first "
        f"{out['ms']}); peak {out['peak_gb']:.2f} GB allocated, "
        f"{out['reserved_gb']:.2f} GB reserved of {out['total_gb']:.2f}: "
        f"{out['free_gb']:.2f} GB free")
    return state, out


def compression_checks(g, e0, fault: bool):
    """The compression's invariants on one leaf of the real gradients
    (``g`` bf16, ``e0`` a carried float32 error) → readings: q int8 within
    [-127, 127]; |deq - (g + e)| over scale/2; ef against gf - deq bit for
    bit; over DP_REPEATS compressions of g from zero error, |mean sent -
    g| over the error feedback's bound max(scale)/(2 DP_REPEATS) (the sum
    sent is DP_REPEATS g - e_last).  With ``fault`` the error is not
    carried between the repeats."""
    import torch
    from repro_torch.optim import compression as comp
    q, s, e1 = comp.compress_pytree({"w": g}, {"w": e0})
    q, s, e1 = q["w"], s["w"], e1["w"]
    gf = g.float() + e0
    deq = comp.decompress_pytree({"w": q}, {"w": s})["w"]
    out = dict(
        q_int8_in_range=bool(q.dtype == torch.int8
                             and int(q.abs().max()) <= 127),
        deq_over_half_scale=float((deq.double() - gf.double()).abs().max()
                                  / (float(s) / 2)),
        ef_bits_equal=bool(torch.equal(e1, gf - deq)))
    err = torch.zeros_like(gf)
    total = torch.zeros(gf.shape, dtype=torch.float64, device=gf.device)
    s_max = 0.0
    for _ in range(DP_REPEATS):
        if fault:
            err.zero_()
        q, s, e = comp.compress_pytree({"w": g}, {"w": err})
        total += comp.decompress_pytree(q, s)["w"].double()
        err, s_max = e["w"], max(s_max, float(s["w"]))
    mean_err = float((total / DP_REPEATS - g.double()).abs().max())
    out.update(mean_err=mean_err, mean_err_abs_limit=2e-2,
               mean_over_bound=mean_err / (s_max / (2 * DP_REPEATS)),
               max_abs_g=float(g.float().abs().max()), scale=s_max)
    return out


def ef_step_check(model, step_fn, state, batch):
    """One compressed step on ``batch`` → whether the DP_LEAF of the new
    ef equals (g + ef_old) - deq(g + ef_old) bit for bit, g that leaf's
    gradient on the same parameters and batch (value_and_grad, run first:
    it is deterministic), and the leaf's largest difference."""
    import torch
    from repro_torch.optim import compression as comp
    from repro_torch.train.step import value_and_grad
    _, grads = value_and_grad(model, state["params"], batch)
    g = leaf_at(grads, DP_LEAF).clone()
    del grads
    e_old = leaf_at(state["ef"], DP_LEAF).clone()
    state, _ = step_fn(state, batch)
    gf = e_old + g
    s = comp._scale(gf)
    want = gf - comp._rounded(gf, s).mul_(s)
    got = leaf_at(state["ef"], DP_LEAF)
    torch.cuda.synchronize()
    return state, g, e_old, dict(
        bits_equal=bool(torch.equal(got, want)),
        max_diff_over_scale=float((got - want).abs().max() / s))


def phase_dp(card: str):
    """(o) qwen3-14b at full width cut to DP_LAYERS, the compressed
    data-parallel step on a one-rank NCCL group against the uncompressed
    step (the main path: launches counted), the ef carried bit for bit with
    a planted fault, the compression's invariants on a leaf of the real
    gradients, and the one-stage pipeline against the sequential layers."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import leaves, tree_map
    from repro_torch.models.registry import build_model
    from repro_torch.models.transformer import layer_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.pipeline import make_pipeline_train_step
    from repro_torch.train.dp_compressed import (
        COMPRESSION_RANGE, init_compressed_state,
        make_compressed_dp_train_step)
    from repro_torch.train.step import init_state, make_train_step

    t_phase = time.perf_counter()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    dev = torch.device(DEVICE)
    check(not dist.is_initialized(), "a process group exists before (o)")
    mesh = make_host_mesh(device=DEVICE)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    check(dist.get_backend() == backend and tuple(mesh.shape) == (1, 1),
          f"(o) mesh {tuple(mesh.shape)} on {dist.get_backend()}")
    full = get_arch(TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=DP_LAYERS)
    check(cfg.d_model == QWEN["d"] and cfg.dtype == torch.bfloat16,
          f"{TRAIN_ARCH} config changed")
    model = build_model(cfg, remat_policy="full")
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                          total_steps=DP_STEPS)
    ds = SyntheticTokens(cfg.vocab, TRAIN_S, TRAIN_B, seed=0)
    batches = [{k: torch.as_tensor(v).to(dev)
                for k, v in ds.batch_at(i).items()} for i in range(DP_STEPS)]

    def gen():
        return torch.Generator(device=dev).manual_seed(0)

    base_step = make_train_step(model, opt_cfg)
    dp_step = make_compressed_dp_train_step(model, opt_cfg, mesh)
    log(f"(o) {TRAIN_ARCH}, {DP_LAYERS} of its {full.n_layers} layers at "
        f"full width: {cfg.param_count() / 1e9:.3f} B parameters; "
        f"B={TRAIN_B} S={TRAIN_S}, remat full, AdamW lr {TRAIN_LR} warmup "
        f"{TRAIN_WARMUP}; mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
        f"on {dist.get_backend()}")
    # ---- turn 1: the baseline, then the compressed step (the main path:
    # counts set to 0 just before, read just after)
    state, base = dp_run(base_step, lambda: init_state(model, gen()),
                         batches, DP_STEPS, "uncompressed step")
    n_params = sum(t.numel() for t in leaves(state["params"]))
    del state
    reset_counts()
    rk.rmsnorm_bwd.launches = 0
    fa.flash_attention_bwd.launches = 0
    for route in fa.flash_attention_bwd.launches_by_route:
        fa.flash_attention_bwd.launches_by_route[route] = 0
    events = []
    with timed_compression(events):
        state, comp = dp_run(dp_step,
                             lambda: init_compressed_state(model, gen()),
                             batches, DP_STEPS, "compressed step",
                             profile=DP_PROFILE_STEP, sync=DP_SYNC_STEP)
    launches = counts()
    bwd_launches = {"rmsnorm_bwd": rk.rmsnorm_bwd.launches,
                    "flash_attention_bwd": fa.flash_attention_bwd.launches}
    bwd_by_route = dict(fa.flash_attention_bwd.launches_by_route)
    # ----
    n_l, n_s = DP_LAYERS * DP_STEPS, DP_STEPS
    want = {"flash_attention": 2 * n_l, "rmsnorm": 8 * n_l + n_s,
            "flash_attention_bwd": n_l, "rmsnorm_bwd": 4 * n_l + n_s}
    have = {"flash_attention": launches["flash_attention"],
            "rmsnorm": launches["rmsnorm"], **bwd_launches}
    log(f"(o) launches in {n_s} compressed steps: {have} (flash attention "
        f"by route {launches['flash_attention_by_route']}, backward by "
        f"route {bwd_by_route})")
    check(have == want and launches["flash_attention_by_route"]["simt"] == 0
          and bwd_by_route == {"wgmma": n_l, "simt": 0},
          f"(o) launches {have}, expected {want} on the tensor-core routes")
    bwd_launches["flash_attention_bwd_by_route"] = bwd_by_route
    # the compression's device ms: CUDA events around it in the timed
    # steps, and its kernels in the profiled step's trace
    comp_ms = [s.elapsed_time(e) for i, (s, e) in enumerate(events)
               if i in comp["step_ms"] and i > 0]
    bound = n_params * DP_BYTES_PER_PARAM / MEM_BYTES_PER_S * 1e3
    prof = comp["profile"]
    if prof["busy"] is None:
        traced = (None, 0)
        log("(o) profiled step: the trace holds no kernel; not measured")
    else:
        traced = range_kernel_ms(OUT / "dp_step_trace.json",
                                 COMPRESSION_RANGE)
        parts, _ = kernel_parts(OUT / "dp_step_trace.json")
        prof.update(parts_ms=parts, idle=1 - prof["busy"] / prof["wall"])
        log(f"(o) profiled compressed step {DP_PROFILE_STEP}: host "
            f"{prof['wall']:.1f} ms, device busy {prof['busy']:.1f} ms "
            f"(idle share {prof['idle']:.3f}), {prof['kernels']} kernels; "
            f"the compression's {traced[1]} kernels {traced[0]} ms; by "
            f"part: " + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))
    med = statistics.median(comp_ms)
    log(f"(o) the compression: {med:.2f} ms a step (events, "
        f"{[round(v, 2) for v in comp_ms]}), {traced[0]} ms of kernels in "
        f"the profiled step; bound {bound:.2f} ms ({DP_BYTES_PER_PARAM} "
        f"bytes a parameter at {MEM_BYTES_PER_S / 1e12:g} TB/s): share "
        f"{bound / med:.3f}; {card}")
    # ---- the losses
    b_l, c_l = base["losses"], comp["losses"]
    log(f"(o) first loss: compressed {c_l[0]!r}, uncompressed {b_l[0]!r}; "
        f"last {c_l[-1]:.5f} and {b_l[-1]:.5f} (|difference| "
        f"{abs(c_l[-1] - b_l[-1]):.5f}, limit {DP_LOSS_TOL})")
    check(c_l[0] == b_l[0], f"(o) first losses differ: {c_l[0]!r} against "
                            f"{b_l[0]!r}")
    check(c_l[-1] < c_l[0] and b_l[-1] < b_l[0],
          f"(o) a loss curve does not fall: {c_l}, {b_l}")
    check(abs(c_l[-1] - b_l[-1]) < DP_LOSS_TOL,
          f"(o) last losses {c_l[-1]} and {b_l[-1]} differ by "
          f"{DP_LOSS_TOL} or more")
    check(comp["free_gb"] >= DP_FREE_GB,
          f"(o) leaves {comp['free_gb']:.2f} GB free, under {DP_FREE_GB:g}")
    # ---- the ef carried, and the planted fault
    state, g, e_old, clean = ef_step_check(model, dp_step, state, batches[0])
    with ef_not_carried():
        state, _, _, faulty = ef_step_check(model, dp_step, state,
                                            batches[1])
    log(f"(o) the ef of {'/'.join(DP_LEAF)} after a step against (g + ef) "
        f"- deq: {clean}; with the ef not carried (planted): {faulty}")
    check(clean["bits_equal"] and not faulty["bits_equal"],
          f"(o) ef check {clean}, with the planted fault {faulty}")
    leaf = compression_checks(g, e_old, fault=False)
    leaf_fault = compression_checks(g, e_old, fault=True)
    log(f"(o) the compression on {'/'.join(DP_LEAF)} ({g.numel()} entries) "
        f"of the real gradients: {leaf}; with the error not carried "
        f"between the repeats (planted): mean over bound "
        f"{leaf_fault['mean_over_bound']:.3f}")
    check(leaf["q_int8_in_range"] and leaf["ef_bits_equal"]
          and leaf["deq_over_half_scale"] <= DP_HALF_SCALE_LIMIT
          and leaf["mean_err"] <= leaf["mean_err_abs_limit"]
          and leaf["mean_over_bound"] <= DP_MEAN_LIMIT
          and leaf_fault["mean_over_bound"] > DP_MEAN_LIMIT,
          f"(o) compression invariants {leaf}, planted {leaf_fault}")
    del g, e_old
    # ---- the one-stage pipeline against the sequential layers
    pos = torch.arange(TRAIN_S, device=dev)

    def layer_fn(x, lp):
        return model._layer_train(x, lp, pos)
    layers = state["params"]["layers"]
    x = torch.randn((DP_MICRO, 1, TRAIN_S, cfg.d_model), generator=gen(),
                    device=dev, dtype=torch.float32).to(cfg.dtype)
    reset_counts()
    with torch.inference_mode():
        run = make_pipeline_train_step(layer_fn, 1, DP_MICRO, mesh)
        piped = run(tree_map(lambda t: t.unsqueeze(0), layers), x)
        pipe_launches = counts()
        same = []
        for m in range(DP_MICRO):
            h = x[m]
            for i in range(DP_LAYERS):
                h = layer_fn(h, layer_params(layers, i))
            same.append(bool(torch.equal(piped[m], h)))
    log(f"(o) one-stage pipeline, {DP_MICRO} microbatches of (1, {TRAIN_S}, "
        f"{cfg.d_model}) through {DP_LAYERS} layers: bit-equal to the "
        f"layers applied to each in turn {same}; launches "
        f"{ {k: pipe_launches[k] for k in ('flash_attention', 'rmsnorm')} }")
    check(all(same), f"(o) pipeline against the sequential layers: {same}")
    check(pipe_launches["flash_attention"] == DP_MICRO * DP_LAYERS
          and pipe_launches["rmsnorm"] == 4 * DP_MICRO * DP_LAYERS,
          f"(o) pipeline launches {pipe_launches}")
    del state, layers, x, piped, h
    # ---- turn 2 of the times: compressed, then uncompressed
    state, comp2 = dp_run(dp_step,
                          lambda: init_compressed_state(model, gen()),
                          batches, DP_TURN_STEPS,
                          "compressed step, second turn")
    del state
    state, base2 = dp_run(base_step, lambda: init_state(model, gen()),
                          batches, DP_TURN_STEPS,
                          "uncompressed step, second turn")
    del state
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    toks = TRAIN_B * TRAIN_S
    turns = {"compressed": [comp["ms"], comp2["ms"]],
             "uncompressed": [base["ms"], base2["ms"]]}
    log(f"(o) step ms in turns (uncompressed, compressed, compressed, "
        f"uncompressed): {base['ms']:.1f}, {comp['ms']:.1f}, "
        f"{comp2['ms']:.1f}, {base2['ms']:.1f}; tokens/s compressed "
        f"{toks / comp['ms'] * 1e3:.0f}; peak GB allocated "
        f"{comp['peak_gb']:.2f} and {comp2['peak_gb']:.2f} against "
        f"{base['peak_gb']:.2f} and {base2['peak_gb']:.2f}; phase (o) "
        f"{time.perf_counter() - t_phase:.1f} s; {card}")
    return launches, bwd_launches, pipe_launches, dict(
        layers=DP_LAYERS, params=n_params, step_ms_turns=turns,
        peak_gb={"compressed": [comp["peak_gb"], comp2["peak_gb"]],
                 "uncompressed": [base["peak_gb"], base2["peak_gb"]]},
        free_gb=comp["free_gb"], total_gb=comp["total_gb"],
        losses={"compressed": c_l, "uncompressed": b_l},
        compression_ms=med, compression_ms_steps=comp_ms,
        compression_traced_ms=traced[0], compression_bound_ms=bound,
        compression_share_of_bound=bound / med, profile=prof,
        ef_check=clean, ef_check_planted=faulty, leaf_checks=leaf,
        leaf_checks_planted=leaf_fault, pipeline_bit_equal=all(same),
        seconds=time.perf_counter() - t_phase)


# ------------------------------------------------------ (p) across ranks
# phase (p): TP_RANKS processes share the one card over a gloo group with
# CUDA tensors (NCCL refuses two ranks on one device), a FileStore under
# TP_DIR; the parent takes the one-rank readings, then the ranks run the
# same work on their shards
TP_RANKS = 4
TP_DIR = ROOT / "build" / "chip_smoke_tp"
# (p1) the serve loop after the prefill step: a prompt of 4 tokens, then
# 8 greedy steps (each a round trip of 81 small all-reduces); 12 cache
# positions, which a sequence sharded over 4 ranks divides
TP_PROMPT, TP_GEN = 4, 8
# (p1)/(p2) the prefill step's batch, cut from PREFILL_B: gloo stages the
# 81 all-reduces of its (B, 4096, 5120) bf16 residual stream through the
# host, 33.4 s a step at B=4 (PERF.md, section 6); the serve loop keeps
# PREFILL_B
TP_PREFILL_B = 1
# (p2) qwen3-moe-235b-a22b cut to this depth: the ranks draw the model in
# turns, so the card holds the full draw of the last rank beside the four
# ranks' shards, twice the model's 4.977 GB a layer and 2.49 GB of
# embeddings: 2 x 32.35 GB at 6 layers plus four processes' contexts
# leaves about 12 GB of the 80 GB free (7 layers would leave 2 GB)
TP_MOE_LAYERS = 6
# (p3) qwen3-14b cut per mesh: a training rank holds 12 bytes a parameter
# of its shards (bf16 weights and gradients, float32 moments); on (1, 4)
# the card holds the state once (12 x (1.557 B + 0.33 B a layer), 38.6 GB
# at 8 layers), on (2, 2) twice (2 layers: 53 GB), beside four processes'
# activations and logits of B=2 x S=2048 (a few GB each)
TP_TRAIN_LAYERS = {(1, 4): 8, (2, 2): 2}
TP_TRAIN_STEPS = 4
# (p3) seed 0 trains TP_TRAIN_STEPS steps, seed 1 one step
TP_TRAIN_SEEDS = (0, 1)
# (p3) limits against the one-rank step on the same batches: the first
# loss (absolute) and every step's grad norm (relative to the one-rank
# one), set before the first run; and each gradient leaf's norm after the
# first step (relative), set between the clean runs' readings and the
# planted fault's (PERF.md, section 6)
TP_TRAIN_TOL = {"first_loss": 2e-2, "grad_norm": 2e-2,
                "leaf_grad_norm": 5e-2}
# a command the ranks must finish within; a rank still in it a little
# before prints every thread's stack
TP_TIMEOUT_S = 420


def tp_worker(rank: int, n: int, store: str, device: str, cmds, results):
    """A rank of phase (p): joins the gloo group, then runs the commands
    it is sent until "stop", putting (rank, command, readings, error)."""
    import faulthandler
    import traceback
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1 if device == "cpu" else 2)
    dist.init_process_group("gloo", store=dist.FileStore(store, n),
                            rank=rank, world_size=n)
    try:
        while True:
            cmd, kw = cmds.get()
            if cmd == "stop":
                break
            faulthandler.dump_traceback_later(TP_TIMEOUT_S - 20)
            try:
                out = TP_COMMANDS[cmd](rank, device, **kw)
            except BaseException:
                results.put((rank, cmd, None, traceback.format_exc()))
                raise
            finally:
                faulthandler.cancel_dump_traceback_later()
            tp_free(device)     # the command's tensors, cached, go back
            results.put((rank, cmd, out, None))
    finally:
        dist.destroy_process_group()


class TpRanks:
    """The phase's rank processes (spawned, started together), sent
    commands one at a time; every process ends with the block."""

    def __init__(self, n: int, device: str):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        TP_DIR.mkdir(parents=True, exist_ok=True)
        store = TP_DIR / f"store_{os.getpid()}"
        if store.exists():
            store.unlink()
        self.n = n
        self.results = ctx.Queue()
        self.cmds = [ctx.Queue() for _ in range(n)]
        self.procs = [ctx.Process(target=tp_worker, daemon=True, args=(
            r, n, str(store), device, self.cmds[r], self.results))
            for r in range(n)]
        for p in self.procs:
            p.start()

    def run(self, cmd: str, **kw) -> list:
        """Every rank's readings of ``cmd`` (a failure on any rank, or no
        answer within TP_TIMEOUT_S, fails the phase)."""
        import queue
        for q in self.cmds:
            q.put((cmd, kw))
        out = [None] * self.n
        deadline = time.monotonic() + TP_TIMEOUT_S
        for _ in range(self.n):
            try:
                rank, got, res, err = self.results.get(
                    timeout=max(1.0, deadline - time.monotonic()))
            except queue.Empty:
                raise SmokeFailure(f"(p) {cmd}: no answer from every rank "
                                   f"within {TP_TIMEOUT_S} s")
            check(err is None, f"(p) {cmd} failed on rank {rank}:\n{err}")
            out[rank] = res
        return out

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for q in self.cmds:
            q.put(("stop", {}))
        for p in self.procs:
            p.join(timeout=60)
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        return False


@contextlib.contextmanager
def tp_recorded():
    """Within the block, the shapes the flash-attention and RMSNorm
    dispatches see: a dict of sets, ``attention`` holding (q heads, key/
    value heads, sequence, head dim) and ``rmsnorm`` (rank, last dim,
    heads of a 4-d view)."""
    from unittest import mock

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    seen = {"attention": set(), "rmsnorm": set()}
    real_fa, real_rn = fa_ops.attention, rn_ops.rmsnorm

    def attention(q, k, v, **kw):
        seen["attention"].add((q.shape[1], k.shape[1], q.shape[2],
                               q.shape[3]))
        return real_fa(q, k, v, **kw)

    def rmsnorm(x, w, eps=1e-6, impl=None):
        seen["rmsnorm"].add((x.dim(), x.shape[-1],
                             x.shape[1] if x.dim() == 4 else 0))
        return real_rn(x, w, eps, impl=impl)

    with mock.patch.object(fa_ops, "attention", attention), \
            mock.patch.object(rn_ops, "rmsnorm", rmsnorm):
        yield seen


def tp_leaf_norms(grads, prefix: str = "") -> dict:
    """Each gradient leaf's norm (its "/"-joined path → float), DTensor
    leaves summed across their shards once (``global_norm`` of the leaf
    alone; a collective on a mesh)."""
    from repro_torch.optim.adamw import global_norm
    if isinstance(grads, dict):
        out = {}
        for k in sorted(grads):
            out.update(tp_leaf_norms(grads[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: float(global_norm({"g": grads}))}


@contextlib.contextmanager
def tp_first_grads():
    """Within the block, the train step's first update reads its
    gradients leaf by leaf: the yielded dict gets :func:`tp_leaf_norms`
    of them."""
    from unittest import mock

    from repro_torch.train import step as step_mod
    real, seen = step_mod.adamw_update, {}

    def update(cfg, params, grads, state):
        if not seen:
            seen.update(tp_leaf_norms(grads))
        return real(cfg, params, grads, state)
    with mock.patch.object(step_mod, "adamw_update", update):
        yield seen


@contextlib.contextmanager
def tp_fault_grad_labels():
    """(p3)'s planted fault: a weight's local gradient in a local region
    labelled with the weight's own placements (``to_local``'s default),
    so a replicated weight applied to sharded activations, as q_norm and
    k_norm on the heads, keeps each rank's partial sum as if whole."""
    from unittest import mock

    from repro_torch.models import common
    with mock.patch.object(common, "weight_grad",
                           lambda w, act: tuple(w.placements)):
        yield


def tp_leaf_err(per_rank: list, want: dict):
    """The largest relative difference of a gradient leaf's norm on any
    rank from the one-rank run's → (difference, "rank r: leaf")."""
    worst = (0.0, None)
    for r, got in enumerate(per_rank):
        check(sorted(got) == sorted(want),
              f"(p3) rank {r}: gradient leaves {sorted(got)}")
        for k, b in want.items():
            err = abs(got[k] - b) / b if b else abs(got[k])
            worst = max(worst, (err, f"rank {r}: {k}"),
                        key=lambda t: t[0])
    return worst


def tp_counts() -> dict:
    """This process's launches of the four kernels of the path."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.rmsnorm import kernel as rk
    return {"flash_attention": fa.flash_attention.launches,
            "flash_attention_by_route": dict(
                fa.flash_attention.launches_by_route),
            "flash_attention_with_stats": fa.flash_attention.stats_launches,
            "rmsnorm": rk.rmsnorm.launches,
            "flash_attention_bwd": fa.flash_attention_bwd.launches,
            "flash_attention_bwd_by_route": dict(
                fa.flash_attention_bwd.launches_by_route),
            "rmsnorm_bwd": rk.rmsnorm_bwd.launches}


def tp_reset_counts() -> None:
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.rmsnorm import kernel as rk
    reset_counts()
    rk.rmsnorm_bwd.launches = 0
    fa.flash_attention_bwd.launches = 0
    for route in fa.flash_attention_bwd.launches_by_route:
        fa.flash_attention_bwd.launches_by_route[route] = 0


def tp_log(rank: int, msg: str) -> None:
    """A progress line from rank 0 of phase (p)."""
    if rank == 0:
        log(f"    (p) rank 0: {msg}")


def tp_sync(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def tp_memory(device: str) -> dict:
    """Peak allocated and reserved GB of this process, and the card's free
    GB now (every process's use counted)."""
    import torch
    if device != "cuda":
        return {"peak_gb": None, "reserved_gb": None, "card_free_gb": None}
    free, _ = torch.cuda.mem_get_info()
    return {"peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
            "card_free_gb": free / 1e9}


def tp_config(arch: str, layers, reduced: bool):
    import torch
    from repro_torch.configs.registry import get_arch, reduced_config
    cfg = get_arch(arch)
    if reduced:
        cfg = dataclasses.replace(reduced_config(cfg), dtype=torch.bfloat16)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def tp_inputs(cfg, b: int, s: int):
    """The prefill tokens (b, s) and the serve prompt (PREFILL_B,
    TP_PROMPT) (numpy, seeded): the same on every rank and in the
    parent."""
    import numpy as np
    rng = np.random.default_rng(0)
    return (rng.integers(0, cfg.vocab, (b, s)).astype(np.int64),
            rng.integers(0, cfg.vocab, (PREFILL_B, TP_PROMPT)).astype(
                np.int64))


def tp_free(device: str) -> None:
    import gc

    import torch
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def tp_serve_rank(rank: int, device: str, *, arch: str, layers, seed: int,
                  shards: int, b: int, s: int, reduced: bool, out: str,
                  serve: bool) -> dict:
    """(p1)/(p2) on one rank: the model placed on make_host_mesh(shards)
    (the ranks drawing in turns), one prefill step, and with ``serve``
    the serve loop fed the one-rank run's tokens (``out``'s reference)
    with greedy picks read from the vocab-sharded logits; rank 0 saves
    the gathered logits to ``out``."""
    import torch
    from repro_torch.launch.mesh import (axis_size, make_host_mesh, place,
                                         place_in_turns)
    from repro_torch.launch.serve import greedy, serve_loop
    from repro_torch.models.registry import build_model
    from repro_torch.models.common import full
    from repro_torch.train.step import make_prefill_step
    tp_free(device)
    dev = torch.device(device)
    cfg = tp_config(arch, layers, reduced)
    model = build_model(cfg)
    mesh = make_host_mesh(shards, device=device)
    drawn = {}

    def draw():
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
        tp_sync(device)
        drawn.update(tp_memory(device))
        return params
    t0 = time.perf_counter()
    params = place_in_turns(draw, model.param_specs(), mesh)
    tp_sync(device)
    place_s = time.perf_counter() - t0
    tp_log(rank, f"placed {arch} in {place_s:.1f} s")
    placed = tp_memory(device)
    tp_free(device)
    tokens, prompt = tp_inputs(cfg, b, s)
    ref = torch.load(out + ".ref", map_location=dev) if serve else None
    picked, whole = [], []

    def replay(logits, i):
        picked.append(full(greedy(logits, i)))
        whole.append(full(logits).argmax(-1))
        return ref["tokens"][:, i]
    cache_specs = model.cache_specs(model_axis=axis_size(mesh, "model"))
    tp_reset_counts()
    with tp_recorded() as seen:
        tp_sync(device)
        t0 = time.perf_counter()
        logits = make_prefill_step(model)(params, {"tokens": tokens})
        tp_sync(device)
        prefill_s = time.perf_counter() - t0
        tp_log(rank, f"prefill step in {prefill_s:.2f} s")
        after_prefill = tp_counts()
        mem = tp_memory(device)
        res = serve_loop(model, params, prompt, TP_GEN, replay,
                         lambda c: place(c, cache_specs, mesh)) \
            if serve else None
    launches = tp_counts()
    logits = full(logits)
    if rank == 0:
        torch.save({"prefill": logits.cpu(),
                    "serve": None if res is None else res.logits.cpu(),
                    "picked": None if res is None
                    else torch.stack(picked, 1).cpu()}, out)
    out_d = dict(
        mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
        local_shapes=tp_local_shapes(params), place_s=place_s,
        prefill_s=prefill_s,
        prefill_launches=after_prefill, launches=launches,
        decode_s=None if res is None else res.decode_s,
        greedy_picks=sum(t.numel() for t in picked),
        greedy_not_argmax=sum(int((a != b).sum())
                              for a, b in zip(picked, whole)),
        serve_prompt_s=None if res is None else res.prefill_s,
        attention_shapes=sorted(seen["attention"]),
        rmsnorm_shapes=sorted(seen["rmsnorm"]),
        memory_after_draw=drawn, memory_placed=placed,
        memory_after_prefill=mem, memory=tp_memory(device))
    return out_d


def tp_local_shapes(params) -> dict:
    """Rank-local shapes of a few leaves of a placed model."""
    lay = params["layers"]
    ffn = lay["moe"] if "moe" in lay else lay["mlp"]
    return {"wq": list(lay["attn"]["wq"].to_local().shape),
            "w_up": list(ffn["w_up"].to_local().shape),
            "embed": list(params["lm"]["embed"].to_local().shape)}


def tp_train_rank(rank: int, device: str, *, layers: int, seed: int,
                  shards: int, steps: int, reduced: bool, s: int,
                  fault: bool = False) -> dict:
    """(p3) on one rank: qwen3-14b cut to ``layers``, its train state
    placed on make_host_mesh(shards), ``steps`` train steps (full remat)
    on SyntheticTokens batches → losses, grad norms, the first step's
    gradient leaves' norms, step times, launches, shapes, memory.  With
    ``fault``, under :func:`tp_fault_grad_labels`."""
    import torch
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_state, make_train_step
    tp_free(device)
    dev = torch.device(device)
    cfg = tp_config(TRAIN_ARCH, layers, reduced)
    model = build_model(cfg, remat_policy="full")
    mesh = make_host_mesh(shards, device=device)
    t0 = time.perf_counter()
    state = init_state(model, torch.Generator(device=dev).manual_seed(seed),
                       mesh=mesh)
    tp_sync(device)
    place_s = time.perf_counter() - t0
    placed = tp_memory(device)
    tp_free(device)
    ds = SyntheticTokens(cfg.vocab, s, TRAIN_B, seed=0)
    step = make_train_step(model, AdamWConfig(
        lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TP_TRAIN_STEPS))
    losses, norms, secs = [], [], []
    tp_log(rank, f"placed the train state in {place_s:.1f} s")
    tp_reset_counts()
    with tp_recorded() as seen, tp_first_grads() as leaf_norms, \
            (tp_fault_grad_labels() if fault else contextlib.nullcontext()):
        for i in range(steps):
            tp_sync(device)
            t0 = time.perf_counter()
            state, m = step(state, ds.batch_at(i))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            secs.append(time.perf_counter() - t0)
            tp_log(rank, f"train step {i} in {secs[-1]:.2f} s")
    launches = tp_counts()
    out = dict(mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
               place_s=place_s, losses=losses, grad_norms=norms,
               leaf_norms=leaf_norms,
               step_s=secs, launches=launches,
               attention_shapes=sorted(seen["attention"]),
               rmsnorm_shapes=sorted(seen["rmsnorm"]),
               memory_placed=placed, memory=tp_memory(device))
    return out


TP_COMMANDS = {"serve": tp_serve_rank, "train": tp_train_rank}


def tp_reference_serve(device: str, *, arch: str, layers, seed: int, b: int,
                       s: int, reduced: bool, out: str, serve: bool) -> dict:
    """The one-rank run of (p1)/(p2) in this process, saved to ``out``
    (the prefill's logits, and the serve loop's greedy tokens and
    logits)."""
    import torch
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models.registry import build_model
    from repro_torch.train.step import make_prefill_step
    tp_free(device)
    dev = torch.device(device)
    cfg = tp_config(arch, layers, reduced)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    tokens, prompt = tp_inputs(cfg, b, s)
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    tp_sync(device)
    t0 = time.perf_counter()
    logits = make_prefill_step(model)(params, batch)
    tp_sync(device)
    prefill_s = time.perf_counter() - t0
    res = serve_loop(model, params, prompt, TP_GEN) if serve else None
    ref = {"prefill": logits.cpu(),
           "serve": None if res is None else res.logits.cpu(),
           "tokens": None if res is None
           else torch.cat([torch.from_numpy(prompt), res.tokens.cpu()],
                          1)[:, TP_PROMPT:]}
    torch.save(ref, out + ".ref")
    mem = tp_memory(device)
    del params, logits, res
    tp_free(device)
    return dict(prefill_s=prefill_s, memory=mem, ref=ref)


def tp_reference_train(device: str, *, layers: int, seed: int, steps: int,
                       reduced: bool, s: int) -> dict:
    """The one-rank run of (p3) in this process."""
    import torch
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_state, make_train_step
    tp_free(device)
    dev = torch.device(device)
    cfg = tp_config(TRAIN_ARCH, layers, reduced)
    model = build_model(cfg, remat_policy="full")
    state = init_state(model, torch.Generator(device=dev).manual_seed(seed))
    ds = SyntheticTokens(cfg.vocab, s, TRAIN_B, seed=0)
    step = make_train_step(model, AdamWConfig(
        lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TP_TRAIN_STEPS))
    losses, norms, secs = [], [], []
    with tp_first_grads() as leaf_norms:
        for i in range(steps):
            tp_sync(device)
            t0 = time.perf_counter()
            state, m = step(state, ds.batch_at(i))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            secs.append(time.perf_counter() - t0)
    mem = tp_memory(device)
    del state
    tp_free(device)
    return dict(losses=losses, grad_norms=norms, leaf_norms=leaf_norms,
                step_s=secs, memory=mem)


def tp_logit_err(got, want) -> float:
    return max_abs_err(got.float(), want.float())


def tp_check_launches(tag: str, per_rank: list, want: dict,
                      device: str) -> dict:
    """Each rank's launches against ``want`` (per rank, tensor-core routes
    only) → the launches summed over the ranks.  On the CPU (a rehearsal:
    the plain versions count nothing) a mismatch is printed."""
    total = {"flash_attention_by_route": {"wgmma": 0, "simt": 0}}
    for r, got in enumerate(per_rank):
        have = {k: got[k] for k in want}
        if device != "cuda" and have != want:
            log(f"(p) {tag}: rank {r} launched {have} on the CPU")
            continue
        check(have == want, f"(p) {tag}: rank {r} launched {have}, "
                            f"expected {want}")
        check(got["flash_attention_by_route"]["simt"] == 0
              and got["flash_attention_bwd_by_route"]["simt"] == 0,
              f"(p) {tag}: rank {r} took the SIMT route: {got}")
        for k in ("flash_attention", "flash_attention_with_stats",
                  "rmsnorm", "flash_attention_bwd", "rmsnorm_bwd"):
            total[k] = total.get(k, 0) + got[k]
        for route, k in got["flash_attention_by_route"].items():
            total["flash_attention_by_route"][route] += k
    return total


def phase_tensor_parallel(card: str, device: str = None,
                          reduced: bool = False, s: int = None):
    """(p) qwen3-14b and qwen3-moe-235b-a22b on TP_RANKS ranks sharing the
    card over gloo: (p1) the prefill step and the serve loop on (1, 4),
    (p2) the moe prefill step on (1, 4), (p3) training on (1, 4) and
    (2, 2); each against the one-rank run in this process, every kernel
    launched on every rank on its shards.  ``device``, ``reduced`` and
    ``s`` rehearse the phase on the CPU."""
    import torch
    device = device or DEVICE
    t_phase = time.perf_counter()
    if device == "cuda":
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    s_prefill = s or PREFILL_S
    s_train = s or TRAIN_S
    moe_layers = 2 if reduced else TP_MOE_LAYERS
    train_layers = {m: 2 for m in TP_TRAIN_LAYERS} if reduced \
        else TP_TRAIN_LAYERS
    TP_DIR.mkdir(parents=True, exist_ok=True)
    out, paths, read = {}, {}, {}
    with TpRanks(TP_RANKS, device) as ranks:
        log(f"(p) {TP_RANKS} ranks started on one {device} device over a "
            f"gloo group with {device} tensors")
        # ---- (p1) qwen3-14b at full width and depth, prefill and serve
        kw = dict(arch=TRAIN_ARCH, layers=None, seed=0, b=TP_PREFILL_B,
                  s=s_prefill, reduced=reduced,
                  out=str(TP_DIR / "p1.pt"), serve=True)
        one = tp_reference_serve(device, **kw)
        log(f"    (p1) one-rank run: prefill {one['prefill_s']:.2f} s")
        per_rank = ranks.run("serve", shards=TP_RANKS, **kw)
        got = torch.load(kw["out"])
        ref = one.pop("ref")
        cfg = tp_config(TRAIN_ARCH, None, reduced)
        n = cfg.n_layers
        errs = {"prefill": tp_logit_err(got["prefill"], ref["prefill"]),
                "serve": tp_logit_err(got["serve"], ref["serve"])}
        picked_same = int((got["picked"] == ref["tokens"]).sum())
        steps = TP_PROMPT + TP_GEN
        want = {"flash_attention": n, "rmsnorm": (4 * n + 1) * (1 + steps),
                "flash_attention_bwd": 0, "rmsnorm_bwd": 0}
        paths["(p1) qwen3-14b prefill and serve on (1, 4)"] = \
            tp_check_launches("(p1)", [r["launches"] for r in per_rank],
                              want, device)
        not_argmax = [r["greedy_not_argmax"] for r in per_rank]
        read["p1"] = dict(one_rank=one, ranks=per_rank, logit_err=errs,
                          greedy_equal=picked_same,
                          greedy_total=got["picked"].numel(),
                          greedy_not_argmax=not_argmax)
        log(f"(p1) {TRAIN_ARCH}, {n} layers at full width, on "
            f"{per_rank[0]['mesh']}: local shards "
            f"{per_rank[0]['local_shapes']}; "
            f"attention shapes (q heads, kv heads, S, D) "
            f"{per_rank[0]['attention_shapes']}; logits against the one-rank "
            f"run: prefill {errs['prefill']:.4g}, serve {errs['serve']:.4g} "
            f"(limit {AGREE_TOL['decode_vs_prefill']}); greedy picks from "
            f"the sharded logits unequal to the argmax of the gathered "
            f"logits, by rank, {not_argmax} of "
            f"{per_rank[0]['greedy_picks']} (must be 0); equal to the "
            f"one-rank run's {picked_same}/{got['picked'].numel()}; prefill "
            f"{per_rank[0]['prefill_s']:.2f} s (a first call; one rank "
            f"{one['prefill_s']:.2f} s), {steps} decode steps "
            f"{per_rank[0]['serve_prompt_s'] + per_rank[0]['decode_s']:.2f} "
            f"s; per rank peak GB "
            f"{[r['memory_after_prefill']['peak_gb'] for r in per_rank]}, "
            f"card free GB after the draws "
            f"{[r['memory_after_draw']['card_free_gb'] for r in per_rank]}; "
            f"{card}")
        for k, v in errs.items():
            check(v <= AGREE_TOL["decode_vs_prefill"],
                  f"(p1) {k} logits differ from the one-rank run by {v}")
        check(all(r["greedy_picks"] == TP_GEN * PREFILL_B for r in per_rank)
              and not any(not_argmax),
              f"(p1) greedy picks from the sharded logits differ from the "
              f"argmax of the gathered logits: {not_argmax}")
        from repro_torch.models.layers import local_kv_heads
        kv = local_kv_heads(cfg, TP_RANKS, 0)
        hkv_local = cfg.n_kv_heads // TP_RANKS if kv is None else \
            kv[1] - kv[0]
        for r, rr in enumerate(per_rank):
            check(all(a[0] == cfg.n_heads // TP_RANKS and a[1] == hkv_local
                      for a in rr["attention_shapes"]),
                  f"(p1) rank {r} attention shapes {rr['attention_shapes']}")
        # ---- (p2) qwen3-moe-235b-a22b cut, prefill
        kw = dict(arch=MOE_ARCH, layers=moe_layers, seed=0, b=TP_PREFILL_B,
                  s=s_prefill, reduced=reduced,
                  out=str(TP_DIR / "p2.pt"), serve=False)
        one = tp_reference_serve(device, **kw)
        one.pop("ref")
        per_rank = ranks.run("serve", shards=TP_RANKS, **kw)
        got = torch.load(kw["out"])
        ref = torch.load(kw["out"] + ".ref")
        err = tp_logit_err(got["prefill"], ref["prefill"])
        want = {"flash_attention": moe_layers,
                "rmsnorm": 4 * moe_layers + 1, "flash_attention_bwd": 0,
                "rmsnorm_bwd": 0}
        paths[f"(p2) {MOE_ARCH} prefill on (1, 4)"] = tp_check_launches(
            "(p2)", [r["launches"] for r in per_rank], want, device)
        free = [r["memory_after_prefill"]["card_free_gb"] for r in per_rank]
        read["p2"] = dict(one_rank=one, ranks=per_rank, logit_err=err)
        log(f"(p2) {MOE_ARCH}, {moe_layers} layers at full width, on "
            f"{per_rank[0]['mesh']}: local shards "
            f"{per_rank[0]['local_shapes']}; attention shapes "
            f"{per_rank[0]['attention_shapes']}; prefill logits against the "
            f"one-rank run {err:.4g} (limit "
            f"{AGREE_TOL_K['moe']['decode_vs_prefill']}); prefill "
            f"{per_rank[0]['prefill_s']:.2f} s (one rank "
            f"{one['prefill_s']:.2f} s); card free GB after the draws "
            f"{[r['memory_after_draw']['card_free_gb'] for r in per_rank]}, "
            f"after the prefill {free}; {card}")
        check(err <= AGREE_TOL_K["moe"]["decode_vs_prefill"],
              f"(p2) prefill logits differ from the one-rank run by {err}")
        # ---- (p3) training on (1, 4) and (2, 2), and the planted fault
        read["p3"] = {}
        for mesh_shape, layers in train_layers.items():
            for seed in TP_TRAIN_SEEDS:
                steps = TP_TRAIN_STEPS if seed == 0 else 1
                kw = dict(layers=layers, seed=seed, steps=steps,
                          reduced=reduced, s=s_train)
                one = tp_reference_train(device, **kw)
                runs = [False]
                if mesh_shape == (1, TP_RANKS) and seed != TP_TRAIN_SEEDS[0]:
                    runs.append(True)
                for fault in runs:
                    per_rank = ranks.run("train", shards=mesh_shape[1],
                                         fault=fault, **kw)
                    r0 = per_rank[0]
                    loss_err = abs(r0["losses"][0] - one["losses"][0])
                    gn_err = max(abs(a - b) / b for a, b in
                                 zip(r0["grad_norms"], one["grad_norms"]))
                    leaf_err, leaf = tp_leaf_err(
                        [r["leaf_norms"] for r in per_rank],
                        one["leaf_norms"])
                    tag = (f"(p3) {mesh_shape} seed {seed}"
                           + (" planted fault" if fault else ""))
                    log(f"{tag}: {TRAIN_ARCH} cut to {layers} layers, B="
                        f"{TRAIN_B} S={s_train}, mesh {r0['mesh']}: losses "
                        f"{r0['losses']} (one rank {one['losses']}), grad "
                        f"norms {r0['grad_norms']} (one rank "
                        f"{one['grad_norms']}); first loss |diff| "
                        f"{loss_err:.4g}, grad norm largest relative diff "
                        f"{gn_err:.4g}, a gradient leaf's norm after the "
                        f"first step largest relative diff {leaf_err:.4g} "
                        f"({leaf}) (limits {TP_TRAIN_TOL}); step s "
                        f"{[round(v, 2) for v in r0['step_s']]} (one rank "
                        f"{[round(v, 3) for v in one['step_s']]}); per rank "
                        f"peak GB {[r['memory']['peak_gb'] for r in per_rank]}"
                        f"; attention shapes {r0['attention_shapes']}; "
                        f"{card}")
                    read["p3"][tag[5:]] = dict(
                        layers=layers, one_rank=one, ranks=per_rank,
                        first_loss_err=loss_err, grad_norm_rel_err=gn_err,
                        leaf_grad_norm_rel_err=leaf_err, worst_leaf=leaf)
                    if fault:
                        check(leaf_err > TP_TRAIN_TOL["leaf_grad_norm"],
                              f"{tag}: not caught, a gradient leaf's norm "
                              f"within {leaf_err} ({leaf})")
                        continue
                    check(all(r["losses"] == r0["losses"] for r in per_rank),
                          f"{tag}: the ranks' losses differ")
                    check(loss_err <= TP_TRAIN_TOL["first_loss"]
                          and gn_err <= TP_TRAIN_TOL["grad_norm"]
                          and leaf_err <= TP_TRAIN_TOL["leaf_grad_norm"],
                          f"{tag}: first loss |diff| {loss_err}, grad norm "
                          f"relative diff {gn_err}, gradient leaf {leaf} "
                          f"relative diff {leaf_err}")
                    if seed == TP_TRAIN_SEEDS[0]:
                        nl, ns = layers * steps, steps
                        want = {"flash_attention": 2 * nl,
                                "rmsnorm": 8 * nl + ns,
                                "flash_attention_bwd": nl,
                                "rmsnorm_bwd": 4 * nl + ns}
                        paths[f"(p3) {TRAIN_ARCH} training on "
                              f"{mesh_shape}"] = tp_check_launches(
                            tag, [r["launches"] for r in per_rank], want,
                            device)
    if device == "cuda":
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    read["seconds"] = time.perf_counter() - t_phase
    log(f"(p) took {read['seconds']:.1f} s over gloo with {device} tensors "
        f"(collectives staged through the host by gloo); {card}")
    return paths, read


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", choices=("o", "p"), default=None,
                    help="build the kernels, then run this phase alone "
                         "(its checks hold; no result lines)")
    args = ap.parse_args(argv)
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
    if args.phase == "o":
        dp = phase_dp(card)[3]
        log("(o) readings " + json.dumps(dp))
        log(f"done in {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.phase == "p":
        tp = phase_tensor_parallel(card)[1]
        log("(p) readings " + json.dumps(tp, default=str))
        log(f"done in {time.perf_counter() - t_start:.1f} s")
        return 0
    t_last = [t_start]

    def took(phase: str) -> None:
        now = time.perf_counter()
        log(f"{phase} took {now - t_last[0]:.1f} s")
        t_last[0] = now
    took("(a)")
    phase_kernel_vs_plain(max_err)
    took("(b)")
    launches, totals, n_runs, cell_ms = phase_main_path(max_err)
    took("(c)")
    phase_reconfig(max_err)
    took("(d)")
    runtime_launches, runtime = phase_runtime(card, cell_ms)
    took("(h)")
    serving_launches, serving = phase_serving(card)
    took("(i)")
    verified_launches, verified = phase_verified(card)
    took("(j)")
    err = max(max_err)
    check(err == 0.0, f"max abs error {err}")
    rms, rms_errs = phase_rmsnorm()
    took("(e)")
    fa, fa_errs, fa_shares = phase_flash_attention()
    took("(f)")
    model_launches, agree_errs = phase_model()
    took("(g)")
    for name in ("rmsnorm", "flash_attention"):
        check(model_launches[name] > 0,
              f"the serving path never launched {name}")
    paths = {"(g) qwen3-14b": model_launches}
    families = {}
    for kind, label in (("moe", f"(k) {MOE_ARCH} ({MOE_LAYERS} layers)"),
                        ("ssm", f"(k) {MAMBA_ARCH}"),
                        ("hybrid", f"(l) {ZAMBA_ARCH}"),
                        ("audio", f"(l) {WHISPER_ARCH}")):
        paths[label], families[label] = phase_family(kind, card)
        took(label)
    log("(k) and (l) readings " + json.dumps(families))
    paper_launches, paper = phase_paper_benchmarks(card)
    took("(m)")
    rms_bwd, fa_bwd, bwd_errs = phase_backward_kernels()
    took("(n1)")
    train_launches, bwd_launches, train = phase_train(card)
    took("(n2)")
    paths["(n) qwen3-14b training"] = train_launches
    dp_launches, dp_bwd, pipe_launches, dp = phase_dp(card)
    took("(o)")
    paths["(o) qwen3-14b compressed DP"] = dp_launches
    paths["(o) one-stage pipeline"] = pipe_launches
    tp_paths, tp = phase_tensor_parallel(card)
    took("(p)")
    paths.update(tp_paths)
    bwd_by_path = {name: {"(n) qwen3-14b training": bwd_launches[name],
                          "(o) qwen3-14b compressed DP": dp_bwd[name],
                          **{label: n[name] for label, n in tp_paths.items()
                             if n[name]}}
                   for name in ("rmsnorm_bwd", "flash_attention_bwd")}
    by_path = {name: {label: n[name] for label, n in paths.items()}
               for name in ("rmsnorm", "flash_attention")}
    fa_by_route = {route: sum(n["flash_attention_by_route"][route]
                              for n in paths.values())
                   for route in model_launches["flash_attention_by_route"]}
    for name in ("rmsnorm", "flash_attention", "rmsnorm_bwd",
                 "flash_attention_bwd"):
        check(sum(n[name] for n in tp_paths.values()) > 0,
              f"phase (p) never launched {name}")
    for name in ("rmsnorm_bwd", "flash_attention_bwd"):
        check(bwd_launches[name] > 0, f"training never launched {name}")
    log("(n) readings " + json.dumps(train))
    log("(o) readings " + json.dumps(dp))
    log("(p) readings " + json.dumps(tp, default=str))
    # kernels per backward wrapper call and device ms per step, counted in
    # the profiled training step's trace (None where it holds no kernel)
    prof = train["profile"] or {}
    per_call = prof.get("kernels_per_backward_call",
                        {"RMSNorm backward": None, "attention backward": None})

    def step_part(part):
        return prof["parts_ms"][part] if prof else None
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": [{
        "name": "overlay_exec",
        "route": "cuda",
        "source": "src/repro_torch/csrc/overlay_exec.cu",
        "replaces": "src/repro/kernels/overlay_exec/kernel.py:30",
        "launches": (launches + runtime_launches + serving_launches
                     + verified_launches + paper_launches),
        "launches_by_path": {"(c) run_overlay": launches,
                             "(h) runtime seam": runtime_launches,
                             "(i) serving": serving_launches,
                             "(j) verified": verified_launches,
                             "(m) paper benchmarks": paper_launches,
                             "(p) across ranks (not on its path: the "
                             "models' pointwise datapaths run the overlay "
                             "DFG as torch ops)": 0},
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
        "paper_benchmarks": paper,
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
        "launches_writing_statistics": {
            label: n["flash_attention_with_stats"]
            for label, n in paths.items()},
        "max_statistics_err": fa["max_stats_err"],
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
        "at_zamba2_prefill_shape": fa["zamba2_shape"],
        "at_whisper_shapes": fa["whisper_shapes"],
        "model_agreement_max_abs_err": agree_errs,
    }, {
        "name": "rmsnorm_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm/kernel.py:38 (backward; no "
                    "Pallas counterpart: the JAX package differentiates its "
                    "plain version)",
        "launches": sum(bwd_by_path["rmsnorm_bwd"].values()),
        "launches_by_path": bwd_by_path["rmsnorm_bwd"],
        "kernel_launches_per_call": per_call["RMSNorm backward"],
        "kernel_launches_per_call_by_route": (
            {route: r["kernels_per_call"]
             for route, r in prof["rmsnorm_bwd_by_route"].items()}
            if prof else None),
        "own_run_ms_per_kernel_by_route": (
            {route: r["own_ms_per_kernel"]
             for route, r in prof["rmsnorm_bwd_by_route"].items()}
            if prof else None),
        "match": "dx and dw within 2^-7 (bfloat16) and 1e-4 (float32) of "
                 "max |plain| of ref.rmsnorm_bwd and of autograd through "
                 "ref.rmsnorm; two runs bit-equal; both planted faults "
                 "caught",
        "max_abs_err": bwd_errs[("rmsnorm", "bfloat16", "abs")],
        "max_rel_err": bwd_errs[("rmsnorm", "bfloat16", "rel")],
        "max_abs_err_float32": bwd_errs[("rmsnorm", "float32", "abs")],
        "planted_fault_min_err": bwd_errs[
            "rmsnorm planted fault errors (smallest)"],
        "ms": rms_bwd["ms"],
        "plain_ms": rms_bwd["plain_ms"],
        "bound_ms": rms_bwd["bound_ms"],
        "bound_by": "bytes",
        "library_ms": rms_bwd["library_ms"],
        "heads_views": {name: {k: r[k] for k in (
            "ms", "bound_ms", "library_ms", "share_of_bound",
            "ratio_to_library")}
            for name, r in rms_bwd["shapes"].items() if "heads" in name},
        "heads_view_copies_per_training_step": (
            prof["heads_view_copies"]["copies"] if prof else None),
        "per": f"one call at qwen3-14b's ln1/ln2/final rows (B*S, 5120) "
               f"bf16, B={TRAIN_B}, S={TRAIN_S}, timed with the L2 evicted; "
               f"{4 * TRAIN_LAYERS + 1} calls at three shapes per training "
               f"step of {TRAIN_LAYERS} layers",
        "ms_per_training_step": step_part("RMSNorm backward"),
        "derived_per_training_step": rms_bwd["derived_per_step"],
        "shapes": rms_bwd["shapes"],
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda (wgmma + TMA)",
        "source": "src/repro_torch/csrc/flash_attention_bwd_wgmma.cu",
        "source_simt": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:98 "
                    "(backward; no Pallas counterpart: the JAX package "
                    "differentiates its plain version)",
        "launches": sum(bwd_by_path["flash_attention_bwd"].values()),
        "launches_by_path": bwd_by_path["flash_attention_bwd"],
        "launches_by_route": {
            route: n + dp_bwd["flash_attention_bwd_by_route"][route]
            + (sum(p["flash_attention_bwd"] for p in tp_paths.values())
               if route == "wgmma" else 0)
            for route, n in
            bwd_launches["flash_attention_bwd_by_route"].items()},
        "kernel_launches_per_call": per_call["attention backward"],
        "match": "bfloat16 (tensor-core route) within 1e-5 max|plain| + "
                 "2^-7 |plain| + 2^-7 plain(|.|) of ref.attention_bwd and "
                 "of autograd through ref.attention, elementwise; float32 "
                 "and D 16/32 (SIMT route) within 1e-4 and 2^-7 of max "
                 "|plain|; two runs bit-equal; both planted faults caught",
        "max_abs_err": bwd_errs[("flash_attention", "bfloat16", "abs")],
        "max_rel_err": bwd_errs[("flash_attention", "bfloat16", "rel")],
        "max_share_of_limit": bwd_errs["tensor-core limit shares"],
        "planted_fault_min_share": bwd_errs[
            "planted fault shares (smallest)"],
        "max_abs_err_float32": bwd_errs[("flash_attention", "float32",
                                         "abs")],
        "ms": fa_bwd["ms"],
        "ms_turns": fa_bwd["ms_turns"],
        "simt_ms": fa_bwd["simt_ms"],
        "ratio_to_library": fa_bwd["ratio_to_library"],
        "plain_ms": fa_bwd["plain_ms"],
        "bound_ms": fa_bwd["bound_ms"],
        "bound_by": fa_bwd["bound_by"],
        "library_ms": fa_bwd["library_ms"],
        "per": "one call at q (2, 40, 2048, 128), k/v (2, 8, 2048, 128) "
               f"bf16 causal with the forward's statistics; {TRAIN_LAYERS} "
               f"calls per training step",
        "at_other_cases": fa_bwd["at_other_cases"],
        "ms_per_training_step": step_part("attention backward"),
        "training": train,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
