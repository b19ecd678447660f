#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card; it builds the
overlay executor from ``src/repro_torch/csrc/overlay_exec.cu`` with nvcc.
Phases:

  (a) set-up: the card's name and power limit, the kernel build;
  (b) the executor kernel against its plain PyTorch version on the card,
      bit for bit, on hand-built images covering all 14 opcodes and both
      immediate ports, inputs holding NaN, +-0, +-inf and denormals,
      register files of 3 slots up to ones that force a smaller block, and
      N of 1, 127 and 2^20+37;
  (c) the main path: ``jit_compile`` of the paper's six kernels on two
      overlay sizes, then ``CompiledKernel.run_overlay`` over N = 2^24
      work-items each, held bit for bit against the plain version on the
      card and against ``run_reference`` (numpy), with times and bounds;
  (d) reconfiguration: six programs padded to one signature are swapped
      into one resident image of the one build, also under one captured
      CUDA graph.

Exits non-zero, printing no result, without a card or when any check
fails.  The last line is ``{"ok": true, "device": {...}}``; the line
before it lists each ported kernel with its launches on the main path.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

DEVICE = "cuda"
SPECS = ((8, 8, 2), (32, 8, 2))
N_MAIN = 1 << 24
N_CHECK = (1, 127, (1 << 20) + 37)
N_SWAP = 1 << 20
REPS = 10
# H100 SXM data-sheet rates (NVIDIA): device memory, and float32 outside
# the tensor cores
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


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


def cuda_ms(fn, reps: int = REPS, warm: int = 2):
    """Device times of ``fn`` over ``reps`` runs, by CUDA events, after
    ``warm`` runs: → (median, fastest, slowest) in ms."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
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


def random_image(rng, n_in: int, n_regs: int, n_out: int, m_random: int):
    """An execution image whose first rows cover every (opcode, port)
    pair, followed by ``m_random`` random rows, then moves parking the
    outputs in the last ``n_out`` slots."""
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
        rows.append([op, d, a, b, c, port])
        imms.append(rng.choice(imm_pool) if rng.random() < 0.1
                    else np.float32(rng.standard_normal()))
    for j in range(n_out):
        rows.append([OP_PASS, writable + j,
                     int(rng.integers(writable)), 0, 0, 0])
        imms.append(0.0)
    return np.asarray(rows, np.int32), np.asarray(imms, np.float32)


# ------------------------------------------------------------------ phases
def phase_setup():
    from repro_torch.kernels.overlay_exec import kernel
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "not read"
    log(card)
    t0 = time.perf_counter()
    kernel.LIBRARY.get()
    build_s = time.perf_counter() - t0
    log(f"(a) built overlay_exec for sm_90a in {build_s:.1f} s "
        f"(libraries built or loaded: {kernel.LIBRARY.builds})")
    for line in kernel.LIBRARY.build_log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"    ptxas: {line.strip()}")
    check(kernel.LIBRARY.builds == 1, "kernel library not built once")
    return card


def phase_kernel_vs_plain(max_err: list) -> int:
    import numpy as np
    import torch
    from repro_torch.core.program import N_OPCODES, OP_PASS
    from repro_torch.kernels.overlay_exec import kernel, ref
    rng = np.random.default_rng(0)
    dev = torch.device(DEVICE)
    smem = kernel.LIBRARY.smem_optin(torch.cuda.current_device())
    cases = 0
    # (n_in, n_regs, n_out, random rows); n_regs 300 and 1200 force blocks
    # of 128 and 32 threads under the opt-in shared-memory limit
    shapes = [(2, 3, 1, 4), (3, 8, 1, 20), (4, 17, 2, 40), (3, 64, 3, 120),
              (4, 300, 2, 200), (2, 1200, 1, 300)]
    for n_in, n_regs, n_out, m in shapes:
        instrs, imms = random_image(rng, n_in, n_regs, n_out, m)
        img = kernel.ExecImage.from_arrays(instrs, imms, n_regs, n_out, dev)
        block, _ = kernel.launch_config(n_regs, img.n_instr, smem)
        for n in N_CHECK:
            x_host = torch.from_numpy(special_inputs(rng, n_in, n))
            x = x_host.to(dev)
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
        log(f"(b) n_regs={n_regs:5d} M={img.n_instr:4d} block={block:3d}: "
            f"bit-exact at N={list(N_CHECK)}")
    # one image per (opcode, port) pair at the largest N
    n = N_CHECK[-1]
    x = torch.from_numpy(special_inputs(rng, 3, n)).to(dev)
    for op in range(N_OPCODES):
        for port in (0, 1, 2):
            instrs = np.array([[op, 3, 0, 1, 2, port],
                               [OP_PASS, 4, 3, 0, 0, 0]], np.int32)
            imms = np.array([-1.5, 0.0], np.float32)
            img = kernel.ExecImage.from_arrays(instrs, imms, 5, 1, dev)
            got = kernel.overlay_execute(img, x)
            plain = ref.execute_image(img.instrs, img.imms, 5, x, 1)
            check(same_bits(got, plain), f"opcode {op} port {port} differs")
            max_err.append(max_abs_err(got, plain))
            cases += 1
    torch.cuda.synchronize()
    log(f"(b) every (opcode, port) pair bit-exact at N={n}; "
        f"{cases} cases in all")
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

    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, byte_ms=0.0,
                  op_ms=0.0)
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
        k_ms, k_lo, k_hi = cuda_ms(lambda: kernel.overlay_execute(img, x))
        p_ms = cuda_ms(lambda: ref.execute_image(
            img.instrs, img.imms, img.n_regs, x, img.n_out), reps=3)[0]
        xs_dev = list(x)
        c_ms = cuda_ms(lambda: ck(*xs_dev), reps=3)[0]
        cm = ck(*xs_dev)
        check(same_bits(cm, got), f"{name}: compiled mode != run_overlay")
        byte_ms, op_ms = bound_ms(x.shape[0], img.n_out, N_MAIN,
                                  program_ops(img.instrs.cpu().numpy()))
        b_ms = max(byte_ms, op_ms)
        b_by = "bytes" if byte_ms >= op_ms else "operations"
        totals["ms"] += k_ms
        totals["plain_ms"] += p_ms
        totals["bound_ms"] += b_ms
        totals["byte_ms"] += byte_ms
        totals["op_ms"] += op_ms
        log(f"(c) {name:9s} {spec.width:2d}x{spec.height}: "
            f"replicas={ck.plan.replicas:3d} compile={compile_ms:7.1f} ms "
            f"run_overlay={run_ms:6.1f} ms "
            f"n_instr={img.n_instr:2d} n_regs={img.n_regs:2d} "
            f"kernel={k_ms:.4f} ms (n={REPS}, {k_lo:.4f}-{k_hi:.4f}) "
            f"plain={p_ms:.3f} ms "
            f"compiled_mode={c_ms:.3f} ms bound={b_ms:.4f} ms ({b_by}; "
            f"ops {op_ms:.5f} ms) "
            f"share={b_ms / k_ms:.2f} launches={launches} bit-exact")
        del x, plain, cm
    return main_launches, totals, len(runs)


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
    launches, totals, n_runs = phase_main_path(max_err)
    phase_reconfig(max_err)
    err = max(max_err)
    check(err == 0.0, f"max abs error {err}")
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": [{
        "name": "overlay_exec",
        "route": "cuda",
        "source": "src/repro_torch/csrc/overlay_exec.cu",
        "replaces": "src/repro/kernels/overlay_exec/kernel.py:30",
        "launches": launches,
        "match": "bit-exact",
        "max_abs_err": err,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": ("bytes" if totals["byte_ms"] >= totals["op_ms"]
                     else "operations"),
        "library_ms": None,
        "main_path_programs": n_runs,
        "work_items_per_launch": N_MAIN,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
