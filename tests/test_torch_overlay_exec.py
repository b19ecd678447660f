"""The port's overlay executor against the JAX package's numpy oracle.

Same inputs (numpy, from a seed) through ``repro``'s
``kernels/overlay_exec/ref.py`` and through ``repro_torch``'s executor.
Tolerance: bit-exact.  Every instruction is one separately rounded float32
operation in both, so the bits must agree; NaN payloads are the one
exception (numpy keeps the operand's NaN, other devices make their own), so
NaN positions must agree instead.  On the CPU the executor runs its plain
PyTorch version; the ``gpu`` tests run the CUDA kernel on a card.
"""

import numpy as np
import pytest
import torch

from repro.core.dfg import optimize as r_optimize
from repro.core.dfg import trace as r_trace
from repro.core.ir import _lower_consts as r_lower_consts
from repro.core.program import compile_program as r_compile_program
from repro.kernels.overlay_exec import ops as r_ops
from repro.kernels.overlay_exec import ref as r_ref
from repro_torch.core.dfg import optimize, trace
from repro_torch.core.ir import _lower_consts
from repro_torch.core.program import (N_OPCODES, OP_PASS, compile_program,
                                      program_from_arrays)
from repro_torch.kernels.overlay_exec import kernel, ops, ref

# the specials make numpy warn about inf - inf and the like; the results
# are what is compared
pytestmark = pytest.mark.filterwarnings("ignore::RuntimeWarning")

CPU = torch.device("cpu")

KERNELS = {
    "poly": (lambda x: x * (x * (16 * x * x - 20) * x + 5), 1),
    "mad": (lambda a, b: a * b + a - b, 2),
    "imm": (lambda x: 3.0 * x + 5.0, 1),
    "rsub": (lambda x: 7.0 - x, 1),
    "minmax": (lambda a, b: a.max(0.0) * b.min(2.0) + a.min(b), 2),
    "neg": (lambda a: -a + abs(a), 1),
    "three": (lambda a, b, c: a * b + b * c + a * c, 3),
    "multi_out": (lambda a, b: (a + b, a * b, a - b), 2),
}

SPECIALS = np.array([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 1e-40,
                     -3e-42, 1.4e-45, 3e38, -3e38, 1.0, -2.5], np.float32)


def gpu(fn):
    """Needs a CUDA card: decided when the test runs, not at import."""
    fn = pytest.mark.skipif("not torch.cuda.is_available()",
                            reason="needs a CUDA card")(fn)
    return pytest.mark.gpu(fn)


def assert_same_bits(got, want):
    got = np.asarray(torch.as_tensor(got).cpu(), np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    np.testing.assert_array_equal(nan_g, nan_w)
    np.testing.assert_array_equal(got.view(np.int32)[~nan_g],
                                  want.view(np.int32)[~nan_w])


def _programs(name):
    fn, n = KERNELS[name]
    mine = compile_program(optimize(_lower_consts(trace(fn, n, name))))
    theirs = r_compile_program(r_optimize(r_lower_consts(r_trace(fn, n,
                                                                 name))))
    return mine, theirs, n


def _inputs(n_in, shape, seed=42):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for _ in range(n_in)]


@pytest.mark.parametrize("name", sorted(KERNELS))
@pytest.mark.parametrize("n_items", [1, 7, 200])
def test_executor_matches_oracle(name, n_items):
    prog, r_prog, n_in = _programs(name)
    np.testing.assert_array_equal(prog.instrs, r_prog.instrs)
    np.testing.assert_array_equal(prog.imms, r_prog.imms)
    xs = _inputs(n_in, n_items)
    want = r_ref.execute(r_prog, xs)
    got = ops.execute(prog, xs, device="cpu")
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert isinstance(g, torch.Tensor) and g.device == CPU
        assert g.dtype == torch.float32
        assert_same_bits(g, w)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_executor_matches_oracle_on_specials(name):
    prog, r_prog, n_in = _programs(name)
    rng = np.random.default_rng(3)
    xs = [rng.permutation(np.tile(SPECIALS, 4)) for _ in range(n_in)]
    for w, g in zip(r_ref.execute(r_prog, xs),
                    ops.execute(prog, xs, device="cpu")):
        assert_same_bits(g, w)


PAPER_SUITE = ("chebyshev", "mibench", "poly1", "poly2", "qspline",
               "sgfilter")


@pytest.mark.parametrize("specials", [False, True])
@pytest.mark.parametrize("name", PAPER_SUITE)
def test_execute_matches_the_reference_on_the_paper_suite(name, specials):
    """``ref.execute`` (an OverlayProgram and its raw inputs → its
    outputs) bit for bit against the reference's ``ref.execute`` on each
    of the paper suite's six programs, each package compiling its own for
    an 8x8 overlay, on inputs of shape (3, 37) or on the specials; the
    outputs keep the inputs' shape."""
    from repro.configs.paper_suite import BENCHMARKS as R_BENCHMARKS
    from repro.core.jit import jit_compile as r_jit_compile
    from repro.core.overlay import OverlaySpec as ROverlaySpec
    from repro_torch.configs.paper_suite import BENCHMARKS
    from repro_torch.core.jit import jit_compile
    from repro_torch.core.overlay import OverlaySpec
    assert sorted(BENCHMARKS) == sorted(PAPER_SUITE)
    prog = jit_compile(BENCHMARKS[name][0], OverlaySpec(8, 8, 2)).program
    r_prog = r_jit_compile(R_BENCHMARKS[name][0],
                           ROverlaySpec(8, 8, 2)).program
    n_in = len(prog.in_slots)
    assert n_in == len(r_prog.in_slots)
    xs = _inputs(n_in, (3, 37))
    if specials:
        xs = [np.roll(SPECIALS, i) for i in range(n_in)]
    want = r_ref.execute(r_prog, xs)
    got = ref.execute(prog, xs)
    assert len(got) == len(want) == len(prog.out_slots)
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.device == CPU
        assert tuple(g.shape) == xs[0].shape
        assert_same_bits(g, w)


@pytest.mark.parametrize("shape", [(4, 4), (2, 3, 5), (128,), ()])
def test_executor_preserves_shape(shape):
    prog, r_prog, _ = _programs("poly")
    x = np.asarray(np.random.default_rng(0).standard_normal(shape),
                   np.float32)
    out = ops.execute(prog, [torch.from_numpy(x)])[0]
    assert out.shape == shape
    assert_same_bits(out, r_ref.execute(r_prog, [x])[0])


def test_padded_programs_share_one_resident_image():
    """Two kernels padded to one signature share one ExecImage: swapping is
    a write into its buffers (the reconfiguration claim)."""
    p1, r1, _ = _programs("imm")
    p2, r2, _ = _programs("rsub")
    n = max(p1.n_instr, p2.n_instr) + 4
    regs = max(ops.build_image(p)[2] for p in (p1, p2))
    i1 = ops.build_image(p1, pad_to=n + 1, pad_regs=regs)
    i2 = ops.build_image(p2, pad_to=n + 1, pad_regs=regs)
    assert i1[0].shape == i2[0].shape and i1[2:] == i2[2:]
    for mine, theirs in zip(i1, r_ops.build_image(r1, pad_to=n + 1,
                                                  pad_regs=regs)):
        np.testing.assert_array_equal(mine, theirs)
    x = torch.from_numpy(np.linspace(-1, 1, 256).astype(np.float32))[None]
    image = ops.load_image(p1, CPU, pad_to=n + 1, pad_regs=regs)
    got1 = kernel.overlay_execute(image, x)[0].clone()
    image.write(*i2)
    got2 = kernel.overlay_execute(image, x)[0]
    assert_same_bits(got1, r_ref.execute(r1, [x[0].numpy()])[0])
    assert_same_bits(got2, r_ref.execute(r2, [x[0].numpy()])[0])


def test_write_rejects_another_signature():
    """Another instruction count, or another register file (the outputs
    sit in its last slots), is another signature."""
    p1, _, _ = _programs("imm")
    p2, _, _ = _programs("poly")
    p3, _, _ = _programs("rsub")
    image = ops.load_image(p1, CPU)
    with pytest.raises(ValueError, match="signature"):
        image.write(*ops.build_image(p2))
    other_regs = ops.build_image(p3, pad_to=image.n_instr)
    assert other_regs[2] != image.n_regs
    with pytest.raises(ValueError, match="signature"):
        image.write(*other_regs)


def test_executor_against_compiled_mode():
    fn, n = KERNELS["three"]
    g = optimize(_lower_consts(trace(fn, n)))
    xs = [torch.from_numpy(x) for x in _inputs(n, 512, seed=1)]
    want = g.evaluate(xs)
    got = ops.execute(compile_program(g), xs)
    for w, gg in zip(want, got):
        assert torch.equal(gg, w)


# one image per (opcode, immediate port): inputs in slots 0..2, the result
# in slot 3, parked in the output slot 4
@pytest.mark.parametrize("op", range(N_OPCODES))
@pytest.mark.parametrize("port", [0, 1, 2])
def test_each_opcode_and_port_matches_oracle(op, port):
    instrs = np.array([[op, 3, 0, 1, 2, port], [OP_PASS, 4, 3, 0, 0, 0]],
                      np.int32)
    rng = np.random.default_rng(op * 3 + port)
    x = np.stack([np.concatenate([rng.permutation(SPECIALS),
                                  rng.standard_normal(50).astype(np.float32)])
                  for _ in range(3)])
    x[1, :len(SPECIALS)] = SPECIALS           # specials meet specials
    x[0, :len(SPECIALS)] = np.roll(SPECIALS, 1)
    for imm in (-1.5, np.nan, -0.0):
        imms = np.array([imm, 0.0], np.float32)
        want = r_ref.execute_image(instrs, imms, 5, x, 1)
        got = ref.execute_image(instrs, imms, 5, torch.from_numpy(x), 1)
        assert_same_bits(got, want)


@pytest.mark.parametrize("n_in, n_regs, n_out, m", [
    (1, 3, 1, 6), (2, 9, 2, 30), (4, 40, 3, 120)])
def test_random_images_match_oracle(n_in, n_regs, n_out, m):
    """Random rows over the whole register file: slots are read before any
    write (they start at zero), overwritten, and fed back."""
    rng = np.random.default_rng(n_regs)
    writable = n_regs - n_out
    instrs = np.concatenate([
        np.stack([rng.integers(0, N_OPCODES, m),
                  *rng.integers(0, writable, (4, m)),
                  rng.integers(0, 3, m)], axis=1),
        [[OP_PASS, writable + j, int(rng.integers(writable)), 0, 0, 0]
         for j in range(n_out)]]).astype(np.int32)
    imms = rng.standard_normal(len(instrs)).astype(np.float32)
    imms[::7] = np.nan
    x = rng.standard_normal((n_in, 64)).astype(np.float32)
    x[:, :len(SPECIALS)] = SPECIALS
    want = r_ref.execute_image(instrs, imms, n_regs, x, n_out)
    image = kernel.ExecImage.from_arrays(instrs, imms, n_regs, n_out, CPU)
    assert_same_bits(kernel.overlay_execute(image, torch.from_numpy(x)),
                     want)


def test_min_max_follow_numpy_on_nan_and_signed_zero():
    a = np.array([np.nan, 1.0, 0.0, -0.0, np.nan], np.float32)
    b = np.array([1.0, np.nan, -0.0, 0.0, np.nan], np.float32)
    x = np.stack([a, b])
    for op, np_fn in ((12, np.minimum), (13, np.maximum)):
        instrs = np.array([[op, 2, 0, 1, 0, 0]], np.int32)
        got = ref.execute_image(instrs, np.zeros(1, np.float32), 3,
                                torch.from_numpy(x), 1)
        assert_same_bits(got[0], np_fn(a, b))
        assert np.array_equal(np.signbit(got[0].numpy()[2:4]),
                              np.signbit(np_fn(a, b)[2:4]))


def test_program_from_arrays_runs_the_reference_program():
    """A program compiled by the JAX package, carried over as plain fields,
    runs on the port's executor with the oracle's bits."""
    _, r_prog, n_in = _programs("multi_out")
    prog = program_from_arrays(r_prog.name, r_prog.n_regs, r_prog.instrs,
                               r_prog.imms, r_prog.in_slots,
                               r_prog.out_slots)
    assert prog.content_hash() == r_prog.content_hash()
    xs = _inputs(n_in, 33)
    for w, g in zip(r_ref.execute(r_prog, xs),
                    ops.execute(prog, xs, device="cpu")):
        assert_same_bits(g, w)


def test_program_from_arrays_checks_lengths():
    with pytest.raises(ValueError):
        program_from_arrays("bad", 3, np.zeros((2, 6)), np.zeros(3), (0,),
                            (1,))


@pytest.mark.parametrize("row, why", [
    ([14, 2, 0, 0, 0, 0], "opcode"),
    ([-1, 2, 0, 0, 0, 0], "opcode"),
    ([1, 3, 0, 0, 0, 0], "slot"),
    ([1, 2, 0, -1, 0, 0], "slot"),
    ([1, 2, 0, 0, 0, 3], "imm_port"),
])
def test_image_validation_rejects(row, why):
    with pytest.raises(ValueError, match=why):
        kernel.ExecImage.from_arrays(np.array([row], np.int32),
                                     np.zeros(1, np.float32), 3, 1, CPU)


def test_executor_rejects_bad_inputs():
    image = kernel.ExecImage.from_arrays(
        np.array([[1, 2, 0, 1, 0, 0]], np.int32), np.zeros(1, np.float32),
        3, 1, CPU)
    with pytest.raises(ValueError):                      # dtype
        kernel.overlay_execute(image, torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError):                      # contiguity
        kernel.overlay_execute(image, torch.zeros((4, 2)).t())
    with pytest.raises(ValueError):                      # more inputs than slots
        kernel.overlay_execute(image, torch.zeros((4, 4)))
    with pytest.raises(ValueError):                      # another device
        kernel.overlay_execute(image, torch.zeros((2, 4), device="meta"))
    bad = kernel.ExecImage(image.instrs.to(torch.int64), image.imms, 3, 1)
    with pytest.raises(ValueError, match="from_arrays"):  # buffer layout
        kernel.overlay_execute(bad, torch.zeros((2, 4)))


def test_cpu_tensors_never_launch_or_build():
    launches, builds = kernel.overlay_execute.launches, kernel.LIBRARY.builds
    prog, _, _ = _programs("poly")
    ops.execute(prog, [np.ones(8, np.float32)], device="cpu")
    assert kernel.overlay_execute.launches == launches
    assert kernel.LIBRARY.builds == builds


@pytest.mark.parametrize("n_regs, n_instr, items, block", [
    (8, 6, 8, 128), (17, 14, 8, 128), (300, 244, 1, 128), (1200, 343, 1, 32)])
def test_launch_config_shrinks_block_to_fit(n_regs, n_instr, items, block):
    got_items, got, smem = kernel.launch_config(n_regs, n_instr, 232448)
    assert (got_items, got) == (items, block)
    # instruction words, register file, list of zeroed slots
    assert smem == (n_instr * 16 + n_regs * block * items * 4
                    + 4 * (n_regs + 1)) <= 232448


def test_launch_config_raises_when_one_warp_does_not_fit():
    with pytest.raises(ValueError, match="one warp"):
        kernel.launch_config(2000, 10, 232448)


SMEM_OPTIN, N_SM = 232448, 132      # an H100's


@pytest.mark.parametrize("spec", [(8, 8, 2), (32, 8, 2)])
def test_paper_programs_take_four_items_a_thread(spec):
    """At N = 2^24 on an aligned x every paper program runs 8 work-items a
    thread in blocks of 128, on one wave of blocks that walk the 16384
    tiles."""
    from repro_torch.configs.paper_suite import BENCHMARKS
    from repro_torch.core.jit import jit_compile
    from repro_torch.core.overlay import OverlaySpec
    n = 1 << 24
    for src, _, _ in BENCHMARKS.values():
        ck = jit_compile(src, OverlaySpec(*spec))
        instrs, _, n_regs, _ = ops.build_image(ck.program)
        cfg = kernel.launch_config(n_regs, instrs.shape[0], SMEM_OPTIN,
                                   kernel.item_width(n, 1 << 20))
        assert cfg[:2] == (8, 128)
        assert kernel.grid_size(n, cfg.items, cfg.block, N_SM, 3) == N_SM * 3


@pytest.mark.parametrize("n, address, width", [
    (1 << 24, 1 << 20, 8), (1 << 24, 16, 8), ((1 << 24) + 4, 0, 4),
    ((1 << 24) + 2, 0, 2), ((1 << 24) + 1, 0, 1), (1 << 24, 8, 2),
    (1 << 24, 4, 1), (5, 256, 1), (4095, 0, 1)])
def test_unaligned_n_or_x_narrows_the_width(n, address, width):
    assert kernel.item_width(n, address) == width
    cfg = kernel.launch_config(17, 14, SMEM_OPTIN, width)
    assert cfg[:2] == (width, 128 if width == 8 else 256)


def test_prefetch_depth_holds_sixteen_registers_of_inputs():
    assert [kernel.prefetch_depth(n_in) for n_in in range(7)] == \
        [4, 4, 2, 1, 1, 1, 1]


def test_grid_covers_small_n_with_one_block_per_tile():
    assert kernel.grid_size(5, 1, 256, N_SM, 4) == 1
    assert kernel.grid_size(4096 * 3, 4, 256, N_SM, 4) == 12
    assert kernel.grid_size(1 << 24, 4, 256, N_SM, 4) == N_SM * 4


def test_image_validation_bounds_slots_to_16_bits():
    instrs = np.array([[1, 2, 0, 1, 0, 0]], np.int32)
    with pytest.raises(ValueError, match="16 bits"):
        kernel.ExecImage.from_arrays(instrs, np.zeros(1, np.float32),
                                     (1 << 16) + 1, 1, CPU)


# ---------------------------------------------------------------- on a card
@gpu
@pytest.mark.parametrize("name", sorted(KERNELS))
@pytest.mark.parametrize("n_items", [1, 127, 5000])
def test_cuda_kernel_matches_plain_and_oracle(name, n_items):
    prog, r_prog, n_in = _programs(name)
    xs = _inputs(n_in, n_items)
    before = kernel.overlay_execute.launches
    got = ops.execute(prog, xs)                    # numpy → the card
    assert kernel.overlay_execute.launches == before + 1
    plain = ops.execute(prog, xs, device="cpu")
    for g, p, w in zip(got, plain, r_ref.execute(r_prog, xs)):
        assert g.is_cuda
        assert_same_bits(g, p)
        assert_same_bits(g, w)


@gpu
@pytest.mark.parametrize("op", range(N_OPCODES))
def test_cuda_kernel_each_opcode(op):
    x = torch.from_numpy(np.stack([np.tile(SPECIALS, 20),
                                   np.repeat(SPECIALS, 20),
                                   np.roll(np.tile(SPECIALS, 20), 3)]))
    for port in (0, 1, 2):
        instrs = np.array([[op, 3, 0, 1, 2, port], [OP_PASS, 4, 3, 0, 0, 0]],
                          np.int32)
        imms = np.array([-1.5, 0.0], np.float32)
        image = kernel.ExecImage.from_arrays(instrs, imms, 5, 1, "cuda")
        got = kernel.overlay_execute(image, x.cuda())
        want = r_ref.execute_image(instrs, imms, 5, x.numpy(), 1)
        assert_same_bits(got, want)


@gpu
def test_cuda_swap_keeps_one_build():
    p1, r1, _ = _programs("imm")
    p2, r2, _ = _programs("rsub")
    n = max(p1.n_instr, p2.n_instr) + 2
    regs = max(ops.build_image(p)[2] for p in (p1, p2))
    image = ops.load_image(p1, "cuda", pad_to=n, pad_regs=regs)
    x = torch.linspace(-1, 1, 1000, device="cuda")[None]
    kernel.overlay_execute(image, x)
    builds = kernel.LIBRARY.builds
    image.write(*ops.build_image(p2, pad_to=n, pad_regs=regs))
    got = kernel.overlay_execute(image, x)
    assert kernel.LIBRARY.builds == builds == 1
    assert_same_bits(got[0], r_ref.execute(r2, [x[0].cpu().numpy()])[0])


def _random_image(rng, n_in, n_regs, n_out, m):
    """Random rows over the whole register file, outputs parked last; half
    the rows read the row before's result as a, a third as b (the chains
    the kernel forwards in registers)."""
    writable = n_regs - n_out
    rows = np.stack([rng.integers(0, N_OPCODES, m),
                     *rng.integers(0, writable, (4, m)),
                     rng.integers(0, 3, m)], axis=1)
    for k in range(1, m):
        for col, p in ((2, 0.5), (3, 0.3)):
            if rng.random() < p:
                rows[k, col] = rows[k - 1, 1]
    instrs = np.concatenate([
        rows, [[OP_PASS, writable + j, int(rng.integers(writable)), 0, 0, 0]
               for j in range(n_out)]]).astype(np.int32)
    imms = rng.standard_normal(len(instrs)).astype(np.float32)
    imms[::7] = np.nan
    return instrs, imms


@gpu
@pytest.mark.parametrize("n_items", [1, 5, 4094, 4095, 4096, (1 << 20) + 3,
                                     (1 << 20) + 4, (1 << 20) + 8])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n_in", [1, 2, 3, 6])
def test_cuda_kernel_ragged_n_and_offset_x(n_items, offset, n_in):
    """Ragged N (each width: 8, 4, 2 and 1 work-items a thread), x starting
    one element past 16 bytes (one work-item a thread), each prefetch
    depth, and more inputs than the kernel loads ahead into registers."""
    rng = np.random.default_rng(n_items + offset)
    n_regs, n_out = 24, 2
    instrs, imms = _random_image(rng, n_in, n_regs, n_out, 60)
    x_np = rng.standard_normal((n_in, n_items)).astype(np.float32)
    x_np[:, :min(n_items, len(SPECIALS))] = SPECIALS[:n_items]
    buf = torch.empty(n_in * n_items + offset, device="cuda")
    x = buf[offset:].view(n_in, n_items)
    x.copy_(torch.from_numpy(x_np))
    image = kernel.ExecImage.from_arrays(instrs, imms, n_regs, n_out, "cuda")
    items = kernel.plan(image, x).items
    assert items == kernel.item_width(n_items, x.data_ptr())
    if offset:
        assert items == 1
    got = kernel.overlay_execute(image, x)
    assert_same_bits(got, r_ref.execute_image(instrs, imms, n_regs, x_np,
                                              n_out))
