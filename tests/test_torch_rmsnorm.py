"""The port's RMSNorm against the JAX package.

Same inputs (numpy, from a seed) through ``repro``'s plain
``kernels/rmsnorm/ref.py``, its Pallas kernel in interpret mode, and the
port's plain version.  Tolerances are those of ``tests/test_kernels.py``:
1e-4 for float32 (only the order of the sum of squares and the spelling of
the inverse root differ) and 3e-2 for bfloat16 (one rounding of the output,
taken by two frameworks).  The ``gpu`` tests hold the CUDA kernel against
the plain version on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm import ref as r_ref
from repro.kernels.rmsnorm.kernel import rmsnorm as r_pallas
from repro_torch.kernels.rmsnorm import kernel, ops, ref

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
SHAPES = [(4, 64), (2, 3, 128), (1, 257, 512)]


def gpu(fn):
    """Needs a CUDA card: decided when the test runs, not at import."""
    fn = pytest.mark.skipif("not torch.cuda.is_available()",
                            reason="needs a CUDA card")(fn)
    return pytest.mark.gpu(fn)


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal(shape[-1]) * 0.1 + 1.0).astype(np.float32)
    return x, w


def _pair(a: np.ndarray, dtype: str):
    """One float32 array as a JAX and a torch array of ``dtype``; both
    round to bfloat16 to nearest-even, so the two hold the same values."""
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_ref_and_pallas(shape, dtype):
    x, w = _inputs(shape)
    jx, tx = _pair(x, dtype)
    jw, tw = _pair(w, dtype)
    got = ops.rmsnorm(tx, tw)                     # CPU tensor → plain
    assert got.dtype == tx.dtype and got.shape == tx.shape
    tol = TOL[dtype]
    for want in (r_ref.rmsnorm(jx, jw), r_pallas(jx, jw)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_on_the_heads_view_matches_jax(dtype):
    """q_norm/k_norm see (B, H, S, D), the transposed view of (B, S, H, D)."""
    x, w = _inputs((2, 5, 3, 16), seed=1)
    jx, tx = _pair(x, dtype)
    jw, tw = _pair(w, dtype)
    view = tx.transpose(1, 2)
    assert not view.is_contiguous()
    got = ops.rmsnorm(view, tw)
    want = r_ref.rmsnorm(jx.transpose(0, 2, 1, 3), jw)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_impl_ref_and_none_agree_on_the_cpu():
    x, w = _inputs((3, 32))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    assert torch.equal(ops.rmsnorm(tx, tw, impl="ref"), ops.rmsnorm(tx, tw))
    assert torch.equal(ref.rmsnorm(tx, tw), kernel.rmsnorm(tx, tw))


def test_unit_rms_with_unit_weight():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (16, 128)).astype(np.float32) * 5)
    y = ops.rmsnorm(x, torch.ones(128)).numpy()
    np.testing.assert_allclose(np.sqrt((y ** 2).mean(-1)), 1.0, rtol=1e-3)


@pytest.mark.parametrize("shape, perm, want", [
    ((6, 8), None, (6, (1, 6), (0, 0, 8))),                 # contiguous
    ((2, 3, 4, 8), None, (24, (1, 24), (0, 0, 8))),         # folds to one
    ((2, 5, 3, 16), (0, 2, 1, 3), (30, (3, 5), (240, 16, 48))),  # heads view
    ((1, 5, 3, 16), (0, 2, 1, 3), (15, (3, 5), (0, 16, 48))),    # B = 1
    ((4, 1, 16), None, (4, (1, 4), (0, 0, 16))),             # size-1 drops
])
def test_row_layout(shape, perm, want):
    x = torch.zeros(shape)
    if perm:
        x = x.permute(*perm)
    assert kernel.row_layout(x) == want


def test_row_layout_raises_past_three_dimensions():
    x = torch.zeros((2, 3, 4, 5, 8)).permute(3, 0, 2, 1, 4)
    with pytest.raises(ValueError, match="three dimensions"):
        kernel.row_layout(x)


def test_wrapper_validates():
    x, w = torch.zeros((2, 8)), torch.ones(8)
    with pytest.raises(ValueError, match="does not match"):
        kernel.rmsnorm(x, torch.ones(4))
    with pytest.raises(ValueError, match="both"):
        kernel.rmsnorm(x, w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="both"):
        kernel.rmsnorm(x.double(), w.double())
    with pytest.raises(ValueError, match="no RMSNorm kernel"):
        kernel.rmsnorm(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        ops.rmsnorm(x, w, impl="kernel")
    with pytest.raises(ValueError, match="unknown"):
        ops.rmsnorm(x, w, impl="pallas")


def test_cpu_tensors_never_launch_or_build():
    launches, builds = kernel.rmsnorm.launches, kernel.LIBRARY.builds
    ops.rmsnorm(torch.ones((3, 8)), torch.ones(8))
    assert kernel.rmsnorm.launches == launches
    assert kernel.LIBRARY.builds == builds


N_SM = 132          # the H100's SMs


def test_plan_splits_rows_of_5120_evenly():
    plan = kernel.launch_plan(5120, torch.bfloat16, True)
    assert (plan.kind, plan.vec, plan.rows_per_group) == ("rows", 8, 1)
    assert plan.tpr * plan.vpt * plan.vec == 5120        # no idle slot
    assert (plan.tpr, plan.vpt, plan.block) == (160, 4, 160)
    # one row a block, whatever the SMs hold
    assert not plan.walk and kernel.grid_size(plan, 16384, N_SM, 5) == 16384
    # 100 floats are 25 whole 16-byte vectors: not the scalar path
    assert kernel.launch_plan(100, torch.float32, True).vec == 4
    f32 = kernel.launch_plan(5120, torch.float32, True)
    assert (f32.tpr, f32.vpt, f32.vec) == (320, 4, 4)


def test_plan_puts_16_lanes_on_a_row_of_128():
    plan = kernel.launch_plan(128, torch.bfloat16, True)
    assert (plan.kind, plan.vec, plan.tpr, plan.vpt) == ("rows", 8, 16, 1)
    assert plan.rows_per_group == 2 and plan.block == 256
    assert plan.rows_per_block == 32           # two rows a warp, twice
    # a grid of one wave: each block walks several tiles
    assert plan.walk and kernel.grid_size(plan, 655360, N_SM, 4) == N_SM * 4
    assert kernel.grid_size(plan, 160, N_SM, 4) == 5     # decode: 160 rows


@pytest.mark.parametrize("d, dtype, aligned", [
    (100, torch.bfloat16, True),               # width not whole vectors
    (102, torch.float32, True),
    (5120, torch.bfloat16, False),             # pointer or stride
    (128, torch.float32, False)])
def test_plan_takes_the_scalar_path(d, dtype, aligned):
    plan = kernel.launch_plan(d, dtype, aligned)
    assert (plan.kind, plan.vec) == ("loop", 1)
    # one block per group of rows, whatever the SMs hold
    assert kernel.grid_size(plan, 3000, N_SM, 1) == \
        -(-3000 // plan.rows_per_block)


def test_plan_walks_rows_too_wide_for_registers():
    d = kernel.MAX_TPR * kernel.MAX_VPT * 8 + 8
    plan = kernel.launch_plan(d, torch.bfloat16, True)
    assert (plan.kind, plan.vec, plan.rows_per_block) == ("loop", 8, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_covers_every_width(dtype):
    vec = 16 // dtype.itemsize
    for d in range(vec, kernel.MAX_TPR * kernel.MAX_VPT * vec + 1, vec * 7):
        plan = kernel.launch_plan(d, dtype, True)
        nv = d // vec
        assert plan.kind == "rows" and plan.vec == vec
        assert plan.tpr * plan.vpt >= nv > plan.tpr * (plan.vpt - 1)
        assert plan.vpt <= kernel.MAX_VPT and plan.block <= 512
        assert plan.block % plan.tpr == 0
        if nv <= 32:
            assert plan.tpr >= nv and plan.tpr & (plan.tpr - 1) == 0
            assert plan.walk and plan.rows_per_group == 2
        else:
            assert plan.tpr % 32 == 0 and plan.block == plan.tpr
            assert not plan.walk and plan.rows_per_group == 1


# ---------------------------------------------------------------- on a card
@gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES + [(1000, 5120), (37, 128),
                                            (3, 100)])
def test_cuda_kernel_matches_plain(shape, dtype):
    x, w = _inputs(shape, seed=3)
    tx = torch.from_numpy(x).to("cuda", getattr(torch, dtype))
    tw = torch.from_numpy(w).to("cuda", getattr(torch, dtype))
    before = kernel.rmsnorm.launches
    got = ops.rmsnorm(tx, tw)
    assert kernel.rmsnorm.launches == before + 1
    want = ref.rmsnorm(tx, tw)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_reads_the_heads_view_in_place(dtype):
    x, w = _inputs((2, 33, 40, 128), seed=4)
    tx = torch.from_numpy(x).to("cuda", getattr(torch, dtype))
    tw = torch.from_numpy(w).to("cuda", getattr(torch, dtype))
    view = tx.transpose(1, 2)
    got = kernel.rmsnorm(view, tw)
    assert got.is_contiguous() and got.shape == view.shape
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), ref.rmsnorm(view, tw).float(),
                               rtol=tol, atol=tol)


@gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape, view", [
    ((2, 33, 40, 128), "heads"),        # the heads view, odd S
    ((4, 1, 40, 128), "heads"),         # the (4, 40, 1, 128) decode view
    ((40000, 128), None),               # more rows than the grid has blocks
    ((5000, 5120), None),
    ((7, 1000), None),                  # a split with idle slots
    ((3, 6144), None), ((2, 8192), None), ((2, 40008), None)])
def test_cuda_kernel_edges(shape, view, dtype):
    x, w = _inputs(shape, seed=5)
    tx = torch.from_numpy(x).to("cuda", getattr(torch, dtype))
    tw = torch.from_numpy(w).to("cuda", getattr(torch, dtype))
    if view == "heads":
        tx = tx.transpose(1, 2)
    got = kernel.rmsnorm(tx, tw)
    assert got.is_contiguous() and got.shape == tx.shape
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), ref.rmsnorm(tx, tw).float(),
                               rtol=tol, atol=tol)
