"""RMSNorm over a row cut into column blocks (the split-row mode: Mamba2's
gated norm with the inner width on 'model') against the JAX package's
RMSNorm of the whole row.

The rows are cut into 2 and 4 column blocks in one process: each block's
partial sum (``split_sumsq``, ``split_dot``) is taken alone, the partials
are summed, and each block is normed (``rmsnorm_split``) or
differentiated (``rmsnorm_split_bwd``) with the row's sums, as the ranks
do around their all-reduce.  The joined blocks are held against
``repro``'s plain ``rmsnorm`` of the whole row and against ``jax.vjp`` of
it, at 1e-4 (float32) and 3e-2 (bfloat16), the tolerances of
``tests/test_torch_rmsnorm.py``.  The backward's two passes are also
taken in blocks of rows, as the card's grid cuts them (the first pass's
dots and partial dw over ragged row ranges, the second's dx and the
partials summed in block order), and the launch plan that cuts them is
checked as a pure function of the width, the SM count and the occupancy.
The card's test of the CUDA kernels is
``tests/test_torch_rmsnorm_split_gpu.py``, which imports no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm import ref as r_ref
from repro_torch.kernels.rmsnorm import kernel, ref

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
EPS = 1e-6


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal(shape[-1]) * 0.1 + 1.0).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, w, dy


def _t(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _j(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _blocks(t: torch.Tensor, k: int):
    return list(torch.chunk(t, k, dim=-1))


def split_forward(x, w, k, n_as=None):
    """The blocks' outputs joined, and the rows' totals."""
    xs, ws = _blocks(x, k), _blocks(w, k)
    total = sum(ref.split_sumsq(b) for b in xs)
    n = n_as or x.shape[-1]
    return torch.cat([ref.rmsnorm_split(b, wb, total, n, EPS)
                      for b, wb in zip(xs, ws)], dim=-1), total


def split_backward(x, w, dy, k):
    xs, ws, gs = _blocks(x, k), _blocks(w, k), _blocks(dy, k)
    total = sum(ref.split_sumsq(b) for b in xs)
    dot = sum(ref.split_dot(b, wb, g) for b, wb, g in zip(xs, ws, gs))
    outs = [ref.rmsnorm_split_bwd(b, wb, g, total, dot, x.shape[-1], EPS)
            for b, wb, g in zip(xs, ws, gs)]
    return (torch.cat([o[0] for o in outs], dim=-1),
            torch.cat([o[1] for o in outs], dim=-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [2, 4])
def test_split_forward_matches_jax_on_the_whole_row(k, dtype):
    x, w, _ = _inputs((3, 16, 256))
    got, total = split_forward(_t(x, dtype), _t(w, dtype), k)
    want = r_ref.rmsnorm(_j(x, dtype), _j(w, dtype), eps=EPS)
    assert got.dtype == getattr(torch, dtype) and total.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [2, 4])
def test_split_backward_matches_jax_vjp(k, dtype):
    x, w, dy = _inputs((3, 16, 256), seed=1)
    dx, dw = split_backward(_t(x, dtype), _t(w, dtype), _t(dy, dtype), k)
    _, vjp = jax.vjp(lambda a, b: r_ref.rmsnorm(a, b, eps=EPS),
                     _j(x, dtype), _j(w, dtype))
    want_dx, want_dw = vjp(_j(dy, dtype))
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(dx), _f32(want_dx), rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(dw), _f32(want_dw), rtol=tol, atol=tol)


def blocked_backward(x, w, dy, k, groups, grid):
    """Both passes of the backward on each of ``k`` column blocks, the
    rows dealt to ``grid`` blocks in tiles of ``groups``: each block's
    dots and partial dw rows, the dots summed over the column blocks, then
    dx and the partials summed."""
    xs, ws, gs = _blocks(x, k), _blocks(w, k), _blocks(dy, k)
    total = sum(ref.split_sumsq(b) for b in xs)
    block_of = kernel.split_bwd_block_of(x.numel() // x.shape[-1], groups,
                                         grid)
    firsts = [ref.split_bwd_rows(b, wb, g, total, x.shape[-1], EPS,
                                 block_of, grid)
              for b, wb, g in zip(xs, ws, gs)]
    for (_, partial), b in zip(firsts, xs):
        assert partial.shape == (grid, b.shape[-1])
        assert partial.dtype == torch.float32
    dot = sum(f[0] for f in firsts)
    outs = [ref.split_bwd_dx(b, wb, g, total, dot, partial, x.shape[-1], EPS)
            for b, wb, g, (_, partial) in zip(xs, ws, gs, firsts)]
    return (torch.cat([o[0] for o in outs], dim=-1),
            torch.cat([o[1] for o in outs], dim=-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("groups,grid", [(39, 1), (4, 3), (1, 39), (8, 2),
                                         (4, 7)])
def test_split_backward_in_row_blocks_matches_jax_vjp(k, dtype, groups,
                                                      grid):
    """39 rows: one block; tiles of 4 dealt to 3 blocks (the last tile
    ragged, 12 rows to one block and 16 to another); a row a block; tiles
    of 8 to 2 blocks; 10 tiles of 4 to 7 blocks.  The partial rows of each
    cut also sum to the partial row of all the rows in one block."""
    x, w, dy = _inputs((3, 13, 256), seed=3)
    tx, tw, tg = _t(x, dtype), _t(w, dtype), _t(dy, dtype)
    dx, dw = blocked_backward(tx, tw, tg, k, groups, grid)
    total = ref.split_sumsq(tx)
    cut = ref.split_bwd_rows(tx, tw, tg, total, 256, EPS,
                             kernel.split_bwd_block_of(39, groups, grid),
                             grid)[1]
    whole = ref.split_bwd_rows(tx, tw, tg, total, 256, EPS)[1]
    assert whole.shape == (1, 256)
    np.testing.assert_allclose(cut.sum(0).numpy(), whole[0].numpy(),
                               rtol=1e-5, atol=1e-5)
    _, vjp = jax.vjp(lambda a, b: r_ref.rmsnorm(a, b, eps=EPS),
                     _j(x, dtype), _j(w, dtype))
    want_dx, want_dw = vjp(_j(dy, dtype))
    tol = TOL[dtype]
    assert dx.dtype == dw.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f32(dx), _f32(want_dx), rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(dw), _f32(want_dw), rtol=tol, atol=tol)


@pytest.mark.parametrize("n_rows,groups,n_sm,per_sm", [
    (16384, 4, 132, 2), (16384, 16, 132, 2), (16384, 1, 132, 1),
    (4096, 32, 132, 3), (131, 4, 132, 1), (1, 8, 132, 4), (3003, 8, 7, 5),
    (16387, 4, 132, 2), (1000003, 16, 132, 2)])
def test_the_split_backward_grid_deals_every_row_once(n_rows, groups, n_sm,
                                                      per_sm):
    """Tiles of ``groups`` rows go to the blocks in turn: every row in one
    block, whole tiles (the last one ragged), the blocks' tile counts at
    most one apart, no more blocks than tiles or than the SMs hold."""
    grid = kernel.split_bwd_grid(n_rows, 1792, groups, n_sm, per_sm)
    tiles = -(-n_rows // groups)
    assert 1 <= grid <= min(tiles, n_sm * per_sm)
    block_of = kernel.split_bwd_block_of(n_rows, groups, grid).numpy()
    assert block_of.shape == (n_rows,)
    assert block_of.min() == 0 and block_of.max() == grid - 1
    tile_of = np.arange(n_rows) // groups
    assert (block_of == tile_of % grid).all()
    per_block = np.bincount(tile_of[::groups] % grid, minlength=grid)
    assert per_block.max() - per_block.min() <= 1


@pytest.mark.parametrize("d,vec", [
    (1792, 8), (512, 8), (448, 8), (128, 8), (1792, 4), (512, 4), (48, 4),
    (509, 1), (49, 1), (1, 1), (16384, 8), (8192, 4), (4096, 1),
    (20480, 8), (20480, 4), (5001, 1), (38656, 8)])
def test_the_split_backward_threads_cover_a_row(d, vec):
    """A row's vectors over its threads, at most ``cap`` of them a thread
    in registers; past 256 x ``cap`` vectors (16384 bf16, 8192 float32,
    4096 single elements) the threads take the rest one at a time."""
    tpr, maxv = kernel.split_bwd_threads(d, vec)
    nv = d // vec
    cap = kernel.SPLIT_MAXV if vec > 1 else kernel.SPLIT_SCALAR_MAXV
    assert tpr & (tpr - 1) == 0 and maxv & (maxv - 1) == 0
    assert kernel.SPLIT_MIN_TPR <= tpr <= kernel.SPLIT_MAX_TPR
    assert kernel.SPLIT_BLOCK % tpr == 0
    per_thread = -(-nv // tpr)
    assert min(per_thread, cap) <= maxv <= cap
    assert maxv < 2 * per_thread
    if per_thread > cap:
        assert (tpr, maxv) == (kernel.SPLIT_MAX_TPR, cap)
    if kernel.SPLIT_MIN_TPR < tpr < kernel.SPLIT_MAX_TPR:
        # the fewest threads that hold SPLIT_VPT vectors at most
        assert -(-nv // tpr) <= kernel.SPLIT_VPT < -(-nv // (tpr // 2))
    if (d, vec) in ((1792, 8), (512, 8)):
        assert (tpr, maxv) == {1792: (64, 4), 512: (16, 4)}[d]


def test_the_split_backward_refuses_what_its_kernels_do_not_take():
    with pytest.raises(ValueError, match="32 bits"):
        kernel.split_bwd_grid(1 << 20, 2048, 4, 132, 1)
    with pytest.raises(ValueError, match="does not fit"):
        kernel.split_bwd_grid(16, 1792, 4, 132, 0)
    # the widest rows whose first-pass block fits 227 KB: 38656 bf16 and
    # 28992 float32 (a row of sums and the weight)
    for d, dtype in ((38656, torch.bfloat16), (28992, torch.float32),
                     (1792, torch.bfloat16), (16392, torch.bfloat16)):
        kernel.split_bwd_check(d, dtype)
    for d, dtype in ((38664, torch.bfloat16), (38657, torch.bfloat16),
                     (28996, torch.float32)):
        with pytest.raises(ValueError, match="shared memory"):
            kernel.split_bwd_check(d, dtype)
    with pytest.raises(ValueError, match="does not match"):
        kernel.split_bwd_rows(torch.zeros(2, 8), torch.zeros(8),
                              torch.zeros(2, 4), torch.zeros(2), 8, EPS)


def test_n_as_the_block_width_is_wrong():
    """The planted fault of the card's check: each block normed by its
    own width, not the row's, is far outside the limit."""
    x, w, _ = _inputs((4, 64))
    want = r_ref.rmsnorm(jnp.asarray(x), jnp.asarray(w), eps=EPS)
    bad, _ = split_forward(torch.from_numpy(x), torch.from_numpy(w), 4,
                           n_as=16)
    assert np.abs(_f32(bad) - _f32(want)).max() > 100 * TOL["float32"]


def test_the_autograd_function_on_the_cpu_takes_the_plain_route():
    """:func:`kernel.rmsnorm_split` with an identity all-reduce is RMSNorm
    of the whole row (one block), forward and backward, and launches
    nothing on the CPU."""
    x, w, dy = _inputs((2, 8, 64), seed=2)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    before = (kernel.rmsnorm_split.launches,
              kernel.rmsnorm_split_bwd.launches)
    y = kernel.rmsnorm_split(tx, tw, EPS, 64, lambda t: t)
    y.backward(torch.from_numpy(dy))
    want = ref.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), EPS)
    dx, dw = ref.rmsnorm_bwd(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(dy), EPS)
    np.testing.assert_allclose(y.detach().numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), dx.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), dw.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert (kernel.rmsnorm_split.launches,
            kernel.rmsnorm_split_bwd.launches) == before


def test_the_wrapper_refuses_what_no_kernel_takes():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="both be float32 or"):
        kernel.rmsnorm_split(x, torch.zeros(8, dtype=torch.float64), EPS, 8,
                             lambda t: t)
    with pytest.raises(ValueError, match="does not match"):
        kernel.rmsnorm_split(x, torch.zeros(4), EPS, 8, lambda t: t)
    with pytest.raises(ValueError, match="unknown rmsnorm impl"):
        kernel.rmsnorm_split(x, torch.zeros(8), EPS, 8, lambda t: t,
                             impl="pallas")
    with pytest.raises(ValueError, match="no RMSNorm kernel"):
        kernel.rmsnorm_split(x, torch.zeros(8), EPS, 8, lambda t: t,
                             impl="kernel")
