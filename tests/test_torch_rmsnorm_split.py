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
``tests/test_torch_rmsnorm.py``.  The ``gpu`` tests hold the CUDA kernels
against the plain versions on a card, with one planted fault (``n``
taken as the block's width).
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


def gpu(fn):
    """Needs a CUDA card: decided when the test runs, not at import."""
    fn = pytest.mark.skipif("not torch.cuda.is_available()",
                            reason="needs a CUDA card")(fn)
    return pytest.mark.gpu(fn)


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


# ------------------------------------------------------------ on the card

def _card_split(x, w, k, n):
    """The kernels' blocks joined: each block's partial sums launched,
    summed in this process, then each block applied."""
    xs, ws = _blocks(x, k), _blocks(w, k)
    total = sum(kernel.split_row_sums(b.contiguous()) for b in xs)
    return torch.cat([kernel.split_apply(b.contiguous(), wb.contiguous(),
                                         total, n, EPS)
                      for b, wb in zip(xs, ws)], dim=-1)


@gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,k", [((4, 512, 2048), 4),
                                     ((2, 256, 7168), 4), ((3, 5, 96), 2)])
def test_cuda_split_kernels_match_plain(shape, k, dtype):
    x, w, dy = _inputs(shape)
    cx, cw, cg = (_t(a, dtype).cuda() for a in (x, w, dy))
    tol = TOL[dtype]
    got = _card_split(cx, cw, k, shape[-1])
    want, _ = split_forward(cx.cpu(), cw.cpu(), k)
    np.testing.assert_allclose(_f32(got.cpu()), _f32(want), rtol=tol,
                               atol=tol)
    bad = _card_split(cx, cw, k, shape[-1] // k)
    assert np.abs(_f32(bad.cpu()) - _f32(want)).max() > tol
    xs, ws, gs = _blocks(cx, k), _blocks(cw, k), _blocks(cg, k)
    total = sum(kernel.split_row_sums(b.contiguous()) for b in xs)
    dot = sum(kernel.split_row_sums(b.contiguous(), wb.contiguous(),
                                    g.contiguous())
              for b, wb, g in zip(xs, ws, gs))
    outs = [kernel.split_bwd_apply(b.contiguous(), wb.contiguous(),
                                   g.contiguous(), total, dot, shape[-1],
                                   EPS) for b, wb, g in zip(xs, ws, gs)]
    want_dx, want_dw = split_backward(cx.cpu(), cw.cpu(), cg.cpu(), k)
    np.testing.assert_allclose(
        _f32(torch.cat([o[0] for o in outs], -1).cpu()), _f32(want_dx),
        rtol=tol, atol=tol)
    np.testing.assert_allclose(
        _f32(torch.cat([o[1] for o in outs], -1).cpu()), _f32(want_dw),
        rtol=tol, atol=tol)
