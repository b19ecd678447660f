"""The split-row RMSNorm's CUDA kernels (Mamba2's gated norm with the
inner width on 'model') against their plain versions on a card: each row
cut into column blocks, each block's partial sums launched and summed in
this process (the all-reduce's part), then each block applied, and the
backward's two passes around the summed dots.  Rows of 512, 1792, 48 and
49 elements a block (the last on the scalar path), in row counts that
the grid's blocks cut unevenly; the backward twice, bit for bit; the
planted faults (``n`` taken as the block's width; the second pass's two,
``kernel.SPLIT_BWD_FAULTS``) caught.  Tolerances 1e-4 (float32) and 3e-2
(bfloat16), as ``tests/test_torch_rmsnorm_split.py``'s against the JAX
package, which this file does not import: it runs on the card with
``-m gpu``.
"""

import numpy as np
import pytest
import torch

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


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _blocks(t: torch.Tensor, k: int):
    return list(torch.chunk(t, k, dim=-1))


def split_forward(x, w, k, n_as=None):
    """The plain blocks' outputs joined, and the rows' totals."""
    xs, ws = _blocks(x, k), _blocks(w, k)
    total = sum(ref.split_sumsq(b) for b in xs)
    n = n_as or x.shape[-1]
    return torch.cat([ref.rmsnorm_split(b, wb, total, n, EPS)
                      for b, wb in zip(xs, ws)], dim=-1), total


def split_backward(x, w, dy, k):
    """The plain backward of each block, joined."""
    xs, ws, gs = _blocks(x, k), _blocks(w, k), _blocks(dy, k)
    total = sum(ref.split_sumsq(b) for b in xs)
    dot = sum(ref.split_dot(b, wb, g) for b, wb, g in zip(xs, ws, gs))
    outs = [ref.rmsnorm_split_bwd(b, wb, g, total, dot, x.shape[-1], EPS)
            for b, wb, g in zip(xs, ws, gs)]
    return (torch.cat([o[0] for o in outs], dim=-1),
            torch.cat([o[1] for o in outs], dim=-1))


def _card_split(x, w, k, n):
    """The kernels' blocks joined: each block's partial sums launched,
    summed in this process, then each block applied."""
    xs, ws = _blocks(x, k), _blocks(w, k)
    total = sum(kernel.split_row_sums(b.contiguous()) for b in xs)
    return torch.cat([kernel.split_apply(b.contiguous(), wb.contiguous(),
                                         total, n, EPS)
                      for b, wb in zip(xs, ws)], dim=-1)


def _card_split_bwd(xs, ws, gs, total, n, fault=0):
    """The backward's passes on each block: the first passes, the dots
    summed in this process (the all-reduce's part), then the second
    passes → (dx joined, dw joined, each block's (dot, partial, plan))."""
    firsts = [kernel.split_bwd_rows(b, wb, g, total, n, EPS)
              for b, wb, g in zip(xs, ws, gs)]
    dot = sum(f[0] for f in firsts)
    outs = [kernel.split_bwd_dx(b, wb, g, total, dot, partial, plan, n, EPS,
                                fault=fault)
            for b, wb, g, (_, partial, plan) in zip(xs, ws, gs, firsts)]
    return (torch.cat([o[0] for o in outs], -1),
            torch.cat([o[1] for o in outs], -1), firsts)


@gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,k", [((4, 512, 2048), 4),
                                     ((2, 256, 7168), 4), ((3, 5, 96), 2),
                                     ((3, 1001, 98), 2), ((2, 5, 40960), 2),
                                     ((3, 7, 10002), 2)])
def test_cuda_split_kernels_match_plain(shape, k, dtype):
    """Rows of 512, 1792, 48 and 49 (single elements: the scalar path) a
    block; 2048, 512, 15 and 3003 rows, whose tiles the grid's blocks
    share unevenly; rows of 20480 and 5001 (scalar), wider than a
    thread's vectors in registers.  The backward twice, bit for bit; its
    faults caught."""
    x, w, dy = _inputs(shape)
    cx, cw, cg = (_t(a, dtype).cuda() for a in (x, w, dy))
    tol = TOL[dtype]
    got = _card_split(cx, cw, k, shape[-1])
    want, _ = split_forward(cx.cpu(), cw.cpu(), k)
    np.testing.assert_allclose(_f32(got.cpu()), _f32(want), rtol=tol,
                               atol=tol)
    bad = _card_split(cx, cw, k, shape[-1] // k)
    assert np.abs(_f32(bad.cpu()) - _f32(want)).max() > tol
    xs, ws, gs = ([t.contiguous() for t in _blocks(a, k)]
                  for a in (cx, cw, cg))
    total = sum(kernel.split_row_sums(b) for b in xs)
    dx, dw, firsts = _card_split_bwd(xs, ws, gs, total, shape[-1])
    torch.cuda.synchronize()
    n_rows = x.size // shape[-1]
    for (dot, partial, plan), b, wb, g in zip(firsts, xs, ws, gs):
        assert plan.vec == (1 if b.shape[-1] % (16 // b.element_size())
                            else 16 // b.element_size())
        want_dot, want_partial = ref.split_bwd_rows(
            b.cpu(), wb.cpu(), g.cpu(), total.cpu(), shape[-1], EPS,
            kernel.split_bwd_block_of(n_rows, plan.groups, plan.grid),
            plan.grid)
        np.testing.assert_allclose(dot.cpu().numpy(), want_dot.numpy(),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(partial.cpu().numpy(),
                                   want_partial.numpy(), rtol=1e-4,
                                   atol=1e-4)
    want_dx, want_dw = split_backward(cx.cpu(), cw.cpu(), cg.cpu(), k)
    np.testing.assert_allclose(_f32(dx.cpu()), _f32(want_dx), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(_f32(dw.cpu()), _f32(want_dw), rtol=tol,
                               atol=tol)
    again = _card_split_bwd(xs, ws, gs, total, shape[-1])
    assert torch.equal(dx, again[0]) and torch.equal(dw, again[1])
    for fault in kernel.SPLIT_BWD_FAULTS.values():
        bad_dx, bad_dw, _ = _card_split_bwd(xs, ws, gs, total, shape[-1],
                                            fault=fault)
        err = max(np.abs(_f32(a.cpu()) - _f32(b_)).max()
                  for a, b_ in ((bad_dx, want_dx), (bad_dw, want_dw)))
        assert err > tol, fault


@gpu
@pytest.mark.parametrize("dtype,d,step", [("bfloat16", 38656, 8),
                                          ("float32", 28992, 4)])
def test_cuda_split_backward_at_the_widest_rows(dtype, d, step):
    """The widest rows the backward takes (a first-pass block's shared
    memory at 227 KB) through the autograd Function against the plain
    backward; a vector wider is refused by the forward, before any
    launch."""
    x, w, dy = _inputs((5, d), seed=5)
    cx, cw = (_t(a, dtype).cuda().requires_grad_() for a in (x, w))
    cg = _t(dy, dtype).cuda()
    before = kernel.rmsnorm_split_bwd.launches
    y = kernel.rmsnorm_split(cx, cw, EPS, d, lambda t: t)
    y.backward(cg)
    assert kernel.rmsnorm_split_bwd.launches == before + 1
    want_dx, want_dw = split_backward(cx.detach().cpu(), cw.detach().cpu(),
                                      cg.cpu(), 1)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(cx.grad.cpu()), _f32(want_dx), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(_f32(cw.grad.cpu()), _f32(want_dw), rtol=tol,
                               atol=tol)
    wide = (_t(np.ones((2, d + step), np.float32), dtype).cuda()
            .requires_grad_())
    launches = (kernel.split_row_sums.launches, kernel.split_apply.launches)
    with pytest.raises(ValueError, match="shared memory"):
        kernel.rmsnorm_split(wide, torch.ones(d + step, dtype=wide.dtype,
                                              device="cuda"),
                             EPS, d + step, lambda t: t)
    assert (kernel.split_row_sums.launches,
            kernel.split_apply.launches) == launches
