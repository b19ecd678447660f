"""Plain PyTorch RMSNorm: ``repro/kernels/rmsnorm/ref.py`` restated, and
its backward.

The mean of x² and the products are taken in float32 and the result is
cast back to the dtype of x.  The tests hold both against the JAX package
(the backward against ``jax.vjp`` of its plain version, which is how the
JAX package trains), and ``chip_smoke.py`` holds the CUDA kernels against
them on the card; the card's main path does not call them.
"""

from __future__ import annotations

from typing import Optional

import torch


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * (var + eps) ** -0.5 * weight.float()).to(x.dtype)


def rmsnorm_bwd(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-6):
    """The gradients of :func:`rmsnorm` given the output's gradient ``dy``
    → (dx in x's dtype and shape, dw in the weight's dtype).  With
    ``r = sqrt(mean(x²) + eps)``: ``dx = (w·dy)/r − x·Σ(w·dy·x)/(d·r³)``
    and ``dw = Σ_rows dy·x/r``, in float32."""
    d = x.shape[-1]
    xf, gf = x.float(), dy.float()
    inv = ((xf * xf).mean(dim=-1, keepdim=True) + eps) ** -0.5
    gw = gf * weight.float()
    c = (gw * xf).sum(dim=-1, keepdim=True) * inv ** 3 / d
    dx = gw * inv - xf * c
    dw = (gf * xf * inv).reshape(-1, d).sum(dim=0)
    return dx.to(x.dtype), dw.to(weight.dtype)


# ------------------------------------------------------------ split rows
# A row cut into column blocks, one a rank (Mamba2's gated norm over the
# inner width on 'model'): each block's partial sum is taken alone, the
# partials are summed across the blocks (an all-reduce), and the block is
# normed with the whole row's mean.  ``n`` is the whole row's width.

def split_sumsq(x: torch.Tensor) -> torch.Tensor:
    """The block's partial ``Σx²`` of each row, float32, x's shape
    without its last dimension."""
    xf = x.float()
    return (xf * xf).sum(dim=-1)


def rmsnorm_split(x: torch.Tensor, weight: torch.Tensor, total: torch.Tensor,
                  n: int, eps: float = 1e-6) -> torch.Tensor:
    """The block ``x`` (..., d) of rows of ``n`` normed by the row's
    ``total`` (``Σx²`` over the whole row, float32), times the block's
    ``weight`` (d,), in float32, rounded once to x's dtype."""
    inv = (total[..., None] / n + eps) ** -0.5
    return (x.float() * inv * weight.float()).to(x.dtype)


def split_dot(x: torch.Tensor, weight: torch.Tensor,
              dy: torch.Tensor) -> torch.Tensor:
    """The block's partial ``Σ(w·dy·x)`` of each row, float32."""
    return (dy.float() * weight.float() * x.float()).sum(dim=-1)


def split_inv(total: torch.Tensor, n: int, eps: float) -> torch.Tensor:
    """Each row's ``(total/n + eps)^-1/2`` with a trailing dimension of 1,
    float32."""
    return (total[..., None] / n + eps) ** -0.5


def split_dw_rows(x: torch.Tensor, dy: torch.Tensor, inv: torch.Tensor,
                  block_of: Optional[torch.Tensor] = None,
                  parts: int = 1) -> torch.Tensor:
    """The partial dw of each of ``parts`` blocks of rows, ``Σ dy·x·inv``
    over the rows whose ``block_of`` (int64, one a row of x; None: all
    rows one block) is that block, float32 (parts, d); ``inv`` is
    :func:`split_inv` of the rows.  The shapes depend on no values, so
    fake tensors trace it."""
    p = (dy.float() * x.float() * inv).reshape(-1, x.shape[-1])
    if block_of is None:
        return p.sum(dim=0, keepdim=True)
    return torch.stack([torch.where((block_of == b)[:, None], p, 0.0)
                        .sum(dim=0) for b in range(parts)])


def _split_dx(xf, weight, gf, inv, dot, n) -> torch.Tensor:
    """``w·dy·inv − x·inv³·dot/n`` from x and dy in float32, float32."""
    return gf * weight.float() * inv - xf * (inv ** 3 * dot[..., None] / n)


def split_bwd_rows(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                   total: torch.Tensor, n: int, eps: float,
                   block_of: Optional[torch.Tensor] = None,
                   parts: int = 1) -> tuple:
    """The backward's first pass, before the all-reduce → (the block's
    partial ``Σ(w·dy·x)`` of each row, float32; :func:`split_dw_rows`
    over the given blocks of rows)."""
    return split_dot(x, weight, dy), split_dw_rows(
        x, dy, split_inv(total, n, eps), block_of, parts)


def split_bwd_dx(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                 total: torch.Tensor, dot: torch.Tensor,
                 partial: torch.Tensor, n: int, eps: float = 1e-6):
    """The backward's second pass, given the row's ``dot`` summed over the
    whole row → (dx of the block; dw, the rows of ``partial`` summed in
    order, in the weight's dtype)."""
    dx = _split_dx(x.float(), weight, dy.float(), split_inv(total, n, eps),
                   dot, n)
    dw = partial[0].clone()
    for row in partial[1:]:
        dw += row
    return dx.to(x.dtype), dw.to(weight.dtype)


def rmsnorm_split_bwd(x: torch.Tensor, weight: torch.Tensor,
                      dy: torch.Tensor, total: torch.Tensor,
                      dot: torch.Tensor, n: int, eps: float = 1e-6):
    """The gradients of :func:`rmsnorm_split` on the block, given the
    row's ``total`` and ``dot`` (both summed over the whole row) → (dx of
    the block, dw of the block's columns summed over this block's rows).
    With ``r = (total/n + eps)^-1/2``: ``dx = w·dy·r − x·r³·dot/n``,
    ``dw = Σ_rows dy·x·r``, in float32."""
    xf, gf = x.float(), dy.float()
    inv = split_inv(total, n, eps)
    dx = _split_dx(xf, weight, gf, inv, dot, n)
    return dx.to(x.dtype), split_dw_rows(xf, gf, inv)[0].to(weight.dtype)
