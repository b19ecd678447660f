"""Plain PyTorch RMSNorm: ``repro/kernels/rmsnorm/ref.py`` restated, and
its backward.

The mean of x² and the products are taken in float32 and the result is
cast back to the dtype of x.  The tests hold both against the JAX package
(the backward against ``jax.vjp`` of its plain version, which is how the
JAX package trains), and ``chip_smoke.py`` holds the CUDA kernels against
them on the card; the card's main path does not call them.
"""

from __future__ import annotations

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
