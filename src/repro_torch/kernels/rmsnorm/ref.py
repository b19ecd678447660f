"""Plain PyTorch RMSNorm: ``repro/kernels/rmsnorm/ref.py`` restated.

The mean of x² and the products are taken in float32 and the result is
cast back to the dtype of x.  The tests hold it against the JAX package,
and ``chip_smoke.py`` holds the CUDA kernel against it on the card; the
card's main path does not call it.
"""

from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * (var + eps) ** -0.5 * weight.float()).to(x.dtype)
