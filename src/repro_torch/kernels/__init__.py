"""The port's hand-written Hopper kernels, one package each, beside their
plain PyTorch versions."""

from __future__ import annotations

import torch


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise when a CUDA kernel would be asked for a gradient it cannot
    give.

    The kernels write their outputs through ctypes into tensors autograd
    never sees, so with grad mode on and an input that requires grad,
    ``backward()`` would run and silently drop every gradient through the
    kernel.  Training needs backward kernels, which arrive with the
    training item of ROADMAP.md §1; until then the plain version (``impl=
    "ref"``, or CPU tensors) is the differentiable route."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward pass and its output "
            f"would carry no gradient; run under torch.no_grad() or "
            f"torch.inference_mode(), or take the plain version with "
            f"impl=\"ref\" (backward kernels arrive with the training item "
            f"of ROADMAP.md section 1)")
