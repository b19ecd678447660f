"""Dispatch for attention, the port's counterpart of the JAX package's
``ops.attention`` (``impl="ref"|"pallas"`` there): the kernel binding's
wrapper, whose ``impl=None|"ref"|"kernel"`` lets the device decide, asks
for the plain version, or asks for the CUDA kernel."""

from repro_torch.kernels.flash_attention.kernel import \
    flash_attention as attention

__all__ = ["attention"]
