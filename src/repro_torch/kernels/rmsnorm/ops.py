"""Dispatch for RMSNorm, the port's counterpart of the JAX package's
``ops.rmsnorm`` (``impl="ref"|"pallas"`` there): the kernel binding's
wrapper, whose ``impl=None|"ref"|"kernel"`` lets the device decide, asks
for the plain version, or asks for the CUDA kernel."""

from repro_torch.kernels.rmsnorm.kernel import rmsnorm

__all__ = ["rmsnorm"]
