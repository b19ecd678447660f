"""Dispatch for RMSNorm, the port's counterpart of the JAX package's
``ops.rmsnorm`` (``impl="ref"|"pallas"`` there): the kernel binding's
wrapper, whose ``impl=None|"ref"|"kernel"`` lets the device decide, asks
for the plain version, or asks for the CUDA kernel; and the split-row
mode for a row whose columns are spread over ranks."""

from repro_torch.kernels.rmsnorm.kernel import rmsnorm, rmsnorm_split

__all__ = ["rmsnorm", "rmsnorm_split"]
