"""PyTorch and CUDA port of the resource-aware overlay JIT compiler.

Mirrors the JAX package ``repro`` path for path and imports nothing of it.
The compiler (``core/``) is host-side numpy; the overlay executor
(``kernels/overlay_exec``) runs on an NVIDIA Hopper card through a CUDA
kernel built from ``csrc/`` at first use.  Entry points run on the card
unless the caller passes ``device="cpu"`` or CPU tensors
(see :mod:`repro_torch.device`).
"""

from repro_torch.device import default_device  # noqa: F401
