"""Binding of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``).

Replaces the Pallas kernel ``_rms_kernel`` / ``rmsnorm`` of the JAX
package (``repro/kernels/rmsnorm/kernel.py``).  The TPU wrapper padded the
rows to a whole block of 256; this one masks the ragged row count in the
kernel.  It also reads rows that sit at strides: the heads view
``(B, H, S, D)`` that ``q_norm`` and ``k_norm`` see is passed as it is, and
the output comes back contiguous in the view's logical order, so no copy is
made on the way in.

:func:`rmsnorm` is the one dispatch point.  With ``impl=None`` the device
decides: a CUDA tensor launches the kernel (``rmsnorm.launches`` counts the
launches), a CPU tensor takes the plain version
:func:`repro_torch.kernels.rmsnorm.ref.rmsnorm`, anything else raises.
``impl="ref"`` asks for the plain version on any device and
``impl="kernel"`` for the kernel, raising off a CUDA device.  The library
is built at first launch (:class:`repro_torch.cuda_build.CudaLibrary`).
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Tuple

import torch

from repro_torch.cuda_build import CudaLibrary
from repro_torch.kernels.rmsnorm import ref

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
LIBRARY = CudaLibrary("rmsnorm", {"rmsnorm_launch": (
    [_P, _P, _P, _LL, _I, _LL, _LL, _LL, _LL, _LL, ctypes.c_float, _I, _P],
    ctypes.c_int)})

# dtype codes of the C interface
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def row_layout(x: torch.Tensor) -> Tuple[int, Tuple[int, int],
                                         Tuple[int, int, int]]:
    """The rows of ``x`` (every index but the last) as at most three nested
    dimensions → (n_rows, (n1, n2), (s0, s1, s2)): row ``r`` starts at
    element ``i0*s0 + i1*s1 + i2*s2`` with ``r = (i0*n1 + i1)*n2 + i2``.

    Dimensions of size 1 drop out and neighbours whose strides nest merge,
    so a contiguous tensor is one dimension and the transposed heads view
    ``(B, H, S, D)`` of a ``(B, S, H*D)`` tensor is three.  Raises when
    more than three remain."""
    dims: List[List[int]] = []
    for n, s in zip(x.shape[:-1], x.stride()[:-1]):
        if n == 1:
            continue
        if dims and dims[-1][1] == s * n:
            dims[-1] = [dims[-1][0] * n, s]
        else:
            dims.append([n, s])
    if len(dims) > 3:
        raise ValueError(f"rows of a {tuple(x.shape)} tensor with strides "
                         f"{x.stride()} do not fold into three dimensions")
    dims = [[1, 0]] * (3 - len(dims)) + dims
    n_rows = math.prod(x.shape[:-1])
    return n_rows, (dims[1][0], dims[2][0]), (dims[0][1], dims[1][1],
                                              dims[2][1])


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
            impl: Optional[str] = None) -> torch.Tensor:
    """x: (..., D) with unit stride in D; weight: (D,) of x's dtype, float32
    or bfloat16 → x's shape, contiguous, x's dtype."""
    if impl not in (None, "ref", "kernel"):
        raise ValueError(f"unknown rmsnorm impl {impl!r}")
    if impl == "ref":
        return ref.rmsnorm(x, weight, eps=eps)
    if x.dim() < 1 or tuple(weight.shape) != (x.shape[-1],):
        raise ValueError(f"weight {tuple(weight.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if x.dtype not in DTYPES or weight.dtype != x.dtype:
        raise ValueError(f"x and weight must both be float32 or both "
                         f"bfloat16, got {x.dtype} and {weight.dtype}")
    if weight.device != x.device:
        raise ValueError(f"x on {x.device}, weight on {weight.device}")
    if x.device.type == "cpu" and impl is None:
        return ref.rmsnorm(x, weight, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"no RMSNorm kernel for device {x.device}: it runs "
                         f"on a CUDA device")
    d = x.shape[-1]
    if d > 1 and x.stride(-1) != 1:
        raise ValueError(f"x must have unit stride in its last dimension, "
                         f"got strides {x.stride()}")
    if not weight.is_contiguous():
        raise ValueError("weight must be contiguous")
    n_rows, (n1, n2), (s0, s1, s2) = row_layout(x)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if n_rows == 0 or d == 0:
        return out
    lib = LIBRARY.get()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rmsnorm_launch(
            x.data_ptr(), weight.data_ptr(), out.data_ptr(), n_rows, d,
            n1, n2, s0, s1, s2, float(eps), DTYPES[x.dtype], stream)
    LIBRARY.check(err, "rmsnorm launch")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
