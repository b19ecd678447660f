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
:func:`launch_plan` decides how the kernel splits the rows; the CPU tests
check it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.cuda_build import CudaLibrary
from repro_torch.kernels import refuse_grad
from repro_torch.kernels.rmsnorm import ref

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
LIBRARY = CudaLibrary("rmsnorm", {
    "rmsnorm_launch": (
        [_P, _P, _P, _LL, _I, _LL, _LL, _LL, _LL, _LL, ctypes.c_float, _I,
         _I, _I, _I, _I, _I, _I, _I, _I, _P], ctypes.c_int),
    "rmsnorm_blocks_per_sm": (
        [_I] * 7 + [ctypes.POINTER(_I)], ctypes.c_int)})

# dtype codes of the C interface
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# kernel codes of the C interface: registers (one read of x), or the
# scalar path's two passes
KINDS = {"rows": 0, "loop": 1}
# rmsnorm_rows' limits: threads per row, 16-byte vectors per thread
MAX_TPR, MAX_VPT = 512, 8
# the block each plan aims for
_BLOCK = 256


@dataclasses.dataclass(frozen=True)
class Plan:
    """How a call splits its rows.  ``kind`` "rows": a group of ``tpr``
    threads owns a row, each thread keeping ``vpt`` loads of ``vec``
    elements in registers, ``rows_per_group`` rows at once; with ``walk`` a
    grid of as many blocks as the SMs hold walks tiles of
    :attr:`rows_per_block` rows, loading each block's next tile ahead, else
    one block per tile.  "loop": the scalar path, ``tpr`` threads walk a row
    twice, one block per :attr:`rows_per_block` rows."""
    kind: str
    vec: int
    tpr: int
    vpt: int
    rows_per_group: int
    block: int
    walk: bool

    @property
    def rows_per_block(self) -> int:
        return self.block // self.tpr * self.rows_per_group


def _even_split(nv: int) -> Tuple[int, int]:
    """→ (threads per row, a multiple of 32 up to MAX_TPR; vectors per
    thread up to MAX_VPT) covering ``nv`` vectors with the fewest idle
    slots, then with the vectors per thread nearest 4 (on an H100, rows of
    5120 ran fastest as 160 x 4 in bf16 and 320 x 4 in float32:
    ``benchmarks/torch_kernel_times.py --alternatives``, PERF.md)."""
    best = None
    for vpt in range(1, MAX_VPT + 1):
        tpr = -(-nv // (vpt * 32)) * 32
        if tpr > MAX_TPR:
            continue
        key = (tpr * vpt - nv, abs(vpt - 4))
        if best is None or key < best[0]:
            best = (key, tpr, vpt)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def launch_plan(d: int, dtype: torch.dtype, aligned: bool) -> Plan:
    """The split of rows of ``d`` elements of ``dtype``; ``aligned`` when
    x, the weight and the output start on 16 bytes and every row stride is
    a whole number of 16 bytes.

    Rows of whole 16-byte vectors go to the register kernel: up to 32
    vectors, a power-of-two group of lanes per row, several rows to a warp
    and two rows a group, on a walking grid; wider rows, a block of whole
    warps splitting the row evenly, one row a block.  Anything else (an
    unaligned pointer, stride or width, or a row past MAX_TPR * MAX_VPT
    vectors) takes the scalar path."""
    vec = 16 // dtype.itemsize
    if not aligned or d % vec:
        vec = 1
    nv = d // vec
    if vec == 1 or nv > MAX_TPR * MAX_VPT:
        tpr = 32
        while tpr < 1024 and tpr * 4 < nv:
            tpr *= 2
        return Plan("loop", vec, tpr, -(-nv // tpr), 1, max(_BLOCK, tpr),
                    False)
    if nv <= 32:
        tpr = 1 << (nv - 1).bit_length()
        return Plan("rows", vec, tpr, 1, 2, _BLOCK, True)
    tpr, vpt = _even_split(nv)
    return Plan("rows", vec, tpr, vpt, 1, tpr, False)


def grid_size(plan: Plan, n_rows: int, n_sm: int,
              blocks_per_sm: int) -> int:
    """Blocks of the launch: one per :attr:`Plan.rows_per_block` rows, or
    for a walking plan no more than the ``n_sm`` SMs hold at once
    (``blocks_per_sm`` each), so each block walks several tiles in one
    wave."""
    tiles = -(-n_rows // plan.rows_per_block)
    if not plan.walk:
        return tiles
    return max(1, min(tiles, n_sm * blocks_per_sm))


_LIMITS: Dict[tuple, int] = {}


def _sm_count(device: torch.device) -> int:
    key = ("sm", device.index)
    if key not in _LIMITS:
        _LIMITS[key] = torch.cuda.get_device_properties(
            device.index).multi_processor_count
    return _LIMITS[key]


def _blocks_per_sm(plan: Plan, dtype: torch.dtype, device) -> int:
    key = (plan, dtype, device.index)
    if key not in _LIMITS:
        val = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = LIBRARY.get().rmsnorm_blocks_per_sm(
                DTYPES[dtype], KINDS[plan.kind], plan.vec, plan.vpt,
                plan.rows_per_group, plan.walk, plan.block,
                ctypes.byref(val))
        LIBRARY.check(err, "cudaOccupancyMaxActiveBlocksPerMultiprocessor")
        _LIMITS[key] = val.value
    return _LIMITS[key]


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
    refuse_grad("rmsnorm", x, weight)
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
    size = x.element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, weight, out)) and \
        all(st * size % 16 == 0 for st in (s0, s1, s2))
    plan = launch_plan(d, x.dtype, aligned)
    grid = grid_size(plan, n_rows, _sm_count(x.device),
                     _blocks_per_sm(plan, x.dtype, x.device)
                     if plan.walk else 0)
    lib = LIBRARY.get()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rmsnorm_launch(
            x.data_ptr(), weight.data_ptr(), out.data_ptr(), n_rows, d,
            n1, n2, s0, s1, s2, float(eps), DTYPES[x.dtype],
            KINDS[plan.kind], plan.vec, plan.tpr, plan.vpt,
            plan.rows_per_group, plan.walk, plan.block, grid, stream)
    LIBRARY.check(err, "rmsnorm launch")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
