"""Binding of the CUDA RMSNorm kernels, forward and backward, of one source
(``csrc/rmsnorm.cu``).

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
Where autograd records (grad mode on, an input that requires grad) the
call is a :class:`torch.autograd.Function` whose backward is
:func:`rmsnorm_bwd`, decided by the device in the same way: the
backward kernel on a CUDA tensor (``rmsnorm_bwd.launches`` counts its
calls, one kernel launch each), :func:`ref.rmsnorm_bwd` on a CPU one; its
dx keeps x's strides where x is dense (:func:`grad_like`).
``impl="ref"`` asks for the plain version on any device, differentiated
by autograd, and ``impl="kernel"`` for the kernel, raising off a CUDA
device.  Each library is built at its first launch
(:class:`repro_torch.cuda_build.CudaLibrary`).  :func:`launch_plan` and
:func:`bwd_plan` decide how the kernels split the rows; the CPU tests
check them.

:func:`rmsnorm_split` norms a row cut into column blocks, one a rank
(Mamba2's gated norm over the inner width on 'model'): a launch writes
the block's partial ``Σx²`` of each row, the caller's ``all_reduce`` sums
the partials over the ranks, and a second launch applies the whole row's
mean.  Its backward (:func:`rmsnorm_split_bwd`) is two passes around the
all-reduce of ``Σ(w·dy·x)``: :func:`split_bwd_rows` reads x and dy once
for the rows' partial dots and the blocks' partial dw, and
:func:`split_bwd_dx` writes dx and sums dw (:func:`split_bwd_threads`,
:func:`split_bwd_grid` and :func:`split_bwd_block_of` cut the rows; the
CPU tests check them).  The device decides as for :func:`rmsnorm`, and
``rmsnorm_split.launches`` / ``rmsnorm_split_bwd.launches`` count the
calls that took the kernels.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.cuda_build import CudaLibrary
from repro_torch.kernels.rmsnorm import ref

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
LIBRARY = CudaLibrary("rmsnorm", {
    "rmsnorm_launch": (
        [_P, _P, _P, _LL, _I, _LL, _LL, _LL, _LL, _LL, ctypes.c_float, _I,
         _I, _I, _I, _I, _I, _I, _I, _I, _P], ctypes.c_int),
    "rmsnorm_blocks_per_sm": (
        [_I] * 7 + [ctypes.POINTER(_I)], ctypes.c_int),
    "rmsnorm_bwd_launch": (
        [_P] * 6 + [_LL, _I, _LL, _LL, ctypes.POINTER(_LL), ctypes.c_float]
        + [_I] * 11 + [_P], ctypes.c_int),
    "rmsnorm_bwd_blocks_per_sm": (
        [_I] * 9 + [ctypes.POINTER(_I)], ctypes.c_int),
    "rmsnorm_split_rows_launch": (
        [_P, _P, _LL, _I, _I, _I, _P], ctypes.c_int),
    "rmsnorm_split_apply_launch": (
        [_P] * 4 + [_LL, _I, _I, ctypes.c_float, _I, _I, _I, _P],
        ctypes.c_int),
    "rmsnorm_split_bwd_rows_launch": (
        [_P] * 6 + [_LL, _I, _I, ctypes.c_float] + [_I] * 5 + [_P],
        ctypes.c_int),
    "rmsnorm_split_bwd_dx_launch": (
        [_P] * 8 + [_LL, _I, _I, ctypes.c_float] + [_I] * 6 + [_P],
        ctypes.c_int),
    "rmsnorm_split_bwd_blocks_per_sm": (
        [_I] * 5 + [ctypes.POINTER(_I)], ctypes.c_int)})

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


def joint_row_layout(*ts: torch.Tensor) -> Tuple[
        int, Tuple[int, int], List[Tuple[int, int, int]]]:
    """The rows (every index but the last) of tensors of one shape as at
    most three nested dimensions common to all → (n_rows, (n1, n2), one
    (s0, s1, s2) a tensor): row ``r = (i0*n1 + i1)*n2 + i2`` of each
    starts at element ``i0*s0 + i1*s1 + i2*s2`` of it.

    Dimensions of size 1 drop out and neighbours whose strides nest in
    every tensor merge, so a contiguous tensor is one dimension and the
    transposed heads view ``(B, H, S, D)`` of a ``(B, S, H*D)`` tensor is
    three.  Raises when more than three remain."""
    shape = ts[0].shape
    dims: List[Tuple[int, List[int]]] = []
    for i, n in enumerate(shape[:-1]):
        if n == 1:
            continue
        st = [t.stride(i) for t in ts]
        if dims and all(p == s * n for p, s in zip(dims[-1][1], st)):
            dims[-1] = (dims[-1][0] * n, st)
        else:
            dims.append((n, st))
    if len(dims) > 3:
        raise ValueError(f"rows of a {tuple(shape)} tensor with strides "
                         f"{[t.stride() for t in ts]} do not fold into "
                         f"three dimensions")
    dims = [(1, [0] * len(ts))] * (3 - len(dims)) + dims
    n_rows = math.prod(shape[:-1])
    return n_rows, (dims[1][0], dims[2][0]), [
        tuple(dim[1][k] for dim in dims) for k in range(len(ts))]


def _folds(*ts: torch.Tensor) -> bool:
    try:
        joint_row_layout(*ts)
    except ValueError:
        return False
    return True


def row_layout(x: torch.Tensor) -> Tuple[int, Tuple[int, int],
                                         Tuple[int, int, int]]:
    """:func:`joint_row_layout` of ``x`` alone → (n_rows, (n1, n2), (s0,
    s1, s2))."""
    n_rows, dims, (strides,) = joint_row_layout(x)
    return n_rows, dims, strides


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
            impl: Optional[str] = None) -> torch.Tensor:
    """x: (..., D) with unit stride in D; weight: (D,) of x's dtype, float32
    or bfloat16 → x's shape, contiguous, x's dtype.  Differentiable on
    every route."""
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
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        _on_kernel_device(x, impl)
        return _RMSNorm.apply(x, weight, eps)
    return _forward(x, weight, eps, impl)   # nothing to differentiate


rmsnorm.launches = 0


def _on_kernel_device(x: torch.Tensor, impl: Optional[str]) -> bool:
    """True for a CUDA tensor (the kernels), False for a CPU tensor with
    ``impl=None`` (the plain versions); raises for anything else."""
    if x.device.type == "cpu" and impl is None:
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no RMSNorm kernel for device {x.device}: it runs "
                         f"on a CUDA device")
    return True


def _forward(x, weight, eps, impl=None):
    """The forward of ``x``'s device: the kernel, or the plain version."""
    if _on_kernel_device(x, impl):
        return _launch(x, weight, eps)
    return ref.rmsnorm(x, weight, eps=eps)


class _RMSNorm(torch.autograd.Function):
    """The forward and backward of one device: the kernels on a CUDA
    tensor, the plain versions on a CPU one."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _forward(x, weight, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, weight, dy, ctx.eps)
        return dx, dw, None


def _launch(x: torch.Tensor, weight: torch.Tensor,
            eps: float) -> torch.Tensor:
    """The forward kernel on CUDA tensors that :func:`rmsnorm` has
    validated."""
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


# ------------------------------------------------------------- backward

# the ring kernel's limits (csrc/rmsnorm.cu): consumer warps of a block,
# ring stages, and the widest row one TMA box spans (elements)
BWD_MAX_WARPS = 11
BWD_MAX_STAGES = 8
BWD_MAP_MAX_D = 256
# what a plan aims for: bytes of x and dy in a stage; bytes of a block's
# ring (two blocks an SM keep up to 192 KB in flight, where Little's law
# asks for about 25 KB); the most a ring may take of the 227 KB a block can
# use (the rest holds the barriers and the sums); consumer warps of a
# narrow-row block; threads of a loop-kernel block
BWD_STAGE_BYTES = 32 << 10
BWD_RING_BYTES = 96 << 10
BWD_MAX_RING = 200 << 10
BWD_MAP_WARPS = 8
BWD_LOOP_BLOCK = 256
SMEM_ALIGN = 128                 # a stage's region of each tensor starts here
# the ring kernel's planted faults (chip_smoke.py's check that its limits
# catch them): dw summed without the last block's partial row; dx computed
# from the previous ring stage's rows
BWD_FAULTS = {"dw without the last block's partial row": 1,
              "dx read from the previous ring stage": 2}
BWD_KINDS = {"ring": 0, "loop": 1}


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How the backward splits its rows.  ``kind`` "ring": a persistent
    grid whose producer warp keeps ``stages`` shared-memory stages of
    ``rows`` rows of x and of dy full (``load`` "map": one TMA box a tensor
    through a tensor map over its strides, rows of one run of positions;
    "bulk": one bulk copy a row), ``region`` bytes a tensor a stage;
    ``warps`` consumer warps in groups of ``tpr`` threads a row, each thread
    ``vpt`` vectors of ``vec`` elements of :func:`bwd_rows_at_once` rows at
    once.  "loop": one row a block, read twice, one element a load."""
    kind: str
    load: str
    vec: int
    vpt: int
    tpr: int
    warps: int
    rows: int
    stages: int
    region: int

    @property
    def block(self) -> int:
        return 32 * (self.warps + 1) if self.kind == "ring" \
            else BWD_LOOP_BLOCK

    @property
    def groups(self) -> int:
        """Rows a stage's consumers hold at once."""
        return 32 * self.warps // self.tpr if self.kind == "ring" else 1

    @property
    def smem(self) -> int:
        """Dynamic shared memory of a block: the ring, and room to align
        it."""
        return 2 * self.stages * self.region + SMEM_ALIGN \
            if self.kind == "ring" else 0


_LOOP_PLAN = BwdPlan("loop", "", 1, 0, BWD_LOOP_BLOCK, 0, 0, 0, 0)


def _bwd_split(nv: int) -> Optional[Tuple[int, int]]:
    """→ (consumer warps up to BWD_MAX_WARPS, vectors a thread of 1, 2, 4
    or 8) covering a wide row of ``nv`` vectors with the fewest idle slots,
    then the vectors a thread nearest 2; None when no split covers it."""
    best = None
    for vpt in (1, 2, 4, 8):
        warps = -(-nv // (32 * vpt))
        if warps > BWD_MAX_WARPS:
            continue
        key = (warps * 32 * vpt - nv, abs(vpt - 2))
        if best is None or key < best[0]:
            best = (key, warps, vpt)
    return None if best is None else best[1:]


@functools.lru_cache(maxsize=None)
def bwd_plan(d: int, dtype: torch.dtype, aligned: bool) -> BwdPlan:
    """The backward's split of rows of ``d`` elements of ``dtype``;
    ``aligned`` when x, dy, dx, the weight and dw start on 16 bytes and
    every row stride is a whole number of 16 bytes.

    Rows of whole 16-byte vectors go to the ring kernel: up to
    BWD_MAP_MAX_D elements (a TMA box's width) through tensor maps, a
    power-of-two group of up to 32 threads a row holding two vectors each
    where the row has them, and as many rows a stage as fill about
    BWD_STAGE_BYTES in whole steps of the block's groups; wider rows by
    bulk copies, every consumer thread on one row (:func:`_bwd_split`), as
    many rows a stage as fit that in whole steps.  The ring takes about
    BWD_RING_BYTES, at least two stages.  Unaligned rows, and rows whose
    two stages pass BWD_MAX_RING, take the loop kernel."""
    size = dtype.itemsize
    vec = 16 // size
    if not aligned or d % vec:
        return _LOOP_PLAN
    nv, row = d // vec, d * size
    if d <= BWD_MAP_MAX_D:
        # two vectors a thread where the row has them: half the threads a
        # row, so half the shuffles and inverse roots an element
        tpr = min(32, 1 << (-(-nv // 2) - 1).bit_length())
        vpt, warps, load = -(-nv // tpr), BWD_MAP_WARPS, "map"
        if 32 * warps // tpr * bwd_rows_at_once(vpt) > BWD_MAP_MAX_D:
            warps //= 2                  # tiny rows: a step fits a box
        step = 32 * warps // tpr * bwd_rows_at_once(vpt)
        rows = max(step, BWD_STAGE_BYTES // 2 // row // step * step)
        rows = min(rows, BWD_MAP_MAX_D // step * step)
    else:
        split = _bwd_split(nv)
        if split is None:
            return _LOOP_PLAN
        (warps, vpt), load = split, "bulk"
        tpr, step = 32 * warps, bwd_rows_at_once(vpt)
        rows = max(step, BWD_STAGE_BYTES // 2 // row // step * step)
    region = -(-rows * row // SMEM_ALIGN) * SMEM_ALIGN
    stages = max(2, min(BWD_MAX_STAGES, BWD_RING_BYTES // (2 * region)))
    if 2 * stages * region > BWD_MAX_RING:
        return _LOOP_PLAN
    return BwdPlan("ring", load, vec, vpt, tpr, warps, rows, stages, region)


def bwd_rows_at_once(vpt: int) -> int:
    """Rows a consumer thread of the ring kernel works on together (its
    ``U``): two while it holds at most two vectors a row, else one."""
    return 2 if vpt <= 2 else 1


def bwd_tiles(plan: BwdPlan, n_rows: int, n2: int) -> int:
    """Tiles the backward walks: the ring's lie inside runs of ``n2`` rows
    (one box, or rows at one stride, a tile); the loop's are rows."""
    if plan.kind == "loop":
        return n_rows
    return n_rows // n2 * -(-n2 // plan.rows)


def bwd_grid(plan: BwdPlan, n_rows: int, n2: int, n_sm: int,
             blocks_per_sm: int) -> int:
    """Blocks of the cooperative launch: one per tile, at most as many as
    the ``n_sm`` SMs hold at once (``blocks_per_sm`` each), every block
    resident for the grid sync."""
    if blocks_per_sm < 1:
        raise ValueError(f"a backward block of {plan} does not fit an SM")
    return max(1, min(bwd_tiles(plan, n_rows, n2), n_sm * blocks_per_sm))


def _bwd_blocks_per_sm(plan: BwdPlan, dtype: torch.dtype, d: int,
                       device) -> int:
    key = ("bwd", plan, dtype, d, device.index)
    if key not in _LIMITS:
        val = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = LIBRARY.get().rmsnorm_bwd_blocks_per_sm(
                DTYPES[dtype], BWD_KINDS[plan.kind], plan.load == "map",
                plan.vec, plan.vpt, plan.block, plan.rows, plan.stages, d,
                ctypes.byref(val))
        LIBRARY.check(err, "cudaOccupancyMaxActiveBlocksPerMultiprocessor")
        _LIMITS[key] = val.value
    return _LIMITS[key]


def _rows_of(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its rows fold into the kernels' three nested
    dimensions with unit stride along a row, else a contiguous copy (an
    expanded gradient, for one)."""
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        return t.contiguous()
    return t if _folds(t) else t.contiguous()


def _dense(t: torch.Tensor) -> bool:
    """True when ``t``'s elements fill its storage span once each (some
    order of its dimensions is contiguous): non-overlapping and dense."""
    want = 1
    for st, n in sorted((st, n) for n, st in zip(t.shape, t.stride())
                        if n != 1):
        if st != want:
            return False
        want *= n
    return True


def grad_like(x: torch.Tensor) -> torch.Tensor:
    """An empty tensor for x's gradient: with x's strides where x is
    non-overlapping and dense with unit stride along its rows (the heads
    view ``(B, H, S, D)`` of a ``(B, S, H*D)`` projection, so that
    autograd's backward of the view is a view, not a copy), else
    contiguous."""
    if _dense(x) and (x.shape[-1] <= 1 or x.stride(-1) == 1):
        return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                   device=x.device)
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


def bwd_operands(x: torch.Tensor, dy: torch.Tensor, *vectors: torch.Tensor):
    """What the backward kernel is handed → (dy, read in place or a
    contiguous copy where its rows do not fold with x's; dx from
    :func:`grad_like`; :func:`joint_row_layout` of x, dy and dx; whether x,
    dy, dx and ``vectors`` (the weight and dw) start on 16 bytes and every
    row stride is a whole number of 16 bytes)."""
    if x.shape[-1] > 1 and x.stride(-1) != 1:
        raise ValueError(f"x must have unit stride in its last dimension, "
                         f"got strides {x.stride()}")
    dy = _rows_of(dy)
    dx = grad_like(x)
    if not _folds(x, dy, dx):
        dy = dy.contiguous()             # then x's and dx's dimensions fold
    layout = joint_row_layout(x, dy, dx)
    size = x.element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, dy, dx, *vectors)) \
        and all(st * size % 16 == 0 for sts in layout[2] for st in sts)
    return dy, dx, layout, aligned


def rmsnorm_bwd(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-6):
    """The gradients of :func:`rmsnorm` → (dx, x's shape and dtype, laid
    out as :func:`grad_like` says: x's strides where x is non-overlapping
    and dense, else contiguous; dw, the weight's shape and dtype).  x,
    weight and eps as given to the forward; dy of the output's shape and
    dtype, at any strides.  The device decides as in :func:`rmsnorm`: the
    backward kernel on CUDA tensors (one launch), :func:`ref.rmsnorm_bwd`
    on CPU ones."""
    if tuple(dy.shape) != tuple(x.shape) or dy.dtype != x.dtype \
            or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} on {dy.device} "
                         f"does not match x {tuple(x.shape)} {x.dtype}")
    if not _on_kernel_device(x, None):
        dx, dw = ref.rmsnorm_bwd(x, weight, dy, eps=eps)
        out = grad_like(x)
        return (dx if out.stride() == dx.stride() else out.copy_(dx)), dw
    return _launch_bwd(x, weight, dy, eps)


def _launch_bwd(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                eps: float, fault: int = 0):
    """The backward kernel on CUDA tensors that :func:`rmsnorm_bwd` has
    matched; called with ``fault`` (``BWD_FAULTS``) by chip_smoke.py to
    plant one in the ring kernel."""
    d = x.shape[-1]
    if not weight.is_contiguous():
        raise ValueError("weight must be contiguous")
    dw = torch.empty((d,), dtype=weight.dtype, device=x.device)
    dy, dx, (n_rows, (n1, n2), strides), aligned = bwd_operands(
        x, dy, weight, dw)
    if n_rows == 0 or d == 0:
        return dx, dw.zero_()
    if n_rows >= 1 << 31:
        raise ValueError(f"{n_rows} rows: the backward kernels index rows "
                         f"in 32 bits")
    plan = bwd_plan(d, x.dtype, aligned)
    if fault and plan.kind != "ring":
        raise ValueError("faults are planted in the ring kernel only")
    grid = bwd_grid(plan, n_rows, n2, _sm_count(x.device),
                    _bwd_blocks_per_sm(plan, x.dtype, d, x.device))
    partial = torch.empty((grid, d), dtype=torch.float32, device=x.device)
    flat = (ctypes.c_longlong * 9)(*(st for sts in strides for st in sts))
    lib = LIBRARY.get()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rmsnorm_bwd_launch(
            x.data_ptr(), weight.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), partial.data_ptr(), n_rows, d, n1, n2, flat,
            float(eps), DTYPES[x.dtype], BWD_KINDS[plan.kind],
            plan.load == "map", plan.vec, plan.vpt, plan.tpr, plan.warps,
            plan.rows, plan.stages, grid, int(fault), stream)
    LIBRARY.check(err, "rmsnorm backward launch")
    rmsnorm_bwd.launches += 1
    return dx, dw


rmsnorm_bwd.launches = 0


# ----------------------------------------------------------- split rows

# the split backward's limits (csrc/rmsnorm.cu): threads a block; threads a
# row, powers of two; vectors a thread, 16-byte or (the scalar path) single
SPLIT_BLOCK = 256
SPLIT_MIN_TPR, SPLIT_MAX_TPR = 8, 256
SPLIT_MAXV, SPLIT_SCALAR_MAXV = 8, 16
# shared memory a block may take on an H100, and what the first pass holds
# besides the weight and its groups' dw rows (its warps' dots)
SPLIT_SMEM = 227 << 10
SPLIT_STATIC_SMEM = 16 * 8 * 4
# the vectors a thread the plan aims for (on an H100, 64 threads of 4 at
# rows of 1792 bf16 and 16 of 4 at 512 ran fastest: PERF.md)
SPLIT_VPT = 4
# the second pass's planted faults (chip_smoke.py's check that its limits
# catch them)
SPLIT_BWD_FAULTS = {"dw without the last block's partial row": 1,
                    "dx with the neighbouring row's coefficients": 2}


@dataclasses.dataclass(frozen=True)
class SplitBwdPlan:
    """How both passes of the split backward cut the rows: a group of
    ``tpr`` threads a row, each thread at most ``maxv`` vectors of ``vec``
    elements; ``grid`` blocks of SPLIT_BLOCK threads, which tiles of
    :attr:`groups` rows are dealt to in turn (:func:`split_bwd_block_of`)."""
    vec: int
    tpr: int
    maxv: int
    grid: int

    @property
    def groups(self) -> int:
        """Rows a block holds at once: its groups of ``tpr`` threads."""
        return SPLIT_BLOCK // self.tpr


def _split_args(x: torch.Tensor, weight: torch.Tensor, what: str):
    """x's rows contiguous, the vector width the kernels can take, x's
    row count and width; raises for operands no split kernel takes."""
    if x.dtype not in DTYPES or weight.dtype != x.dtype:
        raise ValueError(f"{what}: x and weight must both be float32 or "
                         f"both bfloat16, got {x.dtype} and {weight.dtype}")
    if tuple(weight.shape) != (x.shape[-1],):
        raise ValueError(f"{what}: weight {tuple(weight.shape)} does not "
                         f"match x {tuple(x.shape)}")
    x = x.contiguous()
    d = x.shape[-1]
    return x, d, x.numel() // max(d, 1)


def _split_vec(d: int, *ts: torch.Tensor) -> int:
    vec = 16 // ts[0].element_size()
    ok = d % vec == 0 and all(t.data_ptr() % 16 == 0 for t in ts)
    return vec if ok else 1


@functools.lru_cache(maxsize=None)
def split_bwd_threads(d: int, vec: int) -> Tuple[int, int]:
    """→ (threads a row of ``d`` elements in vectors of ``vec``; the
    kernels' ``maxv``): the power of two from SPLIT_MIN_TPR to
    SPLIT_MAX_TPR nearest to giving each thread SPLIT_VPT vectors, at
    most, and ``maxv`` the power of two at or above a thread's vectors,
    at most SPLIT_MAXV (SPLIT_SCALAR_MAXV single elements): a thread of a
    wider row takes the vectors past ``maxv`` one at a time."""
    nv = d // vec
    cap = SPLIT_MAXV if vec > 1 else SPLIT_SCALAR_MAXV
    want = -(-nv // SPLIT_VPT)
    tpr = min(SPLIT_MAX_TPR, max(SPLIT_MIN_TPR,
                                 1 << (want - 1).bit_length()))
    vpt = -(-nv // tpr)
    return tpr, min(cap, 1 << (vpt - 1).bit_length())


def split_bwd_smem(d: int, itemsize: int, tpr: int) -> int:
    """Bytes of shared memory a block of the first pass takes (the more of
    the two passes): the weight, padded to 16 bytes, a float32 row of
    ``d`` a group of ``tpr`` threads, and the warps' dots."""
    return -(-d * itemsize // 16) * 16 + SPLIT_BLOCK // tpr * d * 4 \
        + SPLIT_STATIC_SMEM


def split_bwd_check(d: int, dtype: torch.dtype) -> None:
    """Raises ValueError where rows of ``d`` elements of ``dtype`` are too
    wide for the split backward on either of its paths (16-byte vectors
    and single elements): a block's shared memory past SPLIT_SMEM.  The
    forward asks, so that the limit shows before a backward runs."""
    size = torch.empty((), dtype=dtype).element_size()
    for vec in {16 // size, 1}:
        if d % vec == 0:
            smem = split_bwd_smem(d, size, split_bwd_threads(d, vec)[0])
            if smem > SPLIT_SMEM:
                raise ValueError(
                    f"split backward: rows of {d} {dtype} elements take "
                    f"{smem} bytes of shared memory a block, more than "
                    f"{SPLIT_SMEM}")


def split_bwd_grid(n_rows: int, d: int, groups: int, n_sm: int,
                   blocks_per_sm: int) -> int:
    """Blocks of both passes: as many as the ``n_sm`` SMs hold at once
    (``blocks_per_sm`` each, the fewer of the two passes'), at most one a
    tile of ``groups`` rows.  Raises for 2^31 elements or more (the
    kernels index in 32 bits) and for a block that fits no SM."""
    if n_rows * d >= 1 << 31:
        raise ValueError(f"split backward: {n_rows} x {d} elements; the "
                         f"kernels index elements in 32 bits")
    if blocks_per_sm < 1:
        raise ValueError("a split backward block does not fit an SM")
    return max(1, min(-(-n_rows // groups), n_sm * blocks_per_sm))


def split_bwd_block_of(n_rows: int, groups: int, grid: int) -> torch.Tensor:
    """The block that owns each row, as the kernels deal them: tiles of
    ``groups`` rows to the ``grid`` blocks in turn (row r is block
    ``r // groups % grid``'s), int64 (n_rows,)."""
    return torch.arange(n_rows) // groups % grid


def _split_bwd_blocks_per_sm(dtype: torch.dtype, vec: int, maxv: int,
                             tpr: int, d: int, device) -> int:
    key = ("split_bwd", dtype, vec, maxv, tpr, d, device.index)
    if key not in _LIMITS:
        val = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = LIBRARY.get().rmsnorm_split_bwd_blocks_per_sm(
                DTYPES[dtype], vec, maxv, tpr, d, ctypes.byref(val))
        LIBRARY.check(err, "cudaOccupancyMaxActiveBlocksPerMultiprocessor")
        _LIMITS[key] = val.value
    return _LIMITS[key]


def split_row_sums(x: torch.Tensor) -> torch.Tensor:
    """The block's partial ``Σx²`` of each row on the card, float32 of x's
    shape without its last dimension.  One launch."""
    if x.dtype not in DTYPES:
        raise ValueError(f"split row sums: x must be float32 or bfloat16, "
                         f"got {x.dtype}")
    x = x.contiguous()
    d = x.shape[-1]
    n_rows = x.numel() // max(d, 1)
    out = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    if n_rows == 0 or d == 0:
        return out.zero_()
    with torch.cuda.device(x.device):
        err = LIBRARY.get().rmsnorm_split_rows_launch(
            x.data_ptr(), out.data_ptr(), n_rows, d, DTYPES[x.dtype],
            _split_vec(d, x), torch.cuda.current_stream(x.device).cuda_stream)
    LIBRARY.check(err, "rmsnorm split row sums")
    split_row_sums.launches += 1
    return out


split_row_sums.launches = 0


def split_apply(x: torch.Tensor, weight: torch.Tensor, total: torch.Tensor,
                n: int, eps: float) -> torch.Tensor:
    """The block ``x`` normed by its rows' ``total`` (``Σx²`` of the whole
    row of ``n``) times ``weight``, on the card.  One launch."""
    x, d, n_rows = _split_args(x, weight, "split apply")
    total = total.contiguous()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if n_rows == 0 or d == 0:
        return y
    vec = _split_vec(d, x, weight, y)
    grid = max(1, min(-(-n_rows * d // vec // 256),
                      _sm_count(x.device) * 16))
    with torch.cuda.device(x.device):
        err = LIBRARY.get().rmsnorm_split_apply_launch(
            x.data_ptr(), weight.data_ptr(), total.data_ptr(), y.data_ptr(),
            n_rows, d, n, float(eps), DTYPES[x.dtype], vec, grid,
            torch.cuda.current_stream(x.device).cuda_stream)
    LIBRARY.check(err, "rmsnorm split apply")
    split_apply.launches += 1
    return y


split_apply.launches = 0


def _split_bwd_args(x, weight, dy, total):
    if tuple(dy.shape) != tuple(x.shape) or dy.dtype != x.dtype:
        raise ValueError(f"split backward: dy {tuple(dy.shape)} {dy.dtype} "
                         f"does not match x {tuple(x.shape)} {x.dtype}")
    x, d, n_rows = _split_args(x, weight, "split backward")
    return x, d, n_rows, dy.contiguous(), total.contiguous()


def split_bwd_rows(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                   total: torch.Tensor, n: int, eps: float):
    """The split backward's first pass on the card, before the
    all-reduce → (each row's partial ``Σ(w·dy·x)``, float32 of x's shape
    without its last dimension; each block's partial dw, ``Σ dy·x·inv``
    over its rows, float32 (grid, d); the :class:`SplitBwdPlan` the second
    pass takes).  ``total`` is the forward's ``Σx²`` of each whole row of
    ``n``.  One launch."""
    x, d, n_rows, dy, total = _split_bwd_args(x, weight, dy, total)
    dot = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    if n_rows == 0 or d == 0:
        return dot.zero_(), torch.zeros((1, d), dtype=torch.float32,
                                        device=x.device), None
    vec = _split_vec(d, x, weight, dy)
    split_bwd_check(d, x.dtype)
    tpr, maxv = split_bwd_threads(d, vec)
    grid = split_bwd_grid(n_rows, d, SPLIT_BLOCK // tpr, _sm_count(x.device),
                          _split_bwd_blocks_per_sm(x.dtype, vec, maxv, tpr,
                                                   d, x.device))
    plan = SplitBwdPlan(vec, tpr, maxv, grid)
    partial = torch.empty((grid, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = LIBRARY.get().rmsnorm_split_bwd_rows_launch(
            x.data_ptr(), weight.data_ptr(), dy.data_ptr(), total.data_ptr(),
            dot.data_ptr(), partial.data_ptr(), n_rows, d, n, float(eps),
            DTYPES[x.dtype], vec, maxv, tpr, grid,
            torch.cuda.current_stream(x.device).cuda_stream)
    LIBRARY.check(err, "rmsnorm split backward, first pass")
    split_bwd_rows.launches += 1
    return dot, partial, plan


split_bwd_rows.launches = 0


def split_bwd_dx(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                 total: torch.Tensor, dot: torch.Tensor,
                 partial: torch.Tensor, plan: Optional[SplitBwdPlan], n: int,
                 eps: float, fault: int = 0):
    """The split backward's second pass on the card, after the
    all-reduce → (dx, x's shape and dtype; dw, the weight's: the first
    pass's ``partial`` rows summed in a fixed order) from the rows'
    ``dot`` summed over the whole row.  One launch; ``fault``
    (SPLIT_BWD_FAULTS) plants one, for chip_smoke.py."""
    x, d, n_rows, dy, total = _split_bwd_args(x, weight, dy, total)
    dot = dot.contiguous()
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dw = torch.empty((d,), dtype=weight.dtype, device=x.device)
    if plan is None:
        return dx, dw.zero_()
    if partial.shape != (plan.grid, d) or not partial.is_contiguous():
        raise ValueError(f"split backward: partial {tuple(partial.shape)} "
                         f"is not the first pass's ({plan.grid}, {d})")
    with torch.cuda.device(x.device):
        err = LIBRARY.get().rmsnorm_split_bwd_dx_launch(
            x.data_ptr(), weight.data_ptr(), dy.data_ptr(), total.data_ptr(),
            dot.data_ptr(), partial.data_ptr(), dx.data_ptr(), dw.data_ptr(),
            n_rows, d, n, float(eps), DTYPES[x.dtype], plan.vec, plan.maxv,
            plan.tpr, plan.grid, int(fault),
            torch.cuda.current_stream(x.device).cuda_stream)
    LIBRARY.check(err, "rmsnorm split backward, second pass")
    split_bwd_dx.launches += 1
    return dx, dw


split_bwd_dx.launches = 0


def rmsnorm_split(x: torch.Tensor, weight: torch.Tensor, eps: float, n: int,
                  all_reduce: Callable[[torch.Tensor], torch.Tensor],
                  impl: Optional[str] = None) -> torch.Tensor:
    """RMSNorm of the column block ``x`` (..., d) of rows of ``n``
    elements, the block's ``weight`` (d,): ``all_reduce`` sums a float32
    tensor of one value a row over the blocks (the ranks).  → the block
    of the normed rows, x's shape and dtype.  Differentiable; the device
    decides as in :func:`rmsnorm` (``impl`` None, "ref" or "kernel")."""
    if impl not in (None, "ref", "kernel"):
        raise ValueError(f"unknown rmsnorm impl {impl!r}")
    if weight.device != x.device:
        raise ValueError(f"x on {x.device}, weight on {weight.device}")
    _split_args(x, weight, "rmsnorm_split")
    kernel = impl != "ref" and _on_kernel_device(x, impl)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        if kernel:
            split_bwd_check(x.shape[-1], x.dtype)
        return _RMSNormSplit.apply(x, weight, eps, n, all_reduce, kernel)
    return _split_forward(x, weight, eps, n, all_reduce, kernel)[0]


rmsnorm_split.launches = 0


def _split_forward(x, weight, eps, n, all_reduce, kernel: bool):
    """→ (y, the rows' totals): the kernels, or the plain versions."""
    if not kernel:
        total = all_reduce(ref.split_sumsq(x))
        return ref.rmsnorm_split(x, weight, total, n, eps), total
    total = all_reduce(split_row_sums(x))
    y = split_apply(x, weight, total, n, eps)
    rmsnorm_split.launches += 1
    return y, total


def rmsnorm_split_bwd(x: torch.Tensor, weight: torch.Tensor,
                      dy: torch.Tensor, total: torch.Tensor, eps: float,
                      n: int, all_reduce: Callable[[torch.Tensor],
                                                   torch.Tensor],
                      kernel: Optional[bool] = None):
    """The gradients of :func:`rmsnorm_split` given its rows' ``total`` →
    (dx of the block, dw of the block's columns over this rank's rows):
    the first pass (the rows' ``Σ(w·dy·x)`` and the blocks' partial dw),
    ``all_reduce`` of the dots, the second pass (dx, and dw summed).  The
    kernels on a CUDA tensor (two launches), the plain versions on a CPU
    one, all the rows one block."""
    if kernel is None:
        kernel = _on_kernel_device(x, None)
    if not kernel:
        dot, partial = ref.split_bwd_rows(x, weight, dy, total, n, eps)
        return ref.split_bwd_dx(x, weight, dy, total, all_reduce(dot),
                                partial, n, eps)
    x, dy = x.contiguous(), dy.contiguous()
    dot, partial, plan = split_bwd_rows(x, weight, dy, total, n, eps)
    out = split_bwd_dx(x, weight, dy, total, all_reduce(dot), partial, plan,
                       n, eps)
    rmsnorm_split_bwd.launches += 1
    return out


rmsnorm_split_bwd.launches = 0


class _RMSNormSplit(torch.autograd.Function):
    """The split row's forward and backward of one route: the kernels on
    a CUDA tensor, the plain versions on a CPU one (or asked for)."""

    @staticmethod
    def forward(ctx, x, weight, eps, n, all_reduce, kernel):
        y, total = _split_forward(x, weight, eps, n, all_reduce, kernel)
        ctx.save_for_backward(x, weight, total)
        ctx.eps, ctx.n, ctx.all_reduce, ctx.kernel = eps, n, all_reduce, \
            kernel
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, total = ctx.saved_tensors
        dx, dw = rmsnorm_split_bwd(x, weight, dy, total, ctx.eps, ctx.n,
                                   ctx.all_reduce, kernel=ctx.kernel)
        return dx, dw, None, None, None, None
