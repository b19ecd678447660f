"""Binding of the CUDA flash-attention kernels.

Replaces the Pallas kernel ``_fa_kernel`` / ``flash_attention`` of the JAX
package (``repro/kernels/flash_attention/kernel.py``) with hand-written
kernels on two routes, a forward and a backward each:

- the tensor-core route, bfloat16 at head dims 64, 112 and 128 (every model
  on the port's main path, and the whole training path; 112 runs on the
  128-column tile with TMA's zero-filled columns): the forward
  ``csrc/flash_attention_wgmma.cu`` and the backward
  ``csrc/flash_attention_bwd_wgmma.cu``, TMA loads into rings of stages
  and ``wgmma`` products;
- the SIMT route, full float32 FMAs outside the tensor cores, for float32
  and for head dims 16 and 32: the forward ``csrc/flash_attention.cu`` and
  the backward ``csrc/flash_attention_bwd.cu`` (cp.async rings of tiles,
  register tiles of 4 to 8 FMAs a shared-memory read, at least two blocks
  an SM); :func:`simt_plan` states their launch plan, and
  :func:`simt_built_plans` reads it back from the built libraries.

:func:`route` picks one from the dtype and head dim alone, for the forward
and the backward alike; a build or launch error raises, and no call ever
falls back to the other route or to the plain version.  Each forward
writes, when asked, each row's max m and sum l (``stats``, float32
``(2, B, Hq, Sq)``, the meaning of :func:`ref.attention_stats`), which its
backward reads instead of recomputing them; prefill, decode and serving
ask for none.  Where the TPU wrapper required both lengths to divide its
128-row blocks, the kernels mask the ragged ends themselves; and where the
Pallas kernel gave 0 to a query row that sees no key (``Sq > Skv``,
causal), they give the mean of v over every key, as the plain version does.

q, k and v may be views whose last dimension is contiguous (the heads view
of a ``(B, S, H*D)`` projection): their strides go to the kernel, and no
copy is made.  The output is ``(B, Hq, Sq, D)`` contiguous.

:func:`flash_attention` is the one dispatch point.  With ``impl=None`` the
device decides: CUDA tensors launch a kernel (``flash_attention.launches``
counts the launches, ``flash_attention.launches_by_route`` splits them by
route), CPU tensors take the plain version
:func:`repro_torch.kernels.flash_attention.ref.attention`, anything else
raises.  Where autograd records (grad mode on, an input that requires
grad) the call is a :class:`torch.autograd.Function` whose forward also
keeps the row statistics and whose backward is :func:`flash_attention_bwd`
on them, decided by the device in the same way: the route's backward
kernel on CUDA tensors (``flash_attention_bwd.launches`` counts its calls,
``launches_by_route`` splits them; three kernel launches a call on the
tensor-core route, two on the SIMT route), :func:`ref.attention_bwd` on
CPU ones.  ``impl="ref"`` asks for the plain version on any device,
differentiated by autograd, and ``impl="kernel"`` for the kernel, raising
off a CUDA device.  Each library is built at its first launch
(:class:`repro_torch.cuda_build.CudaLibrary`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.cuda_build import CudaLibrary
from repro_torch.kernels.flash_attention import ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_INTS = ctypes.POINTER(ctypes.c_int)
LIBRARY = CudaLibrary("flash_attention", {
    "flash_attention_launch": (
        [_P] * 5 + [_I] * 6 + [_STRIDES, _I, _I, ctypes.c_float, _I, _P],
        ctypes.c_int),
    "flash_attention_plan": ([_I, _I, _INTS], ctypes.c_int)})
LIBRARY_WGMMA = CudaLibrary("flash_attention_wgmma", {
    "flash_attention_wgmma_launch": (
        [_P] * 5 + [_I] * 6 + [_STRIDES, _I, _I, ctypes.c_float, _P],
        ctypes.c_int),
    "flash_attention_wgmma_smem_bytes": ([_I], ctypes.c_int)})
LIBRARIES = {"simt": LIBRARY, "wgmma": LIBRARY_WGMMA}
LIBRARY_BWD = CudaLibrary("flash_attention_bwd", {
    "flash_attention_bwd_launch": (
        [_P] * 10 + [_I] * 6 + [_STRIDES, _I, _I, ctypes.c_float, _I, _I,
                                _P], ctypes.c_int),
    "flash_attention_bwd_plan": ([_I, _I, _INTS], ctypes.c_int)})
LIBRARY_BWD_WGMMA = CudaLibrary("flash_attention_bwd_wgmma", {
    "flash_attention_bwd_wgmma_launch": (
        [_P] * 10 + [_I] * 6 + [_STRIDES, _I, _I, ctypes.c_float, _I, _P],
        ctypes.c_int),
    "flash_attention_bwd_wgmma_smem_bytes": ([_I, _I], ctypes.c_int)})
BWD_LIBRARIES = {"simt": LIBRARY_BWD, "wgmma": LIBRARY_BWD_WGMMA}

# dtype codes of the SIMT kernel's C interface; head dims each route takes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 112, 128)
WGMMA_HEAD_DIMS = (64, 112, 128)
WGMMA_BLOCK_ROWS = 128            # query rows per block of the wgmma kernel
STATS_TILE = 64                   # rows a statistics tile of the wgmma backward
_MAX_GRID_Y = 65535
# the planted faults of both routes' backwards, one code each
# (chip_smoke.py's check that each route's limit catches them): dS not
# zeroed under the mask (P taken from the unmasked score); the group's last
# query head left out of dK and dV
BWD_FAULTS = {"dS not zeroed under the mask": 1,
              "last query head of each group left out of dK/dV": 2}

# shared memory of an H100 SM for its resident blocks, what one block may
# take, and what the system keeps beside each block
SM_SMEM = 233472
MAX_BLOCK_SMEM = 232448
BLOCK_RESERVED = 1024
SIMT_KERNELS = ("forward", "bwd_dq", "bwd_dkv")


@dataclasses.dataclass(frozen=True)
class SimtPlan:
    """One SIMT kernel's launch at one head dim and dtype.  ``rows`` a
    block and ``tile`` a step of its loop: query rows and keys (forward,
    ``bwd_dq``), or keys and query rows (``bwd_dkv``); ``threads`` a
    block; ``stages`` the slots of its cp.async ring; ``smem`` dynamic
    shared bytes; ``blocks_per_sm`` the blocks an SM holds at once (the
    kernel's ``__launch_bounds__`` minimum, which shared memory allows)."""
    kernel: str
    rows: int
    tile: int
    threads: int
    stages: int
    smem: int
    blocks_per_sm: int


@functools.lru_cache(maxsize=None)
def simt_plan(kernel: str, d: int, dtype: torch.dtype) -> SimtPlan:
    """The launch of a SIMT kernel (:data:`SIMT_KERNELS`), as the CUDA
    sources instantiate it (:func:`simt_built_plans` reads theirs back).

    Every tile is float32 in shared memory (bfloat16 lands raw and is
    widened once).  The forward takes 64 query rows against 64-key tiles,
    8 rows a thread (128 threads) from D 64, 4 below (256); its K and V
    alternate in two slots, each refilled while the block works on the
    other.  The backward's dq launch takes 32 query rows against 64-key
    tiles from D 64 (128 threads; 64 rows below, 256), K and V
    alternating in two slots; its dk/dv launch 64 keys against 32-row
    steps from D 64 (64 below), q and do alternating likewise.  Each is
    held to two blocks an SM (three for the forward at D 64 and below)
    or to what shared memory holds."""
    if kernel not in SIMT_KERNELS:
        raise ValueError(f"unknown SIMT kernel {kernel!r}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if dtype not in DTYPES:
        raise ValueError(f"no flash-attention kernel for {dtype}")
    raw = dtype == torch.bfloat16          # lands raw, widened once
    if kernel == "forward":
        bq = bk = 64
        threads = bq // (8 if d >= 64 else 4) * 16
        floats = bq * d + 2 * bk * d + bk * bq
        raw_bytes = 2 * bk * d * 2
        cap, rows, tile = (2 if d >= 112 else 3), bq, bk
    elif kernel == "bwd_dq":        # Q, dO, dS^T, Di; a K and a V slot
        bq, bk = (32 if d >= 64 else 64), 64
        threads = 4 * bq
        floats = 2 * bq * d + bk * (bq + 4) + bq + bk * (d + 4) + bk * d
        raw_bytes, cap, rows, tile = 2 * bk * d * 2, 2, bq, bk
    else:                           # K, V, P, dS; a q and a do slot
        bk, bq = 64, (32 if d >= 64 else 64)
        threads = 4 * bq
        units = d // 4
        pitch = d if units >= 8 and units & (units - 1) == 0 else d + 4
        floats = 2 * bk * d + 2 * bq * bk + 2 * bq * pitch
        raw_bytes, cap, rows, tile = 2 * bq * d * 2, 2, bk, bq
    smem = floats * 4 + (raw_bytes if raw else 0)
    return SimtPlan(kernel, rows, tile, threads, 2, smem,
                    min(cap, SM_SMEM // (smem + BLOCK_RESERVED)))


def route(dtype: torch.dtype, d: int) -> str:
    """The kernels a CUDA call of this dtype and head dim takes, forward
    and backward: "wgmma" (bfloat16 at D 64, 112 or 128) or "simt"
    (float32, or D 16 or 32)."""
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if dtype not in DTYPES:
        raise ValueError(f"no flash-attention kernel for {dtype}")
    return "wgmma" if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS \
        else "simt"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None,
                    impl: Optional[str] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D), one dtype (float32 or
    bfloat16) → (B, Hq, Sq, D) in q's dtype.  ``scale`` defaults to
    D^-0.5; ``window`` keeps keys with ``k_pos > q_pos - window``."""
    if impl not in (None, "ref", "kernel"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "ref":
        return ref.attention(q, k, v, causal=causal, window=window,
                             scale=scale)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q, k, v must be 4-d with k and v alike, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must all be float32 or all bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not k.device == v.device == q.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    if skv == 0:
        raise ValueError("attention over no keys")
    if _on_kernel_device(q, impl):
        route(q.dtype, d)                   # raises for what no route takes
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Attention.apply(q, k, v, causal, window, scale)
    return _forward(q, k, v, causal, window, scale)   # nothing to train


def _on_kernel_device(q: torch.Tensor, impl: Optional[str]) -> bool:
    """True for CUDA tensors (the kernels), False for CPU tensors with
    ``impl=None`` (the plain versions); raises for anything else."""
    if q.device.type == "cpu" and impl is None:
        return False
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}: "
                         f"it runs on a CUDA device")
    return True


def _forward(q, k, v, causal, window, scale):
    """The forward of the tensors' device: a kernel, or the plain
    version."""
    if q.device.type == "cuda":
        return _launch(q, k, v, causal=causal, window=window, scale=scale,
                       route=route(q.dtype, q.shape[-1]))
    return ref.attention(q, k, v, causal=causal, window=window, scale=scale)


class _Attention(torch.autograd.Function):
    """The forward and backward of one device: the kernels on CUDA
    tensors, the plain versions on CPU ones.  Saves q, k, v (views, as
    given), the output and the row statistics (float32 (2, B, Hq, Sq):
    1.3 MB a layer at qwen3-14b's training shape), which the backward
    reads."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        if q.device.type == "cuda":
            b, hq, sq, d = q.shape
            stats = torch.empty((2, b, hq, sq), dtype=torch.float32,
                                device=q.device)
            out = _launch(q, k, v, causal=causal, window=window, scale=scale,
                          route=route(q.dtype, d), stats=stats)
        else:
            out = ref.attention(q, k, v, causal=causal, window=window,
                                scale=scale)
            stats = torch.stack(ref.attention_stats(
                q, k, v, causal=causal, window=window, scale=scale))
        ctx.save_for_backward(q, k, v, out, stats)
        ctx.opts = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, stats = ctx.saved_tensors
        causal, window, scale = ctx.opts
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, causal=causal,
                                         window=window, scale=scale,
                                         stats=stats)
        return dq, dk, dv, None, None, None


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: Optional[int] = None,
            scale: Optional[float] = None, route: str = "wgmma",
            stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch one route's forward kernel on CUDA tensors that
    :func:`flash_attention` has validated; ``stats``, float32
    (2, B, Hq, Sq) contiguous, receives the row statistics
    (``flash_attention.stats_launches`` counts those launches).  Called
    with an explicit route by :func:`flash_attention_bwd` and, to time the
    SIMT kernel against the tensor-core one, by chip_smoke.py; autograd
    does not see this call."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if route == "wgmma":
        if q.dtype != torch.bfloat16 or d not in WGMMA_HEAD_DIMS:
            raise ValueError(f"the wgmma kernel takes bfloat16 at head dims "
                             f"{WGMMA_HEAD_DIMS}, got {q.dtype} at {d}")
        n_tiles = -(-sq // WGMMA_BLOCK_ROWS)
        if n_tiles > _MAX_GRID_Y:
            raise ValueError(f"Sq = {sq} needs {n_tiles} query tiles, more "
                             f"than {_MAX_GRID_Y}")
    elif route == "simt":
        plan = simt_plan("forward", d, q.dtype)
        n_tiles = -(-sq // plan.rows)
        if n_tiles > _MAX_GRID_Y:
            raise ValueError(f"Sq = {sq} needs {n_tiles} query tiles, more "
                             f"than {_MAX_GRID_Y}")
    else:
        raise ValueError(f"unknown flash-attention route {route!r}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _rows_aligned(t):
            raise ValueError(f"{name} rows must be contiguous and 16-byte "
                             f"aligned, got strides {t.stride()}")
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if stats is not None:
        _check_stats(stats, q)
    strides = (ctypes.c_longlong * 9)(*(s for t in (q, k, v)
                                        for s in t.stride()[:3]))
    scale = scale if scale is not None else d ** -0.5
    lib = LIBRARIES[route].get()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if stats is None else stats.data_ptr(), b, hq, hkv, sq,
                skv, d, strides, int(causal),
                0 if window is None else int(window), float(scale))
        if route == "wgmma":
            err = lib.flash_attention_wgmma_launch(*args, stream)
        else:
            err = lib.flash_attention_launch(*args, DTYPES[q.dtype], stream)
    LIBRARIES[route].check(err, f"flash_attention launch ({route})")
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    flash_attention.stats_launches += stats is not None
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = {"wgmma": 0, "simt": 0}
flash_attention.stats_launches = 0


def simt_built_plans(d: int, dtype: torch.dtype) -> dict:
    """Each SIMT kernel at head dim ``d`` and ``dtype`` as the built
    libraries instantiate it: {kernel: (its :class:`SimtPlan`, which
    should be :func:`simt_plan`'s, the blocks one SM of the current card
    holds at once by the CUDA occupancy calculator: shared memory,
    registers, threads)}.  Builds both libraries."""
    fwd, bwd = (ctypes.c_int * 7)(), (ctypes.c_int * 14)()
    LIBRARY.check(LIBRARY.get().flash_attention_plan(
        d, DTYPES[dtype], fwd), "flash_attention_plan")
    LIBRARY_BWD.check(LIBRARY_BWD.get().flash_attention_bwd_plan(
        d, DTYPES[dtype], bwd), "flash_attention_bwd_plan")
    return {"forward": (SimtPlan("forward", *fwd[:6]), fwd[6]),
            "bwd_dq": (SimtPlan("bwd_dq", *bwd[:6]), bwd[12]),
            "bwd_dkv": (SimtPlan("bwd_dkv", *bwd[6:12]), bwd[13])}


def _check_stats(stats: torch.Tensor, q: torch.Tensor) -> None:
    """Row statistics for q: float32 (2, B, Hq, Sq), contiguous, on q's
    device."""
    want = (2, *q.shape[:3])
    if tuple(stats.shape) != want or stats.dtype != torch.float32 \
            or stats.device != q.device or not stats.is_contiguous():
        raise ValueError(f"stats must be float32 {want} contiguous on "
                         f"{q.device}, got {stats.dtype} "
                         f"{tuple(stats.shape)} on {stats.device}")


def _rows_aligned(t: torch.Tensor) -> bool:
    """Each row of the last dimension contiguous and 16-byte aligned."""
    vec = 16 // t.element_size()
    return not (t.stride(3) != 1 or t.data_ptr() % 16
                or any(s % vec for n, s in zip(t.shape[:3], t.stride()[:3])
                       if n > 1))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None,
                        stats: Optional[torch.Tensor] = None):
    """The gradients of :func:`flash_attention` → (dq, dk, dv), each
    contiguous in its input's shape and dtype.  q, k, v and the options as
    given to the forward, ``o`` its output, ``do`` the output's gradient at
    any strides, ``stats`` the forward's row statistics (float32
    ``(2, B, Hq, Sq)``: m, then l).  The device decides as in
    :func:`flash_attention`: the route's backward kernel on CUDA tensors,
    :func:`ref.attention_bwd` on CPU ones.  Without ``stats`` a CUDA call
    first runs the route's forward kernel once more to get them (the cost
    of one forward); autograd's backward always has them."""
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} and do "
                         f"{tuple(do.shape)} {do.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if stats is not None:
        _check_stats(stats, q)
    if not _on_kernel_device(q, None):
        return ref.attention_bwd(q, k, v, o, do, causal=causal,
                                 window=window, scale=scale, stats=stats)
    which = route(q.dtype, q.shape[-1])
    if stats is None:
        stats = torch.empty((2, *q.shape[:3]), dtype=torch.float32,
                            device=q.device)
        _launch(q, k, v, causal=causal, window=window, scale=scale,
                route=which, stats=stats)
    return _launch_bwd(q, k, v, o, do, stats, causal=causal, window=window,
                       scale=scale, route=which)


def _launch_bwd(q, k, v, o, do, stats, *, causal=True, window=None,
                scale=None, route="wgmma", fault=0):
    """Launch one route's backward kernels on CUDA tensors with the
    forward's ``stats``.  Called with an explicit route by
    :func:`flash_attention_bwd` and, to time the SIMT backward against the
    tensor-core one on bfloat16 or to plant a fault (``BWD_FAULTS``), by
    chip_smoke.py."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if route == "wgmma":
        if max(b * hq, b * hkv) > _MAX_GRID_Y:
            raise ValueError(f"B * Hq = {b * hq} exceeds {_MAX_GRID_Y}")
        if q.dtype != torch.bfloat16 or d not in WGMMA_HEAD_DIMS:
            raise ValueError(f"the wgmma backward takes bfloat16 at head "
                             f"dims {WGMMA_HEAD_DIMS}, got {q.dtype} at {d}")
        if -(-sq // STATS_TILE) > _MAX_GRID_Y:
            raise ValueError(f"Sq = {sq} needs more than {_MAX_GRID_Y} "
                             f"statistics tiles")
    elif route == "simt":
        plans = [simt_plan(n, d, q.dtype) for n in ("bwd_dq", "bwd_dkv")]
        if max(-(-sq // plans[0].rows), -(-skv // plans[1].rows)) \
                > _MAX_GRID_Y:
            raise ValueError(f"Sq = {sq} or Skv = {skv} needs more than "
                             f"{_MAX_GRID_Y} tiles")
    else:
        raise ValueError(f"unknown flash-attention route {route!r}")
    if fault not in (0, *BWD_FAULTS.values()):
        raise ValueError(f"no planted fault {fault} in the {route} "
                         f"backward")
    if not _rows_aligned(do):
        do = do.contiguous()                # e.g. an expanded gradient
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o)):
        if not _rows_aligned(t):
            raise ValueError(f"{name} rows must be contiguous and 16-byte "
                             f"aligned, got strides {t.stride()}")
    dq = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, hkv, skv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, hkv, skv, d), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    if route == "wgmma":    # (m log2 e, 1/l, Di) per 64-row tile
        scratch = torch.empty(b * hq * -(-sq // STATS_TILE) * 3 * STATS_TILE,
                              dtype=torch.float32, device=q.device)
    else:                   # Di
        scratch = torch.empty(b * hq * sq, dtype=torch.float32,
                              device=q.device)
    strides = (ctypes.c_longlong * 15)(*(s for t in (q, k, v, o, do)
                                         for s in t.stride()[:3]))
    scale = scale if scale is not None else d ** -0.5
    lib = BWD_LIBRARIES[route].get()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                stats.data_ptr(), scratch.data_ptr(), b, hq, hkv, sq, skv, d,
                strides, int(causal), 0 if window is None else int(window),
                float(scale))
        if route == "wgmma":
            err = lib.flash_attention_bwd_wgmma_launch(*args, int(fault),
                                                       stream)
        else:
            err = lib.flash_attention_bwd_launch(
                *args, DTYPES[q.dtype], int(fault), stream)
    BWD_LIBRARIES[route].check(err, f"flash_attention backward launch "
                                    f"({route})")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_route[route] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_route = {"wgmma": 0, "simt": 0}
