"""Binding of the CUDA flash-attention kernels.

Replaces the Pallas kernel ``_fa_kernel`` / ``flash_attention`` of the JAX
package (``repro/kernels/flash_attention/kernel.py``) with two hand-written
forward kernels, one function between them, and one backward:

- ``csrc/flash_attention_wgmma.cu``, the tensor-core route: bfloat16 at head
  dims 64, 112 and 128 (every model on the port's main path; 112 runs on the
  128-column tile with TMA's zero-filled columns), with TMA loads, a ring of
  K/V stages and ``wgmma`` products;
- ``csrc/flash_attention.cu``, the SIMT route: float32 FMAs, for float32 and
  for head dims 16 and 32;
- ``csrc/flash_attention_bwd.cu``, the backward of both (SIMT, float32
  sums), which recomputes the row statistics the forwards do not write.

:func:`route` picks one from the dtype and head dim alone; a build or launch
error raises, and no call ever falls back to the other route or to the
plain version.  Where the TPU wrapper required both lengths to divide its
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
grad) the call is a :class:`torch.autograd.Function` whose backward is
:func:`flash_attention_bwd`, decided by the device in the same way: the
backward kernel on CUDA tensors (``flash_attention_bwd.launches`` counts
its calls, two kernel launches each), :func:`ref.attention_bwd` on CPU
ones.  ``impl="ref"`` asks for the plain version on any device,
differentiated by autograd, and ``impl="kernel"`` for the kernel, raising
off a CUDA device.  Each library is built at its first launch
(:class:`repro_torch.cuda_build.CudaLibrary`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.cuda_build import CudaLibrary
from repro_torch.kernels.flash_attention import ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
LIBRARY = CudaLibrary("flash_attention", {"flash_attention_launch": (
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _STRIDES, _I, _I,
     ctypes.c_float, _I, _P],
    ctypes.c_int)})
LIBRARY_WGMMA = CudaLibrary("flash_attention_wgmma", {
    "flash_attention_wgmma_launch": (
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _STRIDES, _I, _I,
         ctypes.c_float, _P],
        ctypes.c_int),
    "flash_attention_wgmma_smem_bytes": ([_I], ctypes.c_int)})
LIBRARIES = {"simt": LIBRARY, "wgmma": LIBRARY_WGMMA}
LIBRARY_BWD = CudaLibrary("flash_attention_bwd", {
    "flash_attention_bwd_launch": (
        [_P] * 9 + [_I] * 6 + [_STRIDES, _I, _I, ctypes.c_float, _I, _P],
        ctypes.c_int)})

# dtype codes of the SIMT kernel's C interface; head dims each route takes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 112, 128)
WGMMA_HEAD_DIMS = (64, 112, 128)
WGMMA_BLOCK_ROWS = 128            # query rows per block of the wgmma kernel
_MAX_GRID_Y = 65535


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA call of this dtype and head dim takes: "wgmma"
    (bfloat16 at D 64, 112 or 128) or "simt" (float32, or D 16 or 32)."""
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
    given) and the output."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out = _forward(q, k, v, causal, window, scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.opts = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out = ctx.saved_tensors
        causal, window, scale = ctx.opts
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, causal=causal,
                                         window=window, scale=scale)
        return dq, dk, dv, None, None, None


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: Optional[int] = None,
            scale: Optional[float] = None,
            route: str = "wgmma") -> torch.Tensor:
    """Launch one route's kernel on CUDA tensors that
    :func:`flash_attention` has validated.  Called with an explicit route
    only to time the SIMT kernel against the tensor-core one; autograd does
    not see this call."""
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
        if d not in HEAD_DIMS:
            raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
        if b * hq > _MAX_GRID_Y:
            raise ValueError(f"B * Hq = {b * hq} exceeds {_MAX_GRID_Y}")
    else:
        raise ValueError(f"unknown flash-attention route {route!r}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _rows_aligned(t):
            raise ValueError(f"{name} rows must be contiguous and 16-byte "
                             f"aligned, got strides {t.stride()}")
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 9)(*(s for t in (q, k, v)
                                        for s in t.stride()[:3]))
    scale = scale if scale is not None else d ** -0.5
    lib = LIBRARIES[route].get()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                hq, hkv, sq, skv, d, strides, int(causal),
                0 if window is None else int(window), float(scale))
        if route == "wgmma":
            err = lib.flash_attention_wgmma_launch(*args, stream)
        else:
            err = lib.flash_attention_launch(*args, DTYPES[q.dtype], stream)
    LIBRARIES[route].check(err, f"flash_attention launch ({route})")
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = {"wgmma": 0, "simt": 0}


def _rows_aligned(t: torch.Tensor) -> bool:
    """Each row of the last dimension contiguous and 16-byte aligned."""
    vec = 16 // t.element_size()
    return not (t.stride(3) != 1 or t.data_ptr() % 16
                or any(s % vec for n, s in zip(t.shape[:3], t.stride()[:3])
                       if n > 1))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None):
    """The gradients of :func:`flash_attention` → (dq, dk, dv), each
    contiguous in its input's shape and dtype.  q, k, v and the options as
    given to the forward, ``o`` its output, ``do`` the output's gradient at
    any strides.  The device decides as in :func:`flash_attention`: the
    backward kernel on CUDA tensors, :func:`ref.attention_bwd` on CPU
    ones."""
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} and do "
                         f"{tuple(do.shape)} {do.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if not _on_kernel_device(q, None):
        return ref.attention_bwd(q, k, v, o, do, causal=causal,
                                 window=window, scale=scale)
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    route(q.dtype, d)                       # the forward's dtypes and dims
    if max(b * hq, b * hkv) > _MAX_GRID_Y:
        raise ValueError(f"B * Hq = {b * hq} exceeds {_MAX_GRID_Y}")
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
    stats = torch.empty((3, b, hq, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 15)(*(s for t in (q, k, v, o, do)
                                         for s in t.stride()[:3]))
    scale = scale if scale is not None else d ** -0.5
    lib = LIBRARY_BWD.get()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            stats.data_ptr(), b, hq, hkv, sq, skv, d, strides, int(causal),
            0 if window is None else int(window), float(scale),
            DTYPES[q.dtype], stream)
    LIBRARY_BWD.check(err, "flash_attention backward launch")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
