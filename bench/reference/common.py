"""Shared pieces of the references: products, norms, RoPE."""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """Matrix products and convolutions in full float32 (no TF32)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8(t: torch.Tensor, dim=None) -> torch.Tensor:
    """``t`` (float32) rounded to float8 e4m3 under a scale that maps the
    largest magnitude (of the whole tensor, or along ``dim``, one
    dimension or a tuple) to 448."""
    amax = t.abs().amax() if dim is None else t.abs().amax(dim, keepdim=True)
    scale = amax.clamp_min(1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


# the reference's modes: "f32", and the controls, which round the
# operands of some products to float8 e4m3 (the precision below the
# configurations' bfloat16): "fp8" every product, the weights' and
# attention's; "fp8_attn" attention's two products alone
MODES = ("f32", "fp8", "fp8_attn")


def fp8_attention(mode: str) -> bool:
    """Whether ``mode`` rounds attention's products' operands to float8."""
    return check(mode) in ("fp8", "fp8_attn")


def check(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"unknown reference mode {mode!r}")
    return mode


def mm(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """x (..., k) float32 @ w (k, n) of any dtype, in float32; with
    ``mode="fp8"`` both operands rounded to e4m3 first (x per row, w
    whole)."""
    w = w.float()
    if check(mode) == "fp8":
        return fp8(x, -1) @ fp8(w)
    return x @ w


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x · rsqrt(mean(x²) + eps) · w over the last axis, float32."""
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (..., S, D) at positions ``pos`` (S,): the two
    halves of D rotated (Qwen3's rotate_half), angles in float64."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                  device=x.device) / d)
    ang = pos.to(torch.float64)[:, None] * inv[None]
    cos, sin = ang.cos().float(), ang.sin().float()
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
