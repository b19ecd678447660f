"""Transformer building blocks: RoPE, GQA attention (prefill + KV-cache
decode), MLP variants, norms.  Plain functions over nested dictionaries of
tensors; layer stacks keep a leading layer axis (see
:mod:`repro_torch.models.common`).

Pointwise datapaths route through the paper's overlay JIT where expressible
(see overlay_ops.py): squared-ReLU and gating products are overlay kernels.
RMSNorm and prefill attention go through the kernels' dispatch: on a CUDA
tensor the hand-written kernel, on a CPU tensor its plain version.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.models import overlay_ops
from repro_torch.models.common import ArchConfig, dense_init


# ------------------------------------------------------------------- norms

rmsnorm = rn_ops.rmsnorm


# -------------------------------------------------------------------- rope

def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, H, S, D); pos: (S,) or (B, S) absolute positions.  Rotates
    the two halves of D (not interleaved pairs)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (D/2,)
    if pos.dim() == 1:
        ang = pos[:, None].float() * freqs[None, :]        # (S, D/2)
        ang = ang[None, None]                              # (1,1,S,D/2)
    else:
        ang = pos[:, None, :, None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------- attention

def _ones(cfg: ArchConfig, n: int, device, n_stack: int) -> torch.Tensor:
    lead = (n_stack,) if n_stack else ()
    return torch.ones((*lead, n), dtype=cfg.dtype, device=device)


def init_attention(gen: torch.Generator, cfg: ArchConfig, device=None,
                   n_stack: int = 0) -> Dict[str, torch.Tensor]:
    """``n_stack`` > 0 stacks that many layers along a leading axis."""
    d, hd, hq, hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    kw = dict(dtype=cfg.dtype, device=device, n_stack=n_stack)
    p = {
        "wq": dense_init(gen, (d, hq * hd), **kw),
        "wk": dense_init(gen, (d, hkv * hd), **kw),
        "wv": dense_init(gen, (d, hkv * hd), **kw),
        "wo": dense_init(gen, (hq * hd, d), **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = _ones(cfg, hd, device, n_stack)
        p["k_norm"] = _ones(cfg, hd, device, n_stack)
    return p


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n*hd) → the (B, n, S, hd) view; no copy."""
    b, s, _ = x.shape
    return x.view(b, s, n, hd).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def attention(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig,
              *, pos: torch.Tensor, causal: bool = True,
              attn_impl: Optional[str] = None,
              memory: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention (training / prefill).  ``attn_impl``: None
    lets the device pick (the flash kernel on a card), ``"ref"`` the plain
    version, ``"kernel"`` the flash kernel.

    memory: if given (B, Sm, d), cross-attention: keys and values come from
    it, neither side is rotated (no RoPE) and no causal mask applies."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    src = x if memory is None else memory
    q = _split_heads(x @ p["wq"], hq, hd)
    k = _split_heads(src @ p["wk"], hkv, hd)
    v = _split_heads(src @ p["wv"], hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if memory is None:                                     # self-attn: RoPE
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    out = fa_ops.attention(q, k, v, causal=causal and memory is None,
                           window=cfg.window, impl=attn_impl)
    return _merge_heads(out) @ p["wo"]


def attention_decode(p: Dict[str, torch.Tensor], x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     cur_pos: int, cfg: ArchConfig):
    """One-token decode. x: (B, 1, d); cache: (B, Hkv, S, hd); cur_pos: the
    index at which the new KV is written.

    The new key and value are written into ``cache_k`` and ``cache_v`` IN
    PLACE at ``cur_pos`` (where JAX's ``lax.dynamic_update_slice`` returns
    new arrays); the same tensors are returned.  An index outside the cache
    raises instead of being clamped.  The attention itself is plain torch,
    as in the JAX package: softmax in float32 over the whole cache, with
    the positions after ``cur_pos`` masked."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _split_heads(x @ p["wq"], hq, hd)                  # (B,Hq,1,hd)
    k_new = _split_heads(x @ p["wk"], hkv, hd)             # (B,Hkv,1,hd)
    v_new = _split_heads(x @ p["wv"], hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k_new = rmsnorm(k_new, p["k_norm"], cfg.norm_eps)
    posv = torch.full((1,), cur_pos, dtype=torch.int64, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k_new = apply_rope(k_new, posv, cfg.rope_theta)
    cache_k[:, :, cur_pos] = k_new[:, :, 0].to(cache_k.dtype)
    cache_v[:, :, cur_pos] = v_new[:, :, 0].to(cache_v.dtype)
    s = cache_k.shape[2]
    kf = cache_k.float()
    vf = cache_v.float()
    qf = q.float() * (hd ** -0.5)
    b = q.shape[0]
    group = hq // hkv
    qg = qf.reshape(b, hkv, group, 1, hd)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf)
    kpos = torch.arange(s, device=x.device)
    mask = kpos <= cur_pos
    if cfg.window is not None:
        mask &= kpos > cur_pos - cfg.window
    logits = torch.where(mask, logits, -1e30)
    pr = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", pr, vf).reshape(b, hq, 1, hd)
    out = out.to(x.dtype)
    return _merge_heads(out) @ p["wo"], cache_k, cache_v


# -------------------------------------------------------------------- MLPs

def init_mlp(gen: torch.Generator, cfg: ArchConfig,
             d_ff: Optional[int] = None, device=None,
             n_stack: int = 0) -> Dict[str, torch.Tensor]:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    kw = dict(dtype=cfg.dtype, device=device, n_stack=n_stack)
    if cfg.activation == "swiglu":
        return {"w_gate": dense_init(gen, (d, ff), **kw),
                "w_up": dense_init(gen, (d, ff), **kw),
                "w_down": dense_init(gen, (ff, d), **kw)}
    return {"w_up": dense_init(gen, (d, ff), **kw),
            "w_down": dense_init(gen, (ff, d), **kw)}


def mlp(p: Dict[str, torch.Tensor], x: torch.Tensor,
        cfg: ArchConfig) -> torch.Tensor:
    if cfg.activation == "swiglu":
        g = x @ p["w_gate"]
        u = x @ p["w_up"]
        return overlay_ops.gated_silu(g, u) @ p["w_down"]
    h = x @ p["w_up"]
    return overlay_ops.squared_relu(h) @ p["w_down"]


# ------------------------------------------------------------ LM head/embed

def init_lm(gen: torch.Generator, cfg: ArchConfig,
            device=None) -> Dict[str, torch.Tensor]:
    v = cfg.vocab_padded
    return {
        "embed": dense_init(gen, (v, cfg.d_model), dtype=cfg.dtype,
                            device=device),
        "unembed": dense_init(gen, (cfg.d_model, v), dtype=cfg.dtype,
                              device=device),
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.dtype,
                                 device=device),
    }


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits: (B, S, V) f32-ish; labels: (B, S) int → scalar mean nll."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return (lse - ll).mean()
