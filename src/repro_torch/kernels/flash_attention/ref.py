"""Plain PyTorch attention: ``repro/kernels/flash_attention/ref.py``
restated, GQA with causal and sliding-window masks, softmax in float32.

Masked logits are set to the finite -1e30, as in the JAX package, so a row
that sees no key (a causal row before the first key when Sq > Skv) gets the
mean of v over every key.  The tests hold it against the JAX package, and
``chip_smoke.py`` holds the CUDA kernel against it on the card; the card's
main path does not call it.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k,v: (B, Hkv, Skv, D); Hq % Hkv == 0.

    Returns (B, Hq, Sq, D) in q.dtype; softmax in f32.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"{hq} query heads are not a multiple of {hkv} "
                         f"key/value heads")
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5

    qf = q.float() * scale
    kf = k.float()
    vf = v.float()
    # expand kv heads to q heads without materialising copies
    qf = qf.reshape(b, hkv, group, sq, d)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf)

    q_pos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
    return out.reshape(b, hq, sq, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode: q (B, Hq, 1, D) against a full KV cache."""
    return attention(q, k_cache, v_cache, causal=True, window=window,
                     scale=scale)
