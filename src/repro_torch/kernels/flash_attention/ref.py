"""Plain PyTorch attention: ``repro/kernels/flash_attention/ref.py``
restated, GQA with causal and sliding-window masks, softmax in float32;
its row statistics, :func:`attention_stats` (what the forward kernels write
for the backward); and its backward, :func:`attention_bwd`.

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
    # kv heads meet their group of q heads without materialising copies
    logits, _, _ = _masked_logits(q, k, causal, window, scale)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(b, hq, sq, d).to(q.dtype)


def _mask(sq: int, skv: int, causal: bool, window: Optional[int],
          device) -> torch.Tensor:
    """(Sq, Skv) bool: True where query row i sees key j; row i sits at
    position ``i + skv - sq``."""
    q_pos = torch.arange(sq, device=device)[:, None] + (skv - sq)
    k_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def _masked_logits(q, k, causal, window, scale):
    """→ (the scaled logits (B, Hkv, G, Sq, Skv) in float32 with masked
    ones at -1e30, q scaled and grouped (B, Hkv, G, Sq, D), the mask)."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"{hq} query heads are not a multiple of {hkv} "
                         f"key/value heads")
    scale = scale if scale is not None else d ** -0.5
    qf = (q.float() * scale).reshape(b, hkv, hq // hkv, sq, d)
    mask = _mask(sq, skv, causal, window, q.device)
    logits = torch.where(mask, torch.einsum("bhgqd,bhkd->bhgqk", qf,
                                            k.float()), NEG_INF)
    return logits, qf, mask


def attention_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None):
    """The row statistics of :func:`attention` → (m, l), each (B, Hq, Sq)
    float32: m the max of a row's scaled, masked logits (masked ones at
    -1e30, so a row that sees no key has m = -1e30) and l the sum of
    exp(S - m).  They stay apart, never m + log l, which rounds to m for a
    row that sees no key.  ``v`` is unused: the signature is the
    forward's."""
    b, hq, sq, _ = q.shape
    logits, _, _ = _masked_logits(q, k, causal, window, scale)
    m = logits.amax(dim=-1, keepdim=True)
    l = torch.exp(logits - m).sum(dim=-1)
    return m.reshape(b, hq, sq), l.reshape(b, hq, sq)


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                  window: Optional[int] = None,
                  scale: Optional[float] = None,
                  stats: Optional[torch.Tensor] = None):
    """The gradients of :func:`attention` given its output ``o`` and the
    output's gradient ``do`` → (dq, dk, dv) in the inputs' dtypes; the
    algorithm of the CUDA backward, in float32.

    With S the scaled logits, masked ones at -1e30: the row max m and the
    sum l of exp(S - m) give P = exp(S - m) / l (kept apart, not as
    m + log l, which rounds to m for a row that sees no key); ``stats``,
    float32 (2, B, Hq, Sq) holding m and l as :func:`attention_stats`
    gives them (the forward kernels' output), takes the place of computing
    them here.  Di = rowsum(do·o); dS = P·(do vᵀ − Di), zeroed wherever
    the mask is false (the gradient of the forward's ``where``), so a row
    that sees no key gives dq 0 while its uniform P still sends do/Skv to
    dv.  dq = scale·dS k, dk = scale·dSᵀ q, dv = Pᵀ do, summed over the
    query heads of each key/value head."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    logits, qf, mask = _masked_logits(q, k, causal, window, scale)
    kf, vf = k.float(), v.float()
    of = o.float().reshape(b, hkv, group, sq, d)
    dof = do.float().reshape(b, hkv, group, sq, d)
    if stats is None:
        m = logits.amax(dim=-1, keepdim=True)
        e = torch.exp(logits - m)
        p = e / e.sum(dim=-1, keepdim=True)
    else:
        m, l = (t.reshape(b, hkv, group, sq, 1) for t in stats)
        p = torch.exp(logits - m) / l
    di = (dof * of).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vf)
    ds = torch.where(mask, p * (dp - di), 0.0)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode: q (B, Hq, 1, D) against a full KV cache."""
    return attention(q, k_cache, v_cache, causal=True, window=window,
                     scale=scale)
