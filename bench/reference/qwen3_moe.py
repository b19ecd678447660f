"""Plain float32 Qwen3-MoE (Qwen3MoeForCausalLM, the published modeling
code's equations) with the capacity dispatch that the configuration file
states under ``assumed``.

Weights (the benchmark's draw, any dtype; :func:`mm` reads them in
float32 one matrix at a time, so at 67 GB of bfloat16 weights the
reference holds one expert's or one projection's float32 copy at a time):

  embed (V, d), unembed (d, V), final_norm (d,)
  ln1, ln2 (L, d); wq (L, d, Hq·D), wk, wv (L, d, Hkv·D), wo (L, Hq·D, d)
  q_norm, k_norm (L, D); router (L, d, E)
  w_gate, w_up (L, E, d, F), w_down (L, E, F, d)

A layer: h = rmsnorm(x); q, k, v = h·Wq, h·Wk, h·Wv split into heads; q
and k normed per head (qk-norm) and rotated (RoPE, half rotation); causal
GQA softmax attention; x += o·Wo; h = rmsnorm(x); the router's softmax,
top-k, the top-k weights renormalised (norm_topk_prob); each kept pick
through its expert's SwiGLU, weighted, summed; x += that.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from bench.reference.common import (exact_float32, fp8, fp8_attention, mm,
                                    rmsnorm, rope)


def dims(cfg: Dict) -> Dict[str, int]:
    return {"L": cfg["num_hidden_layers"], "d": cfg["hidden_size"],
            "hq": cfg["num_attention_heads"],
            "hkv": cfg["num_key_value_heads"], "D": cfg["head_dim"],
            "E": cfg["num_experts"], "k": cfg["num_experts_per_tok"],
            "F": cfg["moe_intermediate_size"]}


def capacity(cfg: Dict, tokens: int) -> int:
    """Slots per expert in a dispatch group of ``tokens`` tokens."""
    e, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    return int(max(1, tokens * k / e * cfg["assumed"]["capacity_factor"]))


def moe(W: Dict, cfg: Dict, i: int, h: torch.Tensor,
        mode: str) -> torch.Tensor:
    """Layer ``i``'s experts on one dispatch group h (T, d) → (T, d).  The
    router runs in float32 in every mode (the port keeps it float32)."""
    t = h.shape[0]
    k = cfg["num_experts_per_tok"]
    probs = torch.softmax(mm(h, W["router"][i], "f32"), dim=-1)
    w, idx = torch.topk(probs, k, dim=-1, sorted=True)
    if cfg["norm_topk_prob"]:
        w = w / w.sum(-1, keepdim=True)
    flat, wflat = idx.reshape(-1), w.reshape(-1)        # (token, pick) order
    order = torch.argsort(flat, stable=True)            # by expert, in order
    counts = torch.bincount(flat, minlength=cfg["num_experts"]).tolist()
    cap = capacity(cfg, t)
    y = torch.zeros_like(h)
    start = 0
    for e, n in enumerate(counts):
        sel = order[start:start + min(n, cap)]          # past cap: dropped
        start += n
        if not len(sel):
            continue
        tok = sel // k
        xe = h[tok]
        a = F.silu(mm(xe, W["w_gate"][i, e], mode)) \
            * mm(xe, W["w_up"][i, e], mode)
        y.index_add_(0, tok, mm(a, W["w_down"][i, e], mode)
                     * wflat[sel][:, None])
    return y


def _qkv(W: Dict, cfg: Dict, i: int, h: torch.Tensor, mode: str):
    """h (..., d) → q (..., Hq, D), k and v (..., Hkv, D), q and k normed."""
    n = dims(cfg)
    eps = cfg["rms_norm_eps"]
    q = mm(h, W["wq"][i], mode).unflatten(-1, (n["hq"], n["D"]))
    k = mm(h, W["wk"][i], mode).unflatten(-1, (n["hkv"], n["D"]))
    v = mm(h, W["wv"][i], mode).unflatten(-1, (n["hkv"], n["D"]))
    return (rmsnorm(q, W["q_norm"][i], eps), rmsnorm(k, W["k_norm"][i], eps),
            v)


def _attention(W: Dict, cfg: Dict, i: int, h: torch.Tensor, mode: str,
               q_block: int) -> torch.Tensor:
    """Causal GQA self-attention of h (B, S, d), queries in blocks.  A
    float8 mode rounds the rotated queries and keys (each vector), the
    values (each head's) and the probabilities (each row) to e4m3."""
    n = dims(cfg)
    b, s, _ = h.shape
    q, k, v = (t.transpose(1, 2) for t in _qkv(W, cfg, i, h, mode))
    pos = torch.arange(s, device=h.device)
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    low = fp8_attention(mode)
    if low:
        q, k = fp8(q, -1), fp8(k, -1)
        v = fp8(v, (-2, -1))
    g, scale = n["hq"] // n["hkv"], n["D"] ** -0.5
    out = torch.empty_like(q)
    for bi in range(b):
        for j in range(n["hkv"]):
            heads = slice(j * g, (j + 1) * g)
            for q0 in range(0, s, q_block):
                q1 = min(s, q0 + q_block)
                sc = q[bi, heads, q0:q1] @ k[bi, j, :q1].T * scale
                masked = pos[None, :q1] > pos[q0:q1, None]
                sc.masked_fill_(masked, -torch.inf)
                p = torch.softmax(sc, -1)
                out[bi, heads, q0:q1] = (fp8(p, -1) if low else p) \
                    @ v[bi, j, :q1]
    return mm(out.transpose(1, 2).flatten(2), W["wo"][i], mode)


def prefill_last_logits(W: Dict, cfg: Dict, tokens: torch.Tensor,
                        mode: str = "f32",
                        q_block: int = 1024) -> torch.Tensor:
    """tokens (B, S) → the last position's logits (B, V), float32.  The
    batch's B·S tokens are one dispatch group, batch-major."""
    eps = cfg["rms_norm_eps"]
    b, s = tokens.shape
    with exact_float32():
        x = W["embed"][tokens].float()
        for i in range(cfg["num_hidden_layers"]):
            x = x + _attention(W, cfg, i, rmsnorm(x, W["ln1"][i], eps), mode,
                               q_block)
            h = rmsnorm(x, W["ln2"][i], eps)
            x = x + moe(W, cfg, i, h.reshape(b * s, -1), mode).view(b, s, -1)
        return mm(rmsnorm(x[:, -1], W["final_norm"], eps), W["unembed"], mode)
