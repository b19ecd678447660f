"""Transformer building blocks: RoPE, GQA attention (prefill + KV-cache
decode), MLP variants, norms.  Plain functions over nested dictionaries of
tensors; layer stacks keep a leading layer axis (see
:mod:`repro_torch.models.common`).

Pointwise datapaths route through the paper's overlay JIT where expressible
(see overlay_ops.py): squared-ReLU and gating products are overlay kernels.
RMSNorm and prefill attention go through the kernels' dispatch: on a CUDA
tensor the hand-written kernel, on a CPU tensor its plain version.

On a mesh with an axis above 1 the tensors are DTensors (the DTensor
seams of :mod:`repro_torch.models.common`): the projections run as
DTensor products (heads, ff width and vocabulary on 'model', the batch on
'data'), the row-parallel ones all-reduced by ``reduce``; the norms, the
attention core, the pointwise datapaths, the embedding lookup and the
cross-entropy run on each rank's local shards, the kernels included.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.models import common as dt
from repro_torch.models import overlay_ops
from repro_torch.models.common import ArchConfig, P, dense_init, spec


# ------------------------------------------------------------------- norms

def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
            impl: Optional[str] = None) -> torch.Tensor:
    """The RMSNorm kernel's dispatch; a DTensor ``x`` (rows whole on every
    rank) is normed shard by shard, the weight's gradient a partial sum
    wherever ``x`` is sharded."""
    y = rn_ops.rmsnorm(dt.local(x), dt.local_weight(weight, x), eps,
                       impl=impl)
    if not isinstance(x, DTensor):
        return y
    return dt.from_local(y, x.device_mesh, x.placements)


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


def attention_specs(cfg: ArchConfig, multi_pod: bool = False
                    ) -> Dict[str, Any]:
    """The sharding specs of :func:`init_attention`'s tree (unstacked)."""
    out = {"wq": spec("embed", "heads", multi_pod=multi_pod),
           "wk": spec("embed", "heads", multi_pod=multi_pod),
           "wv": spec("embed", "heads", multi_pod=multi_pod),
           "wo": spec("heads", "embed", multi_pod=multi_pod)}
    if cfg.qk_norm:
        out["q_norm"] = out["k_norm"] = spec(None)
    return out


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
    lets the device decide (the flash kernel on a card), ``"ref"`` the plain
    version, ``"kernel"`` the flash kernel.

    memory: if given (B, Sm, d), cross-attention: keys and values come from
    it, neither side is rotated (no RoPE) and no causal mask applies."""
    src = x if memory is None else memory
    q, k, v = x @ p["wq"], src @ p["wk"], src @ p["wv"]
    causal = causal and memory is None
    if isinstance(q, DTensor):
        out = _local_heads(_attend, q, k, v, p, cfg, pos=pos, causal=causal,
                           attn_impl=attn_impl, rotate=memory is None)
    else:
        out = _attend(q, k, v, p.get("q_norm"), p.get("k_norm"), cfg,
                      cfg.n_heads, cfg.n_kv_heads, pos=pos, causal=causal,
                      attn_impl=attn_impl, rotate=memory is None)
    return dt.reduce(out @ p["wo"])


def _attend(q, k, v, q_norm, k_norm, cfg: ArchConfig, hq: int, hkv: int, *,
            pos, causal: bool, attn_impl, rotate: bool, kv_heads=None):
    """The attention core on one rank's projections (B, S, heads * hd):
    heads views, q/k norms, RoPE, the flash-attention dispatch → (B, S,
    hq * hd).  ``kv_heads`` (lo, hi) keeps those key/value heads of the
    ``hkv`` projected."""
    hd = cfg.hd
    q = _split_heads(q, hq, hd)
    k = _split_heads(k, hkv, hd)
    v = _split_heads(v, hkv, hd)
    if kv_heads is not None:
        k, v = k[:, kv_heads[0]:kv_heads[1]], v[:, kv_heads[0]:kv_heads[1]]
    if cfg.qk_norm:
        q = rmsnorm(q, q_norm, cfg.norm_eps)
        k = rmsnorm(k, k_norm, cfg.norm_eps)
    if rotate:                                             # self-attn: RoPE
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    out = fa_ops.attention(q, k, v, causal=causal, window=cfg.window,
                           impl=attn_impl)
    return _merge_heads(out)


def local_kv_heads(cfg: ArchConfig, shards: int, rank: int):
    """The key/value heads the query heads of model shard ``rank`` of
    ``shards`` read under the GQA map ``head // group`` → (lo, hi), or
    None where the key/value heads shard alongside the query heads.  A
    shard whose query heads do not map onto whole groups raises."""
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    if hq % shards:
        raise ValueError(f"{hq} query heads do not divide over {shards} "
                         f"model shards")
    if hkv % shards == 0:
        return None
    group, n = hq // hkv, hq // shards
    if n % group and group % n:
        raise ValueError(f"{n} query heads a shard against GQA groups of "
                         f"{group}: the shards' groups would differ")
    lo = rank * n // group
    return lo, lo + max(1, n // group)


def _local_heads(fn, q, k, v, p, cfg: ArchConfig, **kw):
    """``fn`` (:func:`_attend` or :func:`_decode_heads`) on each rank's
    heads: q, k and v are DTensors (B, S, heads * hd) with the heads
    sharded on 'model' and the batch on 'data'.  Where the key/value
    heads do not divide 'model', k and v are gathered and each rank keeps
    the heads its query heads read (their gradients then partial sums).
    The q/k norm weights' gradients are partial sums over every sharded
    axis.  → the output (B, S, hq * hd) sharded as q."""
    mesh, dims = q.device_mesh, dt.mesh_dims(q, -1)
    shards = math.prod(mesh.size(i) for i in dims)
    rank = dt.offset(q, -1) // (q.shape[-1] // shards)
    kv = local_kv_heads(cfg, shards, rank)
    if kv is None:
        kl, vl = k.to_local(), v.to_local()
        hkv = cfg.n_kv_heads // shards
    else:
        grad = dt.with_placement(k.placements, dims, Partial())
        kl = dt.gather(k, -1).to_local(grad_placements=grad)
        vl = dt.gather(v, -1).to_local(grad_placements=grad)
        hkv = cfg.n_kv_heads
    norms = [dt.local_weight(p.get(name), q) for name in ("q_norm", "k_norm")]
    out = fn(q.to_local(), kl, vl, *norms, cfg, cfg.n_heads // shards, hkv,
             kv_heads=kv, **kw)
    return dt.from_local(out, mesh, q.placements)


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
    the positions after ``cur_pos`` masked.

    On DTensors the cache holds each rank's key/value heads where they
    divide 'model' (each rank decodes its heads), else each rank's stretch
    of the sequence: then every rank takes all heads of the new token,
    writes it where its stretch holds ``cur_pos``, and the softmax runs
    across the stretches (max and sums all-reduced)."""
    q, k_new, v_new = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if not isinstance(q, DTensor):
        out = _decode_heads(q, k_new, v_new, p.get("q_norm"),
                            p.get("k_norm"), cfg, cfg.n_heads,
                            cfg.n_kv_heads, cache_k=cache_k, cache_v=cache_v,
                            cur_pos=cur_pos)
    elif dt.mesh_dims(cache_k, 1):
        out = _local_heads(_decode_heads, q, k_new, v_new, p, cfg,
                           cache_k=cache_k.to_local(),
                           cache_v=cache_v.to_local(), cur_pos=cur_pos)
    else:
        out = _decode_seq_sharded(q, k_new, v_new, p, cfg, cache_k, cache_v,
                                  cur_pos)
    return dt.reduce(out @ p["wo"]), cache_k, cache_v


def _decode_new(q, k_new, v_new, q_norm, k_norm, cfg: ArchConfig, hq: int,
                hkv: int, cur_pos: int):
    """The new token's q, k and v as heads (B, H, 1, hd), normed and
    rotated to ``cur_pos``."""
    hd = cfg.hd
    q = _split_heads(q, hq, hd)                            # (B,Hq,1,hd)
    k_new = _split_heads(k_new, hkv, hd)                   # (B,Hkv,1,hd)
    v_new = _split_heads(v_new, hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, q_norm, cfg.norm_eps)
        k_new = rmsnorm(k_new, k_norm, cfg.norm_eps)
    posv = torch.full((1,), cur_pos, dtype=torch.int64, device=q.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k_new = apply_rope(k_new, posv, cfg.rope_theta)
    return q, k_new, v_new


def _decode_heads(q, k_new, v_new, q_norm, k_norm, cfg: ArchConfig,
                  hq: int, hkv: int, *, cache_k, cache_v, cur_pos: int,
                  kv_heads=None):
    """One rank's decode over its heads and its whole cache → (B, 1,
    hq * hd); the cache written in place."""
    q, k_new, v_new = _decode_new(q, k_new, v_new, q_norm, k_norm, cfg, hq,
                                  hkv, cur_pos)
    cache_k[:, :, cur_pos] = k_new[:, :, 0].to(cache_k.dtype)
    cache_v[:, :, cur_pos] = v_new[:, :, 0].to(cache_v.dtype)
    pr = torch.softmax(_decode_scores(q, cache_k, 0, cur_pos, cfg), dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", pr, cache_v.float())
    return _merge_heads(out.reshape(q.shape).to(q.dtype))


def _decode_scores(q, cache_k, s0: int, cur_pos: int, cfg: ArchConfig):
    """The new token's heads q (B, Hq, 1, hd) against ``cache_k`` (B, Hkv,
    S, hd), whose positions start at ``s0``: scaled, in float32, those
    after ``cur_pos`` (and outside the window) masked → (B, Hkv, group, 1,
    S)."""
    b, hq, _, hd = q.shape
    hkv = cache_k.shape[1]
    qg = (q.float() * (hd ** -0.5)).reshape(b, hkv, hq // hkv, 1, hd)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, cache_k.float())
    kpos = torch.arange(s0, s0 + cache_k.shape[2], device=q.device)
    mask = kpos <= cur_pos
    if cfg.window is not None:
        mask &= kpos > cur_pos - cfg.window
    return torch.where(mask, logits, -1e30)


def _decode_seq_sharded(q, k_new, v_new, p, cfg: ArchConfig, cache_k,
                        cache_v, cur_pos: int):
    """Decode against a cache whose sequence is sharded on 'model': the
    new token's heads gathered whole, the softmax taken across the
    ranks' stretches → this rank's query heads (B, 1, hq_l * hd) as a
    DTensor sharded as q."""
    hd, hq, hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    mesh, dims = q.device_mesh, dt.mesh_dims(q, -1)
    seq_dims = dt.mesh_dims(cache_k, 2)
    norms = [dt.local(p.get(n)) for n in ("q_norm", "k_norm")]
    qa, ka, va = (dt.gather(t, -1).to_local() for t in (q, k_new, v_new))
    qh, kh, vh = _decode_new(qa, ka, va, *norms, cfg, hq, hkv, cur_pos)
    ck, cv = cache_k.to_local(), cache_v.to_local()
    s0, sl = dt.offset(cache_k, 2), ck.shape[2]
    if s0 <= cur_pos < s0 + sl:
        ck[:, :, cur_pos - s0] = kh[:, :, 0].to(ck.dtype)
        cv[:, :, cur_pos - s0] = vh[:, :, 0].to(cv.dtype)
    logits = _decode_scores(qh, ck, s0, cur_pos, cfg)
    m = dt.all_reduce(logits.amax(-1, keepdim=True), mesh, seq_dims, "max")
    e = torch.exp(logits - m)
    den = dt.all_reduce(e.sum(-1, keepdim=True), mesh, seq_dims)
    num = dt.all_reduce(torch.einsum("bhgqk,bhkd->bhgqd", e, cv.float()),
                        mesh, seq_dims)
    out = (num / den).reshape(qh.shape).to(qh.dtype)
    n = hq // math.prod(mesh.size(i) for i in dims)
    h0 = dt.offset(q, -1) // hd
    return dt.from_local(_merge_heads(out[:, h0:h0 + n]), mesh, q.placements)


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


def mlp_specs(cfg: ArchConfig, multi_pod: bool = False) -> Dict[str, Any]:
    """The sharding specs of :func:`init_mlp`'s tree (unstacked)."""
    up = spec("embed", "ff", multi_pod=multi_pod)
    down = spec("ff", "embed", multi_pod=multi_pod)
    if cfg.activation == "swiglu":
        return {"w_gate": up, "w_up": up, "w_down": down}
    return {"w_up": up, "w_down": down}


def mlp(p: Dict[str, torch.Tensor], x: torch.Tensor,
        cfg: ArchConfig) -> torch.Tensor:
    if cfg.activation == "swiglu":
        g = x @ p["w_gate"]
        u = x @ p["w_up"]
        h = dt.same_placements(overlay_ops.gated_silu, g, u)
    else:
        h = dt.same_placements(overlay_ops.squared_relu, x @ p["w_up"])
    return dt.reduce(h @ p["w_down"])


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


def lm_specs(multi_pod: bool = False) -> Dict[str, Any]:
    """The sharding specs of :func:`init_lm`'s tree."""
    return {"embed": spec("vocab", "embed", multi_pod=multi_pod),
            "unembed": spec("embed", "vocab", multi_pod=multi_pod),
            "final_norm": spec(None)}


def kv_cache_spec(cfg: ArchConfig, multi_pod: bool, seq_sharded: bool,
                  model_axis: int, seq_batch_axis: Any = None):
    """The spec of a stacked KV cache (layers, B, Hkv, seq, hd): heads on
    'model' where they divide ``model_axis``, else the sequence; with
    ``seq_sharded`` (long context, batch 1) the sequence across the mesh.
    ``seq_batch_axis`` is the axis the sequence takes beside sharded heads
    when ``seq_sharded`` (default: the batch axes)."""
    batch = ("pod", "data") if multi_pod else "data"
    heads_ok = cfg.n_kv_heads % model_axis == 0
    if seq_sharded:
        if heads_ok:
            return P(None, None, "model", seq_batch_axis or batch, None)
        seq = ("pod", "data", "model") if multi_pod else ("data", "model")
        return P(None, None, None, seq, None)
    if heads_ok:
        return P(None, batch, "model", None, None)
    return P(None, batch, None, "model", None)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``: (V, d), (B, S) → (B, S, d).  Each rank looks up
    the ids its shard of the vocabulary holds and zeros the rest; on a
    sharded table the rows are then all-reduced: the table never moves."""
    if not isinstance(tokens, DTensor):
        tokens = torch.as_tensor(tokens, device=table.device)
    if isinstance(table, DTensor):
        tokens = dt.as_dtensor(tokens, table.device_mesh)
    tl = dt.local_weight(table, tokens)
    idx = dt.local(tokens).long() - dt.offset(table, 0)
    own = (idx >= 0) & (idx < tl.shape[0])
    rows = torch.where(own[..., None], tl[idx.clamp(0, tl.shape[0] - 1)],
                       0.0)
    if not isinstance(table, DTensor):
        return rows
    pl = dt.with_placement(tokens.placements, dt.mesh_dims(table, 0),
                           Partial())
    return dt.reduce(dt.from_local(rows, table.device_mesh, pl))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits: (B, S, V) f32-ish; labels: (B, S) int → scalar mean nll.

    Each rank takes the log-sum-exp and the label's logit over the
    columns it holds; where the vocabulary is sharded both are combined
    across the ranks (all-reduced; the padded ids stay in the sum), so
    the (B, S, V) logits are never whole on a rank, and the mean over a
    sharded batch is each rank's share, all-reduced."""
    mesh = getattr(logits, "device_mesh", None)
    dims = dt.mesh_dims(logits, -1)
    if mesh is not None:
        labels = dt.as_dtensor(labels, mesh)
    lf = dt.local(logits).float()
    lse = torch.logsumexp(lf, dim=-1)
    m = dt.all_reduce(lse.detach(), mesh, dims, "max")
    lse = torch.log(dt.all_reduce(torch.exp(lse - m), mesh, dims)) + m
    idx = dt.local(labels).long() - dt.offset(logits, -1)
    own = (idx >= 0) & (idx < lf.shape[-1])
    ll = torch.gather(lf, -1, idx.clamp(0, lf.shape[-1] - 1)[..., None])
    ll = dt.all_reduce(torch.where(own, ll[..., 0], 0.0), mesh, dims)
    share = (lse - ll).mean() * (ll.numel() / labels.numel())
    if mesh is None:
        return share
    pl = tuple(Partial() if isinstance(p, Shard) else Replicate()
               for p in labels.placements)
    return dt.reduce(dt.from_local(share, mesh, pl))
