"""Mamba2 / SSD (state-space duality): mamba2-370m, and the backbone blocks
of zamba2.  Chunked matrix-product formulation (Dao & Gu 2024): the
intra-chunk terms are batched matrix products; the inter-chunk state is a
short loop over chunks.  Decode carries an explicit (heads, head_dim,
state) recurrence, O(1) per token.

The JAX package contracts its three- and four-operand einsums in an order
of XLA's choosing; here each is written out as a chain of matrix products
so that no intermediate larger than the (B, C, H, L, L) decay matrix is
built.

On a mesh with an axis above 1 (DTensors) the block runs on each rank's
share of the inner width: :func:`_sharded_block`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Shard

from repro_torch.models import common as dt
from repro_torch.models import layers as L
from repro_torch.models import overlay_ops
from repro_torch.models.common import (ArchConfig, P, checked_remat_policy,
                                       dense_init, remat, spec, stack_spec)
from repro_torch.models.transformer import layer_params


def ssm_dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_state


def init_mamba_block(gen: torch.Generator, cfg: ArchConfig, device=None,
                     n_stack: int = 0) -> Dict[str, torch.Tensor]:
    """``A_log``, ``D`` and ``dt_bias`` stay float32 whatever ``cfg.dtype``
    is."""
    d = cfg.d_model
    di, h, n = ssm_dims(cfg)
    kw = dict(dtype=cfg.dtype, device=device, n_stack=n_stack)
    lead = (n_stack,) if n_stack else ()

    def const(value, width, dtype):
        return torch.full((*lead, width), value, dtype=dtype, device=device)
    return {
        "in_proj": dense_init(gen, (d, 2 * di + 2 * n + h), **kw),
        "conv_w": dense_init(gen, (cfg.conv_width, di + 2 * n), **kw),
        "A_log": const(0.0, h, torch.float32),
        "D": const(1.0, h, torch.float32),
        "dt_bias": const(0.0, h, torch.float32),
        "norm": const(1.0, di, cfg.dtype),
        "out_proj": dense_init(gen, (di, d), **kw),
    }


def mamba_specs(cfg: ArchConfig, multi_pod: bool = False) -> Dict[str, Any]:
    """The sharding specs of :func:`init_mamba_block`'s tree (unstacked):
    the inner width on 'model'."""
    return {
        "in_proj": P(None, "model"),
        "conv_w": P(None, "model"),
        "A_log": P("model"), "D": P("model"), "dt_bias": P("model"),
        "norm": P("model"),
        "out_proj": P("model", None),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, C); w: (K, C).  The taps are
    summed in float32 and rounded to x's dtype once, as XLA's fused loop
    does for the JAX package's bfloat16 taps (and as decode's product
    does), not rounded after every tap."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0)).float()
    wf = w.float()
    out = xp[:, :s] * wf[0]
    for i in range(1, k):                    # K is tiny (4): unrolled taps
        out = out + xp[:, i:i + s] * wf[i]
    return out.to(x.dtype)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., l) → (..., l, l): seg[i,j] = sum_{k=j+1..i} a_k on the lower
    triangle (0 on the diagonal), -inf above — exp() of this is the 1-SS
    decay matrix of SSD.  The -inf is put in after the subtraction, so no
    ``-inf - -inf`` makes a NaN."""
    l = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    above = torch.ones((l, l), dtype=torch.bool, device=a.device).triu_(1)
    return seg.masked_fill_(above, -torch.inf)


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                compute_dtype: torch.dtype = torch.float32):
    """SSD in chunked matrix-product form.

    xh: (B, S, H, Pd) head inputs; dt: (B, S, H) float32 discretisation
    steps; A: (H,) negative decay rates; Bm, Cm: (B, S, N); S a multiple of
    ``chunk``.  Returns (y (B, S, H, Pd) float32, the final state
    (B, H, Pd, N) float32).

    compute_dtype: the dtype the large intra-chunk tensors (the decay
    matrix, x·dt, B, C) are rounded to, as in the JAX package; the products
    then run in float32 on the rounded values, as its
    ``preferred_element_type=float32`` asks.  Decay exponentials and the
    inter-chunk state stay float32."""
    b, s, h, pd = xh.shape
    n = Bm.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk "
                         f"{chunk}")
    c, cl = s // chunk, chunk
    f32 = torch.float32

    def rounded(t):
        return t.to(compute_dtype).to(f32)

    # every (…, h, l) tensor is laid out (b, c, h, l) so the elementwise
    # passes over the (b, c, h, l, l) decay matrix run on contiguous memory
    x_ = rounded(xh.reshape(b, c, cl, h, pd))
    dt_ = dt.reshape(b, c, cl, h)                               # f32
    B_ = rounded(Bm.reshape(b, c, cl, n))
    C_ = rounded(Cm.reshape(b, c, cl, n))
    dA = (dt_ * A).transpose(2, 3).contiguous()                 # (b,c,h,l)
    xdt = rounded(x_ * rounded(dt_[..., None]))                 # (b,c,l,h,p)
    xdt_h = xdt.transpose(2, 3)                                 # (b,c,h,l,p)

    # intra-chunk (diagonal blocks): y[l] = sum_s (C_l·B_s) L[l,s] xdt[s],
    # contracted as C·Bᵀ, then × the decay matrix, then × xdt
    Lmat = rounded(_segsum(dA).exp_())                          # (b,c,h,l,l)
    cb = C_ @ B_.transpose(-1, -2)                              # (b,c,l,s)
    # in place unless autograd keeps Lmat (exp's output) for the backward
    Lmat = Lmat * cb[:, :, None] if Lmat.requires_grad \
        else Lmat.mul_(cb[:, :, None])
    y_diag = Lmat @ xdt_h                                       # (b,c,h,l,p)
    del Lmat, cb

    # chunk-final states: sum_l B_l decay_l xdt_l
    dA_cum = torch.cumsum(dA, dim=-1)                           # (b,c,h,l)
    decay_states = rounded(torch.exp(dA_cum[..., -1:] - dA_cum))
    xs = xdt_h * decay_states[..., None]                        # (b,c,h,l,p)
    states = xs.transpose(-1, -2) @ B_[:, :, None]              # (b,c,h,p,n)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(dA_cum[..., -1])                    # (b,c,h)
    prev = torch.zeros_like(states[:, 0])
    prev_states = []
    for i in range(c):
        prev_states.append(prev)
        prev = prev * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = rounded(torch.stack(prev_states, dim=1))     # (b,c,h,p,n)

    # the entering state's part: y[l] = exp(dA_cum_l) C_l · state
    state_decay = rounded(torch.exp(dA_cum))                    # (b,c,h,l)
    y_off = (C_[:, :, None] @ prev_states.transpose(-1, -2)) \
        * state_decay[..., None]                                # (b,c,h,l,p)

    y = (y_diag + y_off).transpose(2, 3).reshape(b, s, h, pd)
    return y, prev


def mamba_block(p: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ArchConfig, conv_state: Optional[torch.Tensor] = None,
                ssm_state: Optional[torch.Tensor] = None,
                decode: bool = False,
                ssd_dtype: torch.dtype = torch.float32):
    """Full Mamba2 block.  Train: (B,S,d) → (B,S,d).  Decode: one step
    with the carried conv_state (B, K-1, di+2n) and ssm_state
    (B, H, Pd, N) → (out, new conv_state, new ssm_state).  A DTensor
    ``x`` takes :func:`_sharded_block`, which writes the decode's conv
    window and state into ``conv_state`` and ``ssm_state`` in place."""
    if isinstance(x, DTensor):
        return _sharded_block(p, x, cfg, conv_state, ssm_state, decode,
                              ssd_dtype)
    di, h, n = ssm_dims(cfg)
    zxbcdt = x @ p["in_proj"]                    # (B,S, 2di+2n+h)
    z, xBC, dt = torch.split(zxbcdt, [di, di + 2 * n, h], dim=-1)
    xBC, new_conv = _conv(xBC, p["conv_w"], conv_state, decode, x.dtype)
    xs, Bm, Cm = torch.split(xBC, [di, n, n], dim=-1)
    y, new_ssm = _ssm(xs, dt, p["A_log"], p["D"], p["dt_bias"], Bm, Cm,
                      cfg, ssm_state, decode, ssd_dtype)
    y = _gate(y, z, x.dtype)
    y = L.rmsnorm(y, p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if decode:
        return out, new_conv, new_ssm
    return out


def _conv(xBC: torch.Tensor, w: torch.Tensor,
          conv_state: Optional[torch.Tensor], decode: bool,
          dtype: torch.dtype):
    """The causal conv and SiLU of channels ``xBC`` (B, S, C) with taps
    ``w`` (K, C) → (the output in ``dtype``, the new window (B, K-1, C) in
    decode, else None).  Decode reads the window's first K-1 steps from
    ``conv_state``."""
    if not decode:
        out, new_conv = _causal_conv(xBC, w), None
    else:
        wdt = torch.promote_types(conv_state.dtype, xBC.dtype)
        window = torch.cat([conv_state.to(wdt), xBC.to(wdt)], dim=1)
        out = torch.einsum("bkc,kc->bc", window, w.to(wdt))[:, None]
        new_conv = window[:, 1:]
    return F.silu(out.float()).to(dtype), new_conv


def _ssm(xs, dt, A_log, D, dt_bias, Bm, Cm, cfg: ArchConfig, ssm_state,
         decode: bool, ssd_dtype: torch.dtype):
    """The SSD over the heads of ``xs`` (B, S, heads * Pd) with their
    steps ``dt`` (B, S, heads) and per-head ``A_log``, ``D`` and
    ``dt_bias``, every head reading ``Bm`` and ``Cm`` (B, S, N) → (y (B, S,
    heads, Pd) float32, the new state (B, heads, Pd, N) float32)."""
    pd = cfg.ssm_head_dim
    dtp = F.softplus(dt.float() + dt_bias)                      # (B,S,H)
    A = -torch.exp(A_log)                                       # (H,)
    xh = xs.reshape(*xs.shape[:2], -1, pd)
    if not decode:
        y, new_ssm = ssd_chunked(xh, dtp, A, Bm, Cm, cfg.ssm_chunk,
                                 compute_dtype=ssd_dtype)
    else:
        # single-step recurrence: state ← state·exp(dt·A) + dt·x ⊗ B
        dA = torch.exp(dtp[:, 0, :, None, None] * A[:, None, None])
        xdt = xh[:, 0].float() * dtp[:, 0, :, None]             # (B,H,Pd)
        upd = xdt[..., None] * Bm[:, 0].float()[:, None, None]  # (B,H,Pd,N)
        new_ssm = ssm_state * dA + upd
        y = (new_ssm @ Cm[:, 0].float()[:, None, :, None])[..., 0][:, None]
    return y + D[:, None] * xh.float(), new_ssm


def _gate(y: torch.Tensor, z: torch.Tensor, dtype: torch.dtype):
    """The output gate y·silu(z).  It runs on float32 and rounds once: XLA
    keeps the JAX package's bfloat16 y and gate products in float32 inside
    its fusion (excess precision), and a rounding after each product
    doubles the bfloat16 error of the logits."""
    return overlay_ops.ssm_gate(y.reshape(*y.shape[:2], -1),
                                z.float()).to(dtype)


def _whole(t: DTensor, dims) -> torch.Tensor:
    """``t`` gathered whole along its last dimension over the mesh
    dimensions ``dims`` (c10d, :func:`repro_torch.models.common.gather`)
    → the local tensor, whose gradient is each rank's partial sum (each
    rank reads only some of its columns)."""
    grad = dt.with_placement(t.placements, dims, Partial())
    return dt.gather(t, -1).to_local(grad_placements=grad)


def _sharded_block(p, x: DTensor, cfg: ArchConfig, conv_state, ssm_state,
                   decode: bool, ssd_dtype: torch.dtype):
    """:func:`mamba_block` on DTensors, rank r of tp on 'model' (the specs
    of :func:`mamba_specs`).  ``in_proj`` and ``conv_w`` shard the packed
    axes ``z | x | B | C | dt`` and ``x | B | C`` in blocks, which are not
    slices of each part (a rank's block may straddle two parts), so:

    1. ``x @ in_proj`` is the rank's block of packed columns, gathered
       whole over 'model';
    2. the rank takes its heads' ``z`` and ``dt`` (heads r·h/tp …) and
       its block of the conv's channels, ``conv_w``'s own block;
    3. the conv (and in decode its window, the conv cache's local block,
       written back in place) runs on that block, and its output is
       gathered whole;
    4. the SSD runs on the rank's heads: their ``x``, with ``B`` and
       ``C`` whole (one group: every head reads them), ``A_log``, ``D``,
       ``dt_bias`` and the state cache local;
    5. the gate, then the gated norm in the split-row mode (the rank's
       columns of ``di``, head-aligned);
    6. ``out_proj`` row-parallel: a local product, then ``reduce``.

    A layer's forward moves two gathers of activations, one float32 a row
    (the norm's all-reduce) and the reduce; no weight moves."""
    di, h, n = ssm_dims(cfg)
    zxbcdt = x @ p["in_proj"]
    mesh, dims = x.device_mesh, dt.mesh_dims(zxbcdt, -1)
    tp = math.prod(mesh.size(i) for i in dims)
    r = dt.offset(zxbcdt, -1) // zxbcdt.to_local().shape[-1]
    hr, dr, cw = h // tp, di // tp, (di + 2 * n) // tp
    packed = _whole(zxbcdt, dims)                       # (B, S, 2di+2n+h)
    z = packed[..., r * dr:(r + 1) * dr]
    dtr = packed[..., 2 * di + 2 * n + r * hr:2 * di + 2 * n + (r + 1) * hr]
    xbc = packed[..., di + r * cw:di + (r + 1) * cw]    # conv_w's block
    cs = dt.local(conv_state) if decode else None
    conv, new_conv = _conv(xbc, dt.local_weight(p["conv_w"], x), cs, decode,
                           x.dtype)
    if decode:
        cs.copy_(new_conv)
    cols = dt.with_placement(x.placements, dims, Shard(x.ndim - 1))
    xBC = _whole(dt.from_local(conv, mesh, cols), dims)  # (B, S, di+2n)
    ss = dt.local(ssm_state) if decode else None
    y, new_ssm = _ssm(xBC[..., r * dr:(r + 1) * dr], dtr,
                      *(dt.local_weight(p[k], x)
                        for k in ("A_log", "D", "dt_bias")),
                      xBC[..., di:di + n], xBC[..., di + n:], cfg, ss,
                      decode, ssd_dtype)
    if decode:
        ss.copy_(new_ssm)
    y = dt.from_local(_gate(y, z, x.dtype), mesh, cols)
    y = L.rmsnorm(y, p["norm"], cfg.norm_eps)           # split rows
    out = dt.reduce(y @ p["out_proj"])
    if decode:
        return out, conv_state, ssm_state
    return out


class MambaLM:
    """Decoder-only Mamba2 LM (attention-free).  ``ssd_dtype`` is the
    JAX package's lever of the same name (float32 or bfloat16 for the
    large SSD tensors); ``remat_policy`` checkpoints each layer body in
    training (:func:`repro_torch.models.common.remat`)."""

    def __init__(self, cfg: ArchConfig,
                 ssd_dtype: torch.dtype = torch.float32,
                 remat_policy: str = "full"):
        self.cfg = cfg
        self.ssd_dtype = ssd_dtype
        self.remat_policy = checked_remat_policy(remat_policy)

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random parameters drawn from ``gen``, on ``gen``'s device."""
        cfg, dev = self.cfg, gen.device
        n = cfg.n_layers
        return {"lm": L.init_lm(gen, cfg, device=dev),
                "layers": {
                    "mamba": init_mamba_block(gen, cfg, device=dev,
                                              n_stack=n),
                    "ln": torch.ones((n, cfg.d_model), dtype=cfg.dtype,
                                     device=dev)}}

    def param_specs(self, multi_pod: bool = False) -> Dict[str, Any]:
        """The sharding specs of :meth:`init`'s tree."""
        layer = {"mamba": mamba_specs(self.cfg, multi_pod), "ln": spec(None)}
        return {"lm": L.lm_specs(multi_pod), "layers": stack_spec(layer)}

    def _layer_train(self, x, lp):
        h = L.rmsnorm(x, lp["ln"], self.cfg.norm_eps)
        return x + mamba_block(lp["mamba"], h, self.cfg,
                               ssd_dtype=self.ssd_dtype)

    def forward_train(self, params, tokens: torch.Tensor,
                      input_embeds: Optional[torch.Tensor] = None,
                      last_only: bool = False) -> torch.Tensor:
        """tokens: (B, S) int, S a multiple of ``ssm_chunk`` → logits
        (B, S, V), or (B, 1, V) with ``last_only``.  The model has no
        frontend, so ``input_embeds`` must be None."""
        if input_embeds is not None:
            raise ValueError(f"{self.cfg.arch_id} has no frontend to take "
                             f"input_embeds")
        cfg = self.cfg
        x = L.embed(params["lm"]["embed"], tokens)
        body = remat(self._layer_train, self.remat_policy)
        for i in range(cfg.n_layers):
            x = body(x, layer_params(params["layers"], i))
        if last_only:
            x = dt.same_placements(lambda t: t[:, -1:], x)
        x = L.rmsnorm(x, params["lm"]["final_norm"], cfg.norm_eps)
        return x @ params["lm"]["unembed"]

    def loss(self, params, batch) -> torch.Tensor:
        logits = self.forward_train(params, batch["tokens"])
        return L.cross_entropy(logits, batch["labels"])

    # ------------------------------------------------------------- serving
    def init_cache(self, batch: int, seq: int, dtype=None,
                   device=None) -> Dict[str, torch.Tensor]:
        """The conv window in ``dtype`` (default ``cfg.dtype``) and the SSM
        state in float32; ``seq`` is unused, the state is O(1) in it."""
        cfg = self.cfg
        di, h, n = ssm_dims(cfg)
        return {
            "conv": torch.zeros((cfg.n_layers, batch, cfg.conv_width - 1,
                                 di + 2 * n), dtype=dtype or cfg.dtype,
                                device=device),
            "state": torch.zeros((cfg.n_layers, batch, h, cfg.ssm_head_dim,
                                  n), dtype=torch.float32, device=device),
        }

    def cache_specs(self, multi_pod: bool = False, seq_sharded: bool = False,
                    model_axis: int = 16) -> Dict[str, Any]:
        """The sharding specs of :meth:`init_cache`'s tree: the state's
        heads on 'model'; with ``seq_sharded`` (batch 1) no batch axis."""
        batch = ("pod", "data") if multi_pod else "data"
        if seq_sharded:
            return {"conv": P(None, None, None, "model"),
                    "state": P(None, None, "model", None, None)}
        return {"conv": P(None, batch, None, "model"),
                "state": P(None, batch, "model", None, None)}

    def forward_decode(self, params, cache: Dict[str, torch.Tensor],
                       tokens: torch.Tensor, cur_pos: int):
        """tokens: (B, 1) int → (logits (B, 1, V), cache), the cache
        updated IN PLACE (the JAX package returns new arrays).  ``cur_pos``
        is unused: the recurrence carries the position."""
        cfg = self.cfg
        x = L.embed(params["lm"]["embed"], tokens)         # (B, 1, d)
        for i in range(cfg.n_layers):
            x = self._layer_decode(x, layer_params(params["layers"], i),
                                   cache, i)
        x = L.rmsnorm(x, params["lm"]["final_norm"], cfg.norm_eps)
        return x @ params["lm"]["unembed"], cache

    def _layer_decode(self, x, lp, cache: Dict[str, torch.Tensor], i: int):
        """Layer ``i``'s decode step, its conv window and state written
        into ``cache`` in place (by the block itself on DTensors: each
        rank's block of the conv cache and its heads of the state)."""
        h = L.rmsnorm(x, lp["ln"], self.cfg.norm_eps)
        o, conv, state = mamba_block(
            lp["mamba"], h, self.cfg, conv_state=cache["conv"][i],
            ssm_state=cache["state"][i], decode=True)
        if not isinstance(x, DTensor):
            cache["conv"][i] = conv
            cache["state"][i] = state
        return x + o
