"""Zamba2-style hybrid (zamba2-7b): a Mamba2 backbone with a single SHARED
attention block invoked every ``attn_every`` layers (weights shared across
invocation sites, one KV cache per site).

The JAX package stacks the backbone with ``jax.vmap`` and switches the
shared block in and out of its layer scan with ``lax.cond``; here the
backbone is stacked by ``n_stack`` and a Python ``if`` runs the block after
layer i when ``i % attn_every == 0``.  Prefill attention goes through the
flash-attention dispatch (the kernel on a card, at head dim 112 for
zamba2-7b); decode attention is plain torch, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import common as dt
from repro_torch.models import layers as L
from repro_torch.models.common import ArchConfig, remat, spec
from repro_torch.models.mamba2 import MambaLM
from repro_torch.models.transformer import layer_params


class HybridLM(MambaLM):
    def __init__(self, cfg: ArchConfig, attn_impl: Optional[str] = None,
                 ssd_dtype: torch.dtype = torch.float32,
                 remat_policy: str = "full"):
        super().__init__(cfg, ssd_dtype=ssd_dtype, remat_policy=remat_policy)
        # None: the device decides; "ref": the plain version; "kernel"
        self.attn_impl = attn_impl

    @property
    def n_attn_sites(self) -> int:
        cfg = self.cfg
        return (cfg.n_layers + cfg.attn_every - 1) // cfg.attn_every

    def attn_site(self, i: int) -> Optional[int]:
        """The shared block's site after layer ``i`` (its slot in the KV
        cache), or None where layer ``i`` is not followed by it."""
        every = self.cfg.attn_every
        return i // every if i % every == 0 else None

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random parameters drawn from ``gen``, on ``gen``'s device: the
        backbone stacked by layer, the shared block unstacked."""
        cfg, dev = self.cfg, gen.device
        params = super().init(gen)

        def ones():
            return torch.ones((cfg.d_model,), dtype=cfg.dtype, device=dev)
        params["shared"] = {"attn": L.init_attention(gen, cfg, device=dev),
                            "mlp": L.init_mlp(gen, cfg, device=dev),
                            "ln1": ones(), "ln2": ones()}
        return params

    def param_specs(self, multi_pod: bool = False) -> Dict[str, Any]:
        """The sharding specs of :meth:`init`'s tree."""
        out = super().param_specs(multi_pod)
        out["shared"] = {"attn": L.attention_specs(self.cfg, multi_pod),
                         "mlp": L.mlp_specs(self.cfg, multi_pod),
                         "ln1": spec(None), "ln2": spec(None)}
        return out

    # ------------------------------------------------------------ training
    def _shared_block(self, sp, x, pos):
        cfg = self.cfg
        h = L.rmsnorm(x, sp["ln1"], cfg.norm_eps)
        x = x + L.attention(sp["attn"], h, cfg, pos=pos,
                            attn_impl=self.attn_impl)
        h = L.rmsnorm(x, sp["ln2"], cfg.norm_eps)
        return x + L.mlp(sp["mlp"], h, cfg)

    def forward_train(self, params, tokens: torch.Tensor,
                      input_embeds: Optional[torch.Tensor] = None,
                      last_only: bool = False) -> torch.Tensor:
        """tokens: (B, S) int, S a multiple of ``ssm_chunk`` → logits
        (B, S, V), or (B, 1, V) with ``last_only``.  No frontend, so
        ``input_embeds`` must be None."""
        if input_embeds is not None:
            raise ValueError(f"{self.cfg.arch_id} has no frontend to take "
                             f"input_embeds")
        cfg = self.cfg
        x = L.embed(params["lm"]["embed"], tokens)
        pos = torch.arange(tokens.shape[1], device=x.device)

        def layer(x, lp, shared, i):
            # one body with the shared block after it, as the JAX model's
            # checkpointed body holds both
            x = self._layer_train(x, lp)
            if self.attn_site(i) is not None:
                x = self._shared_block(shared, x, pos)
            return x
        body = remat(layer, self.remat_policy)
        for i in range(cfg.n_layers):
            x = body(x, layer_params(params["layers"], i), params["shared"],
                     i)
        if last_only:
            x = dt.same_placements(lambda t: t[:, -1:], x)
        x = L.rmsnorm(x, params["lm"]["final_norm"], cfg.norm_eps)
        return x @ params["lm"]["unembed"]

    # ------------------------------------------------------------- serving
    def init_cache(self, batch: int, seq: int, dtype=None,
                   device=None) -> Dict[str, torch.Tensor]:
        """Mamba's conv window and state, and one KV cache per attention
        site, ``attn_k``/``attn_v`` (sites, B, Hkv, seq, hd) in ``dtype``
        (default ``cfg.dtype``)."""
        cfg = self.cfg
        cache = super().init_cache(batch, seq, dtype, device)
        kv = (self.n_attn_sites, batch, cfg.n_kv_heads, seq, cfg.hd)
        dt = dtype or cfg.dtype
        cache["attn_k"] = torch.zeros(kv, dtype=dt, device=device)
        cache["attn_v"] = torch.zeros(kv, dtype=dt, device=device)
        return cache

    def cache_specs(self, multi_pod: bool = False, seq_sharded: bool = False,
                    model_axis: int = 16) -> Dict[str, Any]:
        """Mamba's cache specs, and the sites' KV caches as a dense
        model's (with ``seq_sharded`` and sharded heads, the sequence on
        'data' alone, as the reference has it)."""
        out = super().cache_specs(multi_pod, seq_sharded, model_axis)
        s = L.kv_cache_spec(self.cfg, multi_pod, seq_sharded, model_axis,
                            seq_batch_axis="data")
        out["attn_k"] = out["attn_v"] = s
        return out

    def forward_decode(self, params, cache: Dict[str, torch.Tensor],
                       tokens: torch.Tensor, cur_pos: int):
        """tokens: (B, 1) int; cur_pos: the KV write position → (logits
        (B, 1, V), cache), the cache updated IN PLACE: each site's KV at
        ``cur_pos`` (see :func:`repro_torch.models.layers.attention_decode`),
        and Mamba's conv window and state."""
        cfg = self.cfg
        x = L.embed(params["lm"]["embed"], tokens)         # (B, 1, d)
        for i in range(cfg.n_layers):
            x = self._layer_decode(x, layer_params(params["layers"], i),
                                   cache, i)
            site = self.attn_site(i)
            if site is not None:
                x = self._shared_block_decode(
                    params["shared"], x, cache["attn_k"][site],
                    cache["attn_v"][site], cur_pos)
        x = L.rmsnorm(x, params["lm"]["final_norm"], cfg.norm_eps)
        return x @ params["lm"]["unembed"], cache

    def _shared_block_decode(self, sp, x, cache_k, cache_v, cur_pos: int):
        """The shared block at one site, its KV written in place."""
        cfg = self.cfg
        h = L.rmsnorm(x, sp["ln1"], cfg.norm_eps)
        a, _, _ = L.attention_decode(sp["attn"], h, cache_k, cache_v,
                                     cur_pos, cfg)
        x = x + a
        h = L.rmsnorm(x, sp["ln2"], cfg.norm_eps)
        return x + L.mlp(sp["mlp"], h, cfg)
