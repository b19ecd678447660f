"""Dense decoder-only GQA transformer (yi-6b, qwen3-14b, llama3-8b,
nemotron-4-15b, and the internvl2 backbone).

Parameters keep the JAX package's stacked layout (a leading layer axis on
every per-layer tensor); where the JAX model scans over that axis, this one
loops over the layer index in Python.  Training bodies are checkpointed by
``remat_policy`` (:func:`repro_torch.models.common.remat`), as the JAX
model's are ``jax.checkpoint``-ed.  On a mesh with an axis above 1 the
parameters, the cache and the inputs are DTensors and the layers run
through the seams of :mod:`repro_torch.models.layers`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import common as dt
from repro_torch.models import layers as L
from repro_torch.models.common import (ArchConfig, checked_remat_policy,
                                       remat, spec, stack_spec)


def layer_params(stacked: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a stacked parameter tree: views, no copies.  A leaf
    may also be a list of per-layer tensors (the train step hands the
    layers over so, to take each layer's gradient on its own)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def _frontend_first(embeds: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The stub frontend's (B, P, d) embeddings in place of the first P
    token embeddings of x (B, S, d)."""
    p = embeds.shape[1]
    return torch.cat([embeds.to(x.dtype), x[:, p:]], dim=1)


class DenseLM:
    def __init__(self, cfg: ArchConfig, attn_impl: Optional[str] = None,
                 parallel_block: bool = False, remat_policy: str = "full"):
        self.cfg = cfg
        self.remat_policy = checked_remat_policy(remat_policy)
        # None: the device decides (the flash kernel on a card, the plain
        # version on the CPU); "ref": the plain version; "kernel": the kernel
        self.attn_impl = attn_impl
        # PaLM-style parallel attention+MLP block.  BEYOND-PAPER VARIANT:
        # changes layer topology, so it is never the default for an
        # assigned arch.
        self.parallel_block = parallel_block

    # ------------------------------------------------------------- params
    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random parameters drawn from ``gen``, on ``gen``'s device."""
        cfg, dev = self.cfg, gen.device
        n = cfg.n_layers
        lm = L.init_lm(gen, cfg, device=dev)
        layers = {
            "attn": L.init_attention(gen, cfg, device=dev, n_stack=n),
            "mlp": L.init_mlp(gen, cfg, device=dev, n_stack=n),
            "ln1": torch.ones((n, cfg.d_model), dtype=cfg.dtype, device=dev),
            "ln2": torch.ones((n, cfg.d_model), dtype=cfg.dtype, device=dev),
        }
        return {"lm": lm, "layers": layers}

    def param_specs(self, multi_pod: bool = False) -> Dict[str, Any]:
        """The sharding specs of :meth:`init`'s tree."""
        layer = {"attn": L.attention_specs(self.cfg, multi_pod),
                 "mlp": L.mlp_specs(self.cfg, multi_pod),
                 "ln1": spec(None), "ln2": spec(None)}
        return {"lm": L.lm_specs(multi_pod), "layers": stack_spec(layer)}

    # ------------------------------------------------------------ training
    def _layer_train(self, x, lp, pos):
        cfg = self.cfg
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        if self.parallel_block:
            # attn and MLP read the same normed input
            return x + L.attention(lp["attn"], h, cfg, pos=pos,
                                   attn_impl=self.attn_impl) \
                     + L.mlp(lp["mlp"], h, cfg)
        x = x + L.attention(lp["attn"], h, cfg, pos=pos,
                            attn_impl=self.attn_impl)
        h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        return x + L.mlp(lp["mlp"], h, cfg)

    def forward_train(self, params, tokens: torch.Tensor,
                      input_embeds: Optional[torch.Tensor] = None,
                      last_only: bool = False) -> torch.Tensor:
        """tokens: (B, S) int → logits (B, S, V), or (B, 1, V) with
        ``last_only`` (only the last position is unembedded).

        input_embeds: optional (B, P, d) stub-frontend embeddings (vision
        patches / audio frames) that REPLACE the first P token embeddings.
        """
        cfg = self.cfg
        x = L.embed(params["lm"]["embed"], tokens)         # (B, S, d)
        if input_embeds is not None:
            x = dt.same_placements(_frontend_first, input_embeds, x)
        pos = torch.arange(tokens.shape[1], device=x.device)
        body = remat(self._layer_train, self.remat_policy)
        for i in range(cfg.n_layers):
            x = body(x, layer_params(params["layers"], i), pos)
        if last_only:
            x = dt.same_placements(lambda t: t[:, -1:], x)
        x = L.rmsnorm(x, params["lm"]["final_norm"], cfg.norm_eps)
        return x @ params["lm"]["unembed"]

    def loss(self, params, batch) -> torch.Tensor:
        logits = self.forward_train(params, batch["tokens"],
                                    batch.get("input_embeds"))
        return L.cross_entropy(logits, batch["labels"])

    # ------------------------------------------------------------- serving
    def init_cache(self, batch: int, seq: int, dtype=None,
                   device=None) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, seq, cfg.hd)
        dt = dtype or cfg.dtype
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    def cache_specs(self, multi_pod: bool = False, seq_sharded: bool = False,
                    model_axis: int = 16) -> Dict[str, Any]:
        """The sharding specs of :meth:`init_cache`'s tree."""
        s = L.kv_cache_spec(self.cfg, multi_pod, seq_sharded, model_axis)
        return {"k": s, "v": s}

    def forward_decode(self, params, cache: Dict[str, torch.Tensor],
                       tokens: torch.Tensor, cur_pos: int):
        """tokens: (B, 1) int; cur_pos: the write position.  Returns
        (logits (B, 1, V), cache), with the cache updated IN PLACE (see
        :func:`repro_torch.models.layers.attention_decode`)."""
        cfg = self.cfg
        x = L.embed(params["lm"]["embed"], tokens)         # (B, 1, d)
        for i in range(cfg.n_layers):
            x = self._layer_decode(x, layer_params(params["layers"], i),
                                   cache["k"][i], cache["v"][i], cur_pos)
        x = L.rmsnorm(x, params["lm"]["final_norm"], cfg.norm_eps)
        return x @ params["lm"]["unembed"], cache

    def _layer_decode(self, x, lp, cache_k, cache_v, cur_pos: int):
        cfg = self.cfg
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        a, _, _ = L.attention_decode(lp["attn"], h, cache_k, cache_v,
                                     cur_pos, cfg)
        x = x + a
        h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        return x + L.mlp(lp["mlp"], h, cfg)
