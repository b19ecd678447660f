"""Dense decoder-only GQA transformer (yi-6b, qwen3-14b, llama3-8b,
nemotron-4-15b, and the internvl2 backbone).

Parameters keep the JAX package's stacked layout (a leading layer axis on
every per-layer tensor); where the JAX model scans over that axis, this one
loops over the layer index in Python.  Training bodies are checkpointed by
``remat_policy`` (:func:`repro_torch.models.common.remat`), as the JAX
model's are ``jax.checkpoint``-ed.  On a mesh with an axis above 1 the
parameters, the cache and the inputs are DTensors and the layers run
through the seams of :mod:`repro_torch.models.layers`; with
``act_sharding`` set, a prefill shards the activations' sequence on
'model' (context-parallel prefill).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Shard

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


def _frontend(embeds: torch.Tensor, x: torch.Tensor,
              s0: int = 0) -> torch.Tensor:
    """The stub frontend's (B, P, d) embeddings in place of the token
    embeddings at positions below P of x (B, n, d), the block of a
    sequence that starts at position ``s0`` (the whole sequence at 0)."""
    k = max(0, min(embeds.shape[1] - s0, x.shape[1]))
    if not k:
        return x
    return torch.cat([embeds[:, s0:s0 + k].to(x.dtype), x[:, k:]], dim=1)


def _sequence_dims(act_sharding, table):
    """The mesh dimensions that ``act_sharding`` shards the sequence over
    (``Shard(1)``), where the parameters (``table``) are DTensors; else
    None: the activations then take the parameters' layout."""
    if act_sharding is None or not isinstance(table, DTensor):
        return None
    dims = tuple(i for i, p in enumerate(act_sharding) if p == Shard(1))
    return dims or None


def _with_frontend(embeds, x, s0: int):
    """:func:`_frontend` on x's rows (a DTensor's local block, its
    gradient of ``embeds`` a partial sum where x's sequence is sharded
    and ``embeds``' is not)."""
    if not isinstance(x, DTensor):
        return _frontend(embeds, x, s0)
    embeds = dt.as_dtensor(embeds, x.device_mesh)
    seq = dt.mesh_dims(x, 1)
    el = embeds.to_local(grad_placements=dt.with_placement(
        embeds.placements, seq, Partial()))
    return dt.from_local(_frontend(el, x.to_local(), s0), x.device_mesh,
                         x.placements, shape=x.shape)


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
        # context-parallel prefill: None, or the DTensor placements of the
        # (B, S, d) layer-boundary activations on the parameters' mesh
        # (the batch on the data axes, the sequence, Shard(1), on
        # 'model'), which forward_train pins to the embedding output and
        # to every layer's output.  The dry run sets it on prefill cells
        # (--seq-shard-prefill); the loss and decode never read it.
        self.act_sharding = None

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

        With ``act_sharding`` set and the parameters on a mesh whose
        'model' axis is above 1, the sequence is sharded on 'model' from
        the embedding output on (context-parallel prefill): each rank runs
        every layer on its block of positions (see
        :func:`repro_torch.models.layers.attention`), ``last_only`` takes
        the last position from the rank that holds it, and the whole
        logits come back sharded along the sequence.
        """
        return self._forward(params, tokens, input_embeds, last_only,
                             self.act_sharding)

    def _forward(self, params, tokens, input_embeds, last_only: bool,
                 act_sharding):
        cfg = self.cfg
        table = params["lm"]["embed"]
        seq = _sequence_dims(act_sharding, table)
        x = L.embed(table, tokens, seq)                    # (B, S, d)
        s0, n = dt.offset(x, 1), dt.local(x).shape[1]
        if input_embeds is not None:
            x = _with_frontend(input_embeds, x, s0)
        pos = torch.arange(s0, s0 + n, device=dt.local(x).device)
        body = remat(self._layer_train, self.remat_policy)
        # every seam returns x's placements: each layer's output keeps the
        # embedding output's, as the reference's constraint pins them
        for i in range(cfg.n_layers):
            x = body(x, layer_params(params["layers"], i), pos)
        w = params["lm"]["unembed"]
        if last_only:
            x = L.last_position(x) if seq else \
                dt.same_placements(lambda t: t[:, -1:], x)
        elif seq:
            # the whole logits, sharded along the sequence as x
            x = L.rmsnorm(x, params["lm"]["final_norm"], cfg.norm_eps)
            return dt.from_local(dt.local(x) @ dt.whole(w, x),
                                 x.device_mesh, x.placements,
                                 shape=(*x.shape[:2], w.shape[1]))
        x = L.rmsnorm(x, params["lm"]["final_norm"], cfg.norm_eps)
        return x @ w

    def loss(self, params, batch) -> torch.Tensor:
        logits = self._forward(params, batch["tokens"],
                               batch.get("input_embeds"), False, None)
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
