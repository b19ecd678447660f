"""Whisper-style encoder-decoder backbone (whisper-large-v3).

The conv/mel frontend is a STUB, as in the JAX package: precomputed frame
embeddings (B, S_frames, d) arrive as ``input_embeds`` and go straight into
the encoder.  Encoder: a non-causal self-attention stack.  Decoder: causal
self-attention, cross-attention to the encoder's output, MLP.  Decode
caches: the self-attention KV (grows) and the cross-attention KV (one
per layer over the encoder's frames, zeros until the caller fills it, as
in the JAX package).

Every attention over a full sequence, the cross-attention of a decode step
included, goes through the flash-attention dispatch, so on a card it is the
kernel: at a decode step one query row against the 1500 frames, not
causal.  The JAX package calls its plain ``ref.attention`` there
(``repro/models/whisper.py``); calling the port's plain version on a card
would be a fallback that hides the kernel, so the port does not.

On a mesh with an axis above 1 the encoder's and the decoder's attention,
the decode step's cross-attention included
(:func:`repro_torch.models.layers.cross_attention_decode`), go through
the head seams of :mod:`repro_torch.models.layers`; the encoder's memory
is whole on every rank of 'model', and the frames are placed like the
tokens.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import common as dt
from repro_torch.models import layers as L
from repro_torch.models.common import (ArchConfig, P, checked_remat_policy,
                                       remat, spec, stack_spec)
from repro_torch.models.transformer import layer_params

# the encoder's frames at whisper's 30-second window
ENC_LEN = 1500


class EncDecLM:
    def __init__(self, cfg: ArchConfig, attn_impl: Optional[str] = None,
                 remat_policy: str = "full"):
        self.cfg = cfg
        # as in the JAX package, any policy but "none" checkpoints the whole
        # body of each encoder and decoder layer ("dots" included)
        self.remat_policy = checked_remat_policy(remat_policy)
        self._remat = "none" if remat_policy == "none" else "full"
        # None: the device decides; "ref": the plain version; "kernel"
        self.attn_impl = attn_impl

    # ------------------------------------------------------------- params
    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random parameters drawn from ``gen``, on ``gen``'s device: the
        encoder's and the decoder's layers stacked by layer."""
        cfg, dev = self.cfg, gen.device

        def block(n, attn_names, n_norms):
            out = {name: L.init_attention(gen, cfg, device=dev, n_stack=n)
                   for name in attn_names}
            out["mlp"] = L.init_mlp(gen, cfg, device=dev, n_stack=n)
            for j in range(1, n_norms + 1):
                out[f"ln{j}"] = torch.ones((n, cfg.d_model), dtype=cfg.dtype,
                                           device=dev)
            return out
        return {"lm": L.init_lm(gen, cfg, device=dev),
                "enc": block(cfg.enc_layers, ("attn",), 2),
                "dec": block(cfg.n_layers, ("attn", "xattn"), 3)}

    def param_specs(self, multi_pod: bool = False) -> Dict[str, Any]:
        """The sharding specs of :meth:`init`'s tree."""
        attn = L.attention_specs(self.cfg, multi_pod)
        mlp = L.mlp_specs(self.cfg, multi_pod)
        enc = {"attn": attn, "mlp": mlp, "ln1": spec(None), "ln2": spec(None)}
        dec = {"attn": attn, "xattn": attn, "mlp": mlp, "ln1": spec(None),
               "ln2": spec(None), "ln3": spec(None)}
        return {"lm": L.lm_specs(multi_pod), "enc": stack_spec(enc),
                "dec": stack_spec(dec)}

    # ------------------------------------------------------------ encoder
    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, S_enc, d) stub-frontend embeddings, any float dtype
        (cast to ``cfg.dtype``) → memory (B, S_enc, d)."""
        cfg = self.cfg
        x = frames.to(cfg.dtype)
        pos = torch.arange(x.shape[1], device=x.device)

        def layer(x, lp):
            h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
            x = x + L.attention(lp["attn"], h, cfg, pos=pos, causal=False,
                                attn_impl=self.attn_impl)
            h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
            return x + L.mlp(lp["mlp"], h, cfg)
        body = remat(layer, self._remat)
        for i in range(cfg.enc_layers):
            x = body(x, layer_params(params["enc"], i))
        return x

    # ------------------------------------------------------------ decoder
    def forward_train(self, params, tokens: torch.Tensor,
                      input_embeds: Optional[torch.Tensor] = None,
                      last_only: bool = False) -> torch.Tensor:
        """tokens: (B, S_dec) int; input_embeds: (B, S_enc, d) frames →
        logits (B, S_dec, V), or (B, 1, V) with ``last_only``."""
        if input_embeds is None:
            raise ValueError(f"{self.cfg.arch_id} needs input_embeds: the "
                             f"encoder's frames")
        cfg = self.cfg
        memory = self.encode(params, input_embeds)
        x = L.embed(params["lm"]["embed"], tokens)
        pos = torch.arange(tokens.shape[1], device=x.device)

        def layer(x, lp, memory):
            h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
            x = x + L.attention(lp["attn"], h, cfg, pos=pos,
                                attn_impl=self.attn_impl)
            h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
            x = x + L.attention(lp["xattn"], h, cfg, pos=pos, memory=memory,
                                attn_impl=self.attn_impl)
            h = L.rmsnorm(x, lp["ln3"], cfg.norm_eps)
            return x + L.mlp(lp["mlp"], h, cfg)
        body = remat(layer, self._remat)
        for i in range(cfg.n_layers):
            x = body(x, layer_params(params["dec"], i), memory)
        if last_only:
            x = dt.same_placements(lambda t: t[:, -1:], x)
        x = L.rmsnorm(x, params["lm"]["final_norm"], cfg.norm_eps)
        return x @ params["lm"]["unembed"]

    def loss(self, params, batch) -> torch.Tensor:
        logits = self.forward_train(params, batch["tokens"],
                                    batch["input_embeds"])
        return L.cross_entropy(logits, batch["labels"])

    # ------------------------------------------------------------- serving
    def init_cache(self, batch: int, seq: int, dtype=None,
                   enc_len: int = ENC_LEN,
                   device=None) -> Dict[str, torch.Tensor]:
        """Self-attention KV ``k``/``v`` (layers, B, Hkv, seq, hd) and
        cross-attention KV ``xk``/``xv`` (layers, B, Hkv, enc_len, hd), all
        zeros in ``dtype`` (default ``cfg.dtype``)."""
        cfg = self.cfg
        dt = dtype or cfg.dtype
        kv = (cfg.n_layers, batch, cfg.n_kv_heads, seq, cfg.hd)
        xkv = (cfg.n_layers, batch, cfg.n_kv_heads, enc_len, cfg.hd)
        return {"k": torch.zeros(kv, dtype=dt, device=device),
                "v": torch.zeros(kv, dtype=dt, device=device),
                "xk": torch.zeros(xkv, dtype=dt, device=device),
                "xv": torch.zeros(xkv, dtype=dt, device=device)}

    def cache_specs(self, multi_pod: bool = False, seq_sharded: bool = False,
                    model_axis: int = 16) -> Dict[str, Any]:
        """The self-attention KV as a dense model's (``seq_sharded`` aside:
        the reference ignores it here); the 1500-frame cross KV, which
        'model' does not divide, on the batch axes alone where the heads
        do not divide either."""
        s = L.kv_cache_spec(self.cfg, multi_pod, False, model_axis)
        xs = s
        if self.cfg.n_kv_heads % model_axis:
            xs = P(None, ("pod", "data") if multi_pod else "data", None,
                   None, None)
        return {"k": s, "v": s, "xk": xs, "xv": xs}

    def forward_decode(self, params, cache: Dict[str, torch.Tensor],
                       tokens: torch.Tensor, cur_pos: int):
        """One decoder token against the self-attention KV cache and the
        fixed cross-attention KV → (logits (B, 1, V), cache), the
        self-attention KV written IN PLACE at ``cur_pos``."""
        cfg = self.cfg
        x = L.embed(params["lm"]["embed"], tokens)         # (B, 1, d)
        for i in range(cfg.n_layers):
            lp = layer_params(params["dec"], i)
            h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
            a, _, _ = L.attention_decode(lp["attn"], h, cache["k"][i],
                                         cache["v"][i], cur_pos, cfg)
            x = x + a
            # cross-attention against the precomputed encoder KV
            h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
            x = x + L.cross_attention_decode(lp["xattn"], h, cache["xk"][i],
                                             cache["xv"][i], cfg,
                                             self.attn_impl)
            h = L.rmsnorm(x, lp["ln3"], cfg.norm_eps)
            x = x + L.mlp(lp["mlp"], h, cfg)
        x = L.rmsnorm(x, params["lm"]["final_norm"], cfg.norm_eps)
        return x @ params["lm"]["unembed"], cache
