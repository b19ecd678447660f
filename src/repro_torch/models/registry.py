"""Model factory: ArchConfig → model object (family dispatch).

The port builds all six families of the JAX package: dense, vlm (whose
backbone is dense; its ViT frontend is a stub that arrives as
``input_embeds``), moe (:class:`~repro_torch.models.moe.MoeLM`), ssm
(:class:`~repro_torch.models.mamba2.MambaLM`), hybrid
(:class:`~repro_torch.models.zamba2.HybridLM`) and audio
(:class:`~repro_torch.models.whisper.EncDecLM`, whose conv frontend is a
stub that arrives as ``input_embeds``); and each step's inputs as
meta-device tensors (``input_specs``, the port's ``jax.ShapeDtypeStruct``
stand-ins: shapes and dtypes, no storage) with their sharding specs
(``input_shardings``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models.common import ArchConfig, P
from repro_torch.models.mamba2 import MambaLM
from repro_torch.models.moe import MoeLM
from repro_torch.models.transformer import DenseLM
from repro_torch.models.whisper import EncDecLM
from repro_torch.models.zamba2 import HybridLM

# the JAX package's ssd_dtype lever, by name
SSD_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def build_model(cfg: ArchConfig, remat_policy: str = "full",
                attn_impl: Optional[str] = None, ssd_dtype: str = "f32",
                moe_grouped: bool = False, parallel_block: bool = False):
    """Family dispatch.  ``remat_policy`` ("full", "dots" or "none")
    checkpoints each layer body of a training forward, as in the JAX
    package (whose audio family takes "dots" as "full");
    ``attn_impl``: None (the device decides), "ref" or "kernel", for the
    families with attention; ``ssd_dtype`` ("f32" or "bf16") and
    ``moe_grouped`` are the JAX package's levers for the ssm and hybrid
    families and the moe family, and ``parallel_block`` the beyond-paper
    PaLM-style block of the dense family; each is ignored by the families
    it does not apply to, as in the JAX package."""
    if cfg.family in ("dense", "vlm"):
        return DenseLM(cfg, attn_impl=attn_impl,
                       parallel_block=parallel_block,
                       remat_policy=remat_policy)
    if cfg.family == "moe":
        return MoeLM(cfg, attn_impl=attn_impl, moe_grouped=moe_grouped,
                     remat_policy=remat_policy)
    if cfg.family in ("ssm", "hybrid"):
        if ssd_dtype not in SSD_DTYPES:
            raise ValueError(f"ssd_dtype {ssd_dtype!r} not in "
                             f"{sorted(SSD_DTYPES)}")
        if cfg.family == "ssm":
            return MambaLM(cfg, ssd_dtype=SSD_DTYPES[ssd_dtype],
                           remat_policy=remat_policy)
        return HybridLM(cfg, attn_impl=attn_impl,
                        ssd_dtype=SSD_DTYPES[ssd_dtype],
                        remat_policy=remat_policy)
    if cfg.family == "audio":
        return EncDecLM(cfg, attn_impl=attn_impl, remat_policy=remat_policy)
    raise ValueError(f"unknown family {cfg.family!r}")


def get_config(arch_id: str) -> ArchConfig:
    from repro_torch.configs.registry import get_arch
    return get_arch(arch_id)


# -------------------------------------------------------------- input specs

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, seq: int, batch: int, kind: str,
                multi_pod: bool = False) -> Dict[str, torch.Tensor]:
    """Meta-device stand-ins for every model input of a step.

    train/prefill: {tokens, labels [, input_embeds]}, the full sequence
    (the stub vision frontend's patches are 1/8 of it; the stub audio
    frontend's encoder sees ``seq`` frames and the decoder seq // 4
    tokens, at least 8).  decode: {tokens (B, 1), cur_pos}; the KV or SSM
    cache is part of the step's state (``cache_specs``, ``init_cache``).
    """
    i32 = torch.int32
    if kind in ("train", "prefill"):
        if cfg.frontend == "audio":
            n = max(8, seq // 4)
            return {"tokens": _meta((batch, n), i32),
                    "labels": _meta((batch, n), i32),
                    "input_embeds": _meta((batch, seq, cfg.d_model),
                                          torch.float32)}
        specs = {"tokens": _meta((batch, seq), i32),
                 "labels": _meta((batch, seq), i32)}
        if cfg.frontend == "vision":
            specs["input_embeds"] = _meta(
                (batch, max(1, seq // 8), cfg.d_model), torch.float32)
        return specs
    if kind == "decode":
        return {"tokens": _meta((batch, 1), i32), "cur_pos": _meta((), i32)}
    raise ValueError(f"unknown kind {kind}")


def input_shardings(cfg: ArchConfig, kind: str, multi_pod: bool = False,
                    batch_size: Optional[int] = None) -> Dict[str, P]:
    """The inputs' specs: the batch over the data axes, replicated where
    ``batch_size`` does not divide them (a thin batch, e.g. long_500k)."""
    batch = ("pod", "data") if multi_pod else ("data",)
    shards = 32 if multi_pod else 16
    if batch_size is not None and batch_size % shards != 0:
        batch = ()
    lead = batch if batch else None
    if kind in ("train", "prefill"):
        sh = {"tokens": P(lead, None), "labels": P(lead, None)}
        if cfg.frontend is not None:
            sh["input_embeds"] = P(lead, None, None)
        return sh
    return {"tokens": P(lead, None), "cur_pos": P()}
