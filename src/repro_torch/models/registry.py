"""Model factory: ArchConfig → model object (family dispatch).

The port builds all six families of the JAX package: dense, vlm (whose
backbone is dense; its ViT frontend is a stub that arrives as
``input_embeds``), moe (:class:`~repro_torch.models.moe.MoeLM`), ssm
(:class:`~repro_torch.models.mamba2.MambaLM`), hybrid
(:class:`~repro_torch.models.zamba2.HybridLM`) and audio
(:class:`~repro_torch.models.whisper.EncDecLM`, whose conv frontend is a
stub that arrives as ``input_embeds``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.common import ArchConfig
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
