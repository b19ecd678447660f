"""Model factory: ArchConfig → model object (family dispatch).

The port builds the dense family, the vlm family (whose backbone is
dense; its ViT frontend is a stub that arrives as ``input_embeds``), the
moe family (:class:`~repro_torch.models.moe.MoeLM`) and the ssm family
(:class:`~repro_torch.models.mamba2.MambaLM`).  The hybrid and audio
families wait for the model-families slice of ``ROADMAP.md``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.common import ArchConfig
from repro_torch.models.mamba2 import MambaLM
from repro_torch.models.moe import MoeLM
from repro_torch.models.transformer import DenseLM

# families the port does not build yet → the JAX module that holds them
_PENDING = {"hybrid": "zamba2.py", "audio": "whisper.py"}
# the JAX package's ssd_dtype lever, by name
SSD_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def build_model(cfg: ArchConfig, attn_impl: Optional[str] = None,
                ssd_dtype: str = "f32", moe_grouped: bool = False,
                parallel_block: bool = False):
    """Family dispatch.  ``attn_impl``: None (the device decides), "ref"
    or "kernel", for the families with attention; ``ssd_dtype`` ("f32" or
    "bf16") and ``moe_grouped`` are the JAX package's levers for the ssm
    and moe families, and ``parallel_block`` the beyond-paper PaLM-style
    block of the dense family; each is ignored by the families it does not
    apply to, as in the JAX package."""
    if cfg.family in ("dense", "vlm"):
        return DenseLM(cfg, attn_impl=attn_impl,
                       parallel_block=parallel_block)
    if cfg.family == "moe":
        return MoeLM(cfg, attn_impl=attn_impl, moe_grouped=moe_grouped)
    if cfg.family == "ssm":
        if ssd_dtype not in SSD_DTYPES:
            raise ValueError(f"ssd_dtype {ssd_dtype!r} not in "
                             f"{sorted(SSD_DTYPES)}")
        return MambaLM(cfg, ssd_dtype=SSD_DTYPES[ssd_dtype])
    if cfg.family in _PENDING:
        raise NotImplementedError(
            f"{cfg.arch_id}: the {cfg.family} family (repro/models/"
            f"{_PENDING[cfg.family]}) is not ported yet; it comes with the "
            f"model-families slice of ROADMAP.md")
    raise ValueError(f"unknown family {cfg.family!r}")


def get_config(arch_id: str) -> ArchConfig:
    from repro_torch.configs.registry import get_arch
    return get_arch(arch_id)
