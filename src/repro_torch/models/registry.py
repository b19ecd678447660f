"""Model factory: ArchConfig → model object (family dispatch).

The port builds the dense family and the vlm family (whose backbone is
dense; its ViT frontend is a stub that arrives as ``input_embeds``).  The
other families wait for the model-families slice of ``ROADMAP.md``.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import DenseLM

# families the port does not build yet → the JAX module that holds them
_PENDING = {"moe": "moe.py", "ssm": "mamba2.py", "hybrid": "zamba2.py",
            "audio": "whisper.py"}


def build_model(cfg: ArchConfig, attn_impl: Optional[str] = None,
                parallel_block: bool = False) -> DenseLM:
    """Family dispatch.  ``attn_impl``: None (the device decides), "ref"
    or "kernel"; ``parallel_block`` is the beyond-paper PaLM-style block."""
    if cfg.family in ("dense", "vlm"):
        return DenseLM(cfg, attn_impl=attn_impl,
                       parallel_block=parallel_block)
    if cfg.family in _PENDING:
        raise NotImplementedError(
            f"{cfg.arch_id}: the {cfg.family} family (repro/models/"
            f"{_PENDING[cfg.family]}) is not ported yet; it comes with the "
            f"model-families slice of ROADMAP.md")
    raise ValueError(f"unknown family {cfg.family!r}")


def get_config(arch_id: str) -> ArchConfig:
    from repro_torch.configs.registry import get_arch
    return get_arch(arch_id)
