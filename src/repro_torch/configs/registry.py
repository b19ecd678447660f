"""--arch registry + input shapes + applicability rules."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.models.common import ArchConfig

from repro_torch.configs.yi_6b import CONFIG as yi_6b
from repro_torch.configs.qwen3_14b import CONFIG as qwen3_14b
from repro_torch.configs.llama3_8b import CONFIG as llama3_8b
from repro_torch.configs.nemotron_4_15b import CONFIG as nemotron_4_15b
from repro_torch.configs.mamba2_370m import CONFIG as mamba2_370m
from repro_torch.configs.mixtral_8x22b import CONFIG as mixtral_8x22b
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as qwen3_moe
from repro_torch.configs.zamba2_7b import CONFIG as zamba2_7b
from repro_torch.configs.whisper_large_v3 import CONFIG as whisper_large_v3
from repro_torch.configs.internvl2_76b import CONFIG as internvl2_76b

ALL_ARCHS: Dict[str, ArchConfig] = {
    "yi-6b": yi_6b,
    "qwen3-14b": qwen3_14b,
    "llama3-8b": llama3_8b,
    "nemotron-4-15b": nemotron_4_15b,
    "mamba2-370m": mamba2_370m,
    "mixtral-8x22b": mixtral_8x22b,
    "qwen3-moe-235b-a22b": qwen3_moe,
    "zamba2-7b": zamba2_7b,
    "whisper-large-v3": whisper_large_v3,
    "internvl2-76b": internvl2_76b,
}

# name -> (seq_len, global_batch, kind)
SHAPES: Dict[str, tuple] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def get_arch(arch_id: str) -> ArchConfig:
    if arch_id not in ALL_ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ALL_ARCHS)}")
    return ALL_ARCHS[arch_id]


def shape_applicable(cfg: ArchConfig, shape: str) -> Optional[str]:
    """None if the (arch, shape) cell runs; else a skip reason (recorded in
    EXPERIMENTS.md)."""
    if shape == "long_500k":
        if cfg.family == "audio":
            return ("enc-dec with a 30 s audio source window; a 500k-token "
                    "decoder cache is architecturally meaningless")
        if not cfg.is_subquadratic:
            # decode against a huge cache is linear per token, but the cache
            # itself (and its prefill) assumes full attention: per the task
            # statement full-attention archs skip long_500k, except those
            # with SWA / SSM state.
            return "pure full-attention arch (no sub-quadratic path)"
    return None


def reduced_config(cfg: ArchConfig) -> ArchConfig:
    """CPU-smoke-test sized variant of the same family: tiny depth/width,
    few experts, small vocab — exercises every code path of the family."""
    kw = dict(
        n_layers=2 if cfg.attn_every == 0 else 4,
        d_model=64,
        n_heads=4, n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128, vocab=256, head_dim=16,
    )
    if cfg.family == "moe":
        kw.update(n_experts=4, top_k=2, moe_d_ff=64)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    if cfg.attn_every:
        kw.update(attn_every=2)
    if cfg.enc_layers:
        kw.update(enc_layers=2)
    if cfg.window:
        kw.update(window=16)
    return dataclasses.replace(cfg, **kw)
