"""Qwen3-MoE configurations on the port's ``MoeLM``.

The benchmark draws the weights itself (the reference's names, see
:mod:`bench.reference.qwen3_moe`) and hands the program the same tensors
in its parameter tree; the program's ``init`` is never called."""

from __future__ import annotations

from typing import Any, Dict

import torch

from bench import draw
from bench.reference import qwen3_moe as reference

REFERENCE = reference


def arch(cfg: Dict, dtype: torch.dtype):
    """The program's ``ArchConfig`` for the configuration file ``cfg``, with
    the capacity factor the file states."""
    from repro_torch.models.common import ArchConfig
    return ArchConfig(
        arch_id=cfg["name"], family="moe",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["moe_intermediate_size"], vocab=cfg["vocab_size"],
        head_dim=cfg["head_dim"], qk_norm=True, activation="swiglu",
        rope_theta=cfg["rope_theta"], n_experts=cfg["num_experts"],
        top_k=cfg["num_experts_per_tok"],
        moe_d_ff=cfg["moe_intermediate_size"],
        capacity_factor=cfg["assumed"]["capacity_factor"],
        norm_eps=cfg["rms_norm_eps"], dtype=dtype)


def build(cfg: Dict, dtype: torch.dtype, **options: Any):
    from repro_torch.models.registry import build_model
    return build_model(arch(cfg, dtype), **options)


def weights(cfg: Dict, seed: int, device, dtype: torch.dtype,
            table_rows: int) -> Dict[str, torch.Tensor]:
    """The reference's weights drawn from ``seed`` on ``device``, one draw a
    stacked tensor: matrices Normal(0, initializer_range) as published,
    the router in float32, norm weights 1 + 0.05 Normal(0, 1)."""
    n = reference.dims(cfg)
    L, d, D, E, Fw = n["L"], n["d"], n["D"], n["E"], n["F"]
    std = cfg["initializer_range"]
    shapes = {
        "embed": (table_rows, d), "unembed": (d, table_rows),
        "wq": (L, d, n["hq"] * D), "wk": (L, d, n["hkv"] * D),
        "wv": (L, d, n["hkv"] * D), "wo": (L, n["hq"] * D, d),
        "router": (L, d, E), "w_gate": (L, E, d, Fw), "w_up": (L, E, d, Fw),
        "w_down": (L, E, Fw, d)}
    norms = {"final_norm": (d,), "ln1": (L, d), "ln2": (L, d),
             "q_norm": (L, D), "k_norm": (L, D)}
    W = {}
    for name, shape in shapes.items():
        gen = draw.generator(device, seed, "weights", name)
        dt = torch.float32 if name == "router" else dtype
        W[name] = draw.normal(gen, shape, std, dt)
    for name, shape in norms.items():
        gen = draw.generator(device, seed, "weights", name)
        W[name] = draw.normal(gen, shape, 0.05, dtype, mean=1.0)
    return W


def params(W: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The program's parameter tree over the same tensors (no copies)."""
    return {"lm": {k: W[k] for k in ("embed", "unembed", "final_norm")},
            "layers": {
                "attn": {k: W[k] for k in ("wq", "wk", "wv", "wo", "q_norm",
                                           "k_norm")},
                "moe": {k: W[k] for k in ("router", "w_gate", "w_up",
                                          "w_down")},
                "ln1": W["ln1"], "ln2": W["ln2"]}}

