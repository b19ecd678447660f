"""Mamba2 configurations on the port's ``MambaLM``.

The benchmark draws the weights itself as mamba_ssm initialises them
(the reference's names, see :mod:`bench.reference.mamba2`) and hands the
program the same tensors in its parameter tree; the program's ``init``
is never called."""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from bench import draw
from bench.reference import mamba2 as reference

REFERENCE = reference


def arch(cfg: Dict, dtype: torch.dtype):
    """The program's ``ArchConfig`` for the configuration file ``cfg``: the
    vocabulary as the published model pads it."""
    from repro_torch.models.common import ArchConfig
    if cfg["ngroups"] != 1:
        raise ValueError("the port's Mamba2 block has one group")
    if cfg["conv_bias"] or cfg["residual_in_fp32"]:
        raise ValueError("the port's Mamba2 block has no conv bias and keeps "
                         "its residual in the model's dtype")
    m = cfg["pad_vocab_size_multiple"]
    return ArchConfig(
        arch_id=cfg["name"], family="ssm", n_layers=cfg["n_layer"],
        d_model=cfg["d_model"], n_heads=0, n_kv_heads=0, d_ff=0,
        vocab=-(-cfg["vocab_size"] // m) * m, head_dim=cfg["headdim"],
        ssm_state=cfg["d_state"], ssm_head_dim=cfg["headdim"],
        ssm_expand=cfg["expand"], ssm_chunk=cfg["chunk_size"],
        conv_width=cfg["d_conv"], norm_eps=cfg["rms_norm_eps"], dtype=dtype)


def build(cfg: Dict, dtype: torch.dtype, **options: Any):
    from repro_torch.models.registry import build_model
    return build_model(arch(cfg, dtype), **options)


def weights(cfg: Dict, seed: int, device, dtype: torch.dtype,
            table_rows: int) -> Dict[str, torch.Tensor]:
    """The reference's weights drawn from ``seed`` on ``device``, one draw a
    stacked tensor, as mamba_ssm initialises a Mamba2 LM (the configuration
    file's ``assumed.weights``)."""
    n = reference.dims(cfg)
    L, d, di, N, H, K = n["L"], n["d"], n["di"], n["N"], n["H"], n["K"]
    f32 = torch.float32

    def gen(name):
        return draw.generator(device, seed, "weights", name)
    W = {"embed": draw.normal(gen("embed"), (table_rows, d),
                              cfg["initializer_range"], dtype)}
    W["unembed"] = W["embed"].t()                       # tied
    bound = d ** -0.5
    W["in_proj"] = draw.uniform(gen("in_proj"), (L, d, 2 * di + 2 * N + H),
                                -bound, bound, dtype)
    bound = di ** -0.5 / math.sqrt(L)                   # rescaled residual
    W["out_proj"] = draw.uniform(gen("out_proj"), (L, di, d), -bound, bound,
                                 dtype)
    bound = K ** -0.5
    W["conv_w"] = draw.uniform(gen("conv_w"), (L, K, di + 2 * N), -bound,
                               bound, dtype)
    lo, hi = cfg["A_init_range"]
    W["A_log"] = draw.uniform(gen("A_log"), (L, H), lo, hi, f32).log_()
    dt = draw.uniform(gen("dt"), (L, H), math.log(cfg["dt_min"]),
                      math.log(cfg["dt_max"]), f32).exp_()
    dt = dt.clamp_min(cfg["dt_init_floor"])
    W["dt_bias"] = dt + torch.log(-torch.expm1(-dt))    # softplus⁻¹(dt)
    W["D"] = torch.ones((L, H), dtype=f32, device=device)
    for name, shape in (("final_norm", (d,)), ("ln", (L, d)),
                        ("norm", (L, di))):
        W[name] = draw.normal(gen(name), shape, 0.05, dtype, mean=1.0)
    return W


def params(W: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The program's parameter tree over the same tensors (no copies)."""
    return {"lm": {k: W[k] for k in ("embed", "unembed", "final_norm")},
            "layers": {
                "mamba": {k: W[k] for k in ("in_proj", "conv_w", "A_log",
                                            "D", "dt_bias", "norm",
                                            "out_proj")},
                "ln": W["ln"]}}
