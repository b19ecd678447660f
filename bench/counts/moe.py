"""Operations and bytes of a Qwen3-MoE step (configuration-file keys).

Operations count two a multiply-add: every matrix product once with the
parameters a token uses (its top-k experts), attention as 4·D per visible
(query, key) pair per query head, the unembedding of the last position
only.  Bytes count each input read once and each output written once:
the weights the step needs (every expert's: a prefill step's picks hit
them all), the tokens, the logits."""

from __future__ import annotations

from typing import Dict


def _n(cfg: Dict):
    return (cfg["num_hidden_layers"], cfg["hidden_size"],
            cfg["num_attention_heads"], cfg["num_key_value_heads"],
            cfg["head_dim"], cfg["num_experts"], cfg["num_experts_per_tok"],
            cfg["moe_intermediate_size"], cfg["vocab_size"])


def prefill(cfg: Dict, batch: int, seq: int, elt: int = 2
            ) -> Dict[str, float]:
    L, d, hq, hkv, D, E, k, F, V = _n(cfg)
    t = batch * seq
    proj = d * (hq + 2 * hkv) * D + hq * D * d
    pairs = batch * hq * seq * (seq + 1) // 2          # causal, per layer
    attn_flops = L * pairs * 4 * D
    flops = (2 * t * L * (proj + d * E + k * 3 * d * F) + attn_flops
             + 2 * batch * d * V)
    weights = L * ((proj + E * 3 * d * F) * elt + d * E * 4) + d * V * elt
    nbytes = weights + t * 8 + batch * V * elt
    attn_bytes = L * batch * seq * (2 * hq + 2 * hkv) * D * elt

    def norm(rows, width):
        return rows * width * 2 * elt + width * elt
    rms = L * (2 * norm(t, d) + norm(t * hq, D) + norm(t * hkv, D)) \
        + norm(batch, d)
    return {"flops": flops, "bytes": nbytes, "tokens": t,
            "attn_flops": attn_flops, "attn_bytes": attn_bytes,
            "rmsnorm_bytes": rms, "rmsnorm_calls": 4 * L + 1}
