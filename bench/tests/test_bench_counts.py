"""The benchmark's operation and byte counts against values worked by hand
at tiny shapes."""

import pytest

from bench.counts import moe, peaks

MOE = {"num_hidden_layers": 1, "hidden_size": 8, "num_attention_heads": 2,
       "num_key_value_heads": 1, "head_dim": 4, "num_experts": 4,
       "num_experts_per_tok": 2, "moe_intermediate_size": 6,
       "vocab_size": 10}


def test_moe_prefill_by_hand():
    c = moe.prefill(MOE, batch=1, seq=3)
    # a token: q 8·8, k and v 8·4 each, o 8·8 = 192 parameters; router
    # 8·4 = 32; two experts of 3·8·6 = 144 each; 2·(192 + 32 + 288) = 1024
    # a token, 3 tokens; causal pairs 1+2+3 = 6 a head, 2 heads, 4·4 each;
    # the last position's unembedding 2·8·10
    assert c["attn_flops"] == 6 * 2 * 16
    assert c["flops"] == 3 * 1024 + 6 * 2 * 16 + 160
    # norms: ln1, ln2 (3 rows of 8), q (6 rows of 4), k (3 rows of 4) and
    # the final one (1 row of 8): rows·width·2·2 bytes + width·2
    assert c["rmsnorm_bytes"] == (2 * (96 + 16) + (96 + 8) + (48 + 8)
                                  + (32 + 16))
    assert c["rmsnorm_calls"] == 5


def test_moe_prefill_bytes_by_hand():
    c = moe.prefill(MOE, batch=2, seq=3)
    # weights in bf16: 192 attention, 4 experts of 144 and the unembedding
    # 80; the float32 router 32; the tokens' int64 ids, the last logits
    weights = (192 + 4 * 144) * 2 + 32 * 4 + 80 * 2
    assert c["bytes"] == weights + 6 * 8 + 2 * 10 * 2
    # q, k, v and the output once: 6 tokens · (2 + 2 + 1 + 1) heads of 4
    assert c["attn_bytes"] == 6 * (2 * 2 + 2 * 1) * 4 * 2
    assert c["tokens"] == 6


def test_peaks_and_least_time():
    h100 = peaks.peaks("NVIDIA H100 80GB HBM3")
    assert h100["bf16_flops_s"] == 989e12
    assert peaks.peaks("cpu") is None
    assert peaks.least_seconds(989e12, 1.0, h100) == pytest.approx(1.0)
    assert peaks.least_seconds(1.0, 3.35e12, h100) == pytest.approx(1.0)
