"""qwen3-moe-235b-a22b [moe]: 128 experts top-8, qk_norm.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab=151936, head_dim=128,
    n_experts=128, top_k=8, moe_d_ff=1536,
    qk_norm=True, activation="swiglu", rope_theta=1e6,
)
