"""mixtral-8x22b [moe]: 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=32768, head_dim=128,
    n_experts=8, top_k=2, moe_d_ff=16384,
    window=4096, activation="swiglu", rope_theta=1e6,
)
