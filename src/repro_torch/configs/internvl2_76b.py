"""internvl2-76b [vlm]: InternViT frontend STUB + InternLM2-76B backbone.
[arXiv:2404.16821; unverified]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, head_dim=128,
    frontend="vision", activation="swiglu", rope_theta=5e5,
)
