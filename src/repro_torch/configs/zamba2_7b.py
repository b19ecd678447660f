"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; unverified]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, head_dim=112,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    attn_every=6, activation="swiglu",
)
