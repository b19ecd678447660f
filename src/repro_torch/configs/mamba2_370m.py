"""mamba2-370m [ssm]: SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, head_dim=64,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
)
