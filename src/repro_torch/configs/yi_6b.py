"""yi-6b [dense]: llama-arch GQA. [arXiv:2403.04652; hf]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab=64000, head_dim=128,
    activation="swiglu", rope_theta=5e6,
)
