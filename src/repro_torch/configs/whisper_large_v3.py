"""whisper-large-v3 [audio]: enc-dec, conv frontend STUB (input_specs
provides precomputed frame embeddings). [arXiv:2212.04356; unverified]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866, head_dim=64,
    enc_layers=32, frontend="audio", activation="swiglu",
)
