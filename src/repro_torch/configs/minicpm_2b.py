"""minicpm-2b -- MiniCPM 2.4B [arXiv:2404.06395; hf].

40L d_model=2304 36H (kv=36) d_ff=5760 vocab=122753, llama-like blocks,
tied embeddings; the reference's ``repro.configs.minicpm_2b``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    head_dim=64,
    tie_embeddings=True,
    act="silu",
    gated_mlp=True,
    norm="rms",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          head_dim=16, d_ff=128, vocab_size=512)
