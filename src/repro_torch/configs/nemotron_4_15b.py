"""nemotron-4-15b -- Nemotron-4 15B [arXiv:2402.16819; unverified].

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000, squared-ReLU MLP
(non-gated: the activation runs in the up projection's epilogue),
LayerNorm, untied LM head; the reference's
``repro.configs.nemotron_4_15b``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    head_dim=128,
    act="relu2",
    gated_mlp=False,
    norm="layer",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab_size=512)
