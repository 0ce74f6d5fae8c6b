"""granite-34b -- IBM Granite 34B Code [arXiv:2405.04324; hf].

88L d_model=6144 48H MQA (kv=1) d_ff=24576 vocab=49152, llama-style
blocks, untied LM head; the reference's ``repro.configs.granite_34b``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    act="silu",
    gated_mlp=True,
    norm="rms",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
                          head_dim=16, d_ff=128, vocab_size=512)
