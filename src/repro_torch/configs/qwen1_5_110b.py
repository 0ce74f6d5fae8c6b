"""qwen1.5-110b -- Qwen1.5 110B [hf:Qwen/Qwen1.5-0.5B; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064, QKV bias,
rope theta 1e6, untied LM head; the reference's
``repro.configs.qwen1_5_110b`` (whose optimizer-state dtype and FSDP
policy the port has no field for yet).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e6,
    act="silu",
    gated_mlp=True,
    norm="rms",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab_size=512)
