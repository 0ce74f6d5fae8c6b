"""olmoe-1b-7b -- OLMoE 1B-active / 7B-total [arXiv:2409.02060; hf].

16L d_model=2048 16H (GQA kv=16) d_ff=1024 vocab=50304, MoE 64 experts
top-8, untied LM head; the reference's ``repro.configs.olmoe_1b_7b``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    head_dim=128,
    n_experts=64,
    experts_per_token=8,
    moe_shard="expert",
    act="silu",
    gated_mlp=True,
    norm="rms",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          head_dim=16, d_ff=32, vocab_size=512, n_experts=4,
                          experts_per_token=2)
