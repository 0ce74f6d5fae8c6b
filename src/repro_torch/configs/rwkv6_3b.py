"""rwkv6-3b -- RWKV-6 "Finch" 3B [arXiv:2404.05892; hf].

32L d_model=2560 (attention-free, data-dependent decay) d_ff=8960
vocab=65536; the reference's ``repro.configs.rwkv6_3b``.  40 heads of
``rwkv_head_size`` 64 carry the recurrent state; sub-quadratic.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="rwkv",
    n_layers=32,
    d_model=2560,
    n_heads=40,              # d_model / rwkv_head_size
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    head_dim=64,
    rwkv_head_size=64,
    gated_mlp=False,         # RWKV channel-mix is its own structure
    act="relu2",
    norm="layer",
    subquadratic=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          head_dim=16, rwkv_head_size=16, d_ff=128,
                          vocab_size=512)
