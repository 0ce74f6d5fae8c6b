"""hymba-1.5b -- NVIDIA Hymba hybrid-head model [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16;
the reference's ``repro.configs.hymba_1_5b``.  Attention heads and a
selective-SSM branch run side by side in every block and are fused;
sliding-window attention (W=2048) and 128 meta tokens make it
sub-quadratic.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    act="silu",
    gated_mlp=True,
    norm="rms",
    subquadratic=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab_size=512, ssm_state=4)
