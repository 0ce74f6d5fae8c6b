"""phi-3-vision-4.2b -- phi3-mini backbone + CLIP frontend stub
[hf:microsoft/Phi-3-vision-128k-instruct; hf].

32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064, untied LM head; the
reference's ``repro.configs.phi_3_vision_4_2b``.  The CLIP vision tower
is a stub: the caller supplies 576 precomputed patch embeddings (ViT-L/14
at 336 px), which ``frontend_proj`` projects to overwrite the sequence's
first 576 positions.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    head_dim=96,
    frontend="vision",
    frontend_tokens=576,
    act="silu",
    gated_mlp=True,
    norm="rms",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          head_dim=16, d_ff=128, vocab_size=512,
                          frontend_tokens=4)
