"""seamless-m4t-medium -- encoder-decoder speech/text model
[arXiv:2308.11596; hf].

12L encoder + 12L decoder, d_model=1024 16H (kv=16) d_ff=4096
vocab=256206, an un-gated gelu MLP, LayerNorm and an untied head; the
reference's ``repro.configs.seamless_m4t_medium``.  The speech frontend
is a stub: the caller supplies 512 precomputed fbank-frame embeddings as
the encoder's input; the decoder is a causal LM with per-layer
cross-attention into the encoder's memory.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,             # decoder layers
    n_encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,
    frontend="audio",
    frontend_tokens=512,     # fbank frames fed to the encoder
    act="gelu",
    gated_mlp=False,
    norm="layer",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, n_encoder_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
                          vocab_size=512, frontend_tokens=8)
