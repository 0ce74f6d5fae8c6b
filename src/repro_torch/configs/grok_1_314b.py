"""grok-1-314b -- xAI Grok-1 [hf:xai-org/grok-1; unverified].

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8 experts
top-2, non-gated tanh-gelu experts, tanh logit soft-capping, untied LM
head; the reference's ``repro.configs.grok_1_314b``.  Its bf16 optimizer
moments and pod-wide FSDP (``opt_state_dtype``, ``fsdp_over_pod``) belong
to training over a mesh, which the port does not have.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    n_experts=8,
    experts_per_token=2,
    moe_shard="mlp",
    logit_softcap=30.0,
    act="gelu",
    gated_mlp=False,
    norm="rms",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab_size=512, n_experts=4,
                          experts_per_token=2)
