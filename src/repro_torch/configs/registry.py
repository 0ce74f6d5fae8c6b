"""Architecture registry: ``--arch <id>`` -> ModelConfig (full or smoke).

The port has every architecture of the reference's registry, in its
order: the RWKV, four dense, two MoE, one VLM, one encoder-decoder and
one hybrid architectures.
"""
from __future__ import annotations

from typing import List

from . import (granite_34b, grok_1_314b, hymba_1_5b, minicpm_2b,
               nemotron_4_15b, olmoe_1b_7b, phi_3_vision_4_2b,
               qwen1_5_110b, rwkv6_3b, seamless_m4t_medium)
from .base import ModelConfig

_MODULES = {
    "rwkv6-3b": rwkv6_3b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "grok-1-314b": grok_1_314b,
    "phi-3-vision-4.2b": phi_3_vision_4_2b,
    "seamless-m4t-medium": seamless_m4t_medium,
    "minicpm-2b": minicpm_2b,
    "nemotron-4-15b": nemotron_4_15b,
    "qwen1.5-110b": qwen1_5_110b,
    "granite-34b": granite_34b,
    "hymba-1.5b": hymba_1_5b,
}

ARCHS: List[str] = list(_MODULES)


def get_config(arch: str, smoke: bool = False, **overrides) -> ModelConfig:
    try:
        mod = _MODULES[arch]
    except KeyError:
        raise ValueError(f"unknown arch {arch!r}; have {ARCHS}") from None
    cfg = mod.smoke() if smoke else mod.CONFIG
    return cfg.replace(**overrides) if overrides else cfg
