"""Architecture registry: ``--arch <id>`` -> ModelConfig (full or smoke).

The port has the dense minicpm-2b so far; the reference's other nine
architectures follow with their model families.
"""
from __future__ import annotations

from typing import List

from . import minicpm_2b
from .base import ModelConfig

_MODULES = {
    "minicpm-2b": minicpm_2b,
}

ARCHS: List[str] = list(_MODULES)


def get_config(arch: str, smoke: bool = False, **overrides) -> ModelConfig:
    try:
        mod = _MODULES[arch]
    except KeyError:
        raise ValueError(f"unknown arch {arch!r}; have {ARCHS}") from None
    cfg = mod.smoke() if smoke else mod.CONFIG
    return cfg.replace(**overrides) if overrides else cfg
