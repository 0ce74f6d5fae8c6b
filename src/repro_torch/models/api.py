"""Unified per-family model API (``repro.models.api``).

Every family exposes the same entry points so the serving loop is
architecture-agnostic:

    init(gen, cfg, device)                       -> param tree
    init_decode(cfg, batch, max_len, device)     -> decode-state tree
    decode_step(params, tokens, pos, state, cfg) -> (logits [B,1,V], state)

The port has the dense family so far.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from . import transformer as T

__all__ = ["ModelAPI", "get_api"]


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    family: str
    init: Callable
    init_decode: Callable
    decode_step: Callable


def _lm_init_decode(cfg, batch, max_len, device):
    return T.init_caches(cfg, batch, max_len, getattr(torch, cfg.dtype),
                         device)


_FAMILIES: Dict[str, ModelAPI] = {
    "dense": ModelAPI("dense", T.lm_init, _lm_init_decode, T.lm_decode_step),
}


def get_api(cfg) -> ModelAPI:
    try:
        return _FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"model family {cfg.family!r} is not ported "
                         f"(have {sorted(_FAMILIES)})") from None
