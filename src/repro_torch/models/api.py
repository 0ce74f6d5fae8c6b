"""Unified per-family model API (``repro.models.api``).

Every family exposes the same entry points so the training and serving
loops are architecture-agnostic:

    init(gen, cfg, device)                       -> param tree
    forward(params, batch, cfg, device)          -> (logits [B,T,V], aux)
    init_decode(cfg, batch, max_len, device)     -> decode-state tree
    decode_step(params, tokens, pos, state, cfg) -> (logits [B,1,V], state)

``batch`` is a dict: {"tokens": int [B,T], "labels": int [B,T]} plus
"frontend": [B,F,d_model] for the VLM and encoder-decoder families
(precomputed patch or frame embeddings, the modality stub).  ``get_api``
takes every family of the reference.  The dense, MoE and VLM families
run ``models/transformer.py`` (an MoE block swaps its MLP for the
experts; a VLM's frontend overwrites the prompt's first F positions);
the RWKV family runs ``models/rwkv6.py``, whose decode state is a
recurrence, the same size at any ``max_len``; the hybrid family runs
``models/hymba.py``, whose decode state is a KV ring of the attention
window and the SSM's recurrence, also the same size at any ``max_len``;
the encoder-decoder family runs ``models/encdec.py``, whose forward
encodes the frames and whose decode state holds the decoder's KV cache
and each layer's cross K/V over ``cfg.frontend_tokens`` frames (zeros
until the caller primes them with ``encdec_prime_cross``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from . import encdec as E
from . import hymba as H
from . import rwkv6 as R
from . import transformer as T

__all__ = ["ModelAPI", "get_api", "loss_fn", "frontend_len"]


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    family: str
    init: Callable
    forward: Callable            # (params, batch, cfg, device) -> (logits, aux)
    init_decode: Callable
    decode_step: Callable


def frontend_len(cfg) -> int:
    return cfg.frontend_tokens if cfg.frontend else 0


def _lm_forward(params, batch, cfg, device=None):
    return T.lm_apply(params, batch["tokens"], cfg, device,
                      frontend_embeds=batch.get("frontend"))


def _lm_init_decode(cfg, batch, max_len, device):
    return T.init_caches(cfg, batch, max_len, getattr(torch, cfg.dtype),
                         device)


def _rwkv_forward(params, batch, cfg, device=None):
    return R.rwkv_lm_apply(params, batch["tokens"], cfg, device=device)


def _rwkv_init_decode(cfg, batch, max_len, device):
    del max_len  # O(1) recurrent state
    return R.stacked_rwkv_state(cfg, batch, device)


def _hymba_forward(params, batch, cfg, device=None):
    return H.hymba_lm_apply(params, batch["tokens"], cfg, device)


def _hymba_init_decode(cfg, batch, max_len, device):
    del max_len  # a ring of the attention window + the SSM state
    return H.init_hymba_caches(cfg, batch, getattr(torch, cfg.dtype), device)


def _encdec_forward(params, batch, cfg, device=None):
    # a ValueError, where the reference's batch["frontend"] is a KeyError
    return E.encdec_apply(params, batch["tokens"], cfg, device,
                          frontend_embeds=batch.get("frontend"))


def _encdec_init_decode(cfg, batch, max_len, device):
    return E.init_encdec_caches(cfg, batch, max_len, cfg.frontend_tokens,
                                getattr(torch, cfg.dtype), device)


_FAMILIES: Dict[str, ModelAPI] = {
    fam: ModelAPI(fam, T.lm_init, _lm_forward, _lm_init_decode,
                  T.lm_decode_step)
    for fam in ("dense", "moe", "vlm")}
_FAMILIES["rwkv"] = ModelAPI("rwkv", R.rwkv_lm_init, _rwkv_forward,
                             _rwkv_init_decode, R.rwkv_lm_decode_step)
_FAMILIES["hybrid"] = ModelAPI("hybrid", H.hymba_lm_init, _hymba_forward,
                               _hymba_init_decode, H.hymba_lm_decode_step)
_FAMILIES["encdec"] = ModelAPI("encdec", E.encdec_init, _encdec_forward,
                               _encdec_init_decode, E.encdec_decode_step)


def get_api(cfg) -> ModelAPI:
    try:
        return _FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown model family {cfg.family!r} "
                         f"(have {sorted(_FAMILIES)})") from None


def loss_fn(params, batch, cfg, device=None):
    """Next-token cross entropy (float32 logits), masking the VLM
    family's modality prefix.

    Returns (loss, metrics dict).  ``labels`` are already shifted by the
    data pipeline (labels[t] = tokens[t+1]); positions with label < 0 are
    masked, and on a ``vlm`` config (only there, as in the reference) the
    first ``frontend_len(cfg)`` positions too: an ``encdec`` config's
    frames feed the encoder, so every label >= 0 counts.  Forward only:
    the port has no training step yet.
    """
    logits, aux = get_api(cfg).forward(params, batch, cfg, device)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    mask = labels >= 0
    f = frontend_len(cfg) if cfg.family == "vlm" else 0
    if f:
        mask = mask & (torch.arange(labels.shape[1],
                                    device=labels.device) >= f)[None, :]
    labels = torch.clamp_min(labels, 0)
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    nll = (logz - gold) * mask
    denom = torch.clamp_min(mask.sum(), 1)
    loss = nll.sum() / denom
    total = loss + aux
    return total, {"loss": loss, "aux_loss": aux,
                   "tokens": denom.to(torch.float32)}
