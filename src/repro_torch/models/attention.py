"""Grouped-query attention with RoPE: the QKV projection and the
single-token decode path over a preallocated KV cache
(``repro.models.attention``).  Scores, softmax and the value product
accumulate in float32 over bf16 operands, as the reference's
``preferred_element_type=float32`` einsums do.
"""
from __future__ import annotations

import math

import torch

from . import layers as L

__all__ = ["attn_init", "attn_decode", "init_kv_cache"]

NEG_INF = -1e30


def attn_init(gen, cfg, device) -> dict:
    hd = cfg.head_dim
    return {
        "wq": L.dense_init(gen, cfg.d_model, cfg.n_heads * hd, device,
                           bias=cfg.qkv_bias),
        "wk": L.dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, device,
                           bias=cfg.qkv_bias),
        "wv": L.dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, device,
                           bias=cfg.qkv_bias),
        "wo": L.dense_init(gen, cfg.n_heads * hd, cfg.d_model, device),
    }


def _project_qkv(p, x, cfg, positions, dtype):
    b, t, _ = x.shape
    hd = cfg.head_dim
    q = L.dense_apply(p["wq"], x, dtype, cfg.quant_spec())
    k = L.dense_apply(p["wk"], x, dtype, cfg.quant_spec())
    v = L.dense_apply(p["wv"], x, dtype, cfg.quant_spec())
    q = q.reshape(b, t, cfg.n_heads, hd)
    k = k.reshape(b, t, cfg.n_kv_heads, hd)
    v = v.reshape(b, t, cfg.n_kv_heads, hd)
    q, k = L.rope(q, k, positions, hd, cfg.rope_theta)
    return q, k, v


def init_kv_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                  device="cuda") -> dict:
    """One layer's KV cache, k and v [B, S, n_kv, D]."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(p, x, cfg, cache_k, cache_v, pos, dtype=torch.bfloat16):
    """Single-token decode.  x: [B, 1, d]; pos: [B] current positions.

    The new token's K/V are written into ``cache_k`` / ``cache_v`` [B, S,
    n_kv, D] in place (the reference returns updated copies).  Returns
    (out [B, 1, d], cache_k, cache_v).
    """
    b = x.shape[0]
    hd = cfg.head_dim
    n_kv = cfg.n_kv_heads
    g = cfg.n_heads // n_kv
    pos = pos.long()
    q, k_new, v_new = _project_qkv(p, x, cfg, pos[:, None], dtype)
    rows = torch.arange(b, device=x.device)
    cache_k[rows, pos] = k_new[:, 0].to(cache_k.dtype)
    cache_v[rows, pos] = v_new[:, 0].to(cache_v.dtype)
    qg = q.reshape(b, 1, n_kv, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                          cache_k.to(torch.float32)) / math.sqrt(hd)
    s = cache_k.shape[1]
    valid = torch.arange(s, device=x.device)[None, None, None, None, :] <= \
        pos[:, None, None, None, None]
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(torch.float32),
                       cache_v.to(torch.float32)).to(dtype)
    out = out.reshape(b, 1, cfg.n_heads * hd)
    return (L.dense_apply(p["wo"], out, dtype, cfg.quant_spec()),
            cache_k, cache_v)
