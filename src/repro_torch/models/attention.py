"""Grouped-query attention with RoPE: the QKV projection, full-sequence
causal attention (plain, or flash-style chunked above ``cfg.attn_chunk``)
and the single-token decode path over a preallocated KV cache
(``repro.models.attention``).  Scores, softmax and the value product
accumulate in float32 over bf16 operands, as the reference's
``preferred_element_type=float32`` einsums do; an einsum the reference
leaves in bf16 is summed in float32 and rounded to bf16.
"""
from __future__ import annotations

import math

import torch

from . import layers as L

__all__ = ["attn_init", "attn_apply", "attn_decode", "init_kv_cache"]

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


def _f32_einsum(eq, a, b):
    """einsum of bf16 operands summed in float32."""
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32))


def _repeat_kv(k, n_heads):
    """[B, S, n_kv, D] -> [B, S, n_heads, D] by group repetition."""
    n_kv = k.shape[2]
    if n_kv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // n_kv, dim=2)


def _dense_causal(q, k, v):
    """Plain causal attention; q: [B,T,H,D], k/v already head-repeated."""
    d = q.shape[-1]
    tq, tk = q.shape[1], k.shape[1]
    scores = _f32_einsum("bqhd,bkhd->bhqk", q, k)
    scores = scores / math.sqrt(d)
    qi = torch.arange(tq, device=q.device)[:, None]
    ki = torch.arange(tk, device=q.device)[None, :]
    scores = torch.where(ki <= qi, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _f32_einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


def _chunked_causal(q, k, v, chunk_q: int, chunk_kv: int):
    """Flash-style blockwise causal attention with online softmax.

    Memory is O(chunk_q * chunk_kv) per (batch, head) instead of O(T^2).
    Fully-masked kv blocks (kv_start > q_end) are still visited and
    contribute nothing, as in the reference's scan.
    """
    b, t, h, d = q.shape
    nq, nk = t // chunk_q, t // chunk_kv
    qb = q.reshape(b, nq, chunk_q, h, d)
    kb = k.reshape(b, nk, chunk_kv, h, d)
    vb = v.reshape(b, nk, chunk_kv, h, d)
    scale = 1.0 / math.sqrt(d)
    q_idx = torch.arange(chunk_q, device=q.device)[:, None]
    k_idx = torch.arange(chunk_kv, device=q.device)[None, :]
    outs = []
    for qi in range(nq):
        qblk = qb[:, qi]
        # online softmax over kv blocks
        acc = torch.zeros((b, h, chunk_q, d), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, h, chunk_q), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, chunk_q), dtype=torch.float32,
                        device=q.device)
        for ki in range(nk):
            s = _f32_einsum("bqhd,bkhd->bhqk", qblk, kb[:, ki]) * scale
            s = torch.where(ki * chunk_kv + k_idx <= qi * chunk_q + q_idx,
                            s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = _f32_einsum("bhqk,bkhd->bhqd", p.to(q.dtype), vb[:, ki])
            acc = acc * alpha[..., None] + pv.to(q.dtype).to(torch.float32)
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        outs.append(out.transpose(1, 2))         # [b, chunk_q, h, d]
    return torch.stack(outs, dim=1).reshape(b, t, h, d).to(q.dtype)


def attn_apply(p, x, cfg, positions, dtype=torch.bfloat16):
    """Full-sequence causal attention (train / prefill).  x: [B, T, d];
    positions: [B, T].  Returns (out [B, T, d], (k, v)) with k and v
    head-repeated to [B, T, n_heads, D]."""
    b, t, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions, dtype)
    k = _repeat_kv(k, cfg.n_heads)
    v = _repeat_kv(v, cfg.n_heads)
    if t > cfg.attn_chunk and t % cfg.attn_chunk == 0:
        out = _chunked_causal(q, k, v, min(cfg.attn_chunk, t),
                              cfg.attn_chunk)
    else:
        out = _dense_causal(q, k, v)
    out = out.reshape(b, t, cfg.n_heads * cfg.head_dim)
    return L.dense_apply(p["wo"], out, dtype, cfg.quant_spec()), (k, v)


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
