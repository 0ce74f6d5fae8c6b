"""Hymba (arXiv:2411.13676): hybrid-head blocks in which attention heads
and a selective-SSM branch read the same normed input side by side and
their outputs are fused (``repro.models.hymba``).

As in the reference, every layer's attention uses a sliding window of
``HYMBA_WINDOW`` positions, the forward prepends ``N_META`` learned meta
tokens at positions 0..127 (and drops them from the logits), and decode
keeps a rolling-window KV ring and the SSM state.  Decode takes no meta
tokens and starts at position 0, so a served decode continues
``hymba_lm_apply(..., with_meta=False)``, not the forward with meta.

As in the rest of the port, ``params["blocks"]`` is a list of per-layer
dicts, and every decode-state leaf is stacked on a leading layer axis:
``{"kv": {"k", "v": [L, B, W, n_kv, D] bf16, "pos": [L, B, W] int32,
-1 where empty}, "ssm": {"h": [L, B, di, n] float32, "conv": [L, B,
K-1, di] bf16}}``.  A decode step writes the ring in place.
"""
from __future__ import annotations

import math

import torch

from repro_torch import resolve_device

from . import attention as A
from . import layers as L
from . import ssm as S
from . import transformer as T

__all__ = ["hymba_lm_init", "hymba_lm_apply", "hymba_lm_decode_step",
           "init_hymba_caches", "HYMBA_WINDOW", "N_META"]

HYMBA_WINDOW = 2048
N_META = 128


def block_init(gen: torch.Generator, cfg, device) -> dict:
    """One block's float32 params; the fusion's betas are ones, as the
    reference sets them."""
    return {
        "ln1": T.norm_init(cfg, device),
        "attn": A.attn_init(gen, cfg, device),
        "ssm": S.ssm_init(gen, cfg, device),
        "beta_attn": torch.ones((cfg.d_model,), dtype=torch.float32,
                                device=device),
        "beta_ssm": torch.ones((cfg.d_model,), dtype=torch.float32,
                               device=device),
        "ln2": T.norm_init(cfg, device),
        "mlp": T.mlp_init(gen, cfg, device),
    }


def _windowed(q, k, v, window: int, positions):
    """Attention under a causal sliding-window mask over the whole
    sequence; q, k, v [B, T, H, D] (k, v head-repeated), positions
    [B, T].  Scores divided by sqrt(D)."""
    d = q.shape[-1]
    scores = A._f32_einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    qi = positions[:, None, :, None]
    ki = positions[:, None, None, :]
    mask = (ki <= qi) & (ki > qi - window)
    scores = torch.where(mask, scores, A.NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return A._f32_einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


def _windowed_chunked(q, k, v, window: int, chunk: int):
    """Sliding-window attention over kv chunks within the window, with an
    online softmax: for each q chunk only the ``window // chunk + 1`` kv
    chunks ending at it, nearest first (a chunk before the sequence's
    start is visited fully masked, as in the reference's scan).  Scores
    multiplied by 1/sqrt(D).  T a multiple of ``chunk``; positions are
    0..T-1."""
    b, t, h, d = q.shape
    n_chunks = t // chunk
    win_chunks = window // chunk + 1
    qb = q.reshape(b, n_chunks, chunk, h, d)
    kb = k.reshape(b, n_chunks, chunk, h, d)
    vb = v.reshape(b, n_chunks, chunk, h, d)
    scale = 1.0 / math.sqrt(d)
    idx = torch.arange(chunk, device=q.device)
    f32 = torch.float32
    outs = []
    for qi in range(n_chunks):
        qblk = qb[:, qi]
        acc = torch.zeros((b, h, chunk, d), dtype=f32, device=q.device)
        m = torch.full((b, h, chunk), A.NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros((b, h, chunk), dtype=f32, device=q.device)
        qpos = qi * chunk + idx[:, None]
        for off in range(win_chunks):
            ki = max(qi - off, 0)
            s = A._f32_einsum("bqhd,bkhd->bhqk", qblk, kb[:, ki]) * scale
            kpos = ki * chunk + idx[None, :]
            mask = (kpos <= qpos) & (kpos > qpos - window) & (qi - off >= 0)
            s = torch.where(mask, s, A.NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = A._f32_einsum("bhqk,bkhd->bhqd", p.to(q.dtype), vb[:, ki])
            acc = acc * alpha[..., None] + pv.to(q.dtype).to(f32)
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        outs.append(out.transpose(1, 2))             # [b, chunk, h, d]
    return torch.stack(outs, dim=1).reshape(b, t, h, d).to(q.dtype)


def _attn_branch(p, x, cfg, positions, dtype):
    """The block's attention: GQA with RoPE under the sliding window, the
    chunked walk when T is above ``cfg.attn_chunk`` and a multiple of it.
    Returns (out [B, T, d], (k, v) head-repeated)."""
    b, t, _ = x.shape
    q, k, v = A._project_qkv(p, x, cfg, positions, dtype)
    k = A._repeat_kv(k, cfg.n_heads)
    v = A._repeat_kv(v, cfg.n_heads)
    if t > cfg.attn_chunk and t % cfg.attn_chunk == 0:
        out = _windowed_chunked(q, k, v, HYMBA_WINDOW, cfg.attn_chunk)
    else:
        out = _windowed(q, k, v, HYMBA_WINDOW, positions)
    out = out.reshape(b, t, cfg.n_heads * cfg.head_dim)
    return L.dense_apply(p["wo"], out, dtype, cfg.quant_spec()), (k, v)


def _fuse(p, a_out, s_out, dtype):
    """0.5 (a * beta_attn + s * beta_ssm), a bf16 chain."""
    return 0.5 * (a_out * p["beta_attn"].to(dtype)
                  + s_out * p["beta_ssm"].to(dtype))


def block_apply(p, x, cfg, positions, ssm_state, dtype=torch.bfloat16):
    """One block over a whole sequence from ``ssm_state`` (None: zeros);
    returns (x, the SSM's new state)."""
    h = T.norm_apply(cfg, p["ln1"], x)
    a_out, _ = _attn_branch(p["attn"], h, cfg, positions, dtype)
    s_out, new_ssm = S.ssm_apply(p["ssm"], h, cfg, ssm_state, dtype)
    x = x + _fuse(p, a_out, s_out, dtype)
    x = x + T.mlp_apply(p["mlp"], T.norm_apply(cfg, p["ln2"], x), cfg, dtype)
    return x, new_ssm


def hymba_lm_init(gen: torch.Generator, cfg, device) -> dict:
    """Random float32 params from ``gen``, on ``device``; the head is
    untied (``cfg.tie_embeddings`` is not read)."""
    return {
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, device),
        "meta": L.truncated_normal(gen, (N_META, cfg.d_model), 1.0, device),
        "blocks": [block_init(gen, cfg, device)
                   for _ in range(cfg.n_layers)],
        "final_norm": T.norm_init(cfg, device),
        "lm_head": L.dense_init(gen, cfg.d_model, cfg.padded_vocab, device),
    }


def hymba_lm_apply(params, tokens, cfg, device=None, with_meta: bool = True):
    """tokens [B, T] -> (logits [B, T, V], a float32 zero aux) on
    ``device``.  With ``with_meta`` the N_META meta rows go first, at
    positions 0..N_META-1, and are dropped from the logits.  Every
    layer's SSM starts from zeros."""
    x, _, dtype = T._embed_inputs(params, tokens, cfg, device)
    b = x.shape[0]
    n_meta = 0
    if with_meta:
        meta = params["meta"].to(dtype)[None].expand(b, N_META, cfg.d_model)
        x = torch.cat([meta, x], dim=1)
        n_meta = N_META
    tt = x.shape[1]
    positions = torch.arange(tt, device=x.device)[None, :].expand(b, tt)
    for layer in params["blocks"]:
        x, _ = block_apply(layer, x, cfg, positions, None, dtype)
    x = T.norm_apply(cfg, params["final_norm"], x)
    logits = L.dense_apply(params["lm_head"], x[:, n_meta:], dtype,
                           cfg.quant_spec())
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def _stacked_ssm(cfg, batch: int, device=None) -> dict:
    """The per-layer zero SSM state stacked on a leading axis: [L, B, ...]."""
    one = S.init_ssm_state(cfg, batch, device)
    return {k: v[None].repeat(cfg.n_layers, *([1] * v.dim()))
            for k, v in one.items()}


def init_hymba_caches(cfg, batch: int, dtype=torch.bfloat16,
                      device=None) -> dict:
    """The rolling-window KV ring (and its positions, -1 where empty) and
    the SSM state, each stacked over the layers."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, HYMBA_WINDOW, cfg.n_kv_heads, cfg.head_dim)
    return {"kv": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                   "v": torch.zeros(shape, dtype=dtype, device=dev),
                   "pos": torch.full(shape[:3], -1, dtype=torch.int32,
                                     device=dev)},
            "ssm": _stacked_ssm(cfg, batch, dev)}


def _decode_attn(p, x, cfg, ck, cv, cpos, pos, dtype):
    """One token's attention over the ring of width W = ck.shape[1]:
    x [B, 1, d]; pos [B].  The token's K, V and position go to slot
    pos % W of ``ck`` / ``cv`` / ``cpos`` [B, W, ...], in place; a slot
    is attended when its position is >= 0 and within the window.
    Returns (out [B, 1, d], ck, cv, cpos)."""
    b = x.shape[0]
    hd, n_kv = cfg.head_dim, cfg.n_kv_heads
    g = cfg.n_heads // n_kv
    pos = pos.long()
    q, k, v = A._project_qkv(p, x, cfg, pos[:, None], dtype)
    rows = torch.arange(b, device=x.device)
    slot = pos % ck.shape[1]
    ck[rows, slot] = k[:, 0].to(ck.dtype)
    cv[rows, slot] = v[:, 0].to(cv.dtype)
    cpos[rows, slot] = pos.to(cpos.dtype)
    qg = q.reshape(b, 1, n_kv, g, hd)
    scores = A._f32_einsum("bqkgd,bskd->bkgqs", qg, ck) / math.sqrt(hd)
    c = cpos[:, None, None, None, :]
    at = pos[:, None, None, None, None]
    valid = (c >= 0) & (c <= at) & (c > at - HYMBA_WINDOW)
    scores = torch.where(valid, scores, A.NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out = A._f32_einsum("bkgqs,bskd->bqkgd", probs, cv).to(dtype)
    out = out.reshape(b, 1, cfg.n_heads * hd)
    return L.dense_apply(p["wo"], out, dtype, cfg.quant_spec()), ck, cv, cpos


def hymba_lm_decode_step(params, tokens, pos, caches, cfg):
    """One decode step.  tokens [B, 1]; pos [B]; caches from
    init_hymba_caches (the ring written in place).  Returns (logits
    [B, 1, V], caches)."""
    dtype = getattr(torch, cfg.dtype)
    x = L.embed_apply(params["embed"], tokens, dtype)
    kv, ssm = caches["kv"], caches["ssm"]
    new_ssm = {"h": [], "conv": []}
    for i, layer in enumerate(params["blocks"]):
        hn = T.norm_apply(cfg, layer["ln1"], x)
        a_out, _, _, _ = _decode_attn(layer["attn"], hn, cfg, kv["k"][i],
                                      kv["v"][i], kv["pos"][i], pos, dtype)
        s_out, st = S.ssm_apply(layer["ssm"], hn, cfg,
                                {k: v[i] for k, v in ssm.items()}, dtype)
        x = x + _fuse(layer, a_out, s_out, dtype)
        x = x + T.mlp_apply(layer["mlp"],
                            T.norm_apply(cfg, layer["ln2"], x), cfg, dtype)
        for k, v in st.items():
            new_ssm[k].append(v)
    x = T.norm_apply(cfg, params["final_norm"], x)
    logits = L.dense_apply(params["lm_head"], x, dtype, cfg.quant_spec())
    return logits, {"kv": kv, "ssm": {k: torch.stack(v)
                                      for k, v in new_ssm.items()}}
