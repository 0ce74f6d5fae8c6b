"""Encoder-decoder transformer, the SeamlessM4T-medium backbone
(``repro.models.encdec``).

The speech frontend is a stub: the caller supplies precomputed fbank-frame
embeddings [B, S_enc, d_model], which ``frontend_proj`` projects (a bf16
matmul, never quantized or planned) into a bidirectional encoder with
RoPE positions.  The text decoder is a causal transformer with a
cross-attention into the encoder's memory in every layer; the cross path
takes no RoPE.

    forward: (frames, decoder tokens) -> logits [B, T, V]
    decode:  one token against the self-attention KV cache and each
             layer's cross K/V, precomputed by ``encdec_prime_cross``

As in the rest of the port, ``params["enc_blocks"]`` and
``params["dec_blocks"]`` are lists of per-layer dicts (the reference
stacks each on a leading axis), and the decode state's leaves are stacked
on a leading layer axis: ``{"k", "v": [L, B, max_len, n_kv, D], "xk",
"xv": [L, B, F, n_kv, D]}``, bf16.  A decode step writes the self cache
in place and only reads the cross K/V.
"""
from __future__ import annotations

import math

import torch

from repro_torch import resolve_device

from . import attention as A
from . import layers as L
from . import transformer as T

__all__ = ["encdec_init", "encdec_apply", "encdec_encode",
           "encdec_decode_step", "init_encdec_caches",
           "encdec_prime_cross"]


# ---------------------------------------------------------------------------
# attention variants (bidirectional self-attention, cross-attention)
# ---------------------------------------------------------------------------

def _softmax_attend(q, k, v, dtype):
    """Unmasked softmax attention; q [B, Tq, H, D], k / v [B, Tk, H, D]
    (head-repeated).  Scores summed in float32 and divided by sqrt(D);
    the probabilities rounded to ``dtype``; their product with v summed in
    float32 and rounded to ``dtype``, as the reference's bf16 einsum."""
    scores = A._f32_einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return A._f32_einsum("bhqk,bkhd->bqhd", probs, v).to(dtype)


def _bidir_attn(p, x, cfg, positions, dtype=torch.bfloat16):
    """Encoder self-attention: RoPE on q / k, then full (non-causal)
    softmax attention, no chunked walk.  x [B, T, d] -> [B, T, d]."""
    b, t, _ = x.shape
    q, k, v = A._project_qkv(p, x, cfg, positions, dtype)
    k = A._repeat_kv(k, cfg.n_heads)
    v = A._repeat_kv(v, cfg.n_heads)
    out = _softmax_attend(q, k, v, dtype)
    out = out.reshape(b, t, cfg.n_heads * cfg.head_dim)
    return L.dense_apply(p["wo"], out, dtype, cfg.quant_spec())


def cross_init(gen, cfg, device) -> dict:
    hd = cfg.head_dim
    return {
        "wq": L.dense_init(gen, cfg.d_model, cfg.n_heads * hd, device),
        "wk": L.dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, device),
        "wv": L.dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, device),
        "wo": L.dense_init(gen, cfg.n_heads * hd, cfg.d_model, device),
    }


def cross_kv(p, memory, cfg, dtype=torch.bfloat16):
    """Project the encoder's memory [B, S, d] to one layer's cross K/V,
    each [B, S, n_kv, D]."""
    b, s, _ = memory.shape
    hd = cfg.head_dim
    k = L.dense_apply(p["wk"], memory, dtype, cfg.quant_spec())
    v = L.dense_apply(p["wv"], memory, dtype, cfg.quant_spec())
    return (k.reshape(b, s, cfg.n_kv_heads, hd),
            v.reshape(b, s, cfg.n_kv_heads, hd))


def cross_apply(p, x, k, v, cfg, dtype=torch.bfloat16):
    """q from the decoder's states x [B, T, d]; k / v [B, S, n_kv, D]
    precomputed from the memory.  Returns [B, T, d]."""
    b, t, _ = x.shape
    hd = cfg.head_dim
    q = L.dense_apply(p["wq"], x, dtype, cfg.quant_spec())
    q = q.reshape(b, t, cfg.n_heads, hd)
    out = _softmax_attend(q, A._repeat_kv(k, cfg.n_heads),
                          A._repeat_kv(v, cfg.n_heads), dtype)
    out = out.reshape(b, t, cfg.n_heads * hd)
    return L.dense_apply(p["wo"], out, dtype, cfg.quant_spec())


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def enc_block_init(gen, cfg, device) -> dict:
    return {"ln1": T.norm_init(cfg, device),
            "attn": A.attn_init(gen, cfg, device),
            "ln2": T.norm_init(cfg, device),
            "mlp": T.mlp_init(gen, cfg, device)}


def dec_block_init(gen, cfg, device) -> dict:
    return {"ln1": T.norm_init(cfg, device),
            "attn": A.attn_init(gen, cfg, device),
            "ln_x": T.norm_init(cfg, device),
            "cross": cross_init(gen, cfg, device),
            "ln2": T.norm_init(cfg, device),
            "mlp": T.mlp_init(gen, cfg, device)}


def enc_block_apply(p, x, cfg, positions, dtype=torch.bfloat16):
    x = x + _bidir_attn(p["attn"], T.norm_apply(cfg, p["ln1"], x), cfg,
                        positions, dtype)
    return x + T.mlp_apply(p["mlp"], T.norm_apply(cfg, p["ln2"], x), cfg,
                           dtype)


def dec_block_apply(p, x, cfg, positions, mem_k, mem_v,
                    dtype=torch.bfloat16):
    """One decoder block over a whole sequence: causal self-attention,
    cross-attention into (mem_k, mem_v), the MLP, each after its own
    pre-norm (ln1, ln_x, ln2)."""
    h, _ = A.attn_apply(p["attn"], T.norm_apply(cfg, p["ln1"], x), cfg,
                        positions, dtype)
    x = x + h
    x = x + cross_apply(p["cross"], T.norm_apply(cfg, p["ln_x"], x),
                        mem_k, mem_v, cfg, dtype)
    return x + T.mlp_apply(p["mlp"], T.norm_apply(cfg, p["ln2"], x), cfg,
                           dtype)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def encdec_init(gen: torch.Generator, cfg, device) -> dict:
    """Random float32 params from ``gen``, on ``device``; the head is
    untied (``cfg.tie_embeddings`` is not read)."""
    return {
        "frontend_proj": L.dense_init(gen, cfg.d_model, cfg.d_model, device),
        "enc_blocks": [enc_block_init(gen, cfg, device)
                       for _ in range(cfg.n_encoder_layers)],
        "enc_norm": T.norm_init(cfg, device),
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, device),
        "dec_blocks": [dec_block_init(gen, cfg, device)
                       for _ in range(cfg.n_layers)],
        "final_norm": T.norm_init(cfg, device),
        "lm_head": L.dense_init(gen, cfg.d_model, cfg.padded_vocab, device),
    }


def _frames(frames, cfg, dev, batch=None) -> torch.Tensor:
    """The caller's frame embeddings as a [B, S, d_model] tensor on dev;
    a ValueError naming the key or the shape where the reference would
    fail (no frames, another width, another batch than the tokens')."""
    d, f = cfg.d_model, cfg.frontend_tokens
    if frames is None:
        raise ValueError(f"{cfg.name}: the encoder needs batch['frontend'] "
                         f"(frontend_embeds), frame embeddings of shape "
                         f"[B, {f}, {d}]")
    frames = torch.as_tensor(frames, device=dev)
    if frames.dim() != 3 or frames.shape[-1] != d or \
            (batch is not None and frames.shape[0] != batch):
        b = "B" if batch is None else batch
        raise ValueError(f"{cfg.name}: frontend_embeds of shape "
                         f"{list(frames.shape)}, expected [{b}, S, {d}] "
                         f"(S = {f} frames on this config)")
    return frames


def encdec_encode(params, frames, cfg, device=None, batch=None):
    """frames [B, S, d_model] stub embeddings -> memory [B, S, d_model] on
    ``device``: ``frontend_proj`` as a bf16 matmul without the config's
    spec, on the frames cast to bf16 first; the encoder's blocks at
    positions 0..S-1; then ``enc_norm``."""
    dev = T._on_device(params, device)
    dtype = getattr(torch, cfg.dtype)
    frames = _frames(frames, cfg, dev, batch)
    x = L.dense_apply(params["frontend_proj"], frames.to(dtype), dtype)
    b, s, _ = x.shape
    positions = torch.arange(s, device=dev)[None, :].expand(b, s)
    for layer in params["enc_blocks"]:
        x = enc_block_apply(layer, x, cfg, positions, dtype)
    return T.norm_apply(cfg, params["enc_norm"], x)


def encdec_apply(params, tokens, cfg, device=None, frontend_embeds=None):
    """(frames, decoder tokens [B, T]) -> (logits [B, T, V], a float32
    zero aux) on ``device``.  Every decoder layer projects its cross K/V
    from the memory."""
    dev = T._on_device(params, device)
    dtype = getattr(torch, cfg.dtype)
    tokens = torch.as_tensor(tokens, device=dev)
    memory = encdec_encode(params, frontend_embeds, cfg, dev,
                           batch=tokens.shape[0])
    x = L.embed_apply(params["embed"], tokens, dtype)
    b, t, _ = x.shape
    positions = torch.arange(t, device=dev)[None, :].expand(b, t)
    for layer in params["dec_blocks"]:
        mk, mv = cross_kv(layer["cross"], memory, cfg, dtype)
        x = dec_block_apply(layer, x, cfg, positions, mk, mv, dtype)
    x = T.norm_apply(cfg, params["final_norm"], x)
    logits = L.dense_apply(params["lm_head"], x, dtype, cfg.quant_spec())
    return logits, torch.zeros((), dtype=torch.float32, device=dev)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_encdec_caches(cfg, batch: int, max_len: int, n_frames: int,
                       dtype=torch.bfloat16, device=None) -> dict:
    """Zeros: the self-attention KV cache [L, B, max_len, n_kv, D] and the
    cross K/V [L, B, n_frames, n_kv, D]."""
    dev = resolve_device(device)
    hd = cfg.head_dim
    self_shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, hd)
    cross_shape = (cfg.n_layers, batch, n_frames, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(self_shape, dtype=dtype, device=dev),
            "v": torch.zeros(self_shape, dtype=dtype, device=dev),
            "xk": torch.zeros(cross_shape, dtype=dtype, device=dev),
            "xv": torch.zeros(cross_shape, dtype=dtype, device=dev)}


def encdec_prime_cross(params, frames, cfg, device=None) -> dict:
    """Encode once and project every decoder layer's cross K/V (the
    serving set-up step): {"xk", "xv": [L, B, F, n_kv, D]}."""
    dtype = getattr(torch, cfg.dtype)
    memory = encdec_encode(params, frames, cfg, device)
    ks, vs = [], []
    for layer in params["dec_blocks"]:
        mk, mv = cross_kv(layer["cross"], memory, cfg, dtype)
        ks.append(mk)
        vs.append(mv)
    return {"xk": torch.stack(ks), "xv": torch.stack(vs)}


def encdec_decode_step(params, tokens, pos, caches, cfg):
    """One decode token against the self cache (written in place) and the
    cross K/V (read only).  tokens [B, 1]; pos [B].  Returns (logits
    [B, 1, V], caches)."""
    dtype = getattr(torch, cfg.dtype)
    x = L.embed_apply(params["embed"], tokens, dtype)
    for i, layer in enumerate(params["dec_blocks"]):
        hn = T.norm_apply(cfg, layer["ln1"], x)
        a, _, _ = A.attn_decode(layer["attn"], hn, cfg, caches["k"][i],
                                caches["v"][i], pos, dtype)
        x = x + a
        x = x + cross_apply(layer["cross"],
                            T.norm_apply(cfg, layer["ln_x"], x),
                            caches["xk"][i], caches["xv"][i], cfg, dtype)
        x = x + T.mlp_apply(layer["mlp"],
                            T.norm_apply(cfg, layer["ln2"], x), cfg, dtype)
    x = T.norm_apply(cfg, params["final_norm"], x)
    logits = L.dense_apply(params["lm_head"], x, dtype, cfg.quant_spec())
    return logits, caches
