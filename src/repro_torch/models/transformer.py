"""Decoder-only transformer LM, dense, MoE or VLM: init, the
full-sequence forward, prefill, decode-state init and the single-token
decode step (``repro.models.transformer``).  A config with ``n_experts``
puts an MoE FFN (``models/moe.py``) in each block where the dense family
has its MLP.  A config with a ``frontend`` (the VLM family's stub) has a
``frontend_proj`` whose projection of precomputed patch embeddings
overwrites the first ``frontend_tokens`` positions of the forward's and
prefill's token embeddings; decode takes text tokens only.

The reference stacks its layers on a leading axis for ``jax.lax.scan``;
the port keeps ``params["blocks"]`` as a list of per-layer dicts and
loops over it.  The KV caches stay stacked, [L, B, S, n_kv, D].

The forward and prefill take the device they run on (``"cuda"`` unless
told otherwise; without a card that raises) and move the tokens there;
the params must already live on it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import resolve_device

from . import attention as A
from . import layers as L
from . import moe as M

__all__ = ["lm_init", "lm_apply", "lm_prefill", "lm_decode_step",
           "init_caches", "norm_init", "norm_apply", "mlp_init",
           "mlp_apply", "block_init", "block_apply", "block_decode"]


def norm_init(cfg, device) -> dict:
    return (L.rmsnorm_init(cfg.d_model, device) if cfg.norm == "rms"
            else L.layernorm_init(cfg.d_model, device))


def norm_apply(cfg, p, x):
    return (L.rmsnorm_apply(p, x) if cfg.norm == "rms"
            else L.layernorm_apply(p, x))


def mlp_init(gen, cfg, device) -> dict:
    p = {"up": L.dense_init(gen, cfg.d_model, cfg.d_ff, device),
         "down": L.dense_init(gen, cfg.d_ff, cfg.d_model, device)}
    if cfg.gated_mlp:
        p["gate"] = L.dense_init(gen, cfg.d_model, cfg.d_ff, device)
    return p


def mlp_apply(p, x, cfg, dtype=torch.bfloat16):
    if cfg.gated_mlp:
        up = L.dense_apply(p["up"], x, dtype, cfg.quant_spec())
        g = L.dense_apply(p["gate"], x, dtype, cfg.quant_spec())
        h = L.activation(cfg.act)(g) * up
    else:
        # activation folded into the dense epilogue (in-kernel on the
        # fused route)
        h = L.dense_apply(p["up"], x, dtype, cfg.quant_spec(),
                          activation=cfg.act)
    return L.dense_apply(p["down"], h, dtype, cfg.quant_spec())


def block_init(gen, cfg, device) -> dict:
    p = {"ln1": norm_init(cfg, device),
         "attn": A.attn_init(gen, cfg, device),
         "ln2": norm_init(cfg, device)}
    if cfg.n_experts:
        p["moe"] = M.moe_init(gen, cfg, device)
    else:
        p["mlp"] = mlp_init(gen, cfg, device)
    return p


def _ffn(p, x, cfg, dtype):
    """The block's FFN output on the normed x (an MoE block's aux loss
    dropped)."""
    if cfg.n_experts:
        return M.moe_apply(p["moe"], x, cfg, dtype)[0]
    return mlp_apply(p["mlp"], x, cfg, dtype)


def block_apply(p, x, cfg, positions, dtype=torch.bfloat16):
    """One block over a whole sequence; returns (x, aux), aux the MoE
    router's load-balance loss, a float32 zero for the dense MLP."""
    h, _ = A.attn_apply(p["attn"], norm_apply(cfg, p["ln1"], x), cfg,
                        positions, dtype)
    x = x + h
    hn = norm_apply(cfg, p["ln2"], x)
    if cfg.n_experts:
        h, aux = M.moe_apply(p["moe"], hn, cfg, dtype)
    else:
        h = mlp_apply(p["mlp"], hn, cfg, dtype)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h, aux


def block_decode(p, x, cfg, ck, cv, pos, dtype=torch.bfloat16):
    h, ck, cv = A.attn_decode(p["attn"], norm_apply(cfg, p["ln1"], x), cfg,
                              ck, cv, pos, dtype)
    x = x + h
    return x + _ffn(p, norm_apply(cfg, p["ln2"], x), cfg, dtype), ck, cv


def lm_init(gen: torch.Generator, cfg, device) -> dict:
    """Random float32 params from ``gen``, on ``device``."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"lm_init builds the dense, moe and vlm families; "
                         f"family {cfg.family!r} has its own init")
    params = {
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, device),
        "blocks": [block_init(gen, cfg, device)
                   for _ in range(cfg.n_layers)],
        "final_norm": norm_init(cfg, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                         device)
    if cfg.frontend:
        # the modality stub: a learned projection of the caller's
        # precomputed patch / frame embeddings
        params["frontend_proj"] = L.dense_init(gen, cfg.d_model, cfg.d_model,
                                               device)
    return params


def init_caches(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                device="cuda") -> dict:
    """Stacked per-layer KV caches [L, B, S, n_kv, D]."""
    one = A.init_kv_cache(cfg, batch, max_len, dtype, device)
    return {k: v[None].repeat(cfg.n_layers, *([1] * v.dim()))
            for k, v in one.items()}


def _run_blocks(params, x, cfg, positions, dtype):
    """The layers in order, summing their aux losses.  The reference's
    ``remat`` (rematerialize each layer in the backward pass) saves
    gradient memory and changes no forward value, so the port has no such
    switch."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in params["blocks"]:
        x, a = block_apply(layer, x, cfg, positions, dtype)
        aux = aux + a
    return x, aux


def _on_device(params, device) -> torch.device:
    """The device an entry point runs on (``resolve_device``), which must
    hold the params."""
    dev = resolve_device(device)
    table = params["embed"]["table"]
    if table.device.type != dev.type or \
            dev.index not in (None, table.device.index):
        raise ValueError(f"params are on {table.device}, not on {dev}")
    return dev


def _embed_inputs(params, tokens, cfg, device, frontend_embeds=None):
    """(x [B, T, d], positions [B, T], dtype) for a prompt, on device.

    With a frontend in ``cfg``, ``frontend_embeds`` [B, F, d]
    (F = ``cfg.frontend_tokens``) go through ``frontend_proj`` as a bf16
    matmul, never quantized (the reference calls ``dense_apply`` without
    the config's spec), and overwrite positions [0, F) of the token
    embeddings; positions stay 0..T-1.  Without one, ``frontend_embeds``
    is not read, as in the reference.
    """
    dev = _on_device(params, device)
    dtype = getattr(torch, cfg.dtype)
    tokens = torch.as_tensor(tokens, device=dev)
    x = L.embed_apply(params["embed"], tokens, dtype)
    b, t, d = x.shape
    if cfg.frontend:
        f = cfg.frontend_tokens
        if frontend_embeds is None:
            raise ValueError(f"{cfg.name}: the {cfg.frontend!r} frontend "
                             f"needs batch['frontend'] (frontend_embeds) "
                             f"of shape [{b}, {f}, {d}]")
        if t < f:
            raise ValueError(f"{cfg.name}: a prompt of {t} tokens is "
                             f"shorter than the frontend's {f} positions")
        fe = torch.as_tensor(frontend_embeds, device=dev)
        if tuple(fe.shape) != (b, f, d):
            raise ValueError(f"{cfg.name}: frontend_embeds of shape "
                             f"{list(fe.shape)}, expected [{b}, {f}, {d}]")
        fe = L.dense_apply(params["frontend_proj"], fe.to(dtype), dtype)
        x[:, :f] = fe.to(x.dtype)
    positions = torch.arange(t, device=dev)[None, :].expand(b, t)
    return x, positions, dtype


def _logits(params, x, cfg, dtype):
    x = norm_apply(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = L.embed_logits(params["embed"], x, dtype)
    else:
        logits = L.dense_apply(params["lm_head"], x, dtype, cfg.quant_spec())
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits.to(torch.float32) / c)
    return logits


def lm_apply(params, tokens, cfg, device=None, frontend_embeds=None):
    """tokens [B, T] -> (logits [B, T, V], aux) on ``device``.  With a
    frontend in ``cfg``, ``frontend_embeds`` [B, F, d] overwrite the first
    F positions (``_embed_inputs``)."""
    x, positions, dtype = _embed_inputs(params, tokens, cfg, device,
                                        frontend_embeds)
    x, aux = _run_blocks(params, x, cfg, positions, dtype)
    return _logits(params, x, cfg, dtype), aux


def lm_prefill(params, tokens, cfg, max_len: int, device=None,
               frontend_embeds=None):
    """Run the full prompt, return (last-position logits [B, 1, V], caches).

    Prefill reuses the full-sequence attention and keeps each layer's K/V
    in the decode layout: the unrepeated heads (the first of each group of
    the repeated ones), padded to ``max_len`` >= T, stacked into
    init_caches' [L, B, max_len, n_kv, D].  ``frontend_embeds`` as in
    ``lm_apply``.
    """
    x, positions, dtype = _embed_inputs(params, tokens, cfg, device,
                                        frontend_embeds)
    t = x.shape[1]
    if max_len < t:
        raise ValueError(f"max_len {max_len} < prompt length {t}")
    rep = cfg.n_heads // cfg.n_kv_heads
    ks, vs = [], []
    for layer in params["blocks"]:
        hn = norm_apply(cfg, layer["ln1"], x)
        attn_out, (k, v) = A.attn_apply(layer["attn"], hn, cfg, positions,
                                        dtype)
        x = x + attn_out
        x = x + _ffn(layer, norm_apply(cfg, layer["ln2"], x), cfg, dtype)
        for kv, out in ((k, ks), (v, vs)):
            out.append(F.pad(kv[:, :, ::rep, :], (0, 0, 0, 0, 0, max_len - t)))
    logits = _logits(params, x[:, -1:, :], cfg, dtype)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


def lm_decode_step(params, tokens, pos, caches, cfg):
    """One decode step.  tokens [B, 1]; pos [B]; caches from init_caches,
    updated in place.  Returns (logits [B, 1, V], caches)."""
    dtype = getattr(torch, cfg.dtype)
    x = L.embed_apply(params["embed"], tokens, dtype)
    for i, layer in enumerate(params["blocks"]):
        x, _, _ = block_decode(layer, x, cfg, caches["k"][i],
                               caches["v"][i], pos, dtype)
    return _logits(params, x, cfg, dtype), caches
