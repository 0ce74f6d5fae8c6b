"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free time mixing with a
data-dependent per-channel decay, and squared-ReLU channel mixing
(``repro.models.rwkv6``).

The recurrence, per head, with state S in R^{hs x hs}:

    y_t     = r_t . (diag(u) k_t^T v_t + S_t)
    S_{t+1} = diag(w_t) S_t + k_t^T v_t

with w_t = exp(-exp(w0 + lora_w(ddlerp(x_t, x_{t-1})))).  The forward
steps through the sequence in order (``_wkv_scan``, the reference's
``jax.lax.scan``: a plain loop, not a kernel, whose float32 sums keep the
reference's order); a decode step is the forward over one token with the
carried state, so decode ignores the position.

The token shift and the decay's LoRAs run in float32, the four mixer
projections and the output take bf16 inputs; the group norm over each
head's output uses the population variance and eps 64e-5.  Only the
mixers' ``wr`` / ``wk`` / ``wv`` / ``wg`` / ``wo``, the channel mix's
``wk`` / ``wv`` / ``wr`` and the untied ``head`` take ``cfg.quant_spec()``
and are planned; ``mix_w1``, ``w_lora1`` and ``w_lora2`` are float32
matmuls without a spec (``ops._NO_PLAN_KEYS``), ``mix_w2`` a bare
[5, 32, d] tensor in an einsum.

As in the port's transformer, ``params["blocks"]`` is a list of
per-layer dicts; the decode state is a dict of layer-stacked tensors:
``shift_tm`` and ``shift_cm`` [L, B, d] bf16 (the last *normed* input of
each mix) and ``wkv`` [L, B, H, hs, hs] float32.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device

from . import layers as L
from . import transformer as T

__all__ = ["timemix_init", "timemix_apply", "chanmix_init", "chanmix_apply",
           "rwkv_init", "rwkv_apply", "init_rwkv_state",
           "stacked_rwkv_state", "rwkv_lm_init", "rwkv_lm_apply",
           "rwkv_lm_decode_step"]

_LORA_MIX = 32
_LORA_W = 64
_N_MIX = 5  # w, k, v, r, g


def _heads(cfg):
    hs = cfg.rwkv_head_size
    return cfg.d_model // hs, hs


def _const(shape, value: float, device) -> torch.Tensor:
    return torch.full(shape, value, dtype=torch.float32, device=device)


def timemix_init(gen: torch.Generator, cfg, device) -> dict:
    """The time mix's float32 params, the reference's constants included
    (mu_x, mu_base, u zeros; w0 -0.5; ln_x scale ones, bias zeros)."""
    d = cfg.d_model
    n_h, hs = _heads(cfg)
    return {
        "mu_x": _const((d,), 0.0, device),
        "mu_base": _const((_N_MIX, d), 0.0, device),
        "mix_w1": L.dense_init(gen, d, _N_MIX * _LORA_MIX, device),
        "mix_w2": L.truncated_normal(gen, (_N_MIX, _LORA_MIX, d), 1.0,
                                     device),
        "w0": _const((d,), -0.5, device),
        "w_lora1": L.dense_init(gen, d, _LORA_W, device),
        "w_lora2": L.dense_init(gen, _LORA_W, d, device),
        "u": _const((n_h, hs), 0.0, device),
        "wr": L.dense_init(gen, d, d, device),
        "wk": L.dense_init(gen, d, d, device),
        "wv": L.dense_init(gen, d, d, device),
        "wg": L.dense_init(gen, d, d, device),
        "wo": L.dense_init(gen, d, d, device),
        "ln_x_scale": _const((d,), 1.0, device),
        "ln_x_bias": _const((d,), 0.0, device),
    }


def _shifted(x, x_prev_last):
    """The previous token of each position: x_prev_last [B, d] before
    x[:, 0], then x[:, :-1]."""
    return torch.cat([x_prev_last[:, None, :], x[:, :-1]], dim=1)


def _ddlerp(p, x, x_prev, dtype):
    """Data-dependent token-shift interpolation -> the 5 mixed inputs
    [B, T, 5, d]."""
    sx = x_prev - x
    base = x + sx * p["mu_x"].to(dtype)
    lo = torch.tanh(L.dense_apply(p["mix_w1"], base, dtype))
    lo = lo.reshape(*lo.shape[:-1], _N_MIX, _LORA_MIX)
    mix = torch.einsum("btnr,nrd->btnd", lo, p["mix_w2"].to(dtype))
    mu = p["mu_base"].to(dtype)[None, None] + mix
    return x[:, :, None, :] + sx[:, :, None, :] * mu


def _wkv_scan(r, k, v, w, u, state):
    """r, k, v, w: [B, T, H, hs]; u: [H, hs]; state: [B, H, hs, hs] ->
    (y [B, T, H, hs], state), one position after another."""
    ys = []
    bonus = u[None, :, :, None]
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]      # outer product
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               state + bonus * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(ys, dim=1), state


def timemix_apply(p, x, cfg, x_prev_last, state, dtype=torch.bfloat16):
    """x: [B, T, d] (normed); x_prev_last: [B, d], the token before
    x[:, 0]; state: the wkv state [B, H, hs, hs].  Returns (out, the
    shift state x[:, -1], the wkv state)."""
    b, t, d = x.shape
    n_h, hs = _heads(cfg)
    f32 = torch.float32
    spec = cfg.quant_spec()
    mixed = _ddlerp(p, x.to(f32), _shifted(x, x_prev_last).to(f32), f32)
    xw, xk, xv, xr, xg = mixed.unbind(dim=2)
    r = L.dense_apply(p["wr"], xr.to(dtype), dtype, spec)
    k = L.dense_apply(p["wk"], xk.to(dtype), dtype, spec)
    v = L.dense_apply(p["wv"], xv.to(dtype), dtype, spec)
    g = L.activation("silu")(L.dense_apply(p["wg"], xg.to(dtype), dtype,
                                           spec))
    # the data-dependent decay, in float32
    wlo = torch.tanh(L.dense_apply(p["w_lora1"], xw, f32))
    wln = p["w0"].to(f32) + L.dense_apply(p["w_lora2"], wlo, f32)
    w = torch.exp(-torch.exp(wln))                           # (0, 1)

    def split_heads(z):
        return z.to(f32).reshape(b, t, n_h, hs)
    y, state = _wkv_scan(split_heads(r), split_heads(k), split_heads(v),
                         split_heads(w), p["u"].to(f32), state)
    # per-head group norm: the population variance, eps 64e-5
    mu = y.mean(dim=-1, keepdim=True)
    var = torch.square(y - mu).sum(dim=-1, keepdim=True) / hs
    y = (y - mu) * torch.rsqrt(var + 64e-5)
    y = y.reshape(b, t, d) * p["ln_x_scale"].to(f32) + \
        p["ln_x_bias"].to(f32)
    out = L.dense_apply(p["wo"], y.to(dtype) * g, dtype, spec)
    return out, x[:, -1], state


def _sigmoid(x):
    """``jax.nn.sigmoid``: XLA expands it to 1 / (1 + exp(-x)), rounding
    each op in the input's dtype (``torch.sigmoid`` rounds bf16 once, a
    bf16 ulp apart on about a third of the values)."""
    return 1.0 / (1.0 + torch.exp(-x))


def chanmix_init(gen: torch.Generator, cfg, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"mu_k": _const((d,), 0.5, device),
            "mu_r": _const((d,), 0.5, device),
            "wk": L.dense_init(gen, d, f, device),
            "wv": L.dense_init(gen, f, d, device),
            "wr": L.dense_init(gen, d, d, device)}


def chanmix_apply(p, x, cfg, x_prev_last, dtype=torch.bfloat16):
    """The channel mix in the compute dtype: squared ReLU after an
    un-fused projection, gated by sigmoid(wr(xr)).  Returns (out, the
    shift state x[:, -1])."""
    spec = cfg.quant_spec()
    sx = _shifted(x, x_prev_last) - x
    xk = x + sx * p["mu_k"].to(dtype)
    xr = x + sx * p["mu_r"].to(dtype)
    k = torch.square(torch.relu(L.dense_apply(p["wk"], xk, dtype, spec)))
    kv = L.dense_apply(p["wv"], k, dtype, spec)
    return _sigmoid(L.dense_apply(p["wr"], xr, dtype, spec)) * kv, x[:, -1]


def rwkv_init(gen: torch.Generator, cfg, device) -> dict:
    return {"ln1": L.layernorm_init(cfg.d_model, device),
            "tm": timemix_init(gen, cfg, device),
            "ln2": L.layernorm_init(cfg.d_model, device),
            "cm": chanmix_init(gen, cfg, device)}


def rwkv_apply(p, x, cfg, state, dtype=torch.bfloat16):
    """One block over a whole sequence.  state: {'shift_tm', 'shift_cm',
    'wkv'} of this layer ([B, ...]); returns (x, the new state)."""
    h, shift_tm, wkv = timemix_apply(
        p["tm"], L.layernorm_apply(p["ln1"], x), cfg, state["shift_tm"],
        state["wkv"], dtype)
    x = x + h
    h, shift_cm = chanmix_apply(p["cm"], L.layernorm_apply(p["ln2"], x), cfg,
                                state["shift_cm"], dtype)
    return x + h, {"shift_tm": shift_tm, "shift_cm": shift_cm, "wkv": wkv}


def init_rwkv_state(cfg, batch: int, dtype=torch.float32,
                    device=None) -> dict:
    """One layer's zero state: the shifts [B, d] bf16, wkv [B, H, hs, hs]
    in ``dtype``."""
    dev = resolve_device(device)
    n_h, hs = _heads(cfg)
    d = cfg.d_model
    return {"shift_tm": torch.zeros((batch, d), dtype=torch.bfloat16,
                                    device=dev),
            "shift_cm": torch.zeros((batch, d), dtype=torch.bfloat16,
                                    device=dev),
            "wkv": torch.zeros((batch, n_h, hs, hs), dtype=dtype,
                               device=dev)}


def stacked_rwkv_state(cfg, batch: int, device=None) -> dict:
    """The per-layer zero state stacked on a leading axis: [L, B, ...]."""
    one = init_rwkv_state(cfg, batch, device=device)
    return {k: v[None].repeat(cfg.n_layers, *([1] * v.dim()))
            for k, v in one.items()}


def rwkv_lm_init(gen: torch.Generator, cfg, device) -> dict:
    """Random float32 params from ``gen``, on ``device``; the head is
    untied (``cfg.tie_embeddings`` is not read)."""
    return {
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, device),
        "ln_in": L.layernorm_init(cfg.d_model, device),
        "blocks": [rwkv_init(gen, cfg, device)
                   for _ in range(cfg.n_layers)],
        "ln_out": L.layernorm_init(cfg.d_model, device),
        "head": L.dense_init(gen, cfg.d_model, cfg.padded_vocab, device),
    }


def rwkv_lm_apply(params, tokens, cfg, state=None, return_state=False,
                  device=None):
    """tokens [B, T] -> logits [B, T, V] on ``device``, from ``state``
    (None: zeros).  Returns (logits, the new state) with
    ``return_state``, else (logits, a float32 zero aux loss)."""
    x, _, dtype = T._embed_inputs(params, tokens, cfg, device)
    x = L.layernorm_apply(params["ln_in"], x)
    if state is None:
        state = stacked_rwkv_state(cfg, x.shape[0], x.device)
    new = {k: [] for k in state}
    for i, layer in enumerate(params["blocks"]):
        x, st = rwkv_apply(layer, x, cfg, {k: v[i] for k, v in state.items()},
                           dtype)
        for k, v in st.items():
            new[k].append(v)
    x = L.layernorm_apply(params["ln_out"], x)
    logits = L.dense_apply(params["head"], x, dtype, cfg.quant_spec())
    if return_state:
        return logits, {k: torch.stack(v) for k, v in new.items()}
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def rwkv_lm_decode_step(params, tokens, pos, state, cfg):
    """One decode step: the forward over ``tokens`` [B, 1] from the
    carried ``state``; ``pos`` is not read (no position enters the
    recurrence).  Returns (logits [B, 1, V], the new state)."""
    del pos
    return rwkv_lm_apply(params, tokens, cfg, state, return_state=True,
                         device=state["wkv"].device)
