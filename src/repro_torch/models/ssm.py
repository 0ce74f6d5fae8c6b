"""Selective state-space (Mamba-style) sequence mixer of the Hymba hybrid
blocks (``repro.models.ssm``): a scan over the sequence for the forward,
the same scan over one token with the carried state at decode.

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t        (per channel)
    y_t = C_t . h_t + D x_t

``in_proj`` and ``out_proj`` take ``cfg.quant_spec()`` and are planned;
``x_to_dt``, ``dt_proj`` and ``x_to_bc`` are float32 matmuls of a float32
input without a spec, never planned (``ops._NO_PLAN_KEYS``).  The causal
conv sums its K bf16 products in order; ``_selective_scan`` steps through
the sequence in order, a plain loop (the reference's ``jax.lax.scan``,
not a kernel there or here), rounding each op as the source reads.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device

from . import layers as L

__all__ = ["ssm_init", "ssm_apply", "ssm_decode_step", "init_ssm_state"]


def _d_inner(cfg) -> int:
    return cfg.ssm_expand * cfg.d_model


def ssm_init(gen: torch.Generator, cfg, device) -> dict:
    """Float32 params from ``gen``: ``a_log`` = log(1..n) on every channel
    and ``d_skip`` ones, as the reference sets them."""
    d, di, n = cfg.d_model, _d_inner(cfg), cfg.ssm_state
    dt_rank = max(d // 16, 1)
    return {
        "in_proj": L.dense_init(gen, d, 2 * di, device),
        "conv_w": L.truncated_normal(gen, (cfg.ssm_conv, di), 4.0, device),
        "x_to_dt": L.dense_init(gen, di, dt_rank, device),
        "dt_proj": L.dense_init(gen, dt_rank, di, device, bias=True),
        "x_to_bc": L.dense_init(gen, di, 2 * n, device),
        "a_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                        device=device)).expand(di, n)
        .contiguous(),
        "d_skip": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": L.dense_init(gen, di, d, device),
    }


def _causal_conv(x, w, conv_state=None):
    """Depthwise causal conv over time.  x: [B, T, C]; w: [K, C];
    conv_state: [B, K-1, C], the previous inputs (decode), or None
    (zeros).  The K products are summed in order in x's dtype.  Returns
    (out [B, T, C], the last K-1 inputs)."""
    k, t = w.shape[0], x.shape[1]
    if conv_state is None:
        conv_state = torch.zeros((x.shape[0], k - 1, x.shape[2]),
                                 dtype=x.dtype, device=x.device)
    xp = torch.cat([conv_state, x], dim=1)
    out = 0
    for i in range(k):
        out = out + xp[:, i:i + t] * w[i][None, None, :]
    return out, xp[:, -(k - 1):]


def _selective_scan(xs, dt, bmat, cmat, a, state):
    """xs, dt: [B, T, di]; bmat, cmat: [B, T, n]; a: [di, n]; state:
    [B, di, n] float32 -> (y [B, T, di], state), one position after
    another.  exp(dt * a) and (dt * x) * b hold no state, so they are
    taken for every position at once: the same elementwise ops on the
    same values."""
    da = torch.exp(dt[..., None] * a)                        # [B, T, di, n]
    dbx = (dt * xs)[..., None] * bmat[:, :, None, :]
    ys = []
    for t in range(xs.shape[1]):
        state = da[:, t] * state + dbx[:, t]
        ys.append(torch.einsum("bdn,bn->bd", state, cmat[:, t]))
    return torch.stack(ys, dim=1), state


def init_ssm_state(cfg, batch: int, device=None) -> dict:
    """One layer's zero state: ``h`` [B, di, n] float32 and ``conv``
    [B, K-1, di] bf16."""
    dev = resolve_device(device)
    di, n = _d_inner(cfg), cfg.ssm_state
    return {"h": torch.zeros((batch, di, n), dtype=torch.float32,
                             device=dev),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, di),
                                dtype=torch.bfloat16, device=dev)}


def _softplus(x):
    """``jax.nn.softplus``, i.e. ``jnp.logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(-|x|)).  XLA's float32 ``exp`` and ``log1p`` are its own,
    so values sit up to 2 float32 ulps apart (ROADMAP C11)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def ssm_apply(p, x, cfg, state=None, dtype=torch.bfloat16):
    """x: [B, T, d] -> (y [B, T, d], the new state {'h', 'conv'}); state
    None starts from zeros."""
    f32 = torch.float32
    if state is None:
        state = init_ssm_state(cfg, x.shape[0], x.device)
    xz = L.dense_apply(p["in_proj"], x, dtype, cfg.quant_spec())
    xs, z = torch.chunk(xz, 2, dim=-1)
    xs, conv_state = _causal_conv(xs, p["conv_w"].to(dtype),
                                  state["conv"].to(dtype))
    xs = L.activation("silu")(xs).to(f32)
    dt = _softplus(L.dense_apply(p["dt_proj"],
                                 L.dense_apply(p["x_to_dt"], xs, f32), f32))
    bmat, cmat = torch.chunk(L.dense_apply(p["x_to_bc"], xs, f32), 2, dim=-1)
    a = -torch.exp(p["a_log"].to(f32))
    y, h = _selective_scan(xs, dt, bmat, cmat, a, state["h"])
    y = y + xs * p["d_skip"].to(f32)[None, None]
    y = y.to(dtype) * L.activation("silu")(z)
    out = L.dense_apply(p["out_proj"], y, dtype, cfg.quant_spec())
    return out, {"h": h, "conv": conv_state.to(torch.bfloat16)}


def ssm_decode_step(p, x, cfg, state, dtype=torch.bfloat16):
    return ssm_apply(p, x, cfg, state, dtype)
