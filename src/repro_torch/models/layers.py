"""Shared neural-net building blocks: plain functions on torch tensors.

Every ``*_init`` returns a dict of tensors in the reference's param-tree
layout (``repro.models.layers``), drawn from an explicit
``torch.Generator``; every ``*_apply`` computes in the compute dtype
(bf16 by default), with norms, RoPE and softmax in float32, as the
reference does.

Quantized execution is configured per call by the
:class:`repro_torch.engine.QuantSpec` passed to ``dense_apply``; its
``impl`` names the registered GemmEngine.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch import engine as englib
from repro_torch.kernels.bw_gemm import EPILOGUE_ACTIVATIONS

__all__ = [
    "dense_init", "dense_apply", "rmsnorm_init", "rmsnorm_apply",
    "layernorm_init", "layernorm_apply", "embed_init", "embed_apply",
    "embed_logits", "rope", "activation",
]


def truncated_normal(gen: torch.Generator, shape, scale: float,
                     device) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], times scale / sqrt(fan_in) (float32)."""
    stddev = scale / math.sqrt(max(shape[0], 1))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(stddev)


# ---------------------------------------------------------------------------
# Dense / projection layers
# ---------------------------------------------------------------------------

def dense_init(gen, d_in: int, d_out: int, device, bias: bool = False,
               scale: float = 1.0) -> dict:
    p = {"w": truncated_normal(gen, (d_in, d_out), scale, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=device)
    return p


def dense_apply(p: dict, x: torch.Tensor, dtype=torch.bfloat16, quant=None,
                activation: Optional[str] = None) -> torch.Tensor:
    """y = act(x @ w (+ b)), w in the reference's [d_in, d_out] layout.

    quant: a QuantSpec (models pass ``cfg.quant_spec()``) or None for the
    bf16 matmul.  An enabled spec routes through the engine its ``impl``
    names: the kernel engines take the pre-planned ``w_plan`` record when
    one is attached to ``p`` (ops.plan_params), the plain engines the raw
    weight.
    """
    w = p["w"]
    b = p.get("b")
    spec = englib.QuantSpec.coerce(quant)
    if spec is not None:
        eng = englib.get_engine(spec.impl)
        plan = p.get("w_plan") if eng.uses_plans else None
        if plan is not None:
            return eng.apply(plan, x, spec, n_out=w.shape[-1], bias=b,
                             activation=activation, out_dtype=dtype)
        return eng.apply(w, x, spec, bias=b, activation=activation,
                         out_dtype=dtype)
    y = x.to(dtype) @ w.to(dtype)
    if b is not None:
        y = y + b.to(dtype)
    if activation is not None:
        y = EPILOGUE_ACTIVATIONS[activation](y)
    return y


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm_apply(p: dict, x: torch.Tensor, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


def layernorm_init(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm_apply(p: dict, x: torch.Tensor, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def embed_init(gen, vocab: int, d: int, device) -> dict:
    return {"table": truncated_normal(gen, (vocab, d), math.sqrt(d), device)}


def embed_apply(p: dict, tokens: torch.Tensor, dtype=torch.bfloat16):
    """Rows of the table for int tokens [B, T] -> [B, T, d] in dtype."""
    return p["table"][tokens.long()].to(dtype)


def embed_logits(p: dict, x: torch.Tensor, dtype=torch.bfloat16):
    """Tied decode head: x [.., d] @ table.T -> [.., vocab]."""
    return x.to(dtype) @ p["table"].to(dtype).t()


# ---------------------------------------------------------------------------
# RoPE + activations
# ---------------------------------------------------------------------------

def rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
         head_dim: int, theta: float = 1e4):
    """Rotary embeddings.  q, k: [B, T, H, D]; positions: [B, T] int."""
    half = head_dim // 2
    # frequencies in numpy float32, exactly as the reference computes them
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    freqs = torch.as_tensor(freqs, device=q.device)
    angles = positions[..., None].to(torch.float32) * freqs   # [B, T, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]

    def rot(x):
        x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin,
                          x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    return rot(q), rot(k)


def activation(name: str):
    """The activation ``name`` of the fused epilogue's table."""
    if name is None or name not in EPILOGUE_ACTIVATIONS:
        raise ValueError(name)
    return EPILOGUE_ACTIVATIONS[name]
