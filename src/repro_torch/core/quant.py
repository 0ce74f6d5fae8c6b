"""Symmetric integer quantization for the BW-GEMM compute path.

The quantized matmul is ``y = (q_x @ q_w) * (s_x * s_w)``, with the
int8 x int8 -> int32 product computed by the bit-weight decomposed kernel
(``repro_torch.kernels.bw_gemm``) on the card.

Rounding is half-to-even (``torch.round``, as ``jnp.round``) and ``x /
scale`` stays a true division, so ``q`` and ``scale`` are bit-identical
to the reference's on the same float inputs.
"""
from __future__ import annotations

import torch

__all__ = ["symmetric_scale", "quantize", "plane_qmax", "quantize_to_planes",
           "quantize_for_spec"]


def _amax(x: torch.Tensor, axis) -> torch.Tensor:
    if axis is None:
        return x.abs().amax()
    return x.abs().amax(dim=axis, keepdim=True)


def symmetric_scale(x: torch.Tensor, axis=None, bits: int = 8,
                    eps: float = 1e-8) -> torch.Tensor:
    """Per-tensor (axis=None) or per-axis symmetric scale: max|x| / qmax."""
    qmax = float((1 << (bits - 1)) - 1)
    return torch.clamp_min(_amax(x, axis), eps) / qmax


def quantize(x: torch.Tensor, scale: torch.Tensor, bits: int = 8):
    """Round-to-nearest-even symmetric quantization to a signed integer."""
    qmax = (1 << (bits - 1)) - 1
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax)
    return q.to(torch.int8 if bits <= 8 else torch.int32)


def plane_qmax(planes: int, radix: int = 4, bits: int = 8) -> int:
    """Largest magnitude whose encoding uses only `planes` low digit planes.

    radix 4 (EN-T / MBE digit set {-2..2}): 2 * (4^p - 1) / 3
        -> {1:2, 2:10, 3:42, 4:170 (clipped to the int range)}.
    radix 2 (bit-serial, digit set {-1,0,1}): 2^p - 1.
    """
    int_max = (1 << (bits - 1)) - 1
    if radix == 4:
        return min(2 * (4 ** planes - 1) // 3, int_max)
    if radix == 2:
        return min((1 << planes) - 1, int_max)
    raise ValueError(f"unsupported radix {radix}")


def quantize_to_planes(x: torch.Tensor, planes: int = 4, axis=None,
                       radix: int = 4, bits: int = 8):
    """Symmetric quantization bounded to `planes` digit planes.

    Returns (q: int8, scale: float32).  With the default radix-4/int8
    grid, planes=4 is ordinary int8 and planes=3 leaves the 4^3 plane
    structurally empty.
    """
    qmax = plane_qmax(planes, radix, bits)
    scale = torch.clamp_min(_amax(x, axis), 1e-8) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def quantize_for_spec(x: torch.Tensor, spec, axis=None):
    """quantize_to_planes on the grid a repro_torch.engine.QuantSpec names."""
    return quantize_to_planes(x, spec.planes, axis=axis, radix=spec.radix,
                              bits=spec.bits)
