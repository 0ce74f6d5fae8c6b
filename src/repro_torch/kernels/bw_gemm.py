"""Bit-weight decomposed INT8 GEMM with digit-plane block skipping: the
Hopper kernels (``csrc/bw_gemm.cu``) and their plain torch versions.

The multiplicand A is pre-encoded into BW digit planes (radix 4: digits in
{-2..2}), and a per-(plane, m-block, k-block) occupancy mask lets the
kernel skip a plane block outright:

    C = sum_bw (masked digits[bw] @ B) * radix**bw      (paper Eq. (4)/(5))

Layout.  ``digits`` is int8 ``[BW, M, K]`` and K-contiguous; ``b`` holds
the activation rows as int8 ``[N, K]`` -- the transpose of the
reference's ``[K, N]`` B -- so both operands are read along K.  N (the
decode batch) is not padded.  M must be a multiple of ``block_m`` and K of
``block_k``; the ``ops`` wrappers pad.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
plain version for CPU tensors; there is no fallback from one to the other.
Each counts its kernel launches in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.bw_ref import weighted_plane_sum

__all__ = ["bw_gemm", "bw_gemm_fused", "bw_gemm_plain",
           "bw_gemm_fused_plain", "EPILOGUE_ACTIVATIONS"]

# Activations the fused epilogue can apply on the dequantized accumulator,
# in the reference's formulas.  silu is jax.nn.silu's x * sigmoid(x) with
# the sigmoid as 1 / (1 + exp(-x)) op by op: XLA rounds a bf16 sigmoid
# after each step, and the kernel epilogue computes the same steps in
# float32.  gelu is the tanh form, jax.nn.gelu's default.
EPILOGUE_ACTIVATIONS = {
    None: lambda x: x,
    "silu": lambda x: x * (1.0 / (1.0 + torch.exp(-x))),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu2": lambda x: torch.square(F.relu(x)),
}

# activation name -> the kernel's Activation enum
_ACT_CODES = {None: 0, "silu": 1, "gelu": 2, "relu2": 3}

# the kernel's CTA row tile (one row per warp, csrc kWarps): it must divide
# the plan's block_m so a CTA never straddles two mask rows
ROW_TILE = 8


# ---------------------------------------------------------------------------
# Validation shared by the kernels and the plain versions
# ---------------------------------------------------------------------------

def _check_operands(fn: str, digits, b, mask, block_m: int, block_k: int):
    if digits.dim() != 3 or b.dim() != 2 or mask.dim() != 3:
        raise ValueError(f"{fn}: expected digits [BW, M, K], b [N, K] and "
                         f"mask [BW, M/block_m, K/block_k]; got "
                         f"{tuple(digits.shape)}, {tuple(b.shape)}, "
                         f"{tuple(mask.shape)}")
    bw_n, m, k = digits.shape
    n, k2 = b.shape
    if k != k2:
        raise ValueError(f"{fn}: digits have K={k} but b has K={k2}")
    if n < 1:
        raise ValueError(f"{fn}: b has no rows")
    for dim, name, blk, bname in ((m, "M", block_m, "block_m"),
                                  (k, "K", block_k, "block_k")):
        if blk <= 0 or dim % blk:
            raise ValueError(
                f"{fn}: {name}={dim} is not a multiple of {bname}={blk}; "
                f"pad the operands first (the ops wrappers do this)")
    if tuple(mask.shape) != (bw_n, m // block_m, k // block_k):
        raise ValueError(
            f"{fn}: mask shape {tuple(mask.shape)} != expected "
            f"({bw_n}, {m // block_m}, {k // block_k}) = "
            f"[BW, M/block_m, K/block_k]")
    for t, name, dtype in ((digits, "digits", torch.int8),
                           (b, "b", torch.int8), (mask, "mask", torch.bool)):
        if t.dtype != dtype:
            raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype}")


def _check_epilogue(fn: str, activation, scale, bias, scale_n,
                    epilogue_axis: str, m: int, n: int):
    if activation not in EPILOGUE_ACTIVATIONS:
        raise ValueError(
            f"{fn}: unknown activation {activation!r}; expected one of "
            f"{sorted(a for a in EPILOGUE_ACTIVATIONS if a)} or None")
    if epilogue_axis not in ("m", "n"):
        raise ValueError(f"{fn}: epilogue_axis must be 'm' or 'n', got "
                         f"{epilogue_axis!r}")
    want = (m, 1) if epilogue_axis == "m" else (1, n)
    for t, name in ((scale, "scale"), (bias, "bias")):
        if t is not None and tuple(t.shape) != want:
            raise ValueError(f"{fn}: {name} shape {tuple(t.shape)} != "
                             f"expected {want}")
    if scale_n is not None:
        if epilogue_axis != "m":
            raise ValueError(f"{fn}: scale_n only supports "
                             f"epilogue_axis='m'")
        if tuple(scale_n.shape) != (1, n):
            raise ValueError(f"{fn}: scale_n shape {tuple(scale_n.shape)} "
                             f"!= expected (1, {n})")


# ---------------------------------------------------------------------------
# Plain versions (CPU path, and the card-side yardstick in chip_smoke.py)
# ---------------------------------------------------------------------------

def bw_gemm_plain(digits, b, mask, *, block_m: int, block_k: int,
                  radix: int = 4) -> torch.Tensor:
    """Plain torch version of :func:`bw_gemm`: exact int32 [M, N]."""
    _check_operands("bw_gemm", digits, b, mask, block_m, block_k)
    full = mask.repeat_interleave(block_m, 1).repeat_interleave(block_k, 2)
    masked = torch.where(full, digits, torch.zeros_like(digits))
    return weighted_plane_sum(masked, b.t(),
                              [radix ** p for p in range(digits.shape[0])])


def _epilogue(acc, scale, bias, scale_n, activation):
    s = scale if scale_n is None else scale * scale_n
    y = acc.to(torch.float32) * s
    if bias is not None:
        y = y + bias
    return EPILOGUE_ACTIVATIONS[activation](y)


def bw_gemm_fused_plain(digits, b, mask, scale, bias=None, scale_n=None, *,
                        block_m: int, block_k: int, radix: int = 4,
                        activation=None,
                        epilogue_axis: str = "m") -> torch.Tensor:
    """Plain torch version of :func:`bw_gemm_fused`: f32 [M, N]."""
    _check_epilogue("bw_gemm_fused", activation, scale, bias, scale_n,
                    epilogue_axis, digits.shape[1], b.shape[0])
    acc = bw_gemm_plain(digits, b, mask, block_m=block_m, block_k=block_k,
                        radix=radix)
    return _epilogue(acc, scale.to(torch.float32),
                     None if bias is None else bias.to(torch.float32),
                     None if scale_n is None else scale_n.to(torch.float32),
                     activation)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _lib():
    from . import _build
    lib = _build.load("bw_gemm")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bw_gemm_i32.argtypes = [p, p, p, p] + [i] * 7 + [p]
        lib.bw_gemm_i32.restype = i
        lib.bw_gemm_fused.argtypes = [p] * 7 + [i] * 9 + [p]
        lib.bw_gemm_fused.restype = i
        lib._argtypes_set = True
    return lib


def _check_cuda(fn: str, block_m: int, block_k: int, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{fn}: all operands must be on {dev}, got "
                             f"one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: operands must be contiguous")
    for t in tensors[:2]:                        # digits and b: int4 loads
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: digits and b must be 16-byte aligned")
    if block_m % ROW_TILE:
        raise ValueError(f"{fn}: block_m={block_m} is not a multiple of "
                         f"the kernel's row tile {ROW_TILE}")
    if block_k % 16:
        raise ValueError(f"{fn}: block_k={block_k} is not a multiple of 16")
    if tensors[0].shape[0] > 8:
        raise ValueError(f"{fn}: at most 8 digit planes, got "
                         f"{tensors[0].shape[0]}")


def _raise_on(fn: str, err: int):
    if err != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error "
                           f"{err}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def bw_gemm(digits, b, mask, *, block_m: int = 128, block_k: int = 256,
            radix: int = 4) -> torch.Tensor:
    """C[M, N] = sum_bw (masked digits[bw] @ b.T) * radix**bw, int32.

    digits: int8 [BW, M, K]; b: int8 [N, K]; mask: bool [BW, M/block_m,
    K/block_k].  Replaces the reference's ``bw_gemm`` Pallas kernel.
    """
    if digits.device.type != "cuda":
        return bw_gemm_plain(digits, b, mask, block_m=block_m,
                             block_k=block_k, radix=radix)
    _check_operands("bw_gemm", digits, b, mask, block_m, block_k)
    _check_cuda("bw_gemm", block_m, block_k, digits, b, mask)
    bw_n, m, k = digits.shape
    n = b.shape[0]
    out = torch.empty((m, n), dtype=torch.int32, device=digits.device)
    with torch.cuda.device(digits.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().bw_gemm_i32(
            digits.data_ptr(), b.data_ptr(), mask.data_ptr(),
            out.data_ptr(), bw_n, m, k, n, block_m, block_k, radix, stream)
    _raise_on("bw_gemm", err)
    bw_gemm.launches += 1
    return out


def bw_gemm_fused(digits, b, mask, scale, bias=None, scale_n=None, *,
                  block_m: int = 128, block_k: int = 256, radix: int = 4,
                  activation=None, epilogue_axis: str = "m") -> torch.Tensor:
    """C = act((sum_bw (masked digits[bw] @ b.T) * radix**bw) * s + bias).

    scale: f32 [M, 1] (epilogue_axis='m': weight channels on M, the
    planned-weight layout) or [1, N] (epilogue_axis='n').  bias: optional,
    same shape as scale.  scale_n: optional f32 [1, N] on the other axis
    (epilogue_axis='m' only) -- the per-token activation scales; the
    epilogue forms s = scale * scale_n before it touches the accumulator.
    Returns f32 [M, N].  Replaces the reference's ``bw_gemm_fused``.
    """
    if digits.device.type != "cuda":
        return bw_gemm_fused_plain(
            digits, b, mask, scale, bias, scale_n, block_m=block_m,
            block_k=block_k, radix=radix, activation=activation,
            epilogue_axis=epilogue_axis)
    _check_operands("bw_gemm_fused", digits, b, mask, block_m, block_k)
    bw_n, m, k = digits.shape
    n = b.shape[0]
    _check_epilogue("bw_gemm_fused", activation, scale, bias, scale_n,
                    epilogue_axis, m, n)
    for t, name in ((scale, "scale"), (bias, "bias"), (scale_n, "scale_n")):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"bw_gemm_fused: {name} must be float32, got "
                            f"{t.dtype}")
    _check_cuda("bw_gemm_fused", block_m, block_k, digits, b, mask, scale,
                bias, scale_n)
    out = torch.empty((m, n), dtype=torch.float32, device=digits.device)
    with torch.cuda.device(digits.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().bw_gemm_fused(
            digits.data_ptr(), b.data_ptr(), mask.data_ptr(),
            scale.data_ptr(), _ptr(scale_n), _ptr(bias), out.data_ptr(),
            bw_n, m, k, n, block_m, block_k, radix,
            int(epilogue_axis == "n"), _ACT_CODES[activation], stream)
    _raise_on("bw_gemm_fused", err)
    bw_gemm_fused.launches += 1
    return out


bw_gemm.launches = 0
bw_gemm_fused.launches = 0
