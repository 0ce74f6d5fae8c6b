"""The baseline tiled INT8 GEMM (the "parallel MAC" reference the paper
compares the bit-weight GEMM with): the Hopper kernels
(``csrc/quant_gemm.cu``) and their plain torch versions.

    quant_gemm        C[M, N] = A[M, K] @ B[K, N], exact int32
    quant_gemm_fused  C = act((A @ B) * scale + bias), float32 or bfloat16

A and B are int8 in the reference's layout: A K-contiguous, B ``[K, N]``
N-contiguous.  M, N and K must be multiples of ``block_m``, ``block_n``
and ``block_k`` (the reference's contract; the ``ops`` wrappers pad); the
kernel's own tiles are independent of them.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs
the plain version for CPU tensors; there is no fallback from one to the
other.  Each counts its launches in its ``launches`` attribute: one call
is one launch, though a call that splits K takes two on the card (the
partial products, then their sum and the epilogue).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.bw_ref import exact_matmul
from .bw_gemm import (_ACT_CODES, _check_devices, _check_epilogue,
                      _check_float32, _epilogue)

__all__ = ["quant_gemm", "quant_gemm_fused", "quant_gemm_plain",
           "quant_gemm_fused_plain", "OUT_DTYPES"]

# output dtypes the fused kernel writes
OUT_DTYPES = (torch.float32, torch.bfloat16)

# the kernel's K step (csrc kBK): a split of K covers a multiple of it
K_STEP = 64


def _check_gemm(fn: str, a, b, block_m: int, block_n: int, block_k: int,
                *vectors):
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"{fn}: expected a [M, K] and b [K, N]; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"{fn}: a has K={k} columns but b has K={k2} rows")
    for dim, name, blk, bname in ((m, "M", block_m, "block_m"),
                                  (n, "N", block_n, "block_n"),
                                  (k, "K", block_k, "block_k")):
        if blk <= 0 or dim % blk:
            raise ValueError(
                f"{fn}: {name}={dim} is not a multiple of {bname}={blk}; "
                f"pad the operands first (the ops wrappers do this)")
    for t, name in ((a, "a"), (b, "b")):
        if t.dtype != torch.int8:
            raise TypeError(f"{fn}: {name} must be torch.int8, got "
                            f"{t.dtype}")
    _check_devices(fn, a, b, *vectors)


def _check_fused(fn: str, a, b, scale, bias, activation, epilogue_axis,
                 out_dtype, blocks):
    _check_gemm(fn, a, b, *blocks, scale, bias)
    _check_epilogue(fn, activation, scale, bias, None, epilogue_axis,
                    a.shape[0], b.shape[1])
    if not out_dtype.is_floating_point:
        raise TypeError(f"{fn}: out_dtype must be a float dtype, got "
                        f"{out_dtype}")


# ---------------------------------------------------------------------------
# Plain versions (CPU path, and the card-side yardstick in chip_smoke.py)
# ---------------------------------------------------------------------------

def quant_gemm_plain(a, b, *, block_m: int = 128, block_n: int = 128,
                     block_k: int = 256) -> torch.Tensor:
    """Plain torch version of :func:`quant_gemm`: exact int32 [M, N]."""
    _check_gemm("quant_gemm", a, b, block_m, block_n, block_k)
    return exact_matmul(a, b).to(torch.int32)


def quant_gemm_fused_plain(a, b, scale, bias=None, *, activation=None,
                           epilogue_axis: str = "n",
                           out_dtype=torch.float32, block_m: int = 128,
                           block_n: int = 128,
                           block_k: int = 256) -> torch.Tensor:
    """Plain torch version of :func:`quant_gemm_fused`."""
    blocks = (block_m, block_n, block_k)
    _check_fused("quant_gemm_fused", a, b, scale, bias, activation,
                 epilogue_axis, out_dtype, blocks)
    acc = exact_matmul(a, b).to(torch.int32)
    y = _epilogue(acc, scale.to(torch.float32),
                  None if bias is None else bias.to(torch.float32), None,
                  activation)
    return y.to(out_dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _lib():
    from . import _build
    lib = _build.load("quant_gemm")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.quant_gemm_i32.argtypes = [p] * 4 + [i] * 6 + [p]
        lib.quant_gemm_i32.restype = i
        lib.quant_gemm_fused.argtypes = [p] * 6 + [i] * 9 + [p]
        lib.quant_gemm_fused.restype = i
        lib._argtypes_set = True
    return lib


def _launch_config(m: int, n: int, k: int, device):
    """(tile, splits, k_split) for the kernel: the tile shape (0: 64 x 64,
    1: 64 x 16 for N <= 16, 2: 16 x 64 for M <= 16), and a split of K over
    CTAs when the tiles alone give fewer than two CTAs an SM."""
    tile = 1 if n <= 16 < m else 2 if m <= 16 < n else 0
    bm, bn = {0: (64, 64), 1: (64, 16), 2: (16, 64)}[tile]
    tiles = -(-m // bm) * -(-n // bn)
    steps = -(-k // K_STEP)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = 1
    if tiles < 2 * sms:
        splits = max(1, min(-(-4 * sms // tiles), steps // 4))
    per = -(-steps // splits)
    return tile, -(-steps // per), per * K_STEP


def _check_cuda(fn: str, a, b, *vectors):
    for t in (a, b, *vectors):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{fn}: operands must be contiguous")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"{fn}: a and b must be 16-byte aligned")
    if a.shape[1] % 16:
        raise ValueError(f"{fn}: K={a.shape[1]} is not a multiple of 16")


def _launch(fn: str, entry: str, a, b, out, vectors=(), flags=()):
    """Launch ``entry`` of the library: (a, b, *vectors, out, ws, m, n, k,
    splits, k_split, tile, *flags, stream)."""
    m, k = a.shape
    n = b.shape[1]
    tile, splits, k_split = _launch_config(m, n, k, a.device)
    ws = (torch.empty((splits, m, n), dtype=torch.int32, device=a.device)
          if splits > 1 else None)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_lib(), entry)(
            a.data_ptr(), b.data_ptr(), *vectors, out.data_ptr(),
            None if ws is None else ws.data_ptr(), m, n, k, splits, k_split,
            tile, *flags, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error "
                           f"{err}")


def quant_gemm(a, b, *, block_m: int = 128, block_n: int = 128,
               block_k: int = 256) -> torch.Tensor:
    """int8 A [M, K] @ int8 B [K, N] -> exact int32 [M, N].

    Replaces the reference's ``quant_gemm`` Pallas kernel.
    """
    if a.device.type != "cuda":
        return quant_gemm_plain(a, b, block_m=block_m, block_n=block_n,
                                block_k=block_k)
    fn = "quant_gemm"
    _check_gemm(fn, a, b, block_m, block_n, block_k)
    _check_cuda(fn, a, b)
    out = torch.empty((a.shape[0], b.shape[1]), dtype=torch.int32,
                      device=a.device)
    _launch(fn, "quant_gemm_i32", a, b, out)
    quant_gemm.launches += 1
    return out


def quant_gemm_fused(a, b, scale, bias=None, *, activation=None,
                     epilogue_axis: str = "n", out_dtype=torch.float32,
                     block_m: int = 128, block_n: int = 128,
                     block_k: int = 256) -> torch.Tensor:
    """C = act((A @ B)_int * scale + bias), cast to ``out_dtype``.

    scale: f32 [1, N] (epilogue_axis='n') or [M, 1] (epilogue_axis='m');
    bias: optional, the same shape.  activation: a key of
    ``bw_gemm.EPILOGUE_ACTIVATIONS``, the epilogue B1 runs.  out_dtype:
    float32 or bfloat16 on the card.  Replaces the reference's
    ``quant_gemm_fused`` Pallas kernel.
    """
    blocks = (block_m, block_n, block_k)
    if a.device.type != "cuda":
        return quant_gemm_fused_plain(
            a, b, scale, bias, activation=activation,
            epilogue_axis=epilogue_axis, out_dtype=out_dtype,
            block_m=block_m, block_n=block_n, block_k=block_k)
    fn = "quant_gemm_fused"
    _check_fused(fn, a, b, scale, bias, activation, epilogue_axis,
                 out_dtype, blocks)
    _check_float32(fn, scale=scale, bias=bias)
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"{fn}: out_dtype must be one of {OUT_DTYPES} on "
                        f"the card, got {out_dtype}")
    _check_cuda(fn, a, b, scale, bias)
    out = torch.empty((a.shape[0], b.shape[1]), dtype=out_dtype,
                      device=a.device)
    _launch(fn, "quant_gemm_fused", a, b, out,
            (scale.data_ptr(), None if bias is None else bias.data_ptr()),
            (int(epilogue_axis == "n"), _ACT_CODES[activation],
             int(out_dtype == torch.bfloat16)))
    quant_gemm_fused.launches += 1
    return out


quant_gemm.launches = 0
quant_gemm_fused.launches = 0
