"""The paper's step-1 'encode' primitive: int8 operands -> EN-T radix-4
digit planes, fused with the per-block occupancy mask.  The Hopper kernel
(``csrc/encode.cu``) and its plain torch version.

The encoding is branch-free EN-T (sign-magnitude canonical radix-4):

    m     = |x|;  sign = x < 0 ? -1 : +1
    t_bw  = ((m >> 2bw) & 3) + carry_bw
    d_bw  = t==3 ? -1 : (t==4 ? 0 : t);   carry_{bw+1} = t >= 3

with the carry chain unrolled over the BW=4 planes of an int8.  The mask
flags each (plane, m-block, k-block) that holds a non-zero digit, so a
GEMM can skip a plane block without reading its digits.

The kernel encodes by table (:func:`ent_table`: byte p of word u is plane
p's digit of the int8 whose bits are u), one CTA a plan block.

``ent_encode`` launches the kernel for a CUDA tensor (or raises) and runs
the plain version for a CPU tensor; there is no fallback from one to the
other.  It counts its kernel launches in ``ent_encode.launches``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import encodings as enc
from . import ref as kref

__all__ = ["ent_encode", "ent_encode_plain", "ent_table", "BW"]

BW = 4  # int8 in radix 4


def ent_table() -> np.ndarray:
    """The kernel's lookup table: uint32 [256], byte p (little-endian) of
    word u being plane p's EN-T digit of the int8 whose bits are u."""
    values = np.arange(256, dtype=np.uint8).view(np.int8)
    digits = np.ascontiguousarray(enc.ent_digits_np(values), dtype=np.int8)
    return digits.view("<u4").reshape(256)


def _check(fn: str, x, block_m: int, block_k: int):
    if x.dim() != 2:
        raise ValueError(f"{fn}: expected x [M, K], got {tuple(x.shape)}")
    if x.dtype != torch.int8:
        raise TypeError(f"{fn}: x must be torch.int8, got {x.dtype}")
    m, k = x.shape
    for dim, name, blk, bname in ((m, "M", block_m, "block_m"),
                                  (k, "K", block_k, "block_k")):
        if blk <= 0 or dim % blk:
            raise ValueError(
                f"{fn}: {name}={dim} is not a multiple of {bname}={blk}; "
                f"pad the operand first (ops.plan_operand does this)")


def ent_encode_plain(x, *, block_m: int = 128, block_k: int = 128):
    """Plain torch version of :func:`ent_encode`: the EN-T oracle's digits
    and their block mask."""
    from .ops import plane_block_mask      # ops imports this module
    _check("ent_encode", x, block_m, block_k)
    digits = kref.encode_planes_ref(x, "ent", 8)
    return digits, plane_block_mask(digits, block_m, block_k)


def _lib():
    from . import _build
    lib = _build.load("encode")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ent_encode.argtypes = [p] * 4 + [i] * 4 + [p]
        lib.ent_encode.restype = i
        lib._argtypes_set = True
    return lib


# device index -> ent_table() on that device
_TABLES: dict = {}


def _table_on(device) -> torch.Tensor:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _TABLES:
        _TABLES[idx] = torch.from_numpy(ent_table().view(np.int32)).to(
            torch.device("cuda", idx))
    return _TABLES[idx]


def ent_encode(x, *, block_m: int = 128, block_k: int = 128):
    """int8 [M, K] -> (digits int8 [BW, M, K], mask bool [BW, M/bm, K/bk]).

    Shapes must divide the blocks (ops.plan_operand pads first).
    Replaces the reference's ``ent_encode`` Pallas kernel.
    """
    if x.device.type != "cuda":
        return ent_encode_plain(x, block_m=block_m, block_k=block_k)
    fn = "ent_encode"
    _check(fn, x, block_m, block_k)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{fn}: x must be contiguous and 16-byte aligned")
    if block_k % 16:
        raise ValueError(f"{fn}: block_k={block_k} is not a multiple of 16")
    m, k = x.shape
    digits = torch.empty((BW, m, k), dtype=torch.int8, device=x.device)
    mask = torch.empty((BW, m // block_m, k // block_k), dtype=torch.bool,
                       device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        table = _table_on(x.device)
        err = _lib().ent_encode(x.data_ptr(), table.data_ptr(),
                                digits.data_ptr(), mask.data_ptr(), m, k,
                                block_m, block_k, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error "
                           f"{err}")
    ent_encode.launches += 1
    return digits, mask


ent_encode.launches = 0
