"""Plain torch oracles for the bit-weight GEMM kernels.

Integer results are exact (``core.bw_ref.exact_matmul``) and match the
kernels bit for bit.  Unlike the kernels, these take the multiplicand B in
the reference's ``[K, N]`` layout.
"""
from __future__ import annotations

import torch

from repro_torch.core import encodings as enc
from repro_torch.core.bw_ref import exact_matmul, weighted_plane_sum

__all__ = ["quant_gemm_ref", "encode_planes_ref", "bw_gemm_ref",
           "bw_gemm_masked_ref"]


def quant_gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 x int8 -> int32 GEMM oracle (the parallel-MAC baseline).

    a: int [M, K]; b: int [K, N].
    """
    return exact_matmul(a, b).to(torch.int32)


# Elements encoded at a time: the encoder's int32 temporaries take about
# 32 bytes an element, so a 256,000 x 6,144 LM head encoded whole would
# need 50 GB beside its weights; a block of rows needs about 2 GB.
ENCODE_BLOCK_ELEMS = 1 << 26


def encode_row_blocks(a: torch.Tensor, encoding: str = "ent",
                      bits: int = 8):
    """Yield (first row, digit planes int8 [BW, rows, K]) of int A [M, K],
    ENCODE_BLOCK_ELEMS elements at a time."""
    rows = max(1, ENCODE_BLOCK_ELEMS // max(a.shape[1], 1))
    for r0 in range(0, a.shape[0], rows):
        yield r0, enc.encode_torch(a[r0:r0 + rows], encoding,
                                   bits).movedim(-1, 0)


def encode_planes_ref(a: torch.Tensor, encoding: str = "ent",
                      bits: int = 8) -> torch.Tensor:
    """Encode int A [M, K] into digit planes [BW, M, K] (int8), a block
    of rows at a time."""
    out = torch.empty((enc.num_digits(encoding, bits), *a.shape),
                      dtype=torch.int8, device=a.device)
    for r0, planes in encode_row_blocks(a, encoding, bits):
        out[:, r0:r0 + planes.shape[1]] = planes
    return out


def bw_gemm_ref(digits: torch.Tensor, b: torch.Tensor,
                encoding: str = "ent") -> torch.Tensor:
    """C = sum_bw (digits[bw] @ B) * radix**bw, exact int32.

    digits: int8 [BW, M, K]; b: int8 [K, N].
    """
    return weighted_plane_sum(digits, b, enc.digit_weights(encoding))


def bw_gemm_masked_ref(digits: torch.Tensor, b: torch.Tensor,
                       mask: torch.Tensor, block_m: int, block_k: int,
                       encoding: str = "ent") -> torch.Tensor:
    """Oracle for the block-skipping kernel: plane blocks whose mask is
    False count as zero, whatever digits they hold.

    mask: bool [BW, M//block_m, K//block_k].
    """
    full = mask.repeat_interleave(block_m, 1).repeat_interleave(block_k, 2)
    masked = torch.where(full, digits, torch.zeros_like(digits))
    return bw_gemm_ref(masked, b, encoding)
