"""Reference implementation of the paper's bit-weight decomposed matrix
multiplication (Eq. (4)/(5)) on torch tensors:

    C[m,n] = sum_bw shift(bw) * sum_k digit(A[m,k], bw) * B[k,n]

It is the exact oracle behind the ``planes`` engine.  Torch has no int32
matmul on CUDA, so :func:`exact_matmul` multiplies integer operands in
float64 there (exact while every partial sum stays below 2^53, which holds
for int8 operands and any K below 2^37) and in int64 on the CPU.
Float32 is never used: 127 * 127 * 5760 already exceeds 2^24.
"""
from __future__ import annotations

import torch

from . import encodings as enc

__all__ = ["exact_matmul", "bw_matmul", "weighted_plane_sum"]


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product of integer tensors ``a @ b`` as int64."""
    if a.device.type == "cuda":
        return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64)
    return a.to(torch.int64) @ b.to(torch.int64)


def bw_matmul(a: torch.Tensor, b: torch.Tensor, encoding: str = "ent",
              bits: int = 8) -> torch.Tensor:
    """C = A @ B via the BW decomposition of A; exact int32 result.

    a: int [M, K], b: int [K, N].  The shift is applied *after* the K
    reduction (the OPT2 "reduction under the same bit-weight" ordering).
    """
    digits = enc.encode_torch(a, encoding, bits).movedim(-1, 0)  # [BW,M,K]
    return weighted_plane_sum(digits, b, enc.digit_weights(encoding, bits))


def weighted_plane_sum(digits: torch.Tensor, b: torch.Tensor,
                       weights) -> torch.Tensor:
    """sum_p (digits[p] @ b) * weights[p], exact int32 (one matmul for all
    planes).  digits: int [BW, M, K]; b: int [K, N]."""
    bw_n, m, k = digits.shape
    pp = exact_matmul(digits.reshape(bw_n * m, k), b).reshape(bw_n, m, -1)
    w = torch.as_tensor([int(x) for x in weights], dtype=torch.int64,
                        device=pp.device)
    return (pp * w[:, None, None]).sum(dim=0).to(torch.int32)
