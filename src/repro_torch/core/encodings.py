"""Bit-weight (BW) dimension encodings of integer operands.

The four operand encodings of the paper ("Exploring the Performance
Improvement of Tensor Processing Engines through Transformation in the
Bit-weight Dimension of MACs"):

  * ``mbe``          -- Modified Booth Encoding, radix-4, digits {-2..2}.
  * ``ent``          -- EN-T: sign-magnitude canonical radix-4 recoding
                        (91 -> {1,2,-1,-1}, 124 -> {2,0,-1,0}).
  * ``bitserial``    -- radix-2 two's complement digits {-1,0,1}; the MSB
                        digit carries weight -2^(n-1).
  * ``bitserial_sm`` -- radix-2 sign-magnitude digits.

Every encoding satisfies ``value == sum_bw digit[bw] * radix**bw`` exactly
for all int8 inputs.  Each has a NumPy implementation and a torch one; the
torch versions are element-wise integer arithmetic and give the same
digits on the CPU and on the card.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "ENCODINGS", "num_digits", "radix", "digit_weights",
    "encode_np", "decode_np", "num_pps_np", "encode_torch", "decode_torch",
    "mbe_digits_np", "ent_digits_np", "bitserial_digits_np",
    "bitserial_sm_digits_np",
]

ENCODINGS = ("mbe", "ent", "bitserial", "bitserial_sm")

_BITS = 8  # the paper's INT8 setting; generalised via the `bits` argument.


def num_digits(encoding: str, bits: int = _BITS) -> int:
    """Number of BW positions `encoding` produces for a `bits`-wide input."""
    if encoding in ("mbe", "ent"):
        return (bits + 1) // 2
    if encoding in ("bitserial", "bitserial_sm"):
        return bits
    raise ValueError(f"unknown encoding {encoding!r}")


def radix(encoding: str) -> int:
    if encoding in ("mbe", "ent"):
        return 4
    if encoding in ("bitserial", "bitserial_sm"):
        return 2
    raise ValueError(f"unknown encoding {encoding!r}")


def digit_weights(encoding: str, bits: int = _BITS) -> np.ndarray:
    """Weight of each BW position: radix**bw (LSB first)."""
    r = radix(encoding)
    n = num_digits(encoding, bits)
    return r ** np.arange(n, dtype=np.int64)


# ---------------------------------------------------------------------------
# NumPy implementations
# ---------------------------------------------------------------------------

def mbe_digits_np(x, bits: int = _BITS) -> np.ndarray:
    """Modified Booth digits, LSB first:
    d_bw = -2*a[2bw+1] + a[2bw] + a[2bw-1]."""
    x = np.asarray(x)
    u = x.astype(np.int64) & ((1 << bits) - 1)
    n = (bits + 1) // 2
    out = np.empty(x.shape + (n,), dtype=np.int8)
    for bw in range(n):
        a_hi = (u >> (2 * bw + 1)) & 1
        a_mid = (u >> (2 * bw)) & 1
        a_lo = (u >> (2 * bw - 1)) & 1 if bw > 0 else np.zeros_like(u)
        out[..., bw] = (-2 * a_hi + a_mid + a_lo).astype(np.int8)
    return out


def ent_digits_np(x, bits: int = _BITS) -> np.ndarray:
    """EN-T digits, LSB first: sign-magnitude canonical radix-4 recoding."""
    x = np.asarray(x).astype(np.int64)
    sign = np.where(x < 0, -1, 1).astype(np.int64)
    m = np.abs(x)
    n = (bits + 1) // 2
    out = np.empty(x.shape + (n,), dtype=np.int8)
    carry = np.zeros_like(m)
    for bw in range(n):
        t = ((m >> (2 * bw)) & 3) + carry
        d = np.where(t == 3, -1, np.where(t == 4, 0, t))
        carry = (t >= 3).astype(np.int64)
        out[..., bw] = (sign * d).astype(np.int8)
    return out


def bitserial_digits_np(x, bits: int = _BITS) -> np.ndarray:
    """Two's complement radix-2 digits, LSB first; MSB digit is negated."""
    x = np.asarray(x)
    u = x.astype(np.int64) & ((1 << bits) - 1)
    out = np.empty(x.shape + (bits,), dtype=np.int8)
    for bw in range(bits):
        b = (u >> bw) & 1
        out[..., bw] = (-b if bw == bits - 1 else b).astype(np.int8)
    return out


def bitserial_sm_digits_np(x, bits: int = _BITS) -> np.ndarray:
    """Sign-magnitude radix-2 digits (paper Table III "bit-serial(M)")."""
    x = np.asarray(x).astype(np.int64)
    sign = np.where(x < 0, -1, 1).astype(np.int64)
    m = np.abs(x)
    out = np.empty(x.shape + (bits,), dtype=np.int8)
    for bw in range(bits):
        out[..., bw] = (sign * ((m >> bw) & 1)).astype(np.int8)
    return out


_NP_ENCODERS = {
    "mbe": mbe_digits_np,
    "ent": ent_digits_np,
    "bitserial": bitserial_digits_np,
    "bitserial_sm": bitserial_sm_digits_np,
}


def encode_np(x, encoding: str, bits: int = _BITS) -> np.ndarray:
    """Encode integers into BW digits (LSB first) with the chosen encoding."""
    return _NP_ENCODERS[encoding](x, bits)


def decode_np(digits, encoding: str, bits: int = _BITS) -> np.ndarray:
    """Inverse of encode: sum_bw digit[bw] * radix**bw."""
    w = digit_weights(encoding, bits)
    return (np.asarray(digits).astype(np.int64) * w).sum(axis=-1)


def num_pps_np(x, encoding: str, bits: int = _BITS) -> np.ndarray:
    """Number of non-zero partial products per element (paper Sec. II-C)."""
    return (encode_np(x, encoding, bits) != 0).sum(axis=-1)


# ---------------------------------------------------------------------------
# torch implementations (element-wise integer arithmetic, any device)
# ---------------------------------------------------------------------------

def _mbe_digits(x, bits):
    u = x.to(torch.int32) & ((1 << bits) - 1)
    ds = []
    for bw in range((bits + 1) // 2):
        a_hi = (u >> (2 * bw + 1)) & 1
        a_mid = (u >> (2 * bw)) & 1
        a_lo = ((u >> (2 * bw - 1)) & 1) if bw > 0 else torch.zeros_like(u)
        ds.append(-2 * a_hi + a_mid + a_lo)
    return ds


def _ent_digits(x, bits):
    xi = x.to(torch.int32)
    sign = torch.where(xi < 0, -1, 1).to(torch.int32)
    m = xi.abs()
    carry = torch.zeros_like(m)
    ds = []
    for bw in range((bits + 1) // 2):
        t = ((m >> (2 * bw)) & 3) + carry
        d = torch.where(t == 3, -1, torch.where(t == 4, 0, t))
        carry = (t >= 3).to(torch.int32)
        ds.append(sign * d)
    return ds


def _bitserial_digits(x, bits):
    u = x.to(torch.int32) & ((1 << bits) - 1)
    return [-((u >> bw) & 1) if bw == bits - 1 else (u >> bw) & 1
            for bw in range(bits)]


def _bitserial_sm_digits(x, bits):
    xi = x.to(torch.int32)
    sign = torch.where(xi < 0, -1, 1).to(torch.int32)
    m = xi.abs()
    return [sign * ((m >> bw) & 1) for bw in range(bits)]


_TORCH_ENCODERS = {
    "mbe": _mbe_digits,
    "ent": _ent_digits,
    "bitserial": _bitserial_digits,
    "bitserial_sm": _bitserial_sm_digits,
}


def encode_torch(x: torch.Tensor, encoding: str,
                 bits: int = _BITS) -> torch.Tensor:
    """Digits of integer tensor ``x`` stacked on a new trailing BW axis
    (int8, LSB first); the counterpart of the reference's ``encode_jnp``."""
    if encoding not in _TORCH_ENCODERS:
        raise ValueError(f"unknown encoding {encoding!r}")
    ds = _TORCH_ENCODERS[encoding](x, bits)
    return torch.stack([d.to(torch.int8) for d in ds], dim=-1)


def decode_torch(digits: torch.Tensor, encoding: str,
                 bits: int = _BITS) -> torch.Tensor:
    """Inverse of :func:`encode_torch`: sum_bw digit[bw] * radix**bw,
    as int32."""
    w = torch.as_tensor(digit_weights(encoding, bits), dtype=torch.int32,
                        device=digits.device)
    return (digits.to(torch.int32) * w).sum(dim=-1, dtype=torch.int32)
