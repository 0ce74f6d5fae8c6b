"""Core library of the port: the paper's encodings, quantization grid and
the exact digit-plane GEMM reference, on torch tensors.

  encodings  -- MBE / EN-T / bit-serial bit-weight encodings (exact)
  quant      -- symmetric plane-bounded int8 quantization
  bw_ref     -- BW-decomposed GEMM reference (Eq. 4/5)
"""
from . import encodings, quant, bw_ref

__all__ = ["encodings", "quant", "bw_ref"]
