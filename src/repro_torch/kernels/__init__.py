"""Hopper kernels for the paper's compute hot spot, and their wrappers.

  bw_gemm    -- the bit-weight decomposed GEMM with digit-plane block
                skipping (``bw_gemm``) and its fused dequant/bias/activation
                form (``bw_gemm_fused``): CUDA C++ in ``csrc/bw_gemm.cu``;
                the same over a compacted block schedule, sparse
                (``bw_gemm_sparse[_fused]``) and pipelined
                (``bw_gemm_sparse[_fused]_pipelined``): ``csrc/
                bw_gemm_sparse.cu``; plain torch versions beside them all
  encode     -- the EN-T encoder fused with the occupancy mask
                (``ent_encode``): ``csrc/encode.cu``, and its plain version
  quant_gemm -- the "parallel MAC" int8 GEMM baseline (``quant_gemm``) and
                its fused-epilogue form (``quant_gemm_fused``):
                ``csrc/quant_gemm.cu``, and their plain versions
  ops        -- padding, weight planning and block schedules, dispatch,
                the quantized-dense entry points configured by a
                ``QuantSpec``, and the kernel-level API (``encode_planes``,
                ``plan_operand(encode_impl=)``, ``bw_gemm[_fused]``,
                ``quant_gemm[_fused]``)
  ref        -- plain torch oracles
  _build     -- nvcc build and ctypes loading of ``csrc/``, on first use
"""
from . import ops, ref, bw_gemm, encode, quant_gemm

__all__ = ["ops", "ref", "bw_gemm", "encode", "quant_gemm"]
