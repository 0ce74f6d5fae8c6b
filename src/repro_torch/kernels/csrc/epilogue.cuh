// Device helpers shared by the bit-weight GEMM kernels (bw_gemm.cu,
// bw_gemm_sparse.cu): the int8 dot product and the fused epilogue's
// activations.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

enum Activation : int { kNone = 0, kSilu = 1, kGelu = 2, kRelu2 = 3 };

// acc + the int8 dot product of two 16-byte chunks, exact in int32.
__device__ __forceinline__ int dot16(const int4& a, const int4& b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  acc = __dp4a(a.w, b.w, acc);
  return acc;
}

__device__ __forceinline__ float activate(float y, int act) {
  // The plain versions' formulas: silu = y * (1 / (1 + exp(-y))), one
  // rounding a step, and the tanh-form gelu (whose plain version takes
  // y * (0.5 * (1 + tanh))); expf / tanhf differ from the host libraries
  // by a few ulps.
  constexpr float kBeta = 0.7978845608028654f;    // sqrt(2 / pi)
  constexpr float kKappa = 0.044715f;
  switch (act) {
    case kSilu:
      return __fmul_rn(y, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-y))));
    case kGelu: {
      const float inner = kBeta * (y + kKappa * y * y * y);
      return 0.5f * y * (1.0f + tanhf(inner));
    }
    case kRelu2: {
      const float r = fmaxf(y, 0.0f);
      return __fmul_rn(r, r);
    }
    default:
      return y;
  }
}
