// Device helpers shared by the port's kernels: the int8 dot product and
// the fused epilogue's activations (bw_gemm.cu, bw_gemm_sparse.cu,
// quant_gemm.cu), and a 4 x 4 byte transpose (quant_gemm.cu, encode.cu).
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

// Four rows of four bytes (r_j holds b[k + j, n .. n + 3]) -> four
// columns of four K-consecutive bytes (c_i holds b[k .. k + 3, n + i]).
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1,
                                           uint32_t r2, uint32_t r3,
                                           uint32_t (&c)[4]) {
  const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);  // r0.0 r1.0 r0.1 r1.1
  const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);  // r0.2 r1.2 r0.3 r1.3
  const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
  const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(lo01, lo23, 0x5410);             // r0.0 r1.0 r2.0 r3.0
  c[1] = __byte_perm(lo01, lo23, 0x7632);             // r0.1 r1.1 r2.1 r3.1
  c[2] = __byte_perm(hi01, hi23, 0x5410);
  c[3] = __byte_perm(hi01, hi23, 0x7632);
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
