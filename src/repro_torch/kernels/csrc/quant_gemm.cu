// The "parallel MAC" baseline: a tiled int8 x int8 -> int32 GEMM, and its
// form with the fused dequant/bias/activation epilogue, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// repro_torch/kernels/_build.py; no PyTorch headers.
//
// Replaces the TPU Pallas kernels of src/repro/kernels/quant_gemm.py:
//   quant_gemm_i32   <- quant_gemm       (body _kernel :21, pallas_call :43)
//   quant_gemm_fused <- quant_gemm_fused (body _fused_kernel :56,
//                                         pallas_call :107)
//
// Both compute acc[m, n] = sum_k a[m, k] * b[k, n] exactly in int32, with
// a int8 [M, K] (K-contiguous) and b int8 [K, N] in the reference's
// layout (N-contiguous): in quant_gemm_fused(x, w) the b operand is the
// weight, and a transposed copy a call would move the whole weight once
// more.  quant_gemm_fused then runs, once per output element, the
// reference's epilogue in its order, with the round-to-nearest
// intrinsics of bw_gemm.cu (epilogue.cuh) so that nvcc cannot contract it
// into an FMA:
//   y = float(acc) * scale[v];  y = y + bias[v];  y = act(y);  cast
// where v = n (epilogue axis 'n', scale/bias [1, N]) or m (axis 'm',
// [M, 1]); there is no second scale (the reference's quant_gemm_fused
// multiplies the accumulator by scale directly, quant_gemm.py:69-74).
//
// Bound on the H100: at decode (one side 1 to 4 rows) bytes, the int8
// weight read once; at M, N of 512 and more, operations -- against the
// tensor cores' 1,979 int8 TOP/s, which this kernel does not use.
//
// What the design does about it (a simple kernel, right first):
//   * a CTA of 256 threads (16 x 16) owns a 16*TM x 16*TN tile of C, a
//     thread TM x TN outputs strided by 16 rows and 16 columns, so the
//     shared-memory reads of a warp hit distinct banks or broadcast;
//     tiles are 64 x 64, 64 x 16 when N <= 16 (the planned orientation,
//     N the decode batch) and 16 x 64 when M <= 16 (the serving
//     orientation, M the decode batch), chosen by the wrapper;
//   * K is walked 64 bytes a step: the a tile [BM, 64] comes in with
//     16-byte loads, four K-consecutive bytes a 32-bit word; the b tile
//     [64, BN] comes in as 32-bit words of four N-consecutive bytes from
//     four K-consecutive rows, turned by a 4 x 4 byte transpose
//     (__byte_perm) into four words of four K-consecutive bytes of one
//     column, so __dp4a reads both operands as K quads;
//   * at decode M x N gives a few dozen tiles for 132 SMs, so the wrapper
//     splits K over `splits` CTAs a tile (grid z): each writes its int32
//     partial sums into a workspace [splits, M, N], and a second launch
//     adds them in split order (integer addition: exact whatever the
//     order) and runs the epilogue; with one split the epilogue runs in
//     the first launch and there is no workspace;
//   * ragged M, N and K edges are masked (K a multiple of 16).
// No tensor cores (mma.sync / wgmma s8), no TMA, no double buffering:
// later work.

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;    // 16 x 16
constexpr int kBK = 64;          // K bytes a step
constexpr int kKQ = kBK / 4;     // K quads (32-bit words) a step

struct Gemm {
  const int8_t* a;   // [m, k]
  const int8_t* b;   // [k, n]
  int m, n, k;
  int k_split;       // K bytes a split, a multiple of kBK
};

// Where a finished accumulator goes: int32 (out_i32), or through the
// epilogue to float32 / bfloat16 (out_f32 / out_bf16).
struct Epilogue {
  const float* scale;    // [n] (axis_n) or [m]; nullptr: no epilogue
  const float* bias;     // same shape as scale, or nullptr
  int axis_n, act;
  int32_t* out_i32;
  float* out_f32;
  __nv_bfloat16* out_bf16;
};

__device__ __forceinline__ void store(const Epilogue& e, int n_cols, int m,
                                      int n, int acc) {
  const size_t idx = static_cast<size_t>(m) * n_cols + n;
  if (e.scale == nullptr) {
    e.out_i32[idx] = acc;
    return;
  }
  const int v = e.axis_n ? n : m;
  float y = __fmul_rn(__int2float_rn(acc), e.scale[v]);
  if (e.bias != nullptr) y = __fadd_rn(y, e.bias[v]);
  y = activate(y, e.act);
  if (e.out_bf16 != nullptr) e.out_bf16[idx] = __float2bfloat16_rn(y);
  else e.out_f32[idx] = y;
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

// b[row, n0 .. n0 + 3] as one little-endian word, zero past the edges.
__device__ __forceinline__ uint32_t load_b4(const Gemm& g, int row, int n0,
                                            int k_end) {
  if (row >= k_end || n0 >= g.n) return 0u;
  const int8_t* p = g.b + static_cast<size_t>(row) * g.n + n0;
  if ((g.n & 3) == 0) return __ldg(reinterpret_cast<const uint32_t*>(p));
  uint32_t w = 0u;
  for (int i = 0; i < 4 && n0 + i < g.n; ++i)
    w |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + i))) << (8 * i);
  return w;
}

template <int TM, int TN>
__global__ void __launch_bounds__(kThreads)
quant_gemm_kernel(Gemm g, Epilogue e, int32_t* __restrict__ ws) {
  constexpr int BM = 16 * TM;
  constexpr int BN = 16 * TN;
  __shared__ uint32_t a_s[BM][kKQ];    // a_s[r][q] = a[m0 + r, k0 + 4q ..]
  __shared__ uint32_t b_s[kKQ][BN];    // b_s[q][c] = b[k0 + 4q .., n0 + c]
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * g.k_split;
  const int k_end = min(g.k, k_begin + g.k_split);

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    // a tile: BM rows x 4 chunks of 16 bytes
    for (int c = tid; c < BM * (kBK / 16); c += kThreads) {
      const int r = c >> 2;
      const int kk = k0 + ((c & 3) << 4);
      int4 v = make_int4(0, 0, 0, 0);
      if (m0 + r < g.m && kk < k_end)
        v = __ldg(reinterpret_cast<const int4*>(
            g.a + static_cast<size_t>(m0 + r) * g.k + kk));
      const int q = (c & 3) << 2;
      a_s[r][q] = static_cast<uint32_t>(v.x);
      a_s[r][q + 1] = static_cast<uint32_t>(v.y);
      a_s[r][q + 2] = static_cast<uint32_t>(v.z);
      a_s[r][q + 3] = static_cast<uint32_t>(v.w);
    }
    // b tile: kKQ quads x BN / 4 groups of four columns
    for (int c = tid; c < kKQ * (BN / 4); c += kThreads) {
      const int q = c / (BN / 4);
      const int col = (c - q * (BN / 4)) << 2;
      const int row = k0 + 4 * q;
      uint32_t cols[4];
      transpose4(load_b4(g, row, n0 + col, k_end),
                 load_b4(g, row + 1, n0 + col, k_end),
                 load_b4(g, row + 2, n0 + col, k_end),
                 load_b4(g, row + 3, n0 + col, k_end), cols);
#pragma unroll
      for (int i = 0; i < 4; ++i) b_s[q][col + i] = cols[i];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kKQ; ++q) {
      int av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = static_cast<int>(a_s[ty + 16 * i][q]);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        bv[j] = static_cast<int>(b_s[q][tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= g.m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= g.n) continue;
      if (gridDim.z == 1) {
        store(e, g.n, m, n, acc[i][j]);
      } else {
        ws[(static_cast<size_t>(blockIdx.z) * g.m + m) * g.n + n] = acc[i][j];
      }
    }
  }
}

// The split-K partials of every output element, added in split order,
// through the epilogue.
__global__ void __launch_bounds__(kThreads)
quant_gemm_reduce_kernel(const int32_t* __restrict__ ws, int splits, int m,
                         int n, Epilogue e) {
  const size_t total = static_cast<size_t>(m) * n;
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  int acc = 0;
  for (int s = 0; s < splits; ++s) acc += ws[s * total + idx];
  store(e, n, static_cast<int>(idx / n), static_cast<int>(idx % n), acc);
}

template <int TM, int TN>
void launch_tiles(const Gemm& g, const Epilogue& e, int32_t* ws, int splits,
                  cudaStream_t stream) {
  const dim3 grid((g.n + 16 * TN - 1) / (16 * TN),
                  (g.m + 16 * TM - 1) / (16 * TM), splits);
  quant_gemm_kernel<TM, TN><<<grid, kThreads, 0, stream>>>(g, e, ws);
}

// tile: 0 -> 64 x 64, 1 -> 64 x 16 (small N), 2 -> 16 x 64 (small M).
int run(const Gemm& g, const Epilogue& e, int32_t* ws, int splits, int tile,
        cudaStream_t stream) {
  if (g.m < 1 || g.n < 1 || g.k < 16 || g.k % 16 != 0 || splits < 1 ||
      g.k_split < kBK || g.k_split % kBK != 0 ||
      static_cast<long long>(splits - 1) * g.k_split >= g.k ||
      (splits > 1 && ws == nullptr) || tile < 0 || tile > 2 ||
      (g.m + 15) / 16 > 65535 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tile == 1) launch_tiles<4, 1>(g, e, ws, splits, stream);
  else if (tile == 2) launch_tiles<1, 4>(g, e, ws, splits, stream);
  else launch_tiles<4, 4>(g, e, ws, splits, stream);
  if (splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t total = static_cast<size_t>(g.m) * g.n;
    const unsigned blocks =
        static_cast<unsigned>((total + kThreads - 1) / kThreads);
    quant_gemm_reduce_kernel<<<blocks, kThreads, 0, stream>>>(ws, splits, g.m,
                                                              g.n, e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success).  a: int8 [m, k]; b: int8 [k, n]; a
// and b 16-byte aligned; ws: int32 [splits, m, n] when splits > 1, else
// unused.  Split s covers K bytes [s * k_split, (s + 1) * k_split).
extern "C" int quant_gemm_i32(const void* a, const void* b, void* out,
                              void* ws, int m, int n, int k, int splits,
                              int k_split, int tile, void* stream) {
  const Gemm g{static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
               m, n, k, k_split};
  const Epilogue e{nullptr, nullptr, 0, 0, static_cast<int32_t*>(out),
                   nullptr, nullptr};
  return run(g, e, static_cast<int32_t*>(ws), splits, tile,
             static_cast<cudaStream_t>(stream));
}

// scale, bias: float32 [n] (axis_n) or [m]; bias may be null.  out:
// float32 [m, n], or bfloat16 when out_bf16.
extern "C" int quant_gemm_fused(const void* a, const void* b,
                                const void* scale, const void* bias,
                                void* out, void* ws, int m, int n, int k,
                                int splits, int k_split, int tile, int axis_n,
                                int act, int out_bf16, void* stream) {
  if (scale == nullptr || act < kNone || act > kRelu2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Gemm g{static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
               m, n, k, k_split};
  const Epilogue e{static_cast<const float*>(scale),
                   static_cast<const float*>(bias), axis_n, act, nullptr,
                   out_bf16 ? nullptr : static_cast<float*>(out),
                   out_bf16 ? static_cast<__nv_bfloat16*>(out) : nullptr};
  return run(g, e, static_cast<int32_t*>(ws), splits, tile,
             static_cast<cudaStream_t>(stream));
}
