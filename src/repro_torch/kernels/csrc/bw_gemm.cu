// Bit-weight decomposed INT8 GEMM with digit-plane block skipping, for
// Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// repro_torch/kernels/_build.py; no PyTorch headers.
//
// Replaces the TPU Pallas kernels of src/repro/kernels/bw_gemm.py:
//   bw_gemm_i32    <- bw_gemm        (body _kernel,       pallas_call :154)
//   bw_gemm_fused  <- bw_gemm_fused  (body _fused_kernel, pallas_call :263)
//
// Both compute, for every row m of the planned weight and column n:
//   acc[m, n] = sum_p radix^p * sum_{k : mask[p, m/bm, k/bk]}
//                                  digits[p, m, k] * b[n, k]
// in int32 (the deferred shift of the paper's OPT2: one multiply by
// radix^p per plane partial sum, never per partial product).  A plane
// block whose mask bit is False is skipped and its digits are never read,
// even when they are non-zero (bw_gemm_masked_ref's contract).
// bw_gemm_i32 stores acc.  bw_gemm_fused runs the dequant epilogue on the
// register-resident accumulator, in the reference's order, with explicit
// round-to-nearest intrinsics so nvcc cannot contract it into an FMA:
//   s = scale * scale_n;  y = float(acc) * s;  y = y + bias;  y = act(y).
//
// Bound on the H100: bytes.  Decode N is the batch (1 to 4), so each
// digit byte feeds at most 4 multiply-adds: about 2 operations per byte
// read, against the ~590 int8 operations per byte at which the card turns
// compute-bound.  The work is one pass over the live digit planes
// (3 * M * K bytes at planes=3), at 3.35 TB/s.  At the path's sizes a call
// also pays a fixed cost the bytes do not explain: the launch, the round
// trip for the mask bits before the first digit load, and the ramp of the
// memory system; past it the loads below stream at about 60% of the
// data-sheet rate, faster than PyTorch's own reductions over the same
// bytes (PERF.md, chip_smoke.py's stream_ms).
//
// What the design does about it:
//   * one warp per output row, eight rows per CTA: M = 2304 gives 288
//     CTAs and M = 5760 gives 720 for 132 SMs, where the TPU's 128-row
//     tiles would give 18 to 45; registers are capped so three CTAs fit
//     an SM (fewer past four columns or four planes, whose tiles hold
//     more registers, so that nothing spills), and every warp of an
//     M = 2304 product is resident at once;
//   * each lane reads 16 contiguous K bytes of every live plane per step
//     (int4 loads: a warp moves 512 bytes of one row per plane, fully
//     coalesced, as the digits are K-contiguous), issuing all planes'
//     loads and the step's activation chunks before any arithmetic, and
//     __dp4a does 4 int8 products per instruction in exact int32;
//   * the mask bits of a row are fetched once per 32 k-blocks into
//     registers (one ballot per plane), so no digit load waits on a mask
//     load and a dead plane costs no memory traffic at all; no warp waits
//     on another;
//   * the activations are [N, K] int8 rows (K-contiguous, the quantized x
//     rows as they are); they are tiny and stay in L1/L2, read through
//     the read-only path;
//   * N is not padded to a block: columns are processed NT (1, 2, 4 or 8)
//     at a time per CTA and the ragged edge is masked;
//   * partial sums are reduced across the warp with shuffles; no shared
//     memory, no atomics, no split-K.
// The row-streaming core that B3/B4 run (bw_gemm_sparse.cu) was tried
// here as well, with the mask's bits or a CTA-wide table, four or eight
// rows a CTA: level with this walk within the spread between calls, and
// slower in the path, so this walk stays (PERF.md).  No tensor
// cores (wgmma) and no TMA: at N=512 the bound turns to operations,
// which is prefill's work.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

constexpr int kWarps = 8;        // warps per CTA; one output row per warp
constexpr int kMaxPlanes = 8;    // radix-2 encodings of int8 have 8 planes
// CTAs an SM must hold at once (the register cap of __launch_bounds__):
// three (at most 80 registers a thread) up to four columns and four
// planes; past that a tile's loads hold more registers, and no
// instantiation spills: two past four columns, one past four planes.
template <int NT, int BW>
struct MinCtas {
  static constexpr int value = BW > 4 ? 1 : NT <= 4 ? 3 : 2;
};

struct Problem {
  const int8_t* digits;    // [bw, m_pad, k_pad]
  const int8_t* b;         // [n, k_pad]
  const uint8_t* mask;     // [bw, m_pad / block_m, k_pad / block_k]
  int bw, m_pad, k_pad, n, block_m, block_k, radix;
};

// Full int32 sums of row m against columns n0 .. n0+NT-1, in every lane.
// BW is the compile-time plane capacity (4 or 8); planes past pr.bw are
// dead.  The row's mask bits are fetched 32 k-blocks at a time, one
// coalesced load per plane and a warp ballot, so the digit loads of a step
// depend on no other load.
template <int NT, int BW>
__device__ __forceinline__ void row_sums(const Problem& pr, int m, int n0,
                                         int lane, int (&acc)[NT]) {
  const int chunks = pr.k_pad >> 4;              // 16-byte chunks along K
  const int chunks_per_kblk = pr.block_k >> 4;
  const int kblks = pr.k_pad / pr.block_k;
  const int mblk = m / pr.block_m;
  const size_t plane_stride = static_cast<size_t>(pr.m_pad) * pr.k_pad;
  const int8_t* row = pr.digits + static_cast<size_t>(m) * pr.k_pad;
  const uint8_t* row_mask =
      pr.mask + static_cast<size_t>(mblk) * kblks;  // + p * mblks * kblks
  const size_t mask_plane = static_cast<size_t>(pr.m_pad / pr.block_m) * kblks;
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j] = 0;
  for (int kb0 = 0; kb0 < kblks; kb0 += 32) {
    unsigned bits[BW];
#pragma unroll
    for (int p = 0; p < BW; ++p) {
      const bool set = p < pr.bw && kb0 + lane < kblks &&
                       row_mask[p * mask_plane + kb0 + lane];
      bits[p] = __ballot_sync(0xffffffffu, set);
    }
    const int c_end = min(chunks, (kb0 + 32) * chunks_per_kblk);
    for (int c = kb0 * chunks_per_kblk + lane; c < c_end; c += 32) {
      const int kb = c / chunks_per_kblk - kb0;
      int4 d[BW];
#pragma unroll
      for (int p = 0; p < BW; ++p) {
        d[p] = (bits[p] >> kb) & 1u
                   ? __ldg(reinterpret_cast<const int4*>(
                               row + p * plane_stride) + c)
                   : make_int4(0, 0, 0, 0);
      }
      int4 bv[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* brow = pr.b + static_cast<size_t>(n0 + j) * pr.k_pad;
        bv[j] = n0 + j < pr.n
                    ? __ldg(reinterpret_cast<const int4*>(brow) + c)
                    : make_int4(0, 0, 0, 0);
      }
      int w = 1;
#pragma unroll
      for (int p = 0; p < BW; ++p) {
        if ((bits[p] >> kb) & 1u) {
#pragma unroll
          for (int j = 0; j < NT; ++j) acc[j] += w * dot16(d[p], bv[j], 0);
        }
        w *= pr.radix;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
  }
}

template <int NT, int BW>
__global__ void __launch_bounds__(kWarps * 32, MinCtas<NT, BW>::value)
bw_gemm_i32_kernel(Problem pr, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int n0 = blockIdx.y * NT;
  if (m >= pr.m_pad) return;     // the whole warp leaves together
  int acc[NT];
  row_sums<NT, BW>(pr, m, n0, lane, acc);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (n0 + j < pr.n) out[static_cast<size_t>(m) * pr.n + n0 + j] = acc[j];
  }
}

template <int NT, int BW>
__global__ void __launch_bounds__(kWarps * 32, MinCtas<NT, BW>::value)
bw_gemm_fused_kernel(Problem pr, const float* __restrict__ scale,
                     const float* __restrict__ scale_n,
                     const float* __restrict__ bias, int axis_n, int act,
                     float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int n0 = blockIdx.y * NT;
  if (m >= pr.m_pad) return;
  int acc[NT];
  row_sums<NT, BW>(pr, m, n0, lane, acc);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + j;
      if (n >= pr.n) continue;
      const int v = axis_n ? n : m;         // index of the epilogue vectors
      float s = scale[v];
      if (scale_n != nullptr) s = __fmul_rn(s, scale_n[n]);
      float y = __fmul_rn(__int2float_rn(acc[j]), s);
      if (bias != nullptr) y = __fadd_rn(y, bias[v]);
      out[static_cast<size_t>(m) * pr.n + n] = activate(y, act);
    }
  }
}

bool valid(const Problem& pr) {
  return pr.bw >= 1 && pr.bw <= kMaxPlanes && pr.n >= 1 && pr.m_pad >= 1 &&
         pr.block_m > 0 && pr.block_m % kWarps == 0 &&
         pr.m_pad % pr.block_m == 0 && pr.block_k > 0 &&
         pr.block_k % 16 == 0 && pr.k_pad % pr.block_k == 0 &&
         (pr.radix == 2 || pr.radix == 4);
}

// Instantiate the column tile NT (1, 2, 4 or 8) and plane capacity BW
// (4 for the radix-4 encodings, 8 for bit-serial) a problem needs.
template <template <int, int> class Launch, int BW, typename... Args>
void dispatch_nt(const Problem& pr, Args... args) {
  if (pr.n <= 1) Launch<1, BW>::run(pr, args...);
  else if (pr.n <= 2) Launch<2, BW>::run(pr, args...);
  else if (pr.n <= 4) Launch<4, BW>::run(pr, args...);
  else Launch<8, BW>::run(pr, args...);
}

template <template <int, int> class Launch, typename... Args>
void dispatch(const Problem& pr, Args... args) {
  if (pr.bw <= 4) dispatch_nt<Launch, 4>(pr, args...);
  else dispatch_nt<Launch, kMaxPlanes>(pr, args...);
}

template <int NT, int BW>
struct LaunchI32 {
  static void run(const Problem& pr, int32_t* out, cudaStream_t stream) {
    const dim3 grid(pr.m_pad / kWarps, (pr.n + NT - 1) / NT);
    bw_gemm_i32_kernel<NT, BW><<<grid, kWarps * 32, 0, stream>>>(pr, out);
  }
};

template <int NT, int BW>
struct LaunchFused {
  static void run(const Problem& pr, const float* scale, const float* scale_n,
                  const float* bias, int axis_n, int act, float* out,
                  cudaStream_t stream) {
    const dim3 grid(pr.m_pad / kWarps, (pr.n + NT - 1) / NT);
    bw_gemm_fused_kernel<NT, BW><<<grid, kWarps * 32, 0, stream>>>(
        pr, scale, scale_n, bias, axis_n, act, out);
  }
};

}  // namespace

// Each entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success).
extern "C" int bw_gemm_i32(const void* digits, const void* b, const void* mask,
                           void* out, int bw, int m_pad, int k_pad, int n,
                           int block_m, int block_k, int radix, void* stream) {
  const Problem pr{static_cast<const int8_t*>(digits),
                   static_cast<const int8_t*>(b),
                   static_cast<const uint8_t*>(mask),
                   bw, m_pad, k_pad, n, block_m, block_k, radix};
  if (!valid(pr)) return static_cast<int>(cudaErrorInvalidValue);
  dispatch<LaunchI32>(pr, static_cast<int32_t*>(out),
                         static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bw_gemm_fused(const void* digits, const void* b,
                             const void* mask, const void* scale,
                             const void* scale_n, const void* bias, void* out,
                             int bw, int m_pad, int k_pad, int n, int block_m,
                             int block_k, int radix, int axis_n, int act,
                             void* stream) {
  const Problem pr{static_cast<const int8_t*>(digits),
                   static_cast<const int8_t*>(b),
                   static_cast<const uint8_t*>(mask),
                   bw, m_pad, k_pad, n, block_m, block_k, radix};
  if (!valid(pr) || act < kNone || act > kRelu2)
    return static_cast<int>(cudaErrorInvalidValue);
  dispatch<LaunchFused>(pr, static_cast<const float*>(scale),
                           static_cast<const float*>(scale_n),
                           static_cast<const float*>(bias), axis_n, act,
                           static_cast<float*>(out),
                           static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
