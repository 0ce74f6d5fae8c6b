// Bit-weight decomposed INT8 GEMM over a compacted block schedule, for
// Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// repro_torch/kernels/_build.py; no PyTorch headers.
//
// Replaces the TPU Pallas kernels of src/repro/kernels/bw_gemm.py:
//   bw_gemm_sparse_fused           <- bw_gemm_sparse_fused (pallas_call :446)
//   bw_gemm_sparse_i32             <- bw_gemm_sparse       (pallas_call :347)
//   bw_gemm_sparse_fused_pipelined <- bw_gemm_sparse_fused_pipelined (:734)
//   bw_gemm_sparse_pipelined_i32   <- bw_gemm_sparse_pipelined       (:620)
//
// The schedule is int32 [L, cols] (kernels/bw_gemm.py SCHED_COLS): one
// entry (plane, row, kblk, weight, ...) per live plane block, a
// zero-weight sentinel per empty m-block row, and zero-weight padding.
// Every kernel computes, for each output row m and column n,
//   acc[m, n] = sum over entries e with row(e) = m / block_m and
//               weight(e) != 0 of
//               weight(e) * sum_{k in kblk(e)} digits[plane(e), m, k] * b[n, k]
// in int32 (integer addition is order-free, so every kernel here is
// bit-identical to the others and to the plain versions), and writes
// every row, sentinel rows included: 0, or act(0 * s + bias) when fused.
// The schedule alone says what is live; the occupancy mask is never read.
// Columns FIRST, LAST, D_SLOT, B_SLOT and B_FETCH are the TPU kernels'
// accumulator and DMA plumbing and are not read here.
//
// Bound on the H100: bytes, as for bw_gemm.cu (decode N is 1 to 4, about
// 2 operations per digit byte): one pass over the live plane blocks.
//
// The sparse kernels (B3/B4) take an m_major schedule, where each m-block
// row's entries form one consecutive run, sorted by ROW.  As in
// bw_gemm.cu, a warp owns one output row and a CTA eight rows of one
// m-block; the warp finds its run by a warp-wide search of the ROW column,
// loads the run's entries 32 at a time (one a lane), and walks them as a
// flat list of 16-byte chunks (entry, chunk), 32 lanes side by side and
// eight chunks a lane in flight, so a run of any length keeps every lane
// busy.  The accumulator stays in registers for the
// whole run (what FIRST and LAST mean on the TPU) and is reduced across
// the warp with shuffles at its end.
//
// The pipelined kernels (B5/B6) take a schedule in either order.  A
// k_major schedule revisits output rows non-consecutively, so no CTA can
// own a row.  The TPU keeps an [M_pad, bn] accumulator panel for the
// whole walk on its one core; here, instead:
//   * CTAs take contiguous ranges of `per_cta` entries of the schedule as
//     it is given (ranges of k-blocks in k_major), so the 132 SMs share
//     the walk;
//   * a CTA stages the activation block of an entry's k-block in shared
//     memory once, and reuses it while consecutive entries share the
//     k-block (the reuse the k_major order exists for);
//   * lanes split each 128 x 256 plane block by rows (16 lanes a row of
//     256 bytes), reduce each row with shuffles, and add it into a
//     shared-memory accumulator of the current output m-block;
//   * when the entry's row changes, the CTA adds that accumulator into a
//     zeroed [M_pad, N] int32 workspace with coalesced atomicAdd;
//   * the fused form then runs the epilogue once per row in a second
//     launch.
// No cp.async, TMA or double buffering yet: a later change may add them.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

constexpr int kWarps = 8;          // warps per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kMinCtasPerSm = 3;   // register cap, as in bw_gemm.cu
constexpr int kUnroll = 8;         // 16-byte digit loads in flight a lane
constexpr int kMaxSmem = 48 * 1024;
// schedule columns read here (kernels/bw_gemm.py SCHED_COLS)
constexpr int kPlane = 0, kRow = 1, kKblk = 2, kWeight = 3;

struct Sparse {
  const int8_t* digits;    // [bw, m_pad, k_pad]
  const int8_t* b;         // [n, k_pad]
  const int32_t* sched;    // [steps, cols]
  int steps, cols, bw, m_pad, k_pad, n, block_m, block_k;
};

__device__ __forceinline__ int load_col(const Sparse& pr, int e, int col) {
  return __ldg(pr.sched + static_cast<size_t>(e) * pr.cols + col);
}

// True when entry e adds anything: a non-zero weight on a block inside
// the operand (a malformed entry is skipped rather than read out of
// bounds).
__device__ __forceinline__ bool live(const Sparse& pr, int plane, int row,
                                     int kblk, int weight) {
  return weight != 0 && plane >= 0 && plane < pr.bw && row >= 0 &&
         row < pr.m_pad / pr.block_m && kblk >= 0 &&
         kblk < pr.k_pad / pr.block_k;
}

// The fused epilogue of bw_gemm.cu, in the reference's order, with
// explicit round-to-nearest intrinsics so nvcc cannot contract it into an
// FMA: act(float(acc) * (scale * *scale_n) + *bias); scale_n and bias
// point at the element that applies, or are null.
__device__ __forceinline__ float fused_epilogue(int acc, float scale,
                                                const float* scale_n,
                                                const float* bias, int act) {
  float s = scale;
  if (scale_n != nullptr) s = __fmul_rn(s, *scale_n);
  float y = __fmul_rn(__int2float_rn(acc), s);
  if (bias != nullptr) y = __fadd_rn(y, *bias);
  return activate(y, act);
}

// [lo, hi): the entries of m-block `row` in an m_major schedule, whose
// ROW column is sorted (padding included).  The whole warp searches for
// both bounds at once: each round every lane reads one of 32 evenly
// spaced pivots for each bound, so a schedule of L entries takes
// log32(L) rounds of dependent loads (2 up to 1,024 entries).
__device__ __forceinline__ void find_run(const Sparse& pr, int row, int lane,
                                         int& lo_out, int& hi_out) {
  int lo[2] = {0, 0}, len[2] = {pr.steps, pr.steps};  // answer in [lo, lo+len]
  while (len[0] > 0 || len[1] > 0) {
    int step[2];
    bool less[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      step[t] = (len[t] + 31) / 32;
      const int idx = lo[t] + (lane + 1) * step[t] - 1;
      less[t] = len[t] > 0 && idx < lo[t] + len[t] &&
                load_col(pr, idx, kRow) < row + t;
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int below = __popc(__ballot_sync(0xffffffffu, less[t]));
      if (len[t] > 0) {
        const int next = lo[t] + below * step[t];
        len[t] = min(step[t] - 1, lo[t] + len[t] - next);
        lo[t] = next;
      }
    }
  }
  lo_out = lo[0];
  hi_out = lo[1];
}

// ---------------------------------------------------------------------------
// B3 / B4: m_major runs, one warp per output row
// ---------------------------------------------------------------------------

// Full int32 sums of row m against columns n0 .. n0+NT-1, in every lane.
// The run is walked 32 entries at a time: lane e loads entry e of the
// window once, and the lanes reading a chunk of that entry take its
// plane, k-block and weight from lane e by shuffle.
template <int NT>
__device__ __forceinline__ void run_sums(const Sparse& pr, int m, int n0,
                                         int lane, int (&acc)[NT]) {
  const int mblk = m / pr.block_m;
  int lo, hi;
  find_run(pr, mblk, lane, lo, hi);
  const int cpk = pr.block_k >> 4;               // 16-byte chunks a k-block
  const size_t plane_stride = static_cast<size_t>(pr.m_pad) * pr.k_pad;
  const int8_t* row = pr.digits + static_cast<size_t>(m) * pr.k_pad;
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j] = 0;
  for (int e0 = lo; e0 < hi; e0 += 32) {
    const int ents = min(32, hi - e0);
    int my_w = 0, my_plane = 0, my_col = 0;
    if (lane < ents) {
      const int plane = load_col(pr, e0 + lane, kPlane);
      const int kblk = load_col(pr, e0 + lane, kKblk);
      const int weight = load_col(pr, e0 + lane, kWeight);
      if (live(pr, plane, mblk, kblk, weight)) {
        my_w = weight;
        my_plane = plane;
        my_col = kblk * cpk;
      }
    }
    const int chunks = ents * cpk;
    for (int i0 = 0; i0 < chunks; i0 += 32 * kUnroll) {
      int4 d[kUnroll];
      int w[kUnroll], col[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * 32 + lane;
        const int src = min(i / cpk, 31);
        w[u] = __shfl_sync(0xffffffffu, my_w, src);
        col[u] = __shfl_sync(0xffffffffu, my_col, src) + i % cpk;
        const int plane = __shfl_sync(0xffffffffu, my_plane, src);
        if (i >= chunks) w[u] = 0;
        d[u] = w[u] != 0 ? __ldg(reinterpret_cast<const int4*>(
                                     row + plane * plane_stride) + col[u])
                         : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (w[u] == 0) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int8_t* brow = pr.b + static_cast<size_t>(n0 + j) * pr.k_pad;
          const int4 bv = n0 + j < pr.n
                              ? __ldg(reinterpret_cast<const int4*>(brow) +
                                      col[u])
                              : make_int4(0, 0, 0, 0);
          acc[j] += w[u] * dot16(d[u], bv, 0);
        }
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

template <int NT>
__global__ void __launch_bounds__(kThreads, kMinCtasPerSm)
sparse_i32_kernel(Sparse pr, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int n0 = blockIdx.y * NT;
  if (m >= pr.m_pad) return;     // the whole warp leaves together
  int acc[NT];
  run_sums<NT>(pr, m, n0, lane, acc);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (n0 + j < pr.n) out[static_cast<size_t>(m) * pr.n + n0 + j] = acc[j];
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads, kMinCtasPerSm)
sparse_fused_kernel(Sparse pr, const float* __restrict__ scale,
                    const float* __restrict__ scale_n,
                    const float* __restrict__ bias, int act,
                    float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int n0 = blockIdx.y * NT;
  if (m >= pr.m_pad) return;
  int acc[NT];
  run_sums<NT>(pr, m, n0, lane, acc);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + j;
      if (n >= pr.n) continue;
      out[static_cast<size_t>(m) * pr.n + n] = fused_epilogue(
          acc[j], scale[m], scale_n == nullptr ? nullptr : scale_n + n,
          bias == nullptr ? nullptr : bias + m, act);
    }
  }
}

// ---------------------------------------------------------------------------
// B5 / B6: contiguous schedule ranges, workspace accumulation
// ---------------------------------------------------------------------------

// Lanes that share one row of a plane block: every lane of a group reads
// cpk / lanes 16-byte chunks of the row.  A power of two, so the groups
// are aligned inside a warp and reduce with xor shuffles.
__host__ __device__ __forceinline__ int row_lanes(int block_k) {
  const int cpk = block_k >> 4;
  return cpk < 32 ? cpk : 32;
}

// Adds the CTA's accumulator of m-block `row` into the workspace and
// zeroes it.  Every thread of the CTA calls it.
template <int NT>
__device__ __forceinline__ void flush(const Sparse& pr, int row, int n0,
                                      int* acc_s, int32_t* ws) {
  __syncthreads();                 // the row's last sums are in acc_s
  for (int i = threadIdx.x; i < pr.block_m * NT; i += kThreads) {
    const int r = i / NT, j = i % NT;
    const int v = acc_s[i];
    if (v != 0 && n0 + j < pr.n)
      atomicAdd(ws + static_cast<size_t>(row * pr.block_m + r) * pr.n + n0 +
                    j, v);
    acc_s[i] = 0;
  }
  __syncthreads();
}

template <int NT>
__global__ void __launch_bounds__(kThreads, kMinCtasPerSm)
pipelined_kernel(Sparse pr, int per_cta, int32_t* __restrict__ ws) {
  extern __shared__ int4 smem[];
  const int cpk = pr.block_k >> 4;
  int4* bs = smem;                                  // [NT][cpk] activations
  int* acc_s = reinterpret_cast<int*>(smem + NT * cpk);  // [block_m][NT]
  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * NT;
  const int e_begin = blockIdx.x * per_cta;
  const int e_end = min(pr.steps, e_begin + per_cta);
  const int lanes = row_lanes(pr.block_k);
  const int cpl = cpk / lanes;                      // chunks a lane a row
  const int rows_per_pass = kThreads / lanes;
  const int passes = (pr.block_m + rows_per_pass - 1) / rows_per_pass;
  const int items = passes * cpl;
  const int r_off = tid / lanes, sub = tid % lanes;
  const size_t plane_stride = static_cast<size_t>(pr.m_pad) * pr.k_pad;
  for (int i = tid; i < pr.block_m * NT; i += kThreads) acc_s[i] = 0;
  __syncthreads();
  int staged_k = -1, cur_row = -1;
  bool dirty = false;
  // every branch below depends on the schedule entry alone, so all the
  // CTA's threads take it together and may meet at __syncthreads
  int next[4];                     // the next entry, loaded a step ahead
  if (e_begin < e_end) {
#pragma unroll
    for (int c = 0; c < 4; ++c) next[c] = load_col(pr, e_begin, c);
  }
  for (int e = e_begin; e < e_end; ++e) {
    const int plane = next[kPlane], row = next[kRow];
    const int kblk = next[kKblk], weight = next[kWeight];
    if (e + 1 < e_end) {
#pragma unroll
      for (int c = 0; c < 4; ++c) next[c] = load_col(pr, e + 1, c);
    }
    if (row != cur_row) {
      if (dirty) flush<NT>(pr, cur_row, n0, acc_s, ws);
      dirty = false;
      cur_row = row;
    }
    if (!live(pr, plane, row, kblk, weight)) continue;
    if (kblk != staged_k) {
      __syncthreads();             // every warp is done with the old block
      for (int i = tid; i < NT * cpk; i += kThreads) {
        const int j = i / cpk, c = i % cpk;
        bs[i] = n0 + j < pr.n
                    ? __ldg(reinterpret_cast<const int4*>(
                                pr.b + static_cast<size_t>(n0 + j) * pr.k_pad) +
                            kblk * cpk + c)
                    : make_int4(0, 0, 0, 0);
      }
      __syncthreads();
      staged_k = kblk;
    }
    dirty = true;
    const int8_t* blk = pr.digits + plane * plane_stride +
                        static_cast<size_t>(row) * pr.block_m * pr.k_pad +
                        static_cast<size_t>(kblk) * pr.block_k;
    for (int q0 = 0; q0 < items; q0 += kUnroll) {
      int4 d[kUnroll];
      int r[kUnroll], c[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = q0 + u;
        r[u] = (q / cpl) * rows_per_pass + r_off;
        c[u] = (q % cpl) * lanes + sub;
        d[u] = q < items && r[u] < pr.block_m
                   ? __ldg(reinterpret_cast<const int4*>(
                               blk + static_cast<size_t>(r[u]) * pr.k_pad) +
                           c[u])
                   : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (q0 + u >= items) break;             // uniform across the CTA
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          int p = dot16(d[u], bs[j * cpk + c[u]], 0);
          for (int off = lanes >> 1; off > 0; off >>= 1)
            p += __shfl_xor_sync(0xffffffffu, p, off);
          if (sub == 0 && r[u] < pr.block_m)
            acc_s[r[u] * NT + j] += weight * p;  // one owner a row
        }
      }
    }
  }
  if (dirty) flush<NT>(pr, cur_row, n0, acc_s, ws);
}

__global__ void epilogue_kernel(const int32_t* __restrict__ ws,
                                const float* __restrict__ scale,
                                const float* __restrict__ scale_n,
                                const float* __restrict__ bias, int m_pad,
                                int n, int act, float* __restrict__ out) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(m_pad) * n) return;
  const int m = static_cast<int>(i / n), j = static_cast<int>(i % n);
  out[i] = fused_epilogue(ws[i], scale[m],
                          scale_n == nullptr ? nullptr : scale_n + j,
                          bias == nullptr ? nullptr : bias + m, act);
}

// ---------------------------------------------------------------------------
// Launch plumbing
// ---------------------------------------------------------------------------

bool valid(const Sparse& pr) {
  return pr.steps >= 0 && pr.cols >= 4 && pr.bw >= 1 && pr.n >= 1 &&
         pr.m_pad >= 1 && pr.block_m > 0 && pr.block_m % kWarps == 0 &&
         pr.m_pad % pr.block_m == 0 && pr.block_k > 0 &&
         pr.block_k % 16 == 0 && pr.k_pad % pr.block_k == 0;
}

int nt_for(int n) { return n <= 1 ? 1 : n <= 2 ? 2 : n <= 4 ? 4 : 8; }

int pipelined_smem(const Sparse& pr, int nt) {
  return nt * pr.block_k + pr.block_m * nt * 4;
}

// A pipelined problem also needs row groups that tile a warp: 16-byte
// chunks a k-block a power of two below 32, or a multiple of 32.
bool valid_pipelined(const Sparse& pr, int per_cta) {
  const int cpk = pr.block_k >> 4;
  const int lanes = row_lanes(pr.block_k);
  return valid(pr) && per_cta >= 1 && (lanes & (lanes - 1)) == 0 &&
         cpk % lanes == 0 && pipelined_smem(pr, nt_for(pr.n)) <= kMaxSmem;
}

template <int NT>
struct LaunchI32 {
  static void run(const Sparse& pr, int32_t* out, cudaStream_t stream) {
    const dim3 grid(pr.m_pad / kWarps, (pr.n + NT - 1) / NT);
    sparse_i32_kernel<NT><<<grid, kThreads, 0, stream>>>(pr, out);
  }
};

template <int NT>
struct LaunchFused {
  static void run(const Sparse& pr, const float* scale, const float* scale_n,
                  const float* bias, int act, float* out,
                  cudaStream_t stream) {
    const dim3 grid(pr.m_pad / kWarps, (pr.n + NT - 1) / NT);
    sparse_fused_kernel<NT><<<grid, kThreads, 0, stream>>>(
        pr, scale, scale_n, bias, act, out);
  }
};

template <int NT>
struct LaunchPipelined {
  static void run(const Sparse& pr, int per_cta, int32_t* ws,
                  cudaStream_t stream) {
    const int ctas = (pr.steps + per_cta - 1) / per_cta;
    if (ctas == 0) return;
    const dim3 grid(ctas, (pr.n + NT - 1) / NT);
    pipelined_kernel<NT><<<grid, kThreads, pipelined_smem(pr, NT), stream>>>(
        pr, per_cta, ws);
  }
};

// Instantiate the column tile NT (1, 2, 4 or 8) a problem needs.
template <template <int> class Launch, typename... Args>
void dispatch(const Sparse& pr, Args... args) {
  switch (nt_for(pr.n)) {
    case 1: Launch<1>::run(pr, args...); break;
    case 2: Launch<2>::run(pr, args...); break;
    case 4: Launch<4>::run(pr, args...); break;
    default: Launch<8>::run(pr, args...); break;
  }
}

Sparse problem(const void* digits, const void* b, const void* sched,
               int steps, int cols, int bw, int m_pad, int k_pad, int n,
               int block_m, int block_k) {
  return Sparse{static_cast<const int8_t*>(digits),
                static_cast<const int8_t*>(b),
                static_cast<const int32_t*>(sched),
                steps, cols, bw, m_pad, k_pad, n, block_m, block_k};
}

// Zeroes the workspace and runs the pipelined walk into it.
int pipelined_sums(const Sparse& pr, int per_cta, int32_t* ws,
                   cudaStream_t stream) {
  const cudaError_t err = cudaMemsetAsync(
      ws, 0, sizeof(int32_t) * static_cast<size_t>(pr.m_pad) * pr.n, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  dispatch<LaunchPipelined>(pr, per_cta, ws, stream);
  return 0;
}

}  // namespace

// Each entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success).  `cols` is the schedule's column
// count (>= 6 for the sparse kernels, 9 for the pipelined ones).
extern "C" int bw_gemm_sparse_i32(const void* digits, const void* b,
                                  const void* sched, void* out, int steps,
                                  int cols, int bw, int m_pad, int k_pad,
                                  int n, int block_m, int block_k,
                                  void* stream) {
  const Sparse pr = problem(digits, b, sched, steps, cols, bw, m_pad, k_pad,
                            n, block_m, block_k);
  if (!valid(pr)) return static_cast<int>(cudaErrorInvalidValue);
  dispatch<LaunchI32>(pr, static_cast<int32_t*>(out),
                      static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bw_gemm_sparse_fused(const void* digits, const void* b,
                                    const void* sched, const void* scale,
                                    const void* scale_n, const void* bias,
                                    void* out, int steps, int cols, int bw,
                                    int m_pad, int k_pad, int n, int block_m,
                                    int block_k, int act, void* stream) {
  const Sparse pr = problem(digits, b, sched, steps, cols, bw, m_pad, k_pad,
                            n, block_m, block_k);
  if (!valid(pr) || act < kNone || act > kRelu2)
    return static_cast<int>(cudaErrorInvalidValue);
  dispatch<LaunchFused>(pr, static_cast<const float*>(scale),
                        static_cast<const float*>(scale_n),
                        static_cast<const float*>(bias), act,
                        static_cast<float*>(out),
                        static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// out: int32 [m_pad, n], the workspace itself (zeroed here).
extern "C" int bw_gemm_sparse_pipelined_i32(const void* digits, const void* b,
                                            const void* sched, void* out,
                                            int steps, int cols, int bw,
                                            int m_pad, int k_pad, int n,
                                            int block_m, int block_k,
                                            int per_cta, void* stream) {
  const Sparse pr = problem(digits, b, sched, steps, cols, bw, m_pad, k_pad,
                            n, block_m, block_k);
  if (!valid_pipelined(pr, per_cta))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = pipelined_sums(pr, per_cta, static_cast<int32_t*>(out),
                                 static_cast<cudaStream_t>(stream));
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

// ws: int32 [m_pad, n] scratch (zeroed here); out: float [m_pad, n].
extern "C" int bw_gemm_sparse_fused_pipelined(
    const void* digits, const void* b, const void* sched, const void* scale,
    const void* scale_n, const void* bias, void* ws, void* out, int steps,
    int cols, int bw, int m_pad, int k_pad, int n, int block_m, int block_k,
    int per_cta, int act, void* stream) {
  const Sparse pr = problem(digits, b, sched, steps, cols, bw, m_pad, k_pad,
                            n, block_m, block_k);
  if (!valid_pipelined(pr, per_cta) || act < kNone || act > kRelu2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* acc = static_cast<int32_t*>(ws);
  const int err = pipelined_sums(pr, per_cta, acc, s);
  if (err != 0) return err;
  const size_t total = static_cast<size_t>(m_pad) * n;
  const int threads = 256;
  epilogue_kernel<<<static_cast<unsigned>((total + threads - 1) / threads),
                    threads, 0, s>>>(
      acc, static_cast<const float*>(scale),
      static_cast<const float*>(scale_n), static_cast<const float*>(bias),
      m_pad, n, act, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
