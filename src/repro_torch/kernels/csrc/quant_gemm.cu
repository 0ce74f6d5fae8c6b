// The "parallel MAC" baseline: an int8 x int8 -> int32 GEMM, and its form
// with the fused dequant/bias/activation epilogue, for Hopper (sm_90a).
// Plain C interface, loaded with ctypes by repro_torch/kernels/_build.py;
// no PyTorch headers.
//
// Replaces the TPU Pallas kernels of src/repro/kernels/quant_gemm.py:
//   quant_gemm_i32   <- quant_gemm       (body _kernel :21, pallas_call :43)
//   quant_gemm_fused <- quant_gemm_fused (body _fused_kernel :56,
//                                         pallas_call :107)
//
// Both compute acc[m, n] = sum_k a[m, k] * b[k, n] exactly in int32, with
// a int8 [M, K] (K-contiguous) and b int8 [K, N] in the reference's
// layout (N-contiguous), any M, N >= 1 and K a multiple of 16, either
// operand the large one.  quant_gemm_fused then runs, once per output
// element, the reference's epilogue in its order, with the
// round-to-nearest intrinsics of epilogue.cuh so that nvcc cannot
// contract it into an FMA:
//   y = float(acc) * scale[v];  y = y + bias[v];  y = act(y);  cast
// where v = n (epilogue axis 'n', scale/bias [1, N]) or m (axis 'm',
// [M, 1]).  The two entry points share every kernel and differ only in
// the store.
//
// Bound on the H100: at decode (one side at most 16) bytes, the large
// int8 operand read once; when both sides are wide, operations, on the
// tensor cores' 1,979 int8 TOP/s.  The wrapper (kernels/quant_gemm.py
// launch_plan) picks one of three designs by shape:
//
//   rows  the large operand is A [M, K], B [K, T] has T <= 16 columns.
//         A warp streams two rows of A, 16 bytes a lane and three chunk
//         positions of each row in flight, L1 bypassed (B1's walk).
//         The CTA's K range of B is staged once in shared memory,
//         K-major (T rows of K-consecutive words, turned by transpose4),
//         so __dp4a reads both operands as K quads; the sums are reduced
//         across the warp by shuffles.  16 rows a CTA.
//   cols  the large operand is B [K, N], A [T, K] has T <= 16 rows.
//         Lanes lie along N: a lane reads 4 N-consecutive bytes from each
//         of four K rows (a warp 128 contiguous bytes a row, four quads
//         of rows in flight), and transpose4 turns them into four words
//         of four K-consecutive bytes, one a column.  A's K range is
//         staged in shared memory (already K-major).  128 columns a CTA;
//         K is split over its sixteen warps, summed by shared-memory
//         atomics.
//   wide  both sides above 16: 128 x 256 tiles of C on the tensor cores
//         by wgmma, warp-specialized.  The int8 wgmma takes both operands
//         K-major and only its A operand from registers, so the kernel
//         computes C^T = B^T A^T: A [M, K], already K-major, is wgmma's B
//         operand, copied by TMA into shared memory with the 128-byte
//         swizzle; B [K, N] is copied raw (N-major, swizzled the same
//         way) and each consumer thread turns the K slabs it needs into
//         its register A fragments by transpose4, so shared memory never
//         holds a transposed copy.  One producer warp keeps a 4-stage
//         ring of 128-byte K steps in flight (mbarrier expect-tx); two
//         consumer warpgroups each own 128 columns of C, as two wgmma
//         m64n128k32 row tiles, and issue a step's eight products as one
//         group once its fragments are in registers (ptxas serializes
//         every wgmma when a fragment register is written while a
//         product is in flight); the two warpgroups' groups overlap.  The
//         fragment rows are permuted so that the four rows a thread
//         transposes at once are four consecutive columns of C.
//
// One launch a call, no memset, no workspace: every design splits a
// tile's K range over the CTAs of a thread-block cluster (up to 8), which
// add their partial sums through distributed shared memory, each CTA
// summing and storing its share of the tile.  wide takes one CTA an SM
// and the most splits that keep the grid within the SMs (3 at M=2304,
// T=512: 108 CTAs), and stages its sums in the ring once the products are
// done; a split of K over CTAs that meet in global memory (stream-K,
// whose per-CTA partial tiles cost more than the idle SMs) measured
// slower (PERF.md).  Integer addition keeps every sum exact in any order.
// No CTA waits for a CTA outside its cluster.

#include <cstddef>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace cg = cooperative_groups;

namespace {

enum Design : int { kRows = 0, kCols = 1, kWide = 2 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSkinnyMax = 16;     // the skinny side of rows / cols
constexpr int kMaxCluster = 8;     // CTAs a rows / cols tile splits K over
constexpr int kRowsPerWarp = 2;
constexpr int kRowTile = kWarps * kRowsPerWarp;   // rows of A a rows CTA
constexpr int kRowUnroll = 3;      // chunk positions a lane loads at once
constexpr int kColThreads = 512;   // cols: 16 warps split a CTA's K range
constexpr int kColTile = 128;      // columns of B a cols CTA: 32 lanes x 4
constexpr int kColUnroll = 4;      // K quads a lane loads at once
constexpr int kStageCap = 32768;   // staged skinny-operand bytes a CTA
// wide: a CTA's tile of C is kTileM rows x kTileN columns, K in steps of
// kStep bytes through a ring of kStages; a producer warpgroup and
// kConsumers consumer warpgroups, each of the latter kTileN / kConsumers
// columns
constexpr int kTileM = 128;
constexpr int kTileN = 256;
constexpr int kStep = 128;
constexpr int kStages = 4;
constexpr int kConsumers = 2;
constexpr int kWideThreads = 128 * (1 + kConsumers);
constexpr int kSwizzle = 128;      // bytes of a raw B box row (its swizzle)
constexpr int kATile = kTileM * kStep;       // A's rows, K-major, kStep bytes
constexpr int kBBox = kStep * kSwizzle;      // raw B: K rows x 128 columns
constexpr int kStageBytes = kATile + (kTileN / kSwizzle) * kBBox;
constexpr int kWideSmem = kStages * kStageBytes + 1024;   // + alignment
constexpr int kCRow = kTileN + 4;  // ints a row of the staged sums
static_assert(kTileM * kCRow * 4 <= kStages * kStageBytes,
              "the sums outgrow the ring");
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
static_assert(kTileN / kConsumers == 128, "a consumer owns 128 columns");
static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <=
              65536, "setmaxnreg budget");

struct Gemm {
  const int8_t* a;   // [m, k]
  const int8_t* b;   // [k, n]
  int m, n, k;
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

// How a call is cut: `ctas` CTAs take contiguous ranges of the
// tiles * units (tile, K unit) pairs, tile-major; the `ctas / tiles` CTAs
// of a tile are one cluster.  Mirrored by kernels/quant_gemm.py _layout.
struct Layout {
  int design, ctas;
  int nt;       // rows / cols: the skinny side's instantiation, 4, 8 or 16
  int tiles;    // tiles of C
  int units;    // K units a tile: 16-byte chunks, quads, or kStep steps
  int span;     // rows / cols: words a staged skinny row holds
  int smem;     // dynamic shared memory of a CTA
};

int cdiv(int x, int y) { return (x + y - 1) / y; }

bool layout_of(int m, int n, int k, int design, int ctas, Layout& l) {
  if (m < 1 || n < 1 || k < 16 || k % 16 != 0 || ctas < 1) return false;
  l.design = design;
  l.ctas = ctas;
  l.span = 0;
  int skinny = 0;
  if (design == kRows) {
    skinny = n;
    l.tiles = cdiv(m, kRowTile);
    l.units = k / 16;
  } else if (design == kCols) {
    skinny = m;
    l.tiles = cdiv(n, kColTile);
    l.units = k / 4;
  } else if (design == kWide) {
    l.tiles = cdiv(m, kTileM) * cdiv(n, kTileN);
    l.units = cdiv(k, kStep);
  } else {
    return false;
  }
  if (skinny > kSkinnyMax || ctas % l.tiles != 0) return false;
  const int splits = ctas / l.tiles;
  if (splits > kMaxCluster || splits > l.units) return false;
  if (design == kWide) {
    l.nt = 0;
    l.smem = kWideSmem;
    return true;
  }
  l.nt = skinny <= 4 ? 4 : skinny <= 8 ? 8 : 16;
  const int per = cdiv(l.units, splits);     // units a CTA, at most
  l.span = design == kRows ? 4 * per : per;
  l.smem = skinny * l.span * 4 + (design == kCols ? skinny * kColTile * 4 : 0);
  return skinny * l.span * 4 <= kStageCap;
}

// This CTA's units [u0, u1) of the layout's tiles * units.
__device__ __forceinline__ int cta_begin(const Layout& l, int c) {
  return static_cast<int>(static_cast<long long>(l.tiles) * l.units * c /
                          l.ctas);
}

// The CTA that owns unit u, when CTA c takes [cta_begin(c), cta_begin(c+1)).
__device__ __forceinline__ int owner(const Layout& l, long long u) {
  const long long total = static_cast<long long>(l.tiles) * l.units;
  return static_cast<int>(((u + 1) * l.ctas - 1) / total);
}

// The fused epilogue of output (m, n), in the reference's order.
__device__ __forceinline__ float dequant(const Epilogue& e, int m, int n,
                                         int acc) {
  const int v = e.axis_n ? n : m;
  float y = __fmul_rn(__int2float_rn(acc), e.scale[v]);
  if (e.bias != nullptr) y = __fadd_rn(y, e.bias[v]);
  return activate(y, e.act);
}

__device__ __forceinline__ void store(const Epilogue& e, int n_cols, int m,
                                      int n, int acc) {
  const size_t idx = static_cast<size_t>(m) * n_cols + n;
  if (e.scale == nullptr) {
    e.out_i32[idx] = acc;
    return;
  }
  const float y = dequant(e, m, n, acc);
  if (e.out_bf16 != nullptr) e.out_bf16[idx] = __float2bfloat16_rn(y);
  else e.out_f32[idx] = y;
}

// int32 sums (m, n .. n + 3), n a multiple of 4: one 16-byte store where
// all four exist and N is a multiple of 4; else one at a time.  (The
// fused epilogue's stores are store4_staged's.)
__device__ __forceinline__ void store4(const Epilogue& e, int n_cols, int m,
                                       int n, int4 acc) {
  const int a[4] = {acc.x, acc.y, acc.z, acc.w};
  if (n + 3 >= n_cols || (n_cols & 3)) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n + j < n_cols) store(e, n_cols, m, n + j, a[j]);
    return;
  }
  *reinterpret_cast<int4*>(e.out_i32 + static_cast<size_t>(m) * n_cols + n) =
      acc;
}

// The cluster's sums of `count` partials that each of its CTAs holds in
// shared memory at `part` (the same layout in every CTA): CTA rank r
// adds up its share of the elements across the cluster's shared memory
// and calls emit(i, sum) for each.  Every thread of every CTA calls it.
template <class Emit>
__device__ __forceinline__ void cluster_sum(int* part, int count,
                                            Emit emit) {
  cg::cluster_group cluster = cg::this_cluster();
  const int size = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  cluster.sync();                  // every CTA's partials are in place
  const int lo = count * rank / size, hi = count * (rank + 1) / size;
  for (int i = lo + static_cast<int>(threadIdx.x); i < hi;
       i += static_cast<int>(blockDim.x)) {
    int v = 0;
    for (int q = 0; q < size; ++q)
      v += cluster.map_shared_rank(part, q)[i];
    emit(i, v);
  }
  cluster.sync();                  // no CTA leaves while another reads it
}

// store4 with the epilogue's scale and bias read from shared memory:
// ep[0][at .. at + 3] and ep[1][...] on axis n, ep[0][at] and ep[1][at]
// for all four on axis m.
__device__ __forceinline__ void store4_staged(const Epilogue& e, int n_cols,
                                              int m, int n, int4 acc,
                                              const float (*ep)[kTileN], int at) {
  if (e.scale == nullptr) {
    store4(e, n_cols, m, n, acc);
    return;
  }
  const int a[4] = {acc.x, acc.y, acc.z, acc.w};
  float y[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int v = e.axis_n ? at + j : at;
    y[j] = __fmul_rn(__int2float_rn(a[j]), ep[0][v]);
    if (e.bias != nullptr) y[j] = __fadd_rn(y[j], ep[1][v]);
    y[j] = activate(y[j], e.act);
  }
  const size_t idx = static_cast<size_t>(m) * n_cols + n;
  if (n + 3 >= n_cols || (n_cols & 3)) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (n + j >= n_cols) continue;
      if (e.out_bf16 != nullptr) e.out_bf16[idx + j] = __float2bfloat16_rn(y[j]);
      else e.out_f32[idx + j] = y[j];
    }
  } else if (e.out_bf16 != nullptr) {
    __nv_bfloat162* const p = reinterpret_cast<__nv_bfloat162*>(
        e.out_bf16 + idx);
    p[0] = __floats2bfloat162_rn(y[0], y[1]);
    p[1] = __floats2bfloat162_rn(y[2], y[3]);
  } else {
    *reinterpret_cast<float4*>(e.out_f32 + idx) =
        make_float4(y[0], y[1], y[2], y[3]);
  }
}

// ---------------------------------------------------------------------------
// rows: A [M, K] streamed a warp kRowsPerWarp rows, B [K, T] staged K-major
// ---------------------------------------------------------------------------

template <int NT>
__global__ void __launch_bounds__(kThreads)
quant_rows_kernel(Gemm g, Epilogue e, Layout l) {
  extern __shared__ __align__(16) uint32_t bt_s[];   // [T][span]
  __shared__ int part[kRowTile * kSkinnyMax];         // [rows][T] sums
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int u0 = cta_begin(l, blockIdx.x);
  const int tile = u0 / l.units;
  const int c0 = u0 - tile * l.units;     // the CTA's 16-byte K chunks
  const int nc = cta_begin(l, blockIdx.x + 1) - u0;
  const int T = g.n;
  const int m0 = tile * kRowTile + warp * kRowsPerWarp;

  int4 a[kRowsPerWarp][kRowUnroll];
  auto load = [&](int it) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int4* row = reinterpret_cast<const int4*>(
                            g.a + static_cast<size_t>(m0 + r) * g.k) + c0;
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const int ci = (it * kRowUnroll + u) * 32 + lane;
        a[r][u] = ci < nc && m0 + r < g.m ? __ldcg(row + ci)
                                          : make_int4(0, 0, 0, 0);
      }
    }
  };
  load(0);                 // the first loads fly while B is staged

  // bt_s[t][q] = b[16 c0 + 4q .. + 3, t], four K-consecutive bytes.  The
  // CTA's rows of B are 16 c0 .. 16 (c0 + nc), contiguous: with T a
  // multiple of 4, a quad's four rows come in as words, turned by
  // transpose4 four columns at a time; else byte by byte.
  const int qn = 4 * nc;
  if (T % 4 == 0) {
    const int groups = T / 4;            // words a row of B
    const uint32_t* src = reinterpret_cast<const uint32_t*>(
        g.b + static_cast<size_t>(16 * c0) * T);
    for (int i = tid; i < qn * groups; i += kThreads) {
      const int q = i / groups, grp = i - q * groups;
      uint32_t c[4];
      transpose4(__ldg(src + (4 * q) * groups + grp),
                 __ldg(src + (4 * q + 1) * groups + grp),
                 __ldg(src + (4 * q + 2) * groups + grp),
                 __ldg(src + (4 * q + 3) * groups + grp), c);
#pragma unroll
      for (int j = 0; j < 4; ++j) bt_s[(4 * grp + j) * l.span + q] = c[j];
    }
  } else {
    for (int i = tid; i < T * qn; i += kThreads) {
      const int t = i / qn, q = i - t * qn;
      const int8_t* p = g.b + static_cast<size_t>(16 * c0 + 4 * q) * T + t;
      uint32_t v = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + j * T)))
             << (8 * j);
      bt_s[t * l.span + q] = v;
    }
  }
  __syncthreads();

  int acc[kRowsPerWarp][NT];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[r][t] = 0;
  const int iters = (nc + 32 * kRowUnroll - 1) / (32 * kRowUnroll);
  for (int it = 0; it < iters; ++it) {
    if (it > 0) load(it);
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      const int ci = (it * kRowUnroll + u) * 32 + lane;
      if (ci >= nc) continue;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        if (t >= T) continue;
        const int4 bv =
            *reinterpret_cast<const int4*>(bt_s + t * l.span + 4 * ci);
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          acc[r][t] = dot16(a[r][u], bv, acc[r][t]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r][t] += __shfl_xor_sync(0xffffffffu, acc[r][t], off);
      if (t < T && lane == t)      // lane t gives column t
        part[(warp * kRowsPerWarp + r) * T + t] = acc[r][t];
    }

  cluster_sum(part, kRowTile * T, [&](int i, int v) {
    const int m = tile * kRowTile + i / T;
    if (m < g.m) store(e, g.n, m, i % T, v);
  });
}

// ---------------------------------------------------------------------------
// cols: B [K, N] streamed along N, A [T, K] staged
// ---------------------------------------------------------------------------

// b[row, n .. n + 3] as one little-endian word, zero past the edge.
template <bool ALIGNED>
__device__ __forceinline__ uint32_t load_b4(const Gemm& g, int row, int n) {
  if (n >= g.n) return 0u;
  const int8_t* p = g.b + static_cast<size_t>(row) * g.n + n;
  if (ALIGNED) return __ldcg(reinterpret_cast<const unsigned int*>(p));
  uint32_t v = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (n + i < g.n)
      v |= static_cast<uint32_t>(static_cast<uint8_t>(__ldcg(p + i)))
           << (8 * i);
  return v;
}

template <int NT, bool ALIGNED>
__global__ void __launch_bounds__(kColThreads)
quant_cols_kernel(Gemm g, Epilogue e, Layout l) {
  constexpr int kColWarps = kColThreads / 32;
  extern __shared__ __align__(16) uint32_t smem_w[];
  const int T = g.m;
  int* const red = reinterpret_cast<int*>(smem_w);    // [T][kColTile]
  uint32_t* const a_s = smem_w + T * kColTile;        // [T][span]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int u0 = cta_begin(l, blockIdx.x);
  const int tile = u0 / l.units;
  const int q0 = u0 - tile * l.units;     // the CTA's K quads
  const int nq = cta_begin(l, blockIdx.x + 1) - u0;
  const int n0 = tile * kColTile;
  const int n = n0 + 4 * lane;
  // this warp's quads [wq0, wq1) of the CTA's
  const int wq0 = nq * warp / kColWarps, wq1 = nq * (warp + 1) / kColWarps;

  uint32_t rw[kColUnroll][4];
  auto load = [&](int q) {
#pragma unroll
    for (int u = 0; u < kColUnroll; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        rw[u][j] = q + u < wq1 ? load_b4<ALIGNED>(g, 4 * (q0 + q + u) + j, n)
                               : 0u;
  };
  load(wq0);               // the first loads fly while A is staged

  for (int i = tid; i < T * nq; i += kColThreads) {
    const int t = i / nq, q = i - t * nq;
    a_s[t * l.span + q] = __ldg(reinterpret_cast<const unsigned int*>(
                              g.a + static_cast<size_t>(t) * g.k) + q0 + q);
  }
  for (int i = tid; i < T * kColTile; i += kColThreads) red[i] = 0;
  __syncthreads();

  int acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0;
  for (int q = wq0; q < wq1; q += kColUnroll) {
    if (q > wq0) load(q);
#pragma unroll
    for (int u = 0; u < kColUnroll; ++u) {
      if (q + u >= wq1) continue;
      uint32_t col[4];
      transpose4(rw[u][0], rw[u][1], rw[u][2], rw[u][3], col);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        if (t >= T) continue;
        const int av = static_cast<int>(a_s[t * l.span + q + u]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[t][i] = __dp4a(av, static_cast<int>(col[i]), acc[t][i]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t >= T) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (acc[t][i] != 0) atomicAdd(red + t * kColTile + 4 * lane + i,
                                    acc[t][i]);
  }

  cluster_sum(red, T * kColTile, [&](int i, int v) {
    const int c = n0 + i % kColTile;
    if (c < g.n) store(e, g.n, i / kColTile, c, v);
  });
}


// ---------------------------------------------------------------------------
// wide: C^T = B^T A^T on wgmma, a producer warp and two consumer
// warpgroups, a tile's K split over a cluster
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)), "r"(bytes)
      : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// A box of a 2-D tensor map (c0 along the contiguous dimension) into
// shared memory; its bytes count on the barrier's transaction count.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// Byte offset of (row r, byte c) in a tile of 128-byte rows under the
// 128-byte swizzle, as TMA writes it and wgmma reads it: the 16-byte
// chunk c / 16 of row r sits at chunk (c / 16) ^ (r % 8).
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * kSwizzle + ((((c >> 4) ^ r) & 7) << 4) + (c & 15);
}

// A shared-memory matrix descriptor of A's K-major tile: rows of kStep
// bytes under the kStep-byte swizzle (layout 1: 128 bytes, 2: 64), 8-row
// core groups 8 kStep bytes apart.
__device__ __forceinline__ uint64_t gmma_desc(const void* p) {
  static_assert(kStep == 128 || kStep == 64, "a swizzle of kStep bytes");
  return static_cast<uint64_t>((smem_addr(p) >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(8 * kStep >> 4) << 32) |
         (static_cast<uint64_t>(kStep == 128 ? 1 : 2) << 62);
}

// d (64 x 128 int32) += a (64 x 32 int8, this thread's register fragment)
// * b (32 x 128 int8, K-major in shared memory), asynchronously.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1;\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The consumer warpgroups' own barrier (the producer does not take part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
}

// The register A fragments of K slab `slab` (32 bytes) of a consumer's raw B
// box (kStep K rows of 128 N-consecutive bytes, swizzled), for its two m64
// row tiles of C^T, in two parts: load_words reads the box, to_fragments
// turns the words, so that all of a slab's loads are in flight before its
// first transpose (loading and turning a K quad at a time measured slower).
// Fragment row 16 wq + g + 8 h of tile t is column 32 wq + 4 g + 2 t + h of
// the box, so that the four rows a thread holds are four consecutive
// columns: one transpose4 of four K rows' words gives all four at one K
// quad.  Lane (g, q) holds K quads q and q + 4 (registers 0-1 and 2-3 of
// each tile's fragment); it reads its four rows starting at row (q % 4), so
// that the lanes of a warp read 32 distinct banks, and rotates the
// transposed words back.
__device__ __forceinline__ void load_words(const unsigned char* box,
                                           int slab, int wq, int lane,
                                           uint32_t (&r)[2][4]) {
  const int g = lane >> 2, q = lane & 3;
  const int chunk = 2 * wq + (g >> 2);       // the 16-byte chunk of 4 g
  const int word = (g & 3) << 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {      // K quad q, then q + 4
    const int row0 = 32 * slab + 4 * (q + 4 * half);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = row0 + ((j + q) & 3);
      r[half][j] = *reinterpret_cast<const uint32_t*>(
          box + row * kSwizzle + (((chunk ^ row) & 7) << 4) + word);
    }
  }
}

__device__ __forceinline__ void to_fragments(const uint32_t (&r)[2][4],
                                             int lane, uint32_t (&f)[2][4]) {
  const int q = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t c[4];
    transpose4(r[half][0], r[half][1], r[half][2], r[half][3], c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // byte j of c[i] came from row row0 + (j + q) % 4: rotate it there
      const uint32_t v = __funnelshift_l(c[i], c[i], 8 * q);
      f[i >> 1][(i & 1) + 2 * half] = v;
    }
  }
}

__global__ void __launch_bounds__(kWideThreads, 1)
quant_wide_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, Gemm g,
                  Epilogue e, Layout l, int b_by_tma) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ float ep_s[2][kTileN];        // the epilogue's scale, bias
  unsigned char* const smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  int* const c_s = reinterpret_cast<int*>(smem);   // [kTileM][kCRow] sums
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_n = (g.n + kTileN - 1) / kTileN;
  // this CTA's K steps [s0, s1) of its cluster's tile
  const int u0 = cta_begin(l, blockIdx.x);
  const int tile = u0 / l.units;
  const int s0 = u0 - tile * l.units;
  const int s1 = cta_begin(l, blockIdx.x + 1) - tile * l.units;
  const int m0 = (tile / tiles_n) * kTileM, n0 = (tile % tiles_n) * kTileN;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * kConsumers);   // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // the producer warpgroup: warp 0 fills the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (warp == 0) {
      int stage = 0, phase = 0;
      for (int s = s0; s < s1; ++s) {
        const int k0 = s * kStep;
        unsigned char* const a_s = smem + stage * kStageBytes;
        unsigned char* const b_s = a_s + kATile;
        mbar_wait(&empty[stage], phase ^ 1);
        if (b_by_tma) {
          if (lane == 0) {
            mbar_expect_tx(&full[stage], kStageBytes);
            tma_load(a_s, &map_a, k0, m0, &full[stage]);
#pragma unroll
            for (int h = 0; h < kTileN / kSwizzle; ++h)
              tma_load(b_s + h * kBBox, &map_b, n0 + h * kSwizzle, k0,
                       &full[stage]);
          }
        } else {
          // rows of B not 16-byte aligned (N % 16 != 0): the warp gathers
          // the raw boxes byte by byte, swizzled as TMA would write them
          for (int i = lane; i < kStep * kTileN / 4; i += 32) {
            const int h = i / (kBBox / 4), rem = i % (kBBox / 4);
            const int r = rem / (kSwizzle / 4), c = 4 * (rem % (kSwizzle / 4));
            const int k = k0 + r, n = n0 + h * kSwizzle + c;
            uint32_t v = 0;
            if (k < g.k) {
              const int8_t* p = g.b + static_cast<size_t>(k) * g.n + n;
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (n + j < g.n)
                  v |= static_cast<uint32_t>(
                           static_cast<uint8_t>(__ldg(p + j))) << (8 * j);
            }
            *reinterpret_cast<uint32_t*>(b_s + h * kBBox + swizzled(r, c)) =
                v;
          }
          __syncwarp();
          if (lane == 0) {
            mbar_expect_tx(&full[stage], kATile);
            tma_load(a_s, &map_a, k0, m0, &full[stage]);
          }
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    // the consumers' two cluster barriers (below), which every thread of
    // the cluster takes
    cluster.sync();
    cluster.sync();
    return;
  }
  {
    // a consumer warpgroup: columns n0 + 128 cg .. + 127 of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    const int cg_ = warp / 4 - 1, wq = warp & 3;
    const int g8 = lane >> 2, q4 = lane & 3;
    // the epilogue's scale and bias of one of the tile's columns (axis n)
    // or rows (axis m), loaded now so that their latency hides behind the
    // products; staged in ep_s once the products are done
    float ep[2] = {0.0f, 0.0f};
    if (e.scale != nullptr) {
      const int v = (e.axis_n ? n0 : m0) + tid - 128;
      if (v < (e.axis_n ? g.n : g.m)) {
        ep[0] = e.scale[v];
        if (e.bias != nullptr) ep[1] = e.bias[v];
      }
    }
    int acc[2][64];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[t][i] = 0;

    // a K step: every slab's fragments first (no wgmma input register
    // is written while a product is in flight), then its products in one
    // group; the other consumer warpgroup's products run meanwhile
    int stage = 0, phase = 0;
    for (int s = s0; s < s1; ++s) {
      mbar_wait(&full[stage], phase);
      const unsigned char* const a_s = smem + stage * kStageBytes;
      const unsigned char* const box = a_s + kATile + cg_ * kBBox;
      uint32_t f[kStep / 32][2][4];        // [slab][row tile][register]
#pragma unroll
      for (int slab = 0; slab < kStep / 32; ++slab) {
        uint32_t words[2][4];
        load_words(box, slab, wq, lane, words);
        to_fragments(words, lane, f[slab]);
      }
      wgmma_fence();
#pragma unroll
      for (int slab = 0; slab < kStep / 32; ++slab) {
        const uint64_t desc = gmma_desc(a_s + 32 * slab);
        wgmma_s8(acc[0], f[slab][0], desc);
        wgmma_s8(acc[1], f[slab][1], desc);
      }
      wgmma_commit();
      wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);    // the stage is free
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // the partial sums as rows of C, in the ring (every stage consumed,
    // no load outstanding): accumulator (t, 4 j + 2 h + x) is C^T row
    // 16 wq + g8 + 8 h of row tile t, column 8 j + 2 q4 + x, that is C's
    // row 8 j + 2 q4 + x, column 128 cg + 32 wq + 4 g8 + 2 t + h; a
    // thread's four (t, h) are four consecutive columns
    consumers_sync();                 // both warpgroups' products are done
    int* const row0 = c_s + 128 * cg_ + 32 * wq + 4 * g8;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int x = 0; x < 2; ++x)
        *reinterpret_cast<int4*>(row0 + (8 * j + 2 * q4 + x) * kCRow) =
            make_int4(acc[0][4 * j + x], acc[0][4 * j + 2 + x],
                      acc[1][4 * j + x], acc[1][4 * j + 2 + x]);
    static_assert(kTileN == 128 * kConsumers, "a thread a column");
    ep_s[0][tid - 128] = ep[0];
    ep_s[1][tid - 128] = ep[1];
  }

  // the cluster's CTAs split the tile's K range: each sums its share of
  // the rows across the cluster's shared memory, runs the epilogue on
  // them and stores
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int r0 = kTileM * rank / splits, r1 = kTileM * (rank + 1) / splits;
  cluster.sync();                     // every CTA's sums are in place
  {
    // four quads a thread at a time, from each CTA of the cluster in turn
    constexpr int kQuadsRow = kTileN / 4, kPer = 4;
    const int quads = (r1 - r0) * kQuadsRow;
    for (int i0 = tid - 128; i0 < quads; i0 += kPer * 128 * kConsumers) {
      int4 sum[kPer];
#pragma unroll
      for (int r = 0; r < kPer; ++r) sum[r] = make_int4(0, 0, 0, 0);
      for (int q = 0; q < splits; ++q) {
        const int* const peer = cluster.map_shared_rank(c_s, q);
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
          const int i = i0 + r * 128 * kConsumers;
          if (i >= quads) continue;
          const int4 v = *reinterpret_cast<const int4*>(
              peer + (r0 + i / kQuadsRow) * kCRow + 4 * (i % kQuadsRow));
          sum[r].x += v.x;
          sum[r].y += v.y;
          sum[r].z += v.z;
          sum[r].w += v.w;
        }
      }
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int i = i0 + r * 128 * kConsumers;
        const int row = r0 + i / kQuadsRow, col = 4 * (i % kQuadsRow);
        if (i < quads && m0 + row < g.m && n0 + col < g.n)
          store4_staged(e, g.n, m0 + row, n0 + col, sum[r], ep_s,
                        e.axis_n ? col : row);
      }
    }
  }
  cluster.sync();                     // no CTA leaves while another reads it
}

// ---------------------------------------------------------------------------
// Launch plumbing
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against the driver.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D int8 tensor [rows, cols] (cols contiguous) read in boxes of
// box_rows x box_cols bytes under the box_cols-byte swizzle (128 or 64);
// zeros past its edges.
bool tensor_map(CUtensorMap* map, const void* base, int rows, int cols,
                int box_rows, int box_cols) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            box_cols == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// rows / cols / wide: the CTAs of a tile form one cluster along x.
template <typename... Args>
cudaError_t launch_clustered(void (*kernel)(Args...), int threads,
                             const Layout& l, cudaStream_t stream,
                             Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(l.ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = l.ctas / l.tiles;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

cudaError_t launch_wide(const Gemm& g, const Epilogue& e, const Layout& l,
                        cudaStream_t stream) {
  CUtensorMap map_a = {}, map_b = {};
  // A [M, K] in boxes of kTileM rows x kStep K bytes; B [K, N] in boxes
  // of kStep K rows x 128 columns where its rows are 16-byte aligned
  const int b_by_tma = g.n % 16 == 0;
  if (!tensor_map(&map_a, g.a, g.m, g.k, kTileM, kStep) ||
      (b_by_tma && !tensor_map(&map_b, g.b, g.k, g.n, kStep, kSwizzle)))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      quant_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kWideSmem);
  if (err != cudaSuccess) return err;
  return launch_clustered(quant_wide_kernel, kWideThreads, l, stream,
                          map_a, map_b, g, e, l, b_by_tma);
}

template <int NT>
cudaError_t launch_nt(const Gemm& g, const Epilogue& e, const Layout& l,
                      cudaStream_t stream) {
  if (l.design == kRows)
    return launch_clustered(quant_rows_kernel<NT>, kThreads, l, stream, g, e,
                            l);
  if (g.n % 4 == 0)          // rows of B word-aligned
    return launch_clustered(quant_cols_kernel<NT, true>, kColThreads, l,
                            stream, g, e, l);
  return launch_clustered(quant_cols_kernel<NT, false>, kColThreads, l,
                          stream, g, e, l);
}

int run(const Gemm& g, const Epilogue& e, int design, int ctas,
        cudaStream_t stream) {
  Layout l;
  if (!layout_of(g.m, g.n, g.k, design, ctas, l))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (design == kWide) {
    err = launch_wide(g, e, l, stream);
  } else if (l.nt == 4) {
    err = launch_nt<4>(g, e, l, stream);
  } else if (l.nt == 8) {
    err = launch_nt<8>(g, e, l, stream);
  } else {
    err = launch_nt<16>(g, e, l, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The layout a call of (m, n, k, design, ctas) takes: out[0..4] = nt,
// tiles, units, span, smem.  Returns cudaErrorInvalidValue for a call the
// kernels refuse.  Host only; kernels/quant_gemm.py _layout mirrors it.
extern "C" int quant_gemm_layout(int m, int n, int k, int design, int ctas,
                                 int* out) {
  Layout l;
  if (!layout_of(m, n, k, design, ctas, l))
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = l.nt;
  out[1] = l.tiles;
  out[2] = l.units;
  out[3] = l.span;
  out[4] = l.smem;
  return 0;
}

// Each entry point launches on `stream`, does not synchronise, and returns
// the launch's error (0 on success).  a: int8 [m, k]; b: int8 [k, n]; a
// and b 16-byte aligned.  design: 0 rows (n <= 16), 1 cols (m <= 16), 2
// wide; ctas: the grid, the tiles times a cluster of at most 8 that
// splits each tile's K.
extern "C" int quant_gemm_i32(const void* a, const void* b, void* out,
                              int m, int n, int k, int design, int ctas,
                              void* stream) {
  const Gemm g{static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
               m, n, k};
  const Epilogue e{nullptr, nullptr, 0, 0, static_cast<int32_t*>(out),
                   nullptr, nullptr};
  return run(g, e, design, ctas, static_cast<cudaStream_t>(stream));
}

// scale, bias: float32 [n] (axis_n) or [m]; bias may be null.  out:
// float32 [m, n], or bfloat16 when out_bf16.
extern "C" int quant_gemm_fused(const void* a, const void* b,
                                const void* scale, const void* bias,
                                void* out, int m, int n, int k, int design,
                                int ctas, int axis_n, int act, int out_bf16,
                                void* stream) {
  if (scale == nullptr || act < kNone || act > kRelu2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Gemm g{static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
               m, n, k};
  const Epilogue e{static_cast<const float*>(scale),
                   static_cast<const float*>(bias), axis_n, act, nullptr,
                   out_bf16 ? nullptr : static_cast<float*>(out),
                   out_bf16 ? static_cast<__nv_bfloat16*>(out) : nullptr};
  return run(g, e, design, ctas, static_cast<cudaStream_t>(stream));
}
