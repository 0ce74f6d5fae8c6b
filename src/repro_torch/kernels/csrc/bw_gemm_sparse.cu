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
// row's entries form one consecutive run, sorted by ROW.  At decode sizes
// a call is 10-27 MB of live digits, 3-8 us at 3.35 TB/s, so a call's
// fixed cost -- the launch, the round trips before the first digit load
// and the memory system's ramp -- weighs as much as its bytes.  The
// design spends one round trip finding the run, then streams as B1 does:
//   * One warp an output row, four rows (of one m-block) a CTA: 576 CTAs
//     at M = 2304, at most 80 registers a thread so six CTAs fit an SM
//     and an M = 2304 product is resident at once.
//   * The CTA reads its m-block's run once, not once a warp, into a
//     shared-memory table of weights [plane][kblk], 256 k-blocks at a
//     time (0: dead): one window of entries, one a thread, centred where
//     the run would sit if every m-block had L / mblks entries
//     (kernels/bw_gemm.py schedule_window), kept when it holds both ends
//     of the run -- one round trip and one barrier -- else a CTA-wide
//     pivot search for the run's bounds (128 pivots a bound a round) and
//     the run.  Weights are added into the table, so a repeated entry
//     counts as often as it appears.
//   * Each warp then walks its row as B1 does (bw_gemm.cu): 16-byte chunks
//     along K, 32 lanes side by side, the loads of every live plane at a
//     chunk position and its activation chunks issued before any
//     multiply, __dp4a in exact int32, a shuffle reduction, lane 0 stores.
//     Digit loads bypass L1 (each byte is read once).  So B3 reads what B1
//     reads on the same mask and differs only in how it finds it.
// Tried on the card and dropped, each slower at N = 4:
// several rows an item so one activation load feeds them (registers, and
// the products arrive in bursts), more chunk positions in flight a lane,
// activations staged in shared memory (a round trip before the first
// digit load), an L2 prefetch of the row; eight-warp CTAs were no faster.
//
// The pipelined kernels (B5/B6) take a schedule in either order.  A
// k_major schedule revisits output rows non-consecutively, so no CTA can
// own a row.  At decode sizes a call is a few microseconds of bytes
// (3.2-8.1 us at the path's shapes), so launches, memsets and dependent
// round trips set its time.  The design:
//   * One cooperative launch per call, persistent: the grid is every CTA
//     the card holds at once (SMs x CTAs an SM at this shared memory,
//     queried once a device and shape by the wrapper), and the call is
//       walk, adding into an int32 workspace -> grid barrier -> read
//       each sum once, zero it, and write it out (B6) or run the
//       epilogue on it (B5).
//     The workspace (one a stream, kernels/bw_gemm.py) is zero when a
//     call starts and zero when it ends, so a call needs neither a memset
//     nor a barrier after zeroing it; the one barrier left is the one the
//     epilogue needs, and the epilogue runs on every SM (a ticket counter
//     would hand it to the last CTA alone).  Zeroing the workspace in the
//     kernel instead takes a second grid barrier, which the copies then
//     in flight make slow.  A grid the card cannot hold at once is
//     refused by cudaLaunchCooperativeKernel, and the wrapper raises.
//   * The walk is a flat list of (column tile, entry) pairs cut into one
//     contiguous range a CTA (CTA c of G takes [c W / G, (c+1) W / G) of
//     W pairs: bw_gemm.py pipelined_ranges).  A range's plane blocks
//     stream through a ring of 2-4 shared-memory stages filled by
//     cp.async commit groups: while one stage is multiplied, the next
//     stages' blocks (32 KB at 128 x 256) are in flight (the TPU's D_SLOT
//     double buffer).  A plane block above 64 KB goes in row tiles.  The
//     range's schedule entries come 32 at a time, one a lane, and reach
//     the copy and the product by shuffle, so neither waits on a
//     schedule load of its own.
//   * The activation block of an entry's k-block is staged once per run
//     of equal k-blocks into a ring of activation slots (the TPU's
//     B_SLOT / B_FETCH), one slot per stage: a slot is rewritten only
//     when the k-block has changed `stages` times since, by which time
//     every unit that reads it has been multiplied.
//   * The product runs on the tensor cores, exact in int32: each warp
//     takes 16 rows of the stage, loads them with ldmatrix and issues one
//     m16n8k32 int8 mma.sync per 32 bytes of K against the activation
//     slot (N <= 8 columns, the rest of the 8 zero).  Stage and slot rows
//     are 16 bytes wider than a k-block, so ldmatrix's eight rows and the
//     slot's eight columns fall in distinct banks.  __dp4a on the CUDA
//     cores would take about 40 shared-memory loads a thread a block, as
//     long as the copies themselves.
//   * The copies are 16-byte cp.async, 8 a thread a block.  TMA copies
//     do not pay here: one bulk copy a 256-byte row is slower (the TMA
//     unit takes 128 small requests a block), and one 2-D tensor-map box
//     a block gains little, since the rate the memory delivers these
//     blocks at, not the copy instructions, sets the time.
//   * Sums go to a shared-memory panel, [window][block_m][NT] int32
//     (the TPU's [M_pad, bn] accumulator panel, cut to the rows a window
//     touches): a window is up to 32 consecutive entries of the range,
//     one a lane, and __match_any_sync gives each distinct (column tile,
//     m-block) of the window a panel slot.  Each panel element belongs
//     to the one lane whose mma fragment holds it, so the panel needs no
//     barrier; at the window's end the owners add their elements into the
//     workspace with atomicAdd, once per m-block the window touched, not
//     at every change of row.
// Dynamic shared memory: stages x (tile + activation slot) + the panel,
// up to 227 KB (cudaFuncAttributeMaxDynamicSharedMemorySize); one CTA an
// SM at 128 x 256 blocks.  pipelined_layout() sizes it and refuses what
// does not fit; kernels/bw_gemm.py _pipelined_layout mirrors it.

#include <cooperative_groups.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;          // warps per CTA
constexpr int kThreads = kWarps * 32;
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

// ---------------------------------------------------------------------------
// B3 / B4: m_major runs, a weight table a CTA, B1's row walk
// ---------------------------------------------------------------------------

constexpr int kRunWarps = 4;                  // rows a CTA, one a warp
constexpr int kRunThreads = kRunWarps * 32;
constexpr int kTableKblks = 256;              // k-blocks the table holds

// CTAs an SM must hold at once (the register cap of __launch_bounds__):
// six (at most 80 registers a thread) up to four columns and four planes,
// so every CTA of a 2304 x 2304 product is resident together (576 CTAs,
// 792 places); four past that, whose tiles hold more registers.
template <int NT, int BW>
struct RunMinCtas {
  static constexpr int value = NT <= 4 && BW <= 4 ? 6 : 4;
};

// 16 bytes from device memory through the non-coherent path, not kept in
// L1: each digit byte is read once.
__device__ __forceinline__ int4 load_stream(const int4* p) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// [lo, hi) of m-block `mblk`'s run, by a CTA-wide search of the sorted ROW
// column: each round every thread reads one pivot a bound, so L entries
// take log128(L) rounds.
__device__ void search_run(const Sparse& pr, int mblk, int& lo, int& hi) {
  int base[2] = {0, 0}, len[2] = {pr.steps, pr.steps};
  const int t = threadIdx.x;
  while (len[0] > 0 || len[1] > 0) {
    int step[2], below[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      step[s] = (len[s] + kRunThreads - 1) / kRunThreads;
      const int idx = base[s] + (t + 1) * step[s] - 1;
      const bool less = len[s] > 0 && idx < base[s] + len[s] &&
                        load_col(pr, idx, kRow) < mblk + s;
      below[s] = __syncthreads_count(less);
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (len[s] > 0) {
        const int next = base[s] + below[s] * step[s];
        len[s] = min(step[s] - 1, base[s] + len[s] - next);
        base[s] = next;
      }
    }
  }
  lo = base[0];
  hi = base[1];
}

// Adds schedule entry e of ROW `row` into the table when it is live, of
// m-block `mblk`, and its k-block falls in [kb0, kb0 + wk).
__device__ __forceinline__ void add_entry(const Sparse& pr,
                                          int (*table)[kTableKblks], int mblk,
                                          int kb0, int wk, int e, int row) {
  const int plane = load_col(pr, e, kPlane), kblk = load_col(pr, e, kKblk);
  const int weight = load_col(pr, e, kWeight);
  if (row == mblk && live(pr, plane, row, kblk, weight) && kblk >= kb0 &&
      kblk < kb0 + wk)
    atomicAdd(&table[plane][kblk - kb0], weight);
}

// The weights [plane][kblk - kb0] of m-block `mblk`'s live blocks in
// k-blocks [kb0, kb0 + wk), for the whole CTA (every thread calls it; it
// ends at a barrier): the first window of entries (bw_gemm.py
// schedule_window) when it holds both ends of the run, else the run found
// by search_run.  Weights are added, so a repeated entry counts as often
// as it appears.
template <int BW>
__device__ void fill_table(const Sparse& pr, int (*table)[kTableKblks],
                           int mblk, int kb0, int wk) {
  const int t = threadIdx.x, steps = pr.steps;
  if (kb0 > 0) __syncthreads();                // the last window is read
  for (int q = t; q < BW * wk; q += kRunThreads) table[q / wk][q % wk] = 0;
  const int mblks = pr.m_pad / pr.block_m;
  const int run = (steps + mblks - 1) / mblks;
  const int width = min(kRunThreads, min(steps, 2 * run + 32));
  const int guess = static_cast<int>(
      (static_cast<long long>(mblk) * steps + steps / 2) / mblks);
  const int start = max(0, min(steps - width, guess - width / 2));
  const int row = t < width ? load_col(pr, start + t, kRow) : -1;
  // the window holds the run when its first entry is below the m-block
  // (or is the schedule's first) and its last above (or is the last); the
  // barrier also orders the zeroing before the adds
  const bool miss = __syncthreads_or(
      (t == 0 && !(width > 0 && (start == 0 || row < mblk))) ||
      (t == width - 1 && !(start + width == steps || row > mblk)));
  if (!miss) {
    if (t < width) add_entry(pr, table, mblk, kb0, wk, start + t, row);
  } else {
    int lo, hi;
    search_run(pr, mblk, lo, hi);
    for (int e = lo + t; e < hi; e += kRunThreads)
      add_entry(pr, table, mblk, kb0, wk, e, mblk);
  }
  __syncthreads();
}

// Full int32 sums of row m against columns n0 .. n0+NT-1, in every lane:
// B1's walk (bw_gemm.cu row_sums) with the weights from the table, filled
// 256 k-blocks at a time.
template <int NT, int BW>
__device__ __forceinline__ void run_sums(const Sparse& pr,
                                         int (*table)[kTableKblks], int m,
                                         int n0, int lane, int (&acc)[NT]) {
  const int cpk = pr.block_k >> 4;             // 16-byte chunks a k-block
  const int row_chunks = pr.k_pad >> 4;
  const int kblks = pr.k_pad / pr.block_k;
  const size_t plane_chunks = static_cast<size_t>(pr.m_pad) * row_chunks;
  const int4* row = reinterpret_cast<const int4*>(pr.digits) +
                    static_cast<size_t>(m) * row_chunks;
  const int4* bcols = reinterpret_cast<const int4*>(pr.b);
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j] = 0;
  for (int kb0 = 0; kb0 < kblks; kb0 += kTableKblks) {
    const int wk = min(kTableKblks, kblks - kb0);
    fill_table<BW>(pr, table, m / pr.block_m, kb0, wk);
    const int c_end = (kb0 + wk) * cpk;
    for (int c = kb0 * cpk + lane; c < c_end; c += 32) {
      const int kb = c / cpk - kb0;
      int4 d[BW], bv[NT];
      int w[BW];
#pragma unroll
      for (int p = 0; p < BW; ++p) {
        w[p] = table[p][kb];
        d[p] = w[p] != 0 ? load_stream(row + p * plane_chunks + c)
                         : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
        bv[j] = n0 + j < pr.n
                    ? __ldg(bcols +
                            static_cast<size_t>(n0 + j) * row_chunks + c)
                    : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int p = 0; p < BW; ++p) {
        if (w[p] == 0) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j) acc[j] += w[p] * dot16(d[p], bv[j], 0);
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
__global__ void __launch_bounds__(kRunThreads, RunMinCtas<NT, BW>::value)
sparse_i32_kernel(Sparse pr, int32_t* __restrict__ out) {
  __shared__ int table[BW][kTableKblks];
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kRunWarps + (threadIdx.x >> 5);
  const int n0 = blockIdx.y * NT;
  int acc[NT];
  run_sums<NT, BW>(pr, table, m, n0, lane, acc);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (n0 + j < pr.n) out[static_cast<size_t>(m) * pr.n + n0 + j] = acc[j];
  }
}

template <int NT, int BW>
__global__ void __launch_bounds__(kRunThreads, RunMinCtas<NT, BW>::value)
sparse_fused_kernel(Sparse pr, const float* __restrict__ scale,
                    const float* __restrict__ scale_n,
                    const float* __restrict__ bias, int act,
                    float* __restrict__ out) {
  __shared__ int table[BW][kTableKblks];
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kRunWarps + (threadIdx.x >> 5);
  const int n0 = blockIdx.y * NT;
  int acc[NT];
  run_sums<NT, BW>(pr, table, m, n0, lane, acc);
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
// B5 / B6: one cooperative launch, a persistent walk through a cp.async ring
// ---------------------------------------------------------------------------

constexpr int kMaxSmem = 232448;        // 227 KB: an H100 CTA's opt-in limit
constexpr int kTileBytes = 64 * 1024;   // digits a stage holds, at most
constexpr int kPanelBytes = 64 * 1024;  // the accumulator panel, at most
constexpr int kMaxStages = 4;
constexpr int kMaxWindow = 32;          // entries a panel window: one a lane
constexpr int kMmaRows = 16;            // rows of one warp's mma tile
constexpr int kMmaK = 32;               // bytes of K one mma takes

// How a pipelined problem sits in shared memory (host side; the kernel
// gets it by value).  Mirrored by kernels/bw_gemm.py _pipelined_layout.
struct Layout {
  int tile_rows;    // rows of a plane block one stage holds
  int tiles;        // stages a plane block takes: block_m / tile_rows
  int window;       // entries a panel window covers
  int stages;       // depth of the ring
  int stage_bytes;  // one stage's digits: tile_rows x (block_k + 16)
  int b_bytes;      // one activation slot: NT x (block_k + 16)
  int smem;         // dynamic shared memory of a CTA
};

// False when the problem does not fit: blocks that are not whole mma
// tiles, a panel that cannot hold one m-block, or two stages and the
// panel above kMaxSmem.
bool pipelined_layout(int block_m, int block_k, int nt, Layout& l) {
  if (block_m <= 0 || block_m % kMmaRows != 0 || block_k <= 0 ||
      block_k % kMmaK != 0)
    return false;
  // the largest power of two dividing block_m, one mma tile a warp at most
  int tr = std::min(block_m & -block_m, kWarps * kMmaRows);
  while (tr > kMmaRows && tr * block_k > kTileBytes) tr >>= 1;
  l.tile_rows = tr;
  l.tiles = block_m / tr;
  l.window = std::min(kMaxWindow, kPanelBytes / (block_m * nt * 4));
  if (l.window < 1) return false;
  l.stage_bytes = tr * (block_k + 16);
  l.b_bytes = nt * (block_k + 16);
  const int panel = l.window * block_m * nt * 4;
  l.stages = std::min(kMaxStages,
                      (kMaxSmem - panel) / (l.stage_bytes + l.b_bytes));
  if (l.stages < 2) return false;
  l.smem = l.stages * (l.stage_bytes + l.b_bytes) + panel;
  return true;
}

// Where a call's sums go once the walk is done: B6 copies them to
// `sums`; B5 runs the fused epilogue into `out`.
struct Epilogue {
  const float* scale;
  const float* scale_n;
  const float* bias;
  int act;
  float* out;
  int32_t* sums;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `pending` (0, 1 or 2) of this thread's newest
// commit groups are still in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8 x 16-byte matrices from shared memory, one row address a lane:
// the A operand of one m16n8k32 int8 mma.
__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned (&a)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// c += a (16 x 32 int8, row-major) * b (32 x 8 int8, column-major), exact
// in int32 on the tensor cores.
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Flat walk position f: column tile f / steps, schedule entry f % steps.
struct Entry {
  int ct, plane, row, kblk, weight;
  bool live;
};

// 32 consecutive walk positions [base, base + 32), one a lane, loaded
// with one round trip and read back by shuffle, so no copy or product
// waits on a schedule load of its own.
struct Lanes {
  int base, plane, row, kblk, weight;

  __device__ __forceinline__ void fetch(const Sparse& pr, int from, int end,
                                        int lane) {
    base = from;
    const int f = from + lane;
    plane = row = kblk = weight = 0;
    if (f < end) {
      const int i = f % pr.steps;
      plane = load_col(pr, i, kPlane);
      row = load_col(pr, i, kRow);
      kblk = load_col(pr, i, kKblk);
      weight = load_col(pr, i, kWeight);
    }
  }

  // Position f of the 32; every lane of the warp calls it together.
  __device__ __forceinline__ Entry at(const Sparse& pr, int f) const {
    const int l = f - base;
    Entry e;
    e.ct = f / pr.steps;
    e.plane = __shfl_sync(0xffffffffu, plane, l);
    e.row = __shfl_sync(0xffffffffu, row, l);
    e.kblk = __shfl_sync(0xffffffffu, kblk, l);
    e.weight = __shfl_sync(0xffffffffu, weight, l);
    e.live = live(pr, e.plane, e.row, e.kblk, e.weight);
    return e;
  }
};

// One call of B6 (FUSED false) or B5.  `ws` is int32 [m_pad, n], zero
// when the call starts and zero again when it ends.  Every branch on the
// schedule is uniform across the CTA, so all its threads meet at each
// barrier and every shuffle has all 32 lanes.
template <int NT, bool FUSED>
__global__ void __launch_bounds__(kThreads, 1)
pipelined_kernel(Sparse pr, Layout lay, int32_t* __restrict__ ws,
                 Epilogue ep) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = lay.stages, T = lay.tiles, TR = lay.tile_rows;
  const int cpk = pr.block_k >> 4;           // 16-byte chunks a stage row
  const int row_stride = pr.block_k + 16;    // stage and slot rows, padded
  unsigned char* const stage_s = smem;                     // [S][stage]
  unsigned char* const b_s = smem + S * lay.stage_bytes;   // [S][NT][bk]
  int* const panel = reinterpret_cast<int*>(b_s + S * lay.b_bytes);
  const int mblocks = pr.m_pad / pr.block_m;
  const int kblocks = pr.k_pad / pr.block_k;
  const long long work =
      static_cast<long long>((pr.n + NT - 1) / NT) * pr.steps;
  const int f0 = static_cast<int>(work * blockIdx.x / gridDim.x);
  const int f1 = static_cast<int>(work * (blockIdx.x + 1) / gridDim.x);
  const int u0 = f0 * T, u1 = f1 * T;      // units: (entry, row tile)
  const size_t plane_stride = static_cast<size_t>(pr.m_pad) * pr.k_pad;

  // -- the copy side: unit u into stage u % S --------------------------------
  Lanes ahead;                             // the copy side's 32 positions
  ahead.fetch(pr, f0, f1, lane);
  int issued_bkey = -1, issued_bslot = -1;
  auto issue = [&](int u) {
    if (u < u1) {
      const int f = u / T, tile = u - f * T;
      if (f >= ahead.base + 32) ahead.fetch(pr, f, f1, lane);
      const Entry e = ahead.at(pr, f);
      if (e.live) {
        const int8_t* src =
            pr.digits + e.plane * plane_stride +
            (static_cast<size_t>(e.row) * pr.block_m + tile * TR) * pr.k_pad +
            static_cast<size_t>(e.kblk) * pr.block_k;
        unsigned char* dst = stage_s + (u % S) * lay.stage_bytes;
        for (int i = tid; i < TR * cpk; i += kThreads) {
          const int r = i / cpk, c = i - r * cpk;
          cp_async16(dst + r * row_stride + c * 16,
                     src + static_cast<size_t>(r) * pr.k_pad + c * 16);
        }
        const int bkey = e.ct * kblocks + e.kblk;
        if (bkey != issued_bkey) {             // a new k-block: next slot
          issued_bkey = bkey;
          issued_bslot = issued_bslot + 1 == S ? 0 : issued_bslot + 1;
          unsigned char* bdst = b_s + issued_bslot * lay.b_bytes;
          for (int i = tid; i < NT * cpk; i += kThreads) {
            const int j = i / cpk, c = i - j * cpk;
            const int n = e.ct * NT + j;       // columns past N stay unread
            if (n < pr.n)
              cp_async16(bdst + j * row_stride + c * 16,
                         pr.b + static_cast<size_t>(n) * pr.k_pad +
                             static_cast<size_t>(e.kblk) * pr.block_k +
                             c * 16);
          }
        }
      }
    }
    cp_async_commit();                         // one group a unit, always
  };

  // -- the panel window: entries [win.base, win.base + window) of the range --
  // Lane l holds entry win.base + l; key_l is its (column tile, m-block),
  // or -1 when dead or past the window; slot_l its panel slot; fresh_l
  // whether it is the window's first entry of its key (which writes the
  // slot instead of adding to it).
  Lanes win;
  int key_l = -1, slot_l = 0, fresh_l = 0;
  unsigned firsts = 0;                         // lanes that open a slot
  auto open_window = [&](int base) {
    win.fetch(pr, base, f1, lane);
    const int f = base + lane;
    const Entry e = win.at(pr, min(f, f1 - 1));
    const int key =
        f < f1 && lane < lay.window && e.live ? e.ct * mblocks + e.row : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const int first = __ffs(peers) - 1;
    fresh_l = key >= 0 && first == lane;
    firsts = __ballot_sync(0xffffffffu, fresh_l);
    slot_l = __popc(firsts & ((1u << first) - 1u));
    key_l = key;
  };

  // Warp w multiplies rows [16 w, 16 w + 16) of a stage (warps past
  // tile_rows / 16 idle); lane (g, q) = (lane / 4, lane % 4) holds its
  // rows g and g + 8, columns 2q and 2q + 1 of the mma result, and owns
  // those panel elements.
  const int g = lane >> 2, q2 = (lane & 3) * 2;
  const bool computes = warp * kMmaRows < TR;

  // adds the window's panel slots into the workspace, each owner its own
  auto flush = [&]() {
    for (unsigned bits = firsts; bits != 0; bits &= bits - 1) {
      const int l = __ffs(bits) - 1;
      const int key = __shfl_sync(0xffffffffu, key_l, l);
      const int slot = __shfl_sync(0xffffffffu, slot_l, l);
      const int ct = key / mblocks, mblk = key - ct * mblocks;
      if (!computes) continue;
      for (int t = 0; t < T; ++t) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = t * TR + warp * kMmaRows + g + 8 * h;
          const int* prow =
              panel + (static_cast<size_t>(slot) * pr.block_m + row) * NT;
          int32_t* wrow = ws +
                          static_cast<size_t>(mblk * pr.block_m + row) *
                              pr.n +
                          ct * NT;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int j = q2 + i;
            if (j >= NT || ct * NT + j >= pr.n) continue;
            const int v = prow[j];
            if (v != 0) atomicAdd(wrow + j, v);
          }
        }
      }
    }
  };

  // -- the call --------------------------------------------------------------
  for (int s = 0; s < S - 1; ++s) issue(u0 + s);
  if (f0 < f1) open_window(f0);
  int used_bkey = -1, used_bslot = -1;
  for (int u = u0; u < u1; ++u) {
    cp_async_wait(S - 2);        // this thread's copies of unit u landed
    __syncthreads();             // everyone's have, and unit u-1 is done
    issue(u + S - 1);            // into the stage unit u-1 used
    const int f = u / T, tile = u - f * T;
    const Entry e = win.at(pr, f);
    const int idx = f - win.base;
    const int slot = __shfl_sync(0xffffffffu, slot_l, idx);
    const int fresh = __shfl_sync(0xffffffffu, fresh_l, idx);
    if (e.live) {
      const int bkey = e.ct * kblocks + e.kblk;
      if (bkey != used_bkey) {   // the copy side's slot sequence, replayed
        used_bkey = bkey;
        used_bslot = used_bslot + 1 == S ? 0 : used_bslot + 1;
      }
      if (computes) {
        // A from the stage by ldmatrix: lane l gives row l % 16 of the
        // warp's tile, K half l / 16; B, the activation slot [NT, block_k]
        // read as columns, straight from shared memory (zero past NT)
        const unsigned a_row = static_cast<unsigned>(__cvta_generic_to_shared(
            stage_s + (u % S) * lay.stage_bytes +
            (warp * kMmaRows + (lane & 15)) * row_stride + (lane >> 4) * 16));
        const unsigned char* b_row =
            b_s + used_bslot * lay.b_bytes + g * row_stride + (lane & 3) * 4;
        int c[4] = {0, 0, 0, 0};
#pragma unroll 4
        for (int kk = 0; kk < pr.block_k; kk += kMmaK) {
          unsigned a[4];
          ldmatrix_x4(a_row + kk, a);
          const unsigned b0 =
              g < NT ? *reinterpret_cast<const unsigned*>(b_row + kk) : 0u;
          const unsigned b1 =
              g < NT ? *reinterpret_cast<const unsigned*>(b_row + kk + 16)
                     : 0u;
          mma_s8(c, a, b0, b1);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int* prow = panel + (static_cast<size_t>(slot) * pr.block_m +
                               tile * TR + warp * kMmaRows + g + 8 * h) *
                                  NT;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int j = q2 + i;
            if (j >= NT) continue;
            const int v = e.weight * c[2 * h + i];
            prow[j] = fresh ? v : prow[j] + v;
          }
        }
      }
    }
    if (tile == T - 1 && (f + 1 == f1 || f + 1 - win.base == lay.window)) {
      flush();
      if (f + 1 < f1) open_window(f + 1);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  grid.sync();                   // every CTA's sums are in the workspace
  // read each sum once, leave the workspace zero for the next call
  const size_t total = static_cast<size_t>(pr.m_pad) * pr.n;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + tid; i < total;
       i += static_cast<size_t>(gridDim.x) * kThreads) {
    const int v = __ldcg(ws + i);
    ws[i] = 0;
    if constexpr (FUSED) {
      const int m = static_cast<int>(i / pr.n);
      const int j = static_cast<int>(i - static_cast<size_t>(m) * pr.n);
      ep.out[i] = fused_epilogue(
          v, ep.scale[m], ep.scale_n == nullptr ? nullptr : ep.scale_n + j,
          ep.bias == nullptr ? nullptr : ep.bias + m, ep.act);
    } else {
      ep.sums[i] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// Launch plumbing
// ---------------------------------------------------------------------------

bool valid(const Sparse& pr) {
  return pr.steps >= 0 && pr.cols >= 4 && pr.bw >= 1 && pr.bw <= 8 &&
         pr.n >= 1 &&
         pr.m_pad >= 1 && pr.block_m > 0 && pr.block_m % kWarps == 0 &&
         pr.m_pad % pr.block_m == 0 && pr.block_k > 0 &&
         pr.block_k % 16 == 0 && pr.k_pad % pr.block_k == 0;
}

int nt_for(int n) { return n <= 1 ? 1 : n <= 2 ? 2 : n <= 4 ? 4 : 8; }

bool valid_pipelined(const Sparse& pr, int ctas, Layout& lay) {
  return valid(pr) && ctas >= 1 &&
         pipelined_layout(pr.block_m, pr.block_k, nt_for(pr.n), lay);
}

template <int NT, int BW>
struct LaunchI32 {
  static void run(const Sparse& pr, int32_t* out, cudaStream_t stream) {
    const dim3 grid(pr.m_pad / kRunWarps, (pr.n + NT - 1) / NT);
    sparse_i32_kernel<NT, BW><<<grid, kRunThreads, 0, stream>>>(pr, out);
  }
};

template <int NT, int BW>
struct LaunchFused {
  static void run(const Sparse& pr, const float* scale, const float* scale_n,
                  const float* bias, int act, float* out,
                  cudaStream_t stream) {
    const dim3 grid(pr.m_pad / kRunWarps, (pr.n + NT - 1) / NT);
    sparse_fused_kernel<NT, BW><<<grid, kRunThreads, 0, stream>>>(
        pr, scale, scale_n, bias, act, out);
  }
};

// Instantiate the column tile NT (1, 2, 4 or 8) and plane capacity BW (4,
// or 8 past four planes) a problem needs.
template <template <int, int> class Launch, int BW, typename... Args>
void dispatch_nt(const Sparse& pr, Args... args) {
  switch (nt_for(pr.n)) {
    case 1: Launch<1, BW>::run(pr, args...); break;
    case 2: Launch<2, BW>::run(pr, args...); break;
    case 4: Launch<4, BW>::run(pr, args...); break;
    default: Launch<8, BW>::run(pr, args...); break;
  }
}

template <template <int, int> class Launch, typename... Args>
void dispatch(const Sparse& pr, Args... args) {
  if (pr.bw <= 4) dispatch_nt<Launch, 4>(pr, args...);
  else dispatch_nt<Launch, 8>(pr, args...);
}

// The pipelined kernel of column tile NT, its shared memory opted in.
template <int NT, bool FUSED>
struct Pipelined {
  static cudaError_t prepare(const Layout& lay) {
    return cudaFuncSetAttribute(pipelined_kernel<NT, FUSED>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                lay.smem);
  }

  // CTAs an SM of the current device holds at once.
  static cudaError_t per_sm(const Layout& lay, int* out) {
    cudaError_t err = prepare(lay);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          out, pipelined_kernel<NT, FUSED>, kThreads, lay.smem);
    return err;
  }

  static cudaError_t launch(Sparse pr, Layout lay, int ctas, int32_t* ws,
                            Epilogue ep, cudaStream_t stream) {
    cudaError_t err = prepare(lay);
    if (err != cudaSuccess) return err;
    void* args[] = {&pr, &lay, &ws, &ep};
    return cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(pipelined_kernel<NT, FUSED>),
        dim3(ctas), dim3(kThreads), args, lay.smem, stream);
  }
};

template <bool FUSED>
cudaError_t pipelined_per_sm(int nt, const Layout& lay, int* out) {
  switch (nt) {
    case 1: return Pipelined<1, FUSED>::per_sm(lay, out);
    case 2: return Pipelined<2, FUSED>::per_sm(lay, out);
    case 4: return Pipelined<4, FUSED>::per_sm(lay, out);
    default: return Pipelined<8, FUSED>::per_sm(lay, out);
  }
}

template <bool FUSED>
cudaError_t pipelined_launch(const Sparse& pr, const Layout& lay, int ctas,
                             int32_t* ws, const Epilogue& ep,
                             cudaStream_t stream) {
  switch (nt_for(pr.n)) {
    case 1: return Pipelined<1, FUSED>::launch(pr, lay, ctas, ws, ep, stream);
    case 2: return Pipelined<2, FUSED>::launch(pr, lay, ctas, ws, ep, stream);
    case 4: return Pipelined<4, FUSED>::launch(pr, lay, ctas, ws, ep, stream);
    default:
      return Pipelined<8, FUSED>::launch(pr, lay, ctas, ws, ep, stream);
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

}  // namespace

// Each kernel entry point launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (0 on success).  `cols` is the schedule's
// column count (>= 6 for the sparse kernels, 9 for the pipelined ones).
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

// The pipelined kernels' shared-memory layout for N columns and the plan's
// blocks: out[0..6] = tile_rows, tiles, window, stages, stage bytes,
// activation slot bytes, dynamic shared memory.  Returns
// cudaErrorInvalidValue (and leaves out alone) for a problem the kernels
// refuse.  Host only: launches nothing.
extern "C" int bw_gemm_sparse_pipelined_layout(int n, int block_m,
                                               int block_k, int* out) {
  Layout l{};
  if (n < 1 || !pipelined_layout(block_m, block_k, nt_for(n), l))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vals[] = {l.tile_rows, l.tiles,       l.window, l.stages,
                      l.stage_bytes, l.b_bytes, l.smem};
  std::copy(vals, vals + 7, out);
  return 0;
}

// *per_sm: CTAs of the pipelined kernel (B5 when `fused`, else B6) that
// one SM of the current device holds at once at this problem's shared
// memory; the wrapper's cooperative grid is SMs x *per_sm.  Host only.
extern "C" int bw_gemm_sparse_pipelined_per_sm(int n, int block_m,
                                               int block_k, int fused,
                                               int* per_sm) {
  Layout l{};
  if (n < 1 || !pipelined_layout(block_m, block_k, nt_for(n), l))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      fused ? pipelined_per_sm<true>(nt_for(n), l, per_sm)
            : pipelined_per_sm<false>(nt_for(n), l, per_sm);
  return static_cast<int>(err);
}

// ws: int32 [m_pad, n] that is zero, and that the launch leaves zero;
// out: int32 [m_pad, n].  ctas: the cooperative grid, at most SMs x
// bw_gemm_sparse_pipelined_per_sm.
extern "C" int bw_gemm_sparse_pipelined_i32(const void* digits, const void* b,
                                            const void* sched, void* ws,
                                            void* out, int steps, int cols,
                                            int bw, int m_pad, int k_pad,
                                            int n, int block_m, int block_k,
                                            int ctas, void* stream) {
  const Sparse pr = problem(digits, b, sched, steps, cols, bw, m_pad, k_pad,
                            n, block_m, block_k);
  Layout lay{};
  if (!valid_pipelined(pr, ctas, lay))
    return static_cast<int>(cudaErrorInvalidValue);
  Epilogue ep{};
  ep.sums = static_cast<int32_t*>(out);
  const cudaError_t err =
      pipelined_launch<false>(pr, lay, ctas, static_cast<int32_t*>(ws), ep,
                              static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// ws: as above; out: float [m_pad, n].  One launch: the walk and the
// epilogue.
extern "C" int bw_gemm_sparse_fused_pipelined(
    const void* digits, const void* b, const void* sched, const void* scale,
    const void* scale_n, const void* bias, void* ws, void* out, int steps,
    int cols, int bw, int m_pad, int k_pad, int n, int block_m, int block_k,
    int ctas, int act, void* stream) {
  const Sparse pr = problem(digits, b, sched, steps, cols, bw, m_pad, k_pad,
                            n, block_m, block_k);
  Layout lay{};
  if (!valid_pipelined(pr, ctas, lay) || act < kNone || act > kRelu2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Epilogue ep{static_cast<const float*>(scale),
                    static_cast<const float*>(scale_n),
                    static_cast<const float*>(bias), act,
                    static_cast<float*>(out), nullptr};
  const cudaError_t err =
      pipelined_launch<true>(pr, lay, ctas, static_cast<int32_t*>(ws), ep,
                             static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
