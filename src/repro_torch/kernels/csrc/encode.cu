// EN-T radix-4 encoding of an int8 operand into digit planes, fused with
// the per-(plane, block) occupancy mask, for Hopper (sm_90a).  Plain C
// interface, loaded with ctypes by repro_torch/kernels/_build.py; no
// PyTorch headers.
//
// Replaces the TPU Pallas kernel of src/repro/kernels/encode.py:
//   ent_encode <- ent_encode (body _kernel :30, pallas_call :55)
//
// For every int8 x, the reference's branch-free carry chain over the four
// radix-4 planes p = 0..3:
//   m = |x|;  t = ((m >> 2p) & 3) + carry;
//   d = t == 3 ? -1 : (t == 4 ? 0 : t);  carry = t >= 3;
//   digits[p] = sign(x) * d
// (-128 has m = 128 and encodes to (0, 0, 0, -2); 127 to (-1, 0, 0, 2);
// the carry out of plane 3 is 0 for every int8).  mask[p, i, j] is True
// where plane p of block (i, j) holds a non-zero digit.
//
// Bound on the H100: bytes.  Each input byte is read once and becomes
// four digit bytes, plus one mask byte a plane block: 5 bytes moved an
// input byte, at 3.35 TB/s.  The card must then encode about 2.4 input
// bytes a clock on each SM, so the encoding may cost a few integer
// operations a byte, not the carry chain's forty.
//
// What the design does about it:
//   * encoding by table: the wrapper passes a 256-entry table of 32-bit
//     words (kernels/encode.py ent_table), byte p of word u being plane
//     p's digit of the int8 whose bits are u; a CTA copies it into shared
//     memory, and a byte costs one extract and one lookup.  Four looked-up
//     words are four bytes' digits; transpose4 (four byte permutes a pair
//     of words) turns them into one word of four digits a plane, and each
//     plane's 16 digits of a chunk leave in one 16-byte store.  ORing the
//     looked-up words gives the four plane flags at once (byte p);
//   * many bytes in flight: a thread issues all its kUnroll 16-byte chunk
//     loads (neighbouring threads on neighbouring chunks of a row) before
//     it encodes any, and the first loads go out before the table copy;
//   * the card filled: one CTA a plan block, as wide as the block needs
//     (ent_threads: enough threads for kUnroll chunks each, at most
//     kMaxThreads; 24 x 16 blocks take 32).  The 128 x 256 blocks of the
//     path's plans take 256 threads, each eight chunks (128 bytes in
//     flight): 162-414 CTAs, every input byte requested at once.  A
//     larger block loops, kUnroll chunks a thread a pass.  Splitting the
//     128 x 256 blocks over 2-CTA clusters at four chunks a thread
//     (324-828 CTAs), or 512-thread CTAs at four, was slower (PERF.md);
//   * the mask: each warp ORs its flags (__reduce_or_sync) into the CTA's
//     word in shared memory, and after one barrier four threads write
//     the block's four mask bytes (torch.bool, one byte a flag).  One
//     launch, no memset, no global atomics.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

constexpr int kPlanes = 4;       // int8 in radix 4
constexpr int kMaxThreads = 256;
constexpr int kUnroll = 8;       // 16-byte chunks a thread loads at once

int cdiv(int x, int y) { return (x + y - 1) / y; }

// Threads a CTA for a block_m x block_k plan block, or 0 for a call the
// kernel refuses.
int ent_threads(int m, int k, int block_m, int block_k) {
  if (m < 1 || k < 1 || block_m < 1 || block_k < 16 || block_k % 16 != 0 ||
      m % block_m != 0 || k % block_k != 0 || m / block_m > 65535)
    return 0;
  const int chunks = block_m * (block_k / 16);
  const int threads = 32 * cdiv(cdiv(chunks, kUnroll), 32);
  return threads < kMaxThreads ? threads : kMaxThreads;
}

// Plane p's digits of four bytes, one word a plane, from their four table
// words t_i (byte p of t_i: plane p's digit of byte i).
__device__ __forceinline__ void planes4(const uint32_t* table, uint32_t x,
                                        uint32_t& live, uint32_t (&d)[4]) {
  const uint32_t t0 = table[x & 0xffu], t1 = table[(x >> 8) & 0xffu];
  const uint32_t t2 = table[(x >> 16) & 0xffu], t3 = table[x >> 24];
  live |= t0 | t1 | t2 | t3;
  transpose4(t0, t1, t2, t3, d);
}

__global__ void __launch_bounds__(kMaxThreads)
ent_encode_kernel(const int8_t* __restrict__ x,
                  const uint32_t* __restrict__ table,
                  int8_t* __restrict__ digits, uint8_t* __restrict__ mask,
                  int m, int k, int block_m, int block_k) {
  __shared__ uint32_t table_s[256];
  __shared__ uint32_t flags_s;       // byte p: plane p has a non-zero digit
  const int tid = threadIdx.x, threads = blockDim.x;
  const int bj = blockIdx.x, bi = blockIdx.y;   // plan block (bi, bj)
  const int per_row = block_k >> 4;
  const int chunks = block_m * per_row;
  const size_t plane = static_cast<size_t>(m) * k;
  const size_t origin = static_cast<size_t>(bi) * block_m * k +
                        static_cast<size_t>(bj) * block_k;
  auto offset = [&](int c) {
    const int r = c / per_row;
    return origin + static_cast<size_t>(r) * k + ((c - r * per_row) << 4);
  };

  int4 v[kUnroll];
  auto load = [&](int c0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * threads;
      if (c < chunks)
        v[u] = __ldg(reinterpret_cast<const int4*>(x + offset(c)));
    }
  };
  load(tid);
  for (int i = tid; i < 256; i += threads) table_s[i] = table[i];
  if (tid == 0) flags_s = 0u;
  __syncthreads();

  uint32_t live = 0u;
  for (int c0 = tid;;) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * threads;
      if (c >= chunks) break;
      uint32_t d[4][4];            // [word][plane]
      planes4(table_s, static_cast<uint32_t>(v[u].x), live, d[0]);
      planes4(table_s, static_cast<uint32_t>(v[u].y), live, d[1]);
      planes4(table_s, static_cast<uint32_t>(v[u].z), live, d[2]);
      planes4(table_s, static_cast<uint32_t>(v[u].w), live, d[3]);
      const size_t off = offset(c);
#pragma unroll
      for (int p = 0; p < kPlanes; ++p)
        *reinterpret_cast<int4*>(digits + p * plane + off) = make_int4(
            static_cast<int>(d[0][p]), static_cast<int>(d[1][p]),
            static_cast<int>(d[2][p]), static_cast<int>(d[3][p]));
    }
    c0 += kUnroll * threads;
    if (c0 - tid >= chunks) break;
    load(c0);
  }

  live = __reduce_or_sync(0xffffffffu, live);
  if ((tid & 31) == 0 && live != 0u) atomicOr(&flags_s, live);
  const size_t kblks = static_cast<size_t>(k / block_k);
  const size_t at = static_cast<size_t>(bi) * kblks + bj;
  const size_t mask_plane = static_cast<size_t>(m / block_m) * kblks;
  __syncthreads();
  if (tid < kPlanes)
    mask[tid * mask_plane + at] = (flags_s >> (8 * tid)) & 0xffu ? 1 : 0;
}

}  // namespace

// Launches on `stream`, does not synchronise, and returns the launch's
// error (0 on success).  x: int8 [m, k]; table: the 256 words of
// kernels/encode.py ent_table; digits: int8 [4, m, k]; mask: bool
// [4, m / block_m, k / block_k]; x and digits 16-byte aligned.
extern "C" int ent_encode(const void* x, const void* table, void* digits,
                          void* mask, int m, int k, int block_m, int block_k,
                          void* stream) {
  const int threads = ent_threads(m, k, block_m, block_k);
  if (table == nullptr || threads == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ent_encode_kernel<<<dim3(k / block_k, m / block_m), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const uint32_t*>(table),
      static_cast<int8_t*>(digits), static_cast<uint8_t*>(mask), m, k,
      block_m, block_k);
  return static_cast<int>(cudaGetLastError());
}
