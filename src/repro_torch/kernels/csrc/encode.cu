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
// four digit bytes, plus one mask byte a plane block: about 5 bytes moved
// an input byte at 3.35 TB/s, and some 40 integer operations an input
// byte, well inside the SMs' integer rate at that byte rate.
//
// What the design does about it:
//   * one CTA of 256 threads per (m-block, k-block) tile, for any
//     block_m x block_k whose block_k is a multiple of 16; the threads
//     loop over the tile in 16-byte chunks, neighbouring threads on
//     neighbouring chunks of a row, so every load and store is a
//     coalesced 16-byte access;
//   * the carry chain runs in registers on the chunk's 16 bytes, and each
//     plane's 16 digits are written with one 16-byte store;
//   * each thread ORs its plane chunks into four flags, __syncthreads_or
//     reduces each over the CTA, and one thread writes the tile's four
//     mask bytes (torch.bool, one byte a flag).
// No shared memory, no atomics.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPlanes = 4;      // int8 in radix 4

// The four digit planes of 16 int8 values, each plane packed in an int4.
__device__ __forceinline__ void encode16(const int4& x, int4 (&d)[kPlanes]) {
  const uint32_t in[4] = {static_cast<uint32_t>(x.x),
                          static_cast<uint32_t>(x.y),
                          static_cast<uint32_t>(x.z),
                          static_cast<uint32_t>(x.w)};
  uint32_t out[kPlanes][4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) out[p][w] = 0u;
#pragma unroll
    for (int byte = 0; byte < 4; ++byte) {
      const int v = static_cast<int8_t>((in[w] >> (8 * byte)) & 0xffu);
      const int m = v < 0 ? -v : v;
      int carry = 0;
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        const int t = ((m >> (2 * p)) & 3) + carry;
        int digit = t == 3 ? -1 : (t == 4 ? 0 : t);
        carry = t >= 3;
        digit = v < 0 ? -digit : digit;
        out[p][w] |= (static_cast<uint32_t>(digit) & 0xffu) << (8 * byte);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kPlanes; ++p)
    d[p] = make_int4(static_cast<int>(out[p][0]), static_cast<int>(out[p][1]),
                     static_cast<int>(out[p][2]), static_cast<int>(out[p][3]));
}

__global__ void __launch_bounds__(kThreads)
ent_encode_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ digits,
                  uint8_t* __restrict__ mask, int m, int k, int block_m,
                  int block_k) {
  const int bi = blockIdx.y;                     // m-block
  const int bj = blockIdx.x;                     // k-block
  const int chunks_per_row = block_k >> 4;
  const int chunks = block_m * chunks_per_row;
  const size_t plane = static_cast<size_t>(m) * k;
  int live[kPlanes] = {0, 0, 0, 0};
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const int r = c / chunks_per_row;
    const int col = (c - r * chunks_per_row) << 4;
    const size_t off = static_cast<size_t>(bi * block_m + r) * k +
                       static_cast<size_t>(bj) * block_k + col;
    const int4 xv = __ldg(reinterpret_cast<const int4*>(x + off));
    int4 d[kPlanes];
    encode16(xv, d);
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      *reinterpret_cast<int4*>(digits + p * plane + off) = d[p];
      live[p] |= d[p].x | d[p].y | d[p].z | d[p].w;
    }
  }
  const size_t mblks = static_cast<size_t>(m / block_m);
  const size_t kblks = static_cast<size_t>(k / block_k);
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
    const int any = __syncthreads_or(live[p] != 0);
    if (threadIdx.x == 0)
      mask[(p * mblks + bi) * kblks + bj] = any ? 1 : 0;
  }
}

}  // namespace

// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success).  x: int8 [m, k]; digits: int8
// [4, m, k]; mask: bool [4, m / block_m, k / block_k]; x and digits
// 16-byte aligned.
extern "C" int ent_encode(const void* x, void* digits, void* mask, int m,
                          int k, int block_m, int block_k, void* stream) {
  if (m < 1 || k < 1 || block_m < 1 || block_k < 16 || block_k % 16 != 0 ||
      m % block_m != 0 || k % block_k != 0 || m / block_m > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(k / block_k, m / block_m);
  ent_encode_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(digits),
      static_cast<uint8_t*>(mask), m, k, block_m, block_k);
  return static_cast<int>(cudaGetLastError());
}
