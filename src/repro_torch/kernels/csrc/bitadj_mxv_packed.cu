// Bit-tile or_and product:  Yw[32p+r] = OR over slots s and set bits b of
// tiles[p, s, r] of Xw[cols[p, s]*32 + b].
//
// Replaces the Pallas TPU kernel src/repro/kernels/bitadj_mxv.py
// (bitadj_mxv_packed -> pl.pallas_call, body _kernel). The TPU body spread
// all 32 bit positions of every slot as masks over a (32, W) query tile.
// Here that would be 32 word-ORs per row per slot whatever the tile holds:
// at Graph500 scale 18 (P = 8192 panels, S = 5908 slots) about 96% of the
// slots are the padding sentinel and an occupied tile holds about 2 edges
// of 1024, so the all-bits loop is about 8e11 word-ORs per hop where the
// edges need about 6e7.
//
// What bounds it on an H100: memory, and little of it. The data needs
// each panel's occupied slot ids plus one sentinel, the 32 words of each
// occupied tile, the frontier and the n*W*4-byte output, at 3.35 TB/s
// (about 270 MB at scale 18, W = 16, against 6.1 GB of padded tiles).
// Slots are occupied-first within each panel (BitELL.occupied_first), so
// a warp stops at its first sentinel slot and reads nothing behind it. In
// practice the hub panel is the tail: its thousands of occupied slots are
// walked by one block.
//
// Design: one block per 32-row panel, 32 warps. Warp j takes slots j,
// j+32, ...; lane r holds row r's tile word (one coalesced 128-byte load
// per slot) and visits only its set bits (__ffs, then t &= t - 1), OR-ing
// the named frontier row into a (32, wc) accumulator in shared memory
// with shared atomics, since two warps can hit one row. The wrapper
// splits W into chunks of at most 256 words so the accumulator fits
// shared memory.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void bitadj_mxv_packed_kernel(const uint32_t* __restrict__ tiles,
                                         const int32_t* __restrict__ cols,
                                         const uint32_t* __restrict__ xw,
                                         uint32_t* __restrict__ y,
                                         int S, int C, long long xrows,
                                         long long n, int W, int w0, int wc) {
  extern __shared__ uint32_t acc[];             // (32, wc)
  const long long p = blockIdx.x;
  for (int i = threadIdx.x; i < 32 * wc; i += blockDim.x) acc[i] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long base = p * (long long)S;
  for (int s = warp; s < S; s += nwarps) {
    const int c = __ldg(cols + base + s);
    if (c < 0 || c >= C) break;                 // sentinel: the rest are too
    uint32_t t = __ldg(tiles + (base + s) * 32 + lane);
    while (t) {
      const int b = __ffs(t) - 1;
      t &= t - 1;
      const long long row = (long long)c * 32 + b;
      if (row >= xrows) break;                  // bits ascend: rest is past
      const uint32_t* xr = xw + row * W + w0;
      for (int w = 0; w < wc; ++w) atomicOr(&acc[lane * wc + w], __ldg(xr + w));
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 32 * wc; i += blockDim.x) {
    const long long row = p * 32 + i / wc;
    if (row < n) y[row * W + w0 + i % wc] = acc[i];
  }
}

// Words [w0, w0 + wc) of every output row; launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int bitadj_mxv_packed(const void* tiles, const void* cols,
                                 const void* xw, void* y, int P, int S, int C,
                                 long long xrows, long long n, int W, int w0,
                                 int wc, void* stream) {
  if (P == 0 || wc == 0) return 0;
  const int threads = 1024;
  const size_t smem = (size_t)32 * wc * sizeof(uint32_t);
  bitadj_mxv_packed_kernel<<<P, threads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)tiles, (const int32_t*)cols, (const uint32_t*)xw,
      (uint32_t*)y, S, C, xrows, n, W, w0, wc);
  return (int)cudaGetLastError();
}
