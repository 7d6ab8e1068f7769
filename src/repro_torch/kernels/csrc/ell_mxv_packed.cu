// Packed or_and gather-OR over ELL rows:  Yw[i] = OR_s Xw[idx[i, s]].
//
// Replaces the Pallas TPU kernel src/repro/kernels/bitmap_mxv.py
// (ell_mxv_packed -> pl.pallas_call, body _kernel). Same sentinel
// spelling as its wrapper: idx is where(mask, indices, k). Here each row
// holds its valid ids first (ELL.sentinel_indices), so the first k ends
// the row and the padded slots behind it are never read; the TPU kernel
// instead streamed every slot and gathered an appended zero row. Words
// are 32-bit patterns; torch stores them as int32, read here as uint32_t.
//
// What bounds it on an H100: memory, but only a little of it. The data
// needs each row's valid ids plus one sentinel (about nnz + n ids, 4 MB
// for the scale-16 Graph500 ELL handle against 1.65 GB of padded slots),
// the frontier k*W*4 bytes and the output n*W*4 bytes, at 3.35 TB/s. The
// gathered frontier rows are read once per edge, from L2 (4 MB at W = 16).
// In practice the power-law hub row is the tail: one thread walks all its
// slots in order.
//
// Design: one thread per (row, word). Neighbouring threads take
// neighbouring words of one row, so each slot id is one broadcast load
// and the frontier loads of a row are contiguous. Ids are read 8 at a
// time and the 8 frontier loads they name issue together, so a long row
// keeps 8 gathers in flight. Offsets are 64-bit: n * deg passes 2^31 at
// scale 18.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int CHUNK = 8;

__global__ void ell_mxv_packed_kernel(const int32_t* __restrict__ idx,
                                      const uint32_t* __restrict__ xw,
                                      uint32_t* __restrict__ y,
                                      long long n, int deg, int k, int W) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * W) return;
  const long long row = t / W;
  const int w = (int)(t - row * W);
  const int32_t* ri = idx + row * (long long)deg;
  uint32_t acc = 0;
  for (int s = 0; s < deg; s += CHUNK) {
    int j[CHUNK];
    #pragma unroll
    for (int u = 0; u < CHUNK; ++u) j[u] = s + u < deg ? __ldg(ri + s + u) : k;
    #pragma unroll
    for (int u = 0; u < CHUNK; ++u)
      if (j[u] != k) acc |= __ldg(xw + (long long)j[u] * W + w);
    if (j[CHUNK - 1] == k) break;               // valid ids come first
  }
  y[t] = acc;
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int ell_mxv_packed(const void* idx, const void* xw, void* y,
                              long long n, int deg, int k, int W,
                              void* stream) {
  const long long total = n * (long long)W;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  ell_mxv_packed_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const uint32_t*)xw, (uint32_t*)y, n, deg, k, W);
  return (int)cudaGetLastError();
}
