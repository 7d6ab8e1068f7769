// Block-sparse semiring matmul:  Y = A_bsr (x) X  [<M> / <!M>].
//
// Replaces the Pallas TPU kernel src/repro/kernels/bsr_mxm.py (bsr_mxm ->
// pl.pallas_call, body _kernel). The TPU grid is (F tiles, nnzb), sequential
// over nnzb, and revisits one output tile while k walks a block-row. Here one
// thread block owns one (block-row r, 64-column F tile): it walks the tiles
// row_ptr[r] .. row_ptr[r+1], skips those with valid == 0 (padding tiles of
// empty rows; the grid padding past row_ptr[nbr] is never visited, and
// first/last are not read), keeps the output tile in registers from the
// semiring identity on, applies the clamp and the mask epilogue once and
// writes the tile once. No atomics, no second pass, deterministic.
//
// Modes (the semiring's `mode`), all in fp32 on the CUDA cores (no TF32, so
// dot and dot_first match the fp32 reference):
//   0 dot            acc += a * x
//   1 dot_indicator  acc += (a != 0) * (x != 0), then y = acc > 0
//   2 dot_pair       acc += (a != 0) * (x != 0)
//   3 dot_first      acc += a * (x != 0)
//   4 bcast, min     acc = min(acc, a' + x),  a' = a where stored else +inf
//   5 bcast, max     acc = max(acc, a' + x),  a' = a where stored else -inf
// "stored" is the emask where the matrix has one, else a != 0. The operand
// transforms happen once, as the chunk is staged in shared memory, so the
// inner loop is one FMA (or add + min/max) per element.
//
// What bounds it on an H100: operations. The data needs the stored tiles
// once (nnzb * b * b * 4 bytes: 6.1 GB for the Graph500 scale-16 handle)
// plus the frontier, mask and output, about 2 ms at 3.35 TB/s; the work is
// nnzb * b * b * F multiply-adds, 1.57e12 operations at F = 512, 23 ms at
// the 67 TFLOP/s fp32 peak. This first kernel stages an A chunk (b x 32,
// transposed) and an X chunk (32 x 64) in shared memory and gives each of
// 256 threads an 8 x 4 register tile; each tile of A is read once per F
// tile. wgmma and bf16 operands for the 0/1 modes are later work.
//
// Offsets into the tiles are 64-bit: k * b * b passes 2^31 past about 131k
// tiles of 128 x 128. The ragged F edge and the rows past m in the last
// block-column are masked here; X is not padded on the host.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

constexpr int BM = 128;       // output rows per block (b <= 128)
constexpr int FT = 64;        // frontier columns per block
constexpr int KC = 32;        // inner-dimension chunk staged in shared memory
constexpr int THREADS = 256;  // 16 x 16 threads, each 8 rows x 4 columns
constexpr int TM = 8;
constexpr int TN = 4;

template <int MODE>
__device__ __forceinline__ float identity() {
  if (MODE == 4) return CUDART_INF_F;
  if (MODE == 5) return -CUDART_INF_F;
  return 0.0f;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
bsr_mxm_kernel(const float* __restrict__ blocks,
               const uint8_t* __restrict__ emask,
               const int32_t* __restrict__ block_cols,
               const int32_t* __restrict__ valid,
               const int32_t* __restrict__ row_ptr,
               const float* __restrict__ x, const float* __restrict__ mask,
               float* __restrict__ y, int b, long long n, long long m, int F,
               int complement) {
  __shared__ float As[KC][BM + 1];   // As[j][i] = A[i, kc + j]
  __shared__ float Xs[KC][FT];       // Xs[j][q] = X[col0 + kc + j, f0 + q]
  const int r = blockIdx.x;
  const int f0 = blockIdx.y * FT;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float ident = identity<MODE>();

  float acc[TM][TN];
#pragma unroll
  for (int u = 0; u < TM; ++u)
#pragma unroll
    for (int v = 0; v < TN; ++v) acc[u][v] = ident;

  const long long bb = (long long)b * b;
  const int k0 = row_ptr[r], k1 = row_ptr[r + 1];
  for (int k = k0; k < k1; ++k) {
    if (valid[k] == 0) continue;
    const float* tile = blocks + (long long)k * bb;
    const uint8_t* etile = emask ? emask + (long long)k * bb : nullptr;
    const long long xrow0 = (long long)block_cols[k] * b;
    for (int kc = 0; kc < b; kc += KC) {
      // stage A[:, kc:kc+KC] transposed; consecutive threads read
      // consecutive columns of one row
      for (int e = tid; e < BM * KC; e += THREADS) {
        const int i = e / KC, j = e % KC;
        float a = (MODE >= 4) ? ident : 0.0f;
        if (i < b && kc + j < b) {
          const long long o = (long long)i * b + kc + j;
          const float raw = tile[o];
          if (MODE == 1 || MODE == 2) {
            a = raw != 0.0f ? 1.0f : 0.0f;
          } else if (MODE >= 4) {
            const bool stored = etile ? etile[o] != 0 : raw != 0.0f;
            a = stored ? raw : ident;
          } else {
            a = raw;
          }
        }
        As[j][i] = a;
      }
      // stage X rows xrow0+kc .. +KC, columns f0 .. f0+FT
      for (int e = tid; e < KC * FT; e += THREADS) {
        const int j = e / FT, q = e % FT;
        const long long row = xrow0 + kc + j;
        float xv = 0.0f;
        if (kc + j < b && row < m && f0 + q < F) {
          xv = x[row * F + f0 + q];
          if (MODE >= 1 && MODE <= 3) xv = xv != 0.0f ? 1.0f : 0.0f;
        }
        Xs[j][q] = xv;
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < KC; ++j) {
        float av[TM], xv[TN];
#pragma unroll
        for (int u = 0; u < TM; ++u) av[u] = As[j][ty + 16 * u];
#pragma unroll
        for (int v = 0; v < TN; ++v) xv[v] = Xs[j][tx + 16 * v];
#pragma unroll
        for (int u = 0; u < TM; ++u)
#pragma unroll
          for (int v = 0; v < TN; ++v) {
            if (MODE == 4) acc[u][v] = fminf(acc[u][v], av[u] + xv[v]);
            else if (MODE == 5) acc[u][v] = fmaxf(acc[u][v], av[u] + xv[v]);
            else acc[u][v] = fmaf(av[u], xv[v], acc[u][v]);
          }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int u = 0; u < TM; ++u) {
    const int i = ty + 16 * u;
    const long long row = (long long)r * b + i;
    if (i >= b || row >= n) continue;
#pragma unroll
    for (int v = 0; v < TN; ++v) {
      const int f = f0 + tx + 16 * v;
      if (f >= F) continue;
      float out = acc[u][v];
      if (MODE == 1) out = out > 0.0f ? 1.0f : 0.0f;
      if (mask) {
        const float mv = mask[row * F + f];
        const bool keep = complement ? (mv == 0.0f) : (mv != 0.0f);
        if (!keep) out = ident;
      }
      y[row * F + f] = out;
    }
  }
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// emask and mask may be null.
extern "C" int bsr_mxm(const void* blocks, const void* emask,
                       const void* block_cols, const void* valid,
                       const void* row_ptr, const void* x, const void* mask,
                       void* y, int nbr, int b, long long n, long long m,
                       int F, int mode, int complement, void* stream) {
  if (nbr == 0 || F == 0) return 0;
  if (b < 1 || b > BM || mode < 0 || mode > 5)
    return (int)cudaErrorInvalidValue;
  const int ftiles = (F + FT - 1) / FT;
  if (ftiles > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)nbr, (unsigned)ftiles);
  cudaStream_t s = (cudaStream_t)stream;
  const float* A = (const float*)blocks;
  const uint8_t* E = (const uint8_t*)emask;
  const int32_t* bc = (const int32_t*)block_cols;
  const int32_t* va = (const int32_t*)valid;
  const int32_t* rp = (const int32_t*)row_ptr;
  const float* X = (const float*)x;
  const float* M = (const float*)mask;
  float* Y = (float*)y;
#define LAUNCH(MD)                                                        \
  bsr_mxm_kernel<MD><<<grid, THREADS, 0, s>>>(A, E, bc, va, rp, X, M, Y, b, \
                                              n, m, F, complement)
  switch (mode) {
    case 0: LAUNCH(0); break;
    case 1: LAUNCH(1); break;
    case 2: LAUNCH(2); break;
    case 3: LAUNCH(3); break;
    case 4: LAUNCH(4); break;
    default: LAUNCH(5); break;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
