// BSR x BSR SpGEMM numeric phase: for each planned task t,
//   C[c_sel[t]] (+)= A[a_sel[t]] (x) B[b_sel[t]],  then the mask epilogue.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bsr_spgemm.py
// (spgemm_blocks -> _spgemm_pallas -> pl.pallas_call, body _kernel). The TPU
// grid walks the task list in order and revisits one output tile while
// consecutive tasks share c_sel. The plan sorts tasks by c_sel, so each
// output tile is one contiguous run; the wrapper turns the run starts into
// a (nc+1,) pointer once, on the host. Here one thread block owns one
// output tile: it walks its run, accumulates the b x b tile products in
// fp32 registers (8 x 8 per thread, 256 threads), applies the
// dot_indicator clamp and the mask epilogue, and writes the tile once. No
// atomics, no second pass, deterministic.
//
// Modes (dot modes only, as on the TPU), fp32 FMAs, no TF32:
//   0 dot            acc += a * b
//   1 dot_indicator  acc += (a != 0) * (b != 0), then c = acc > 0
//   2 dot_pair       acc += (a != 0) * (b != 0)
//   3 dot_first      acc += a * (b != 0)
// The operand transforms happen as a chunk is staged in shared memory.
//
// What bounds it on an H100: operations. Each task is b^3 multiply-adds;
// the Graph500 scale-14 `*1..2` hop matrix plans 1,005,225 tasks, 4.2e12
// operations, 63 ms at the 67 TFLOP/s fp32 peak. With perfect reuse the
// bytes are the A and B tiles once plus the output tiles, under 1 ms. Each
// block stages a b x 32 chunk of A (transposed) and a 32 x b chunk of B in
// shared memory; a tile pair is read once per task. wgmma and bf16
// operands for the 0/1 modes are later work.
//
// Offsets into the tiles are 64-bit.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int BT = 128;       // tile side the block covers (b <= 128)
constexpr int KC = 32;        // inner-dimension chunk staged in shared memory
constexpr int THREADS = 256;  // 16 x 16 threads, each 8 rows x 8 columns
constexpr int TM = 8;
constexpr int TN = 8;

template <int MODE>
__global__ void __launch_bounds__(THREADS)
bsr_spgemm_kernel(const float* __restrict__ ablk,
                  const float* __restrict__ bblk,
                  const float* __restrict__ mblk,
                  const int32_t* __restrict__ a_sel,
                  const int32_t* __restrict__ b_sel,
                  const int32_t* __restrict__ valid,
                  const int32_t* __restrict__ cptr, float* __restrict__ c,
                  int b, int complement) {
  __shared__ float As[KC][BT + 1];   // As[j][i] = A[i, kc + j]
  __shared__ float Bs[KC][BT];       // Bs[j][q] = B[kc + j, q]
  const int ct = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long bb = (long long)b * b;

  float acc[TM][TN];
#pragma unroll
  for (int u = 0; u < TM; ++u)
#pragma unroll
    for (int v = 0; v < TN; ++v) acc[u][v] = 0.0f;

  const int t0 = cptr[ct], t1 = cptr[ct + 1];
  for (int t = t0; t < t1; ++t) {
    if (valid[t] == 0) continue;
    const float* at = ablk + (long long)a_sel[t] * bb;
    const float* bt = bblk + (long long)b_sel[t] * bb;
    for (int kc = 0; kc < b; kc += KC) {
      for (int e = tid; e < BT * KC; e += THREADS) {
        const int i = e / KC, j = e % KC;
        float a = 0.0f;
        if (i < b && kc + j < b) {
          a = at[(long long)i * b + kc + j];
          if (MODE == 1 || MODE == 2) a = a != 0.0f ? 1.0f : 0.0f;
        }
        As[j][i] = a;
      }
      for (int e = tid; e < KC * BT; e += THREADS) {
        const int j = e / BT, q = e % BT;
        float v = 0.0f;
        if (kc + j < b && q < b) {
          v = bt[(long long)(kc + j) * b + q];
          if (MODE >= 1) v = v != 0.0f ? 1.0f : 0.0f;
        }
        Bs[j][q] = v;
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < KC; ++j) {
        float av[TM], bv[TN];
#pragma unroll
        for (int u = 0; u < TM; ++u) av[u] = As[j][ty + 16 * u];
#pragma unroll
        for (int v = 0; v < TN; ++v) bv[v] = Bs[j][tx + 16 * v];
#pragma unroll
        for (int u = 0; u < TM; ++u)
#pragma unroll
          for (int v = 0; v < TN; ++v)
            acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
      }
      __syncthreads();
    }
  }

  float* out = c + (long long)ct * bb;
  const float* mt = mblk ? mblk + (long long)ct * bb : nullptr;
#pragma unroll
  for (int u = 0; u < TM; ++u) {
    const int i = ty + 16 * u;
    if (i >= b) continue;
#pragma unroll
    for (int v = 0; v < TN; ++v) {
      const int q = tx + 16 * v;
      if (q >= b) continue;
      float o = acc[u][v];
      if (MODE == 1) o = o > 0.0f ? 1.0f : 0.0f;
      if (mt) {
        const float mv = mt[(long long)i * b + q];
        const bool keep = complement ? (mv == 0.0f) : (mv != 0.0f);
        if (!keep) o = 0.0f;
      }
      out[(long long)i * b + q] = o;
    }
  }
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// mblk (the (nc, b, b) mask tiles aligned to the output tiles) may be null.
extern "C" int bsr_spgemm(const void* ablk, const void* bblk, const void* mblk,
                          const void* a_sel, const void* b_sel,
                          const void* valid, const void* cptr, void* c,
                          int nc, int b, int mode, int complement,
                          void* stream) {
  if (nc == 0) return 0;
  if (b < 1 || b > BT || mode < 0 || mode > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* A = (const float*)ablk;
  const float* B = (const float*)bblk;
  const float* M = (const float*)mblk;
  const int32_t* as = (const int32_t*)a_sel;
  const int32_t* bs = (const int32_t*)b_sel;
  const int32_t* va = (const int32_t*)valid;
  const int32_t* cp = (const int32_t*)cptr;
  float* C = (float*)c;
#define LAUNCH(MD)                                                         \
  bsr_spgemm_kernel<MD><<<(unsigned)nc, THREADS, 0, s>>>(A, B, M, as, bs, \
                                                         va, cp, C, b,      \
                                                         complement)
  switch (mode) {
    case 0: LAUNCH(0); break;
    case 1: LAUNCH(1); break;
    case 2: LAUNCH(2); break;
    default: LAUNCH(3); break;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
