// Block-sparse semiring matmul at the entry level:  Y = A (x) X  [<M>/<!M>],
// the same function as bsr_mxm.cu, over the handle's stored entries.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bsr_mxm.py (bsr_mxm ->
// pl.pallas_call, body _kernel), like the tile kernel; the wrapper picks one
// of the two by the handle's fill.
//
// Why: a Graph500 R-MAT 128-tile holds about 10 entries in some 6 of its 128
// rows (scale 16: 955,494 entries in 93,690 tiles), so the tile kernel's
// nnzb * b * b * F multiply-adds (1.57e12 at F = 512) are over 99.9% products
// by zero. This kernel reads the handle's row CSR (built on the device by the
// wrapper: a 64-bit row pointer, then the int32 global column and fp32 value
// of each stored entry, every row in ascending column order, emask'd zeros
// kept) and gathers one frontier row per entry.
//
// Schedule. One warp owns one (row, slice of 32 * VEC frontier columns):
// each lane keeps VEC fp32 accumulators (VEC = 4: one float4, so a warp's
// gather of a frontier row slice is one 512-byte run of 16-byte loads). The
// warp reads 32 entries of its row at once (one coalesced load of columns and
// values, the next 32 in flight meanwhile), then walks them in order, U
// entries at a time: the U gathers are issued together, then folded in
// order. Rows are visited longest first (``order``, the wrapper's sort of
// row lengths). R-MAT rows are skewed (scale 16: 132 rows of over 1,000
// entries, the longest 6,270, against a mean near 15): a warp walks its row
// as a chain of memory waits, one a U entries, and the longest chain is the
// kernel's least time. A hub row never holds up another row, since a warp
// owns one row; and the rows whose chain would outlast the mean work of a
// warp the card holds (the wrapper's ``nlong`` threshold) are cut into
// 32-column slices, a warp each with 16 gathers in flight a lane, so their
// chains are half as long per entry and four times as many warps share
// them. Where every row is long (a hop matrix), none is cut: parallelism
// is not short there, and the wide slices move more bytes a load. A long row is not split over warps along
// its entries, because a sum split that way would round differently: only
// along F, which leaves every output element's summation order alone.
//
// Every output element folds its terms in ascending column order, the tile
// kernel's (tile, column) order, with the tile kernel's operations (fmaf on
// the same operand transforms; fminf / fmaxf of a + x), skipping only the
// entries A does not store. Those add fmaf(0, x, acc) == acc for finite x in
// the dot modes and nothing in bcast (inf + x, or NaN, never wins a
// fminf / fmaxf), so the result equals the tile kernel's bit for bit, and
// the plain versions' wherever their sums are exact. A dot product over a
// non-finite X is sent to the tile kernel by the wrapper (0 * inf = NaN).
// No atomics, deterministic.
//
// Modes (the semiring's `mode`), fp32 on the CUDA cores:
//   0 dot            acc = fmaf(a, x, acc)
//   1 dot_indicator  acc = fmaf(a != 0, x != 0, acc), then y = acc > 0
//   2 dot_pair       acc = fmaf(a != 0, x != 0, acc)
//   3 dot_first      acc = fmaf(a, x != 0, acc)
//   4 bcast, min     acc = fminf(acc, a + x), from +inf
//   5 bcast, max     acc = fmaxf(acc, a + x), from -inf
// The mask epilogue keeps acc where the mask is nonzero (zero under
// complement) and writes the semiring identity elsewhere; a warp whose whole
// slice is masked out skips its row's gathers.
//
// What bounds it on an H100: bytes. The data needs the CSR (8 bytes an entry
// and a row pointer), the frontier, the mask and the output once (scale 16,
// F = 512: about 0.4 GB, 0.12 ms at 3.35 TB/s) and 2 * E * F fp32 operations
// (1e9, 15 us at the fp32 peak); what the kernel moves is one 4F-byte frontier
// row a stored entry (2 GB at scale 16), from L2 when the frontier fits its
// 50 MB and from device memory when it does not.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

constexpr int THREADS = 128;   // 4 warps a block, one (row, slice) each
constexpr int MIN_BLOCKS = 6;  // blocks an SM holds: at most 85 registers
constexpr int U = 8;           // gathers in flight per lane
constexpr int LONG_U = 16;     // the same on a long row (32-column slices)
constexpr unsigned FULL = 0xffffffffu;

template <int MODE>
__device__ __forceinline__ float identity() {
  if (MODE == 4) return CUDART_INF_F;
  if (MODE == 5) return -CUDART_INF_F;
  return 0.0f;
}

// the entry value as the tile kernel stages it
template <int MODE>
__device__ __forceinline__ float stage_a(float a) {
  if (MODE == 1 || MODE == 2) return a != 0.0f ? 1.0f : 0.0f;
  return a;
}

template <int MODE>
__device__ __forceinline__ float fold(float acc, float a, float x) {
  if (MODE == 4) return fminf(acc, a + x);
  if (MODE == 5) return fmaxf(acc, a + x);
  if (MODE >= 1) x = x != 0.0f ? 1.0f : 0.0f;
  return fmaf(a, x, acc);
}

template <int VEC> struct Vec;
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store(float* p, T v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  static __device__ __forceinline__ float get(const T& v, int k) {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
  }
  static __device__ __forceinline__ void set(T& v, int k, float f) {
    if (k == 0) v.x = f; else if (k == 1) v.y = f;
    else if (k == 2) v.z = f; else v.w = f;
  }
};
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void store(float* p, T v) { *p = v; }
  static __device__ __forceinline__ float get(const T& v, int) { return v; }
  static __device__ __forceinline__ void set(T& v, int, float f) { v = f; }
};

// One warp's (row i, columns f .. f + VEC - 1 of each lane) of Y: UU
// gathers in flight a lane; with PF the next 32 entries' columns and values
// are loaded while the current ones are gathered.
template <int MODE, int VEC, int UU, bool PF>
__device__ __forceinline__ void warp_row(
    const long long* __restrict__ indptr, const int32_t* __restrict__ cols,
    const float* __restrict__ vals, const float* __restrict__ x,
    const float* __restrict__ mask, float* __restrict__ y, long long i,
    int f, int F, int complement) {
  using V = Vec<VEC>;
  const int lane = threadIdx.x % 32;
  const bool on = f < F;                 // VEC = 4 only when F % 4 == 0
  const float ident = identity<MODE>();
  const long long out = i * F + f;

  float acc[VEC];
  bool keep[VEC];
  bool any = false;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    acc[k] = ident;
    keep[k] = true;
  }
  if (mask) {
    if (on) {
      const typename V::T mv = V::load(mask + out);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float m = V::get(mv, k);
        keep[k] = complement ? (m == 0.0f) : (m != 0.0f);
        any |= keep[k];
      }
    }
  } else {
    any = on;
  }

  if (__any_sync(FULL, any)) {
    const long long e0 = indptr[i], e1 = indptr[i + 1];
    int c = 0;
    float a = 0.0f;
    if (e0 + lane < e1) {
      c = cols[e0 + lane];
      a = stage_a<MODE>(vals[e0 + lane]);
    }
    for (long long eb = e0; eb < e1; eb += 32) {
      int cn = 0;                        // the next 32 entries, in flight
      float an = 0.0f;
      if (PF && eb + 32 + lane < e1) {
        cn = cols[eb + 32 + lane];
        an = stage_a<MODE>(vals[eb + 32 + lane]);
      }
      const int cnt = (int)min(32LL, e1 - eb);   // the same in every lane
      for (int q = 0; q < cnt; q += UU) {
        typename V::T xv[UU];
#pragma unroll
        for (int u = 0; u < UU; ++u) {
          const int cc = __shfl_sync(FULL, c, (q + u) & 31);
          if (q + u < cnt && on) xv[u] = V::load(x + (long long)cc * F + f);
        }
#pragma unroll
        for (int u = 0; u < UU; ++u) {
          const float av = __shfl_sync(FULL, a, (q + u) & 31);
          if (q + u < cnt && on) {
#pragma unroll
            for (int k = 0; k < VEC; ++k)
              acc[k] = fold<MODE>(acc[k], av, V::get(xv[u], k));
          }
        }
      }
      if (PF) {
        c = cn;
        a = an;
      } else if (eb + 32 + lane < e1) {
        c = cols[eb + 32 + lane];
        a = stage_a<MODE>(vals[eb + 32 + lane]);
      }
    }
  }

  if (!on) return;
  typename V::T o;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    float r = acc[k];
    if (MODE == 1) r = r > 0.0f ? 1.0f : 0.0f;
    if (!keep[k]) r = ident;
    V::set(o, k, r);
  }
  V::store(y + out, o);
}

// Warps 0 .. nlong * sl - 1 take the long rows (the first nlong of
// ``order``), a 32-column slice each with LONG_U gathers in flight and the
// next entries' indices prefetched; the rest take the other rows, a
// 32 * VEC-column slice each with U in flight. (Measured on the H100 at the
// path's shapes, against 256-thread blocks, 32 or 8 gathers in flight on
// long rows, the prefetch on short rows and 64 registers with spills: this
// shape was the fastest or within noise of it on each.)
template <int MODE, int VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
bsr_mxm_entry_kernel(const long long* __restrict__ indptr,
                     const int32_t* __restrict__ cols,
                     const float* __restrict__ vals,
                     const int32_t* __restrict__ order,
                     const float* __restrict__ x,
                     const float* __restrict__ mask, float* __restrict__ y,
                     long long n, long long nlong, int F, int sl, int ss,
                     int complement) {
  const long long w =
      ((long long)blockIdx.x * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  const long long wl = nlong * sl;       // warps of the long rows
  if (w < wl) {
    warp_row<MODE, 1, LONG_U, true>(indptr, cols, vals, x, mask, y,
                              order[w / sl], (int)(w % sl) * 32 + lane, F,
                              complement);
    return;
  }
  const long long ws = w - wl;
  if (ws >= (n - nlong) * ss) return;    // whole warps leave together
  warp_row<MODE, VEC, U, false>(indptr, cols, vals, x, mask, y,
                         order[nlong + ws / ss],
                         (int)(ws % ss) * 32 * VEC + lane * VEC, F,
                         complement);
}

template <int MODE>
static void launch(unsigned blocks, cudaStream_t s, int vec,
                   const long long* ip, const int32_t* c, const float* v,
                   const int32_t* ord, const float* X, const float* M,
                   float* Y, long long n, long long nlong, int F, int sl,
                   int ss, int comp) {
  if (vec == 4)
    bsr_mxm_entry_kernel<MODE, 4><<<blocks, THREADS, 0, s>>>(
        ip, c, v, ord, X, M, Y, n, nlong, F, sl, ss, comp);
  else
    bsr_mxm_entry_kernel<MODE, 1><<<blocks, THREADS, 0, s>>>(
        ip, c, v, ord, X, M, Y, n, nlong, F, sl, ss, comp);
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched). mask may
// be null. vec is 4 (F % 4 == 0, x / mask / y 16-byte aligned) or 1; the
// first nlong rows of ``order`` are the long ones.
extern "C" int bsr_mxm_entry(const void* indptr, const void* cols,
                             const void* vals, const void* order,
                             const void* x, const void* mask, void* y,
                             long long n, long long nlong, int F, int mode,
                             int complement, int vec, void* stream) {
  if (n == 0 || F == 0) return 0;
  if (mode < 0 || mode > 5 || (vec != 1 && vec != 4) ||
      (vec == 4 && F % 4 != 0) || nlong < 0 || nlong > n)
    return (int)cudaErrorInvalidValue;
  const int sl = (F + 31) / 32;
  const int ss = (F + 32 * vec - 1) / (32 * vec);
  const long long warps = nlong * sl + (n - nlong) * ss;
  const long long blocks = (warps * 32 + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  const long long* ip = (const long long*)indptr;
  const int32_t* c = (const int32_t*)cols;
  const float* v = (const float*)vals;
  const int32_t* ord = (const int32_t*)order;
  const float* X = (const float*)x;
  const float* M = (const float*)mask;
  float* Y = (float*)y;
  const unsigned b = (unsigned)blocks;
#define LAUNCH(MD) launch<MD>(b, s, vec, ip, c, v, ord, X, M, Y, n, nlong, F, \
                              sl, ss, complement)
  switch (mode) {
    case 0: LAUNCH(0); break;
    case 1: LAUNCH(1); break;
    case 2: LAUNCH(2); break;
    case 3: LAUNCH(3); break;
    case 4: LAUNCH(4); break;
    default: LAUNCH(5);
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
