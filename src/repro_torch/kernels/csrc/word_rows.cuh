// Shared by the two packed-word kernels (ell_mxv_packed.cu and
// bitadj_mxv_packed.cu): a lane's share of a frontier row as one 16-byte
// vector (VEC = 4 words) or one word (VEC = 1), the warp operations on it,
// how lanes form row groups, and the pass that zeroes the output rows that
// the kernels then OR into.
//
// Words are 32-bit patterns; torch stores them as int32, read here as
// uint32_t.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace words {

constexpr unsigned FULL = 0xffffffffu;

template <int VEC> struct Vec;
template <> struct Vec<4> { using T = uint4; };
template <> struct Vec<1> { using T = uint32_t; };

__device__ __forceinline__ uint32_t zero_v(uint32_t) { return 0u; }
__device__ __forceinline__ uint4 zero_v(uint4) { return make_uint4(0, 0, 0, 0); }

__device__ __forceinline__ uint32_t or_v(uint32_t a, uint32_t b) { return a | b; }
__device__ __forceinline__ uint4 or_v(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}

// a frontier row's words through the read-only path: the frontier is
// gathered once per edge and should stay in L2
__device__ __forceinline__ void ldg_v(const uint32_t* p, uint32_t& v) { v = __ldg(p); }
__device__ __forceinline__ void ldg_v(const uint32_t* p, uint4& v) {
  v = __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint32_t shfl_v(uint32_t v, int src) {
  return __shfl_sync(FULL, v, src);
}
__device__ __forceinline__ uint4 shfl_v(uint4 v, int src) {
  return make_uint4(__shfl_sync(FULL, v.x, src), __shfl_sync(FULL, v.y, src),
                    __shfl_sync(FULL, v.z, src), __shfl_sync(FULL, v.w, src));
}
__device__ __forceinline__ uint32_t shfl_up_v(uint32_t v, int d) {
  return __shfl_up_sync(FULL, v, d);
}
__device__ __forceinline__ uint4 shfl_up_v(uint4 v, int d) {
  return make_uint4(__shfl_up_sync(FULL, v.x, d), __shfl_up_sync(FULL, v.y, d),
                    __shfl_up_sync(FULL, v.z, d), __shfl_up_sync(FULL, v.w, d));
}

__device__ __forceinline__ void store_v(uint32_t* p, uint32_t v) { *p = v; }
__device__ __forceinline__ void store_v(uint32_t* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// OR into memory another item also ORs into (global or shared); a zero
// word changes nothing and is skipped
__device__ __forceinline__ void atomic_or_v(uint32_t* p, uint32_t v) {
  if (v) atomicOr(p, v);
}
__device__ __forceinline__ void atomic_or_v(uint32_t* p, uint4 v) {
  atomic_or_v(p, v.x);
  atomic_or_v(p + 1, v.y);
  atomic_or_v(p + 2, v.z);
  atomic_or_v(p + 3, v.w);
}

// Lanes per row group: enough vectors to cover W words (VEC words each),
// rounded up to a power of two and capped at `cap` lanes; a wider row is
// cut into column slices of gs * VEC words (the grid's y dimension).
inline int group_lanes(int W, int vec, int cap) {
  const int need = (W + vec - 1) / vec;
  int gs = 1;
  while (gs < need && gs < cap) gs <<= 1;
  return gs;
}

__global__ void zero_rows_kernel(const int32_t* __restrict__ rows,
                                 long long nrows, uint32_t* __restrict__ y,
                                 int W) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nrows * W) return;
  const long long i = t / W;
  y[(long long)__ldg(rows + i) * W + (t - i * W)] = 0u;
}

// Zero the listed rows of y (n, W) on `stream`; 0 or the launch's error.
inline int zero_rows(const int32_t* rows, long long nrows, uint32_t* y, int W,
                     cudaStream_t stream) {
  const long long total = nrows * (long long)W;
  if (total == 0) return 0;
  const long long blocks = (total + 255) / 256;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  zero_rows_kernel<<<(unsigned)blocks, 256, 0, stream>>>(rows, nrows, y, W);
  return (int)cudaGetLastError();
}

}  // namespace words
