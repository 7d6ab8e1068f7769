// BSR element-wise numeric phase: one output tile per planned slot t,
//   out[t] = mode(A[sel_a[t]], B[sel_b[t]])   (selector -1: the zero tile)
//
// Replaces the Pallas TPU kernel src/repro/kernels/bsr_ewise.py (map_tiles ->
// _ewise_pallas -> pl.pallas_call, body _kernel). The TPU grid runs one
// program per output tile and DMAs both operand tiles by scalar-prefetched
// selectors, multiplying each by a presence flag. Output tiles are
// independent (no accumulation across slots), so here a tile is cut into
// gridDim.y chunks and each block streams one chunk: 16-byte float4 loads
// and stores with neighbouring threads on neighbouring addresses, no shared
// memory. A side whose selector is -1 is not loaded at all; it reads as 0.
//
// Modes (template parameter) and ops: ewise_op.cuh, shared with the entry
// kernel (bsr_ewise_entry.cu), which the wrapper takes for sparse tiles.
//
// What bounds it on an H100: bytes. Each output tile reads at most two
// input tiles and writes one, a handful of operations per 4-byte entry, far
// below the card's rate; at b = 128 a tile is 64 KB. TMA bulk copies and
// skipping all-zero sub-tiles are later work.
//
// Offsets are 64-bit: T x b^2 passes 2^31 at Graph500 scale 15.
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "ewise_op.cuh"

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;   // vectors per thread per chunk

template <int MODE> struct Unary { static constexpr bool value = false; };
template <> struct Unary<2> { static constexpr bool value = true; };
template <> struct Unary<3> { static constexpr bool value = true; };

// VEC = 4 streams float4 (every tile base 16-byte aligned, b^2 % 4 == 0);
// VEC = 1 is the scalar path for any other shape.
template <int MODE, int VEC>
__global__ void __launch_bounds__(THREADS)
bsr_ewise_kernel(const float* __restrict__ ablk,
                 const float* __restrict__ bblk,
                 const int32_t* __restrict__ sel_a,
                 const int32_t* __restrict__ sel_b, float* __restrict__ out,
                 long long tile, int op, float s) {
  using V = typename std::conditional<VEC == 4, float4, float>::type;
  const long long t = blockIdx.x;
  const int sa = sel_a[t];
  const int sb = Unary<MODE>::value ? -1 : sel_b[t];
  const V* at = sa >= 0 ? reinterpret_cast<const V*>(ablk + sa * tile)
                        : nullptr;
  const V* bt = sb >= 0 ? reinterpret_cast<const V*>(bblk + sb * tile)
                        : nullptr;
  V* ot = reinterpret_cast<V*>(out + t * tile);
  const long long nv = tile / VEC;
  const long long stride = (long long)THREADS * gridDim.y;
  for (long long i = (long long)blockIdx.y * THREADS + threadIdx.x; i < nv;
       i += stride) {
    V a, b, o;
    if constexpr (VEC == 4) {
      a = at ? at[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      b = bt ? bt[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      o.x = tile_fn<MODE>(a.x, b.x, op, s);
      o.y = tile_fn<MODE>(a.y, b.y, op, s);
      o.z = tile_fn<MODE>(a.z, b.z, op, s);
      o.w = tile_fn<MODE>(a.w, b.w, op, s);
    } else {
      a = at ? at[i] : 0.0f;
      b = bt ? bt[i] : 0.0f;
      o = tile_fn<MODE>(a, b, op, s);
    }
    ot[i] = o;
  }
}

template <int MODE>
static void launch(dim3 grid, cudaStream_t st, int vec, const float* A,
                   const float* B, const int32_t* sa, const int32_t* sb,
                   float* out, long long tile, int op, float s) {
  if (vec == 4)
    bsr_ewise_kernel<MODE, 4><<<grid, THREADS, 0, st>>>(A, B, sa, sb, out,
                                                        tile, op, s);
  else
    bsr_ewise_kernel<MODE, 1><<<grid, THREADS, 0, st>>>(A, B, sa, sb, out,
                                                        tile, op, s);
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched). bblk and
// sel_b may be null for the unary modes (apply, select). vec is 4 or 1.
extern "C" int bsr_ewise(const void* ablk, const void* bblk, const void* sel_a,
                         const void* sel_b, void* out, int nt, int b,
                         int mode, int op, float scalar, int vec,
                         void* stream) {
  if (nt == 0) return 0;
  const long long tile = (long long)b * b;
  if (b < 1 || mode < 0 || mode > 5 || op < 0 || op > 19 ||
      (vec != 1 && vec != 4) || (vec == 4 && tile % 4 != 0) ||
      (mode != 2 && mode != 3 && sel_b == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long nv = tile / vec;
  const long long per_block = (long long)THREADS * PER_THREAD;
  long long chunks = (nv + per_block - 1) / per_block;
  if (chunks > 65535) chunks = 65535;
  dim3 grid((unsigned)nt, (unsigned)chunks);
  cudaStream_t st = (cudaStream_t)stream;
  const float* A = (const float*)ablk;
  const float* B = (const float*)bblk;
  const int32_t* sa = (const int32_t*)sel_a;
  const int32_t* sb = (const int32_t*)sel_b;
  float* O = (float*)out;
  switch (mode) {
    case 0: launch<0>(grid, st, vec, A, B, sa, sb, O, tile, op, scalar); break;
    case 1: launch<1>(grid, st, vec, A, B, sa, sb, O, tile, op, scalar); break;
    case 2: launch<2>(grid, st, vec, A, B, sa, sb, O, tile, op, scalar); break;
    case 3: launch<3>(grid, st, vec, A, B, sa, sb, O, tile, op, scalar); break;
    case 4: launch<4>(grid, st, vec, A, B, sa, sb, O, tile, op, scalar); break;
    default: launch<5>(grid, st, vec, A, B, sa, sb, O, tile, op, scalar);
  }
  return (int)cudaGetLastError();
}
