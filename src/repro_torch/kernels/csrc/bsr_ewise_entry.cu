// BSR element-wise numeric phase at the entry level: the same function as
// bsr_ewise.cu on the same host plan (per output tile t a selector into each
// operand, -1 = no tile), over the operands' stored entries, with the output
// as entries.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bsr_ewise.py (map_tiles
// -> _ewise_pallas -> pl.pallas_call, body _kernel), like the tile kernel;
// the wrapper picks one of the two by the operands' fill.
//
// Why: Graph500 R-MAT 128-tiles hold 10-30 entries, 0.1-0.2% of a tile, and
// the tile kernel streams two 64 KB tiles in and one out a tile. This
// kernel reads each operand's payload form (a per-tile CSR built on the
// device by the handle: a 64-bit base per tile, then the uint8 row and
// column and the fp32 value of each element whose bits are not +0.0, -0.0
// included, row-major inside the tile) and writes the results as entries.
//
// Output layout. The wrapper gives output tile t the slots ub_base[t] ..
// ub_base[t + 1], an upper bound of its results (A's entries plus B's under
// union, A's under the other modes: a result can only be nonzero where A or
// B holds an element), and zeroes the values. A candidate writes its row,
// column and result into the slot of its rank among the tile's candidates
// in row-major order; the wrapper's compaction keeps every slot whose value
// bits are not +0.0. So -0.0 results stay entries, with the bits the tile
// kernel writes, and a +0.0 result, as the tile kernel's zeros, is absent.
//
// Schedule. One warp, a thread block of its own, owns one output tile.
// Unary modes (apply, select), and binary modes whose B tile is absent,
// map A's entries lane by lane. Otherwise the warp builds bitmaps of the
// tile's b * b keys (row * b + column) in shared memory: B's, and under
// union A's. A per-word prefix of the bitmaps' popcounts (a warp scan)
// gives each key its rank: B's entry holding key k is number rank_B(k) of
// B's tile (the entries are sorted by key), so A's lanes find their B
// value in one load, with no search, and under union each candidate's
// slot is its rank in A | B. Each result is tile_fn of ewise_op.cuh on the
// values (an absent side reads +0.0), the tile kernel's arithmetic, so the
// results equal the tile kernel's bit for bit, NaN and +-inf included: the
// tile kernel writes +0.0 wherever neither side holds an element.
//
// What bounds it on an H100: bytes, at R-MAT fill far under the tile
// kernel's. It reads each present tile's entries once (6 bytes and its
// base) and writes up to the slots' 6 bytes; the bitmaps (2 KB a 128-tile)
// live in shared memory, cleared and scanned once a tile. No atomics on
// values, deterministic. Offsets are 64-bit.
#include <cstdint>
#include <cuda_runtime.h>

#include "ewise_op.cuh"

constexpr unsigned FULL = 0xffffffffu;

template <int MODE>
__global__ void __launch_bounds__(32)
bsr_ewise_entry_kernel(const long long* __restrict__ a_base,
                       const uint8_t* __restrict__ a_rows,
                       const uint8_t* __restrict__ a_cols,
                       const float* __restrict__ a_vals,
                       const long long* __restrict__ b_base,
                       const uint8_t* __restrict__ b_rows,
                       const uint8_t* __restrict__ b_cols,
                       const float* __restrict__ b_vals,
                       const int32_t* __restrict__ sel_a,
                       const int32_t* __restrict__ sel_b,
                       const long long* __restrict__ ub_base,
                       uint8_t* __restrict__ o_rows,
                       uint8_t* __restrict__ o_cols,
                       float* __restrict__ o_vals, int b, int op, float s) {
  constexpr bool UNARY = MODE == 2 || MODE == 3;
  constexpr bool UNION = MODE == 0;
  extern __shared__ uint32_t sm[];
  const int t = blockIdx.x, lane = threadIdx.x;
  const int sa = sel_a[t];
  const int sb = UNARY ? -1 : sel_b[t];
  long long a0 = 0, b0 = 0;
  int na = 0, nb = 0;
  if (sa >= 0) { a0 = a_base[sa]; na = (int)(a_base[sa + 1] - a0); }
  if (sb >= 0) { b0 = b_base[sb]; nb = (int)(b_base[sb + 1] - b0); }
  const long long o0 = ub_base[t];

  if (nb == 0) {              // B reads +0.0 everywhere: A's entries alone
    for (int e = lane; e < na; e += 32) {
      o_rows[o0 + e] = a_rows[a0 + e];
      o_cols[o0 + e] = a_cols[a0 + e];
      o_vals[o0 + e] = tile_fn<MODE>(a_vals[a0 + e], 0.0f, op, s);
    }
    return;
  }
  if (UNARY) return;          // (sb is -1 under the unary modes)

  const int W = (b * b + 31) >> 5;
  uint32_t* bits_b = sm;          // B's keys
  uint32_t* pre_b = sm + W;       // popcount of bits_b before each word
  uint32_t* bits_a = sm + 2 * W;  // A's keys (union)
  uint32_t* pre_u = sm + 3 * W;   // popcount of bits_a | bits_b before
  for (int w = lane; w < W; w += 32) {
    bits_b[w] = 0u;
    if (UNION) bits_a[w] = 0u;
  }
  __syncwarp();
  for (int e = lane; e < nb; e += 32) {
    const int k = b_rows[b0 + e] * b + b_cols[b0 + e];
    atomicOr(&bits_b[k >> 5], 1u << (k & 31));
  }
  if (UNION) {
    for (int e = lane; e < na; e += 32) {
      const int k = a_rows[a0 + e] * b + a_cols[a0 + e];
      atomicOr(&bits_a[k >> 5], 1u << (k & 31));
    }
  }
  __syncwarp();
  // each lane scans a run of words; a warp scan joins the runs
  const int per = (W + 31) / 32;
  const int w0 = min(lane * per, W), w1 = min(w0 + per, W);
  int cb = 0, cu = 0;
  for (int w = w0; w < w1; ++w) {
    cb += __popc(bits_b[w]);
    if (UNION) cu += __popc(bits_b[w] | bits_a[w]);
  }
  int ib = cb, iu = cu;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int yb = __shfl_up_sync(FULL, ib, d);
    const int yu = __shfl_up_sync(FULL, iu, d);
    if (lane >= d) { ib += yb; iu += yu; }
  }
  int xb = ib - cb, xu = iu - cu;
  for (int w = w0; w < w1; ++w) {
    pre_b[w] = xb;
    xb += __popc(bits_b[w]);
    if (UNION) {
      pre_u[w] = xu;
      xu += __popc(bits_b[w] | bits_a[w]);
    }
  }
  __syncwarp();

  for (int e = lane; e < na; e += 32) {
    const uint8_t r = a_rows[a0 + e], c = a_cols[a0 + e];
    const int k = r * b + c, wd = k >> 5;
    const uint32_t bit = 1u << (k & 31), below = bit - 1u;
    const uint32_t wb = bits_b[wd];
    const float bv =
        (wb & bit) ? b_vals[b0 + pre_b[wd] + __popc(wb & below)] : 0.0f;
    const long long o =
        o0 + (UNION ? pre_u[wd] + __popc((wb | bits_a[wd]) & below) : e);
    o_rows[o] = r;
    o_cols[o] = c;
    o_vals[o] = tile_fn<MODE>(a_vals[a0 + e], bv, op, s);
  }
  if (UNION) {                // B's keys that A does not hold
    for (int e = lane; e < nb; e += 32) {
      const uint8_t r = b_rows[b0 + e], c = b_cols[b0 + e];
      const int k = r * b + c, wd = k >> 5;
      const uint32_t bit = 1u << (k & 31), below = bit - 1u;
      if (bits_a[wd] & bit) continue;
      const long long o =
          o0 + pre_u[wd] + __popc((bits_b[wd] | bits_a[wd]) & below);
      o_rows[o] = r;
      o_cols[o] = c;
      o_vals[o] = tile_fn<MODE>(0.0f, b_vals[b0 + e], op, s);
    }
  }
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched). The B
// arrays and sel_b may be null for the unary modes (apply, select). o_vals
// must hold +0.0 in every slot.
extern "C" int bsr_ewise_entry(
    const void* a_base, const void* a_rows, const void* a_cols,
    const void* a_vals, const void* b_base, const void* b_rows,
    const void* b_cols, const void* b_vals, const void* sel_a,
    const void* sel_b, const void* ub_base, void* o_rows, void* o_cols,
    void* o_vals, int nt, int b, int mode, int op, float scalar,
    void* stream) {
  if (nt == 0) return 0;
  const bool unary = mode == 2 || mode == 3;
  if (b < 1 || b > 256 || mode < 0 || mode > 5 || op < 0 || op > 19 ||
      (!unary && (sel_b == nullptr || b_base == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t W = ((size_t)b * b + 31) / 32;
  const size_t shm = unary ? 0 : 4 * W * sizeof(uint32_t);
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(MD)                                                          \
  bsr_ewise_entry_kernel<MD><<<(unsigned)nt, 32, shm, st>>>(                \
      (const long long*)a_base, (const uint8_t*)a_rows,                     \
      (const uint8_t*)a_cols, (const float*)a_vals,                         \
      (const long long*)b_base, (const uint8_t*)b_rows,                     \
      (const uint8_t*)b_cols, (const float*)b_vals, (const int32_t*)sel_a, \
      (const int32_t*)sel_b, (const long long*)ub_base, (uint8_t*)o_rows,   \
      (uint8_t*)o_cols, (float*)o_vals, b, op, scalar)
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
