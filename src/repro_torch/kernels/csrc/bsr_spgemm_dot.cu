// Masked dot-product SpGEMM (GraphBLAS's "dot3" method): C<M> = A (x) B
// under a structural, not complemented, mask M, computed per stored entry
// (i, j) of M as the dot product of A's row i and B's column j, both held
// as sorted row CSRs (B's columns are the rows of its transpose). C is
// written as one value per mask entry, in the mask's entry order; nothing
// is written outside the mask, and no (b x b) tile is ever made.
//
// Why: the tile route (bsr_spgemm_entry.cu) fills a dense (nc, b, b)
// output stack and plans one task per pair of tiles. At the Graph
// Challenge's graph500-scale18-ef16 the mask's 7.6 M entries lie in 3.06 M
// 128-tiles (2.5 entries a tile), so that stack alone is 199 GB; the
// answer needs the 7.6 M values.
//
// Work. Entry (i, j) intersects two sorted lists of lengths la = |A(i,:)|
// and lb = |B(:,j)|: the shorter list is walked, and each of its columns k
// is looked up in the longer one by a binary search, so an entry costs
// min(la, lb) lookups of log2(max(la, lb)) loads each. Over the mask of a
// power-law graph that minimum spreads from 1 to the hub's degree (25,231
// at scale 18; its sum is 2.1e9 there, 1.25e8 at scale 15), so the wrapper
// cuts the work into units: one warp owns one unit, up to CHUNK (128)
// elements of one entry's shorter list, 32 lanes at a time, each lane one
// lookup (its loads in flight beside the other lanes'). Each next round of
// 32 searches from where the last lane of the round before stopped, since
// the walked columns ascend. Four warps make a thread block, so an SM
// holds up to 64 warps of lookups in flight.
//
// Modes (dot modes only), fp32, and how a unit's result reaches C:
//   0 dot            c = fmaf(a, b, c) over the matches in ascending k
//   1 dot_indicator  c = 1 if any match
//   2 dot_pair       c = the number of matches
//   3 dot_first      c = fmaf(a, 1, c) over the matches in ascending k
// The valued modes (0, 3) keep an entry on one warp (one unit whatever its
// length), which folds its matches in ascending k order with fmaf: the
// order in which the tile route sums an output element over its tasks and
// their k, so the value equals the tile route's bit for bit for finite
// inputs (the wrapper sends non-finite values to the tile route). The 0/1
// modes split a long entry over units: each adds its count with one
// atomicAdd (exact: counts are integers below 2^24, as in the tile route's
// fp32 accumulators) or stores 1. C starts at +0.0, written by the
// wrapper.
//
// What bounds it on an H100: neither peak. The data's bytes are the two
// CSRs and the mask once (94 MB at scale 18, 28 us at 3.35 TB/s); what a
// lookup waits on is the chain of dependent loads (unit -> entry -> row
// bounds -> walked column -> log2 steps of the search), mostly L2 hits
// once a hub's list is hot. Offsets into the entry arrays are 64-bit.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int WARPS = 4;              // units (warps) per thread block
constexpr int CHUNK = 128;            // walked elements per unit (0/1 modes)
constexpr unsigned FULL = 0xffffffffu;

// first position in cols[lo, hi) holding x or more (hi if none)
__device__ __forceinline__ long long lower_bound(const int32_t* cols,
                                                 long long lo, long long hi,
                                                 int x) {
  long long len = hi - lo;
  while (len > 0) {
    const long long half = len >> 1;
    if (cols[lo + half] < x) {
      lo += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  return lo;
}

template <int MODE>
__global__ void __launch_bounds__(32 * WARPS)
bsr_spgemm_dot_kernel(const long long* __restrict__ a_ptr,
                      const int32_t* __restrict__ a_cols,
                      const float* __restrict__ a_vals,
                      const long long* __restrict__ b_ptr,
                      const int32_t* __restrict__ b_cols,
                      const float* __restrict__ b_vals,
                      const int32_t* __restrict__ m_rows,
                      const int32_t* __restrict__ m_cols,
                      const int32_t* __restrict__ unit_entry,
                      const int32_t* __restrict__ unit_chunk,
                      long long units, float* __restrict__ c) {
  constexpr bool VALUED = MODE == 0 || MODE == 3;
  const long long u = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (u >= units) return;             // whole warps only: u is warp-uniform
  const int lane = threadIdx.x % 32;
  const int e = unit_entry[u];
  const int i = m_rows[e], j = m_cols[e];
  const long long a0 = a_ptr[i], a1 = a_ptr[i + 1];
  const long long b0 = b_ptr[j], b1 = b_ptr[j + 1];
  // walk the shorter list (A's row on a tie), search the longer
  const bool walk_a = a1 - a0 <= b1 - b0;
  const int32_t* wcols = walk_a ? a_cols : b_cols;
  const int32_t* scols = walk_a ? b_cols : a_cols;
  const long long w0 = walk_a ? a0 : b0;
  const long long wn = walk_a ? a1 - a0 : b1 - b0;
  long long lo = walk_a ? b0 : a0;
  const long long hi = walk_a ? b1 : a1;
  long long p0 = 0, p1 = wn;
  if (!VALUED) {
    p0 = (long long)unit_chunk[u] * CHUNK;
    p1 = p0 + CHUNK < wn ? p0 + CHUNK : wn;
  }
  float acc = 0.f;
  int count = 0;
  for (long long p = p0; p < p1; p += 32) {
    const long long q = p + lane;
    long long pos = hi;
    bool hit = false;
    if (q < p1) {
      const int x = wcols[w0 + q];
      pos = lower_bound(scols, lo, hi, x);
      hit = pos < hi && scols[pos] == x;
    }
    const unsigned bits = __ballot_sync(FULL, hit);
    if (VALUED) {
      float av = 0.f, bv = 0.f;
      if (hit) {
        av = a_vals[walk_a ? w0 + q : pos];
        if (MODE == 0) bv = b_vals[walk_a ? pos : w0 + q];
      }
      unsigned todo = bits;
      while (todo) {                  // the matches in ascending k
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const float x = __shfl_sync(FULL, av, src);
        const float y = MODE == 0 ? __shfl_sync(FULL, bv, src) : 1.0f;
        acc = fmaf(x, y, acc);
      }
    } else {
      count += __popc(bits);
      if (MODE == 1 && count) break;
    }
    // the next round's columns lie past every column of this one
    const int last = (int)(p1 - p < 32 ? p1 - p - 1 : 31);
    lo = __shfl_sync(FULL, pos, last);
  }
  if (lane != 0) return;
  if (VALUED) {
    c[e] = acc;
  } else if (count) {
    if (MODE == 2) atomicAdd(c + e, (float)count);
    else c[e] = 1.0f;
  }
}

// Launches on `stream`; returns a cudaError_t (0 = launched). The A and B^T
// row CSRs may be the same arrays. c holds one float per mask entry, zeroed
// by the caller; units come from the wrapper (one per entry in the valued
// modes, one per CHUNK walked elements in the 0/1 modes).
extern "C" int bsr_spgemm_dot(const void* a_ptr, const void* a_cols,
                              const void* a_vals, const void* b_ptr,
                              const void* b_cols, const void* b_vals,
                              const void* m_rows, const void* m_cols,
                              const void* unit_entry, const void* unit_chunk,
                              long long units, void* c, int mode,
                              void* stream) {
  if (units == 0) return 0;
  if (units < 0 || mode < 0 || mode > 3) return (int)cudaErrorInvalidValue;
  const long long blocks = (units + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(MD)                                                          \
  bsr_spgemm_dot_kernel<MD><<<(unsigned)blocks, 32 * WARPS, 0, s>>>(        \
      (const long long*)a_ptr, (const int32_t*)a_cols,                      \
      (const float*)a_vals, (const long long*)b_ptr,                        \
      (const int32_t*)b_cols, (const float*)b_vals,                         \
      (const int32_t*)m_rows, (const int32_t*)m_cols,                       \
      (const int32_t*)unit_entry, (const int32_t*)unit_chunk, units,        \
      (float*)c)
  switch (mode) {
    case 0: LAUNCH(0); break;
    case 1: LAUNCH(1); break;
    case 2: LAUNCH(2); break;
    default: LAUNCH(3); break;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
