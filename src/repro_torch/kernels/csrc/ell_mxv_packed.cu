// Packed or_and gather-OR over ELL rows:  Yw[i] = OR over the ids j of row
// i of Xw[j].
//
// Replaces the Pallas TPU kernel src/repro/kernels/bitmap_mxv.py,
// function ell_mxv_packed (pl.pallas_call, body _kernel): there a grid
// step ORs the frontier rows that a tile of 8 padded ELL rows names,
// every padded slot included (an invalid slot gathers an appended zero
// row). Here the structure is read as a CSR of the valid ids only
// (ELL.row_csr) with a work plan (ELL.item_plan); no padded slot is read.
//
// What bounds it on an H100. From device memory: the ids and their
// per-id row words (8 bytes an edge), the rows to zero and the n*W*4-byte
// output: about 12 MB for the scale-16 Graph500 transpose handle (955,494
// ids, 65,536 rows, W = 16), 4 us at 3.35 TB/s. From L2: one W*4-byte
// frontier row per edge, 61 MB at W = 16, against a 4.2 MB frontier that
// L2 (50 MB) holds. The edges' skew is what used to bound it: the hub row
// (6,270 ids) was a chain of 784 dependent rounds of 8 gathers walked by
// one half-warp.
//
// Design: edge-balanced work. Item i is the ids [i*L, (i+1)*L) of the CSR
// (L = 128 on the path: 7,465 items), one warp each, whatever rows they belong to: a
// hub row is cut over many items and many short rows share one. The warp
// splits into row groups of GS lanes; a lane loads 16 bytes (uint4) of a
// frontier row where W is a multiple of 4 (a scalar path serves any other
// W), so at W = 16 a group of 4 lanes gathers one row and the warp's 8
// groups gather 8. Each lane issues 4 steps' gathers before it uses one,
// so a warp keeps 32 frontier rows in flight, and the next ids load
// (streaming, __ldcs) while they are. After each step the groups' words
// are OR-combined across the groups that share a row (a segmented scan by
// shuffles; the row's last group carries its words into the next step).
// A group that holds the last id of its row stores the row, unless an
// item boundary cut the row: then it ORs it into y with atomicOr, and the
// wrapper's plan lists such rows (and the empty rows, which no item
// reaches) to be zeroed first. OR is associative, commutative and
// idempotent, so any split of a row's ids, and any order of the atomics,
// gives the same words: the result is bit-identical to the plain version.
// Offsets are 64-bit.
#include "word_rows.cuh"

using namespace words;

constexpr uint32_t ROW_MASK = (1u << 30) - 1;   // ELL.ROW_BITS
constexpr uint32_t FIRST_EDGE = 1u << 30;
constexpr uint32_t LAST_EDGE = 1u << 31;
constexpr int WARPS = 8;                        // warps per block
constexpr int STEPS = 4;                        // gathers in flight a lane

template <int VEC, int GS>
__global__ void __launch_bounds__(WARPS * 32)
ell_items_kernel(const int32_t* __restrict__ ids,
                 const uint32_t* __restrict__ erow,
                 const uint32_t* __restrict__ xw, uint32_t* __restrict__ y,
                 long long nnz, long long L, long long n_items, int W) {
  using V = typename Vec<VEC>::T;
  constexpr int G = 32 / GS;                    // row groups per warp
  constexpr int BATCH = STEPS * G;              // ids a batch gathers
  constexpr int CH = BATCH > 32 ? BATCH : 32;   // ids a buffer holds
  constexpr int NC = CH / 32;                   // of them, per lane
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (item >= n_items) return;                  // whole warps only
  const int g = lane / GS, q = lane % GS;
  const int w = blockIdx.y * GS * VEC + q * VEC;   // this lane's first word
  const bool on = w < W;           // VEC = 4: W % 4 == 0, so all 4 are in
  const uint32_t* xq = xw + w;
  uint32_t* yq = y + w;
  const long long e0 = item * L;
  const long long e1 = min(e0 + L, nnz);
  // the item's first row was cut by the boundary before it
  const uint32_t f0 = __ldg(erow + e0);
  const uint32_t start_row = f0 & ROW_MASK;
  const bool start_cut = !(f0 & FIRST_EDGE);

  int32_t idb[NC];
  uint32_t flb[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const long long p = e0 + c * 32 + lane;
    idb[c] = p < e1 ? __ldcs(ids + p) : 0;
    flb[c] = p < e1 ? __ldcs(erow + p) : 0u;
  }
  V carry = zero_v(V());
  bool has_carry = false;
  for (long long base = e0; base < e1; base += CH) {
    int32_t idn[NC];
    uint32_t fln[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {               // the next buffer, early
      const long long p = base + CH + c * 32 + lane;
      idn[c] = p < e1 ? __ldcs(ids + p) : 0;
      fln[c] = p < e1 ? __ldcs(erow + p) : 0u;
    }
#pragma unroll
    for (int b = 0; b < CH / BATCH; ++b) {
      if (base + b * BATCH >= e1) break;        // warp-uniform
      V v[STEPS];
      uint32_t fl[STEPS];
      bool val[STEPS];
#pragma unroll
      for (int u = 0; u < STEPS; ++u) {         // issue every gather first
        const int pos = b * BATCH + u * G + g;
        const int c = (u * G) >> 5;             // buffer chunk of pos
        const int32_t j = __shfl_sync(FULL, idb[c], pos & 31);
        fl[u] = __shfl_sync(FULL, flb[c], pos & 31);
        val[u] = base + pos < e1;
        v[u] = zero_v(V());
        if (val[u] && on) ldg_v(xq + (long long)j * W, v[u]);
      }
#pragma unroll
      for (int u = 0; u < STEPS; ++u) {
        const long long e = base + b * BATCH + u * G + g;
        const uint32_t row = val[u] ? (fl[u] & ROW_MASK) : 0xffffffffu;
        V x = v[u];
        if (g == 0 && has_carry) x = or_v(x, carry);
#pragma unroll
        for (int d = 1; d < G; d <<= 1) {       // segmented OR-scan
          const V px = shfl_up_v(x, d * GS);
          const uint32_t pr = __shfl_up_sync(FULL, row, d * GS);
          if (g >= d && pr == row) x = or_v(x, px);
        }
        const bool closes = (fl[u] & LAST_EDGE) != 0;
        if (val[u] && on && (closes || e == e1 - 1)) {
          uint32_t* yr = yq + (long long)row * W;
          if (closes && !(start_cut && row == start_row)) store_v(yr, x);
          else atomic_or_v(yr, x);              // cut by an item boundary
        }
        // the last group's row goes on into the next step
        const int tail = (G - 1) * GS;
        carry = shfl_v(x, tail + q);
        has_carry = __shfl_sync(FULL, (int)(val[u] && !closes && e < e1 - 1),
                                tail) != 0;
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      idb[c] = idn[c];
      flb[c] = fln[c];
    }
  }
}

template <int VEC, int GS>
static void launch(const void* ids, const void* erow, const void* xw, void* y,
                   long long nnz, long long L, long long n_items, int W,
                   unsigned slices, cudaStream_t stream) {
  const dim3 grid((unsigned)((n_items + WARPS - 1) / WARPS), slices);
  ell_items_kernel<VEC, GS><<<grid, WARPS * 32, 0, stream>>>(
      (const int32_t*)ids, (const uint32_t*)erow, (const uint32_t*)xw,
      (uint32_t*)y, nnz, L, n_items, W);
}

template <int VEC>
static int launch_vec(int gs, const void* ids, const void* erow,
                      const void* xw, void* y, long long nnz, long long L,
                      long long n_items, int W, unsigned slices,
                      cudaStream_t stream) {
  switch (gs) {
    case 1: launch<VEC, 1>(ids, erow, xw, y, nnz, L, n_items, W, slices, stream); break;
    case 2: launch<VEC, 2>(ids, erow, xw, y, nnz, L, n_items, W, slices, stream); break;
    case 4: launch<VEC, 4>(ids, erow, xw, y, nnz, L, n_items, W, slices, stream); break;
    case 8: launch<VEC, 8>(ids, erow, xw, y, nnz, L, n_items, W, slices, stream); break;
    case 16: launch<VEC, 16>(ids, erow, xw, y, nnz, L, n_items, W, slices, stream); break;
    case 32: launch<VEC, 32>(ids, erow, xw, y, nnz, L, n_items, W, slices, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// y (n, W) from the CSR ids (nnz) and the plan's per-id row words (nnz),
// items of L ids; the plan's zero rows (zrows, n_zero) are zeroed first.
// vec != 0 takes 16-byte vectors (W % 4 == 0 and 16-byte aligned xw and
// y).
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int ell_mxv_packed(const void* ids, const void* erow,
                              const void* zrows, long long n_zero,
                              const void* xw, void* y, long long nnz,
                              long long L, int W, int vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (W <= 0) return 0;
  const int rc = zero_rows((const int32_t*)zrows, n_zero, (uint32_t*)y, W, s);
  if (rc != 0 || nnz == 0) return rc;
  const long long n_items = (nnz + L - 1) / L;
  if ((n_items + WARPS - 1) / WARPS > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  const int v = vec ? 4 : 1;
  const int gs = group_lanes(W, v, 32);
  const long long slices = (W + gs * v - 1) / (gs * v);
  if (slices > 65535) return (int)cudaErrorInvalidConfiguration;
  return vec ? launch_vec<4>(gs, ids, erow, xw, y, nnz, L, n_items, W,
                             (unsigned)slices, s)
             : launch_vec<1>(gs, ids, erow, xw, y, nnz, L, n_items, W,
                             (unsigned)slices, s);
}
