// Bit-tile or_and product:  Yw[32p+r] = OR over slots s and set bits b of
// tiles[p, s, r] of Xw[cols[p, s]*32 + b].
//
// Replaces the Pallas TPU kernel src/repro/kernels/bitadj_mxv.py,
// function bitadj_mxv_packed (pl.pallas_call, body _kernel): there a grid
// step takes one 32-row panel and, for every slot, spreads all 32 bit
// positions as masks over a (32, W) query tile, padded slots included.
// Here only occupied slots are read (BitELL.occupied_first, split into
// work items by BitELL.slot_plan) and only set bits gather.
//
// What bounds it on an H100. From device memory: the occupied tiles, 128
// bytes each, read once: 226 MB for the scale-18 Graph500 transpose
// handle (1,762,314 occupied tiles of 8,192 panels, 2.24 edges a tile),
// plus about 41 MB of slot ids, frontier and output at W = 16; 80 us at
// 3.35 TB/s. From L2: one W*4-byte frontier row per edge, 252 MB for its
// 3,939,319 edges at W = 16, against a 16.8 MB frontier that L2 (50 MB)
// holds. The panels' skew is what used to bound it: one block walked a
// panel, and the hub panel holds 5,807 occupied slots.
//
// Design: slot-balanced work. Item (panel, slots [s0, s1)) takes at most
// K occupied slots (K = 64 on the path: 32,454 items), one warp each, so
// a hub panel is spread over 91 warps. The warp takes its slots in
// batches of 32 tiles, lane j reading tile j. A batch's 4 KB (32 tiles of
// 128 contiguous bytes) is copied coalesced and asynchronously
// (cp.async) into shared memory, transposed on the way so that lane j
// reads tile j's 32 row words without bank conflicts; the copy bypasses
// L1 and is marked evict-first in L2, since 226 MB of tiles pass through
// once and must not push the frontier out. The set (row r, bit b) pairs
// are listed warp-wide in rounds: in each round every lane with a pair
// left lists one at its rank among the lanes listing one (__ballot_sync,
// __popc of the lower lanes), into a per-warp list in shared memory. A
// round serves up to 32 tiles at once; drafts that listed per slot (one
// lane per row) or per row of a batch took a warp step for every edge or
// two and were slower as a whole. Row groups of GS lanes
// then serve the list, each gathering one frontier row cols*32+b (16
// bytes a lane where W is a multiple of 4), 8 pairs a lane before it uses
// one, so a warp keeps 64 frontier rows in flight at W = 16, and OR them
// into a (32, W-slice) accumulator in shared memory (shared atomics: two
// groups may hold one row; the rows are padded to spread the banks). The
// next batch's tiles are copied while this batch's rows are gathered.
// Frontier rows at or past xrows read as zero. At the item's end the warp
// stores the panel's 32 rows, or, where the plan split the panel over
// several items, ORs its touched rows into y with atomicOr (the plan's
// rows to zero cover those panels). OR is associative, commutative and
// idempotent, so any split of a panel's slots, any listing order and any
// order of the atomics give the same words: bit-identical to the plain
// version. W wider than 32 words is cut into column slices (the grid's y
// dimension), which keeps a block's shared memory under 48 KB.
//
// What holds it back is not split yet: it runs at about a third of its
// byte bound. A warp's phases run one after another (wait for a batch,
// list its pairs, gather them), but drafts that overlapped them, with a
// second tile buffer, with resident warps claiming items from a counter
// and loading the next item early, or with more resident warps (fewer
// registers), were no faster, so the limit is some throughput (shared
// memory, L2) rather than latency; there are no profiler counters to
// say which.
#include "word_rows.cuh"

using namespace words;

constexpr int WARPS = 2;      // warps per block
constexpr int BATCH = 32;     // slots a warp enumerates at once, a lane each
constexpr int TSTRIDE = 36;   // words per tile in a transposed batch
constexpr int LIST = 256;     // pairs a warp lists before it gathers them
constexpr int STEPS = 8;      // gathers in flight a lane

// the accumulator's row: a slice's WS words and a pad that spreads the
// rows of one step's groups over the banks
__host__ __device__ constexpr int acc_stride(int ws, int vec) {
  return ws + (vec == 4 ? 4 : 1);
}
// shared memory per warp, in words: the (32, stride) accumulator, a batch
// of tiles, the list's frontier rows, then (bytes) the list's panel rows
__host__ __device__ constexpr int warp_words(int as) {
  return 32 * as + BATCH * TSTRIDE + LIST;
}

// Gather the n listed frontier rows into the accumulator: group g takes
// pairs g, g+G, ..., STEPS of them in flight a lane. Kept out of line, so
// the enumeration loops around it stay small.
template <int VEC, int GS>
__device__ __noinline__ void serve(const uint32_t* __restrict__ xw,
                                   uint32_t* acc, const int32_t* xr,
                                   const uint8_t* rr, int n, int W, int w) {
  using V = typename Vec<VEC>::T;
  constexpr int G = 32 / GS;
  const int lane = threadIdx.x & 31;
  const int g = lane / GS, q = lane % GS;
  const bool on = w < W;
  __syncwarp();
  for (int i0 = 0; i0 < n; i0 += STEPS * G) {
    V v[STEPS];
    int r[STEPS];
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      const int i = i0 + u * G + g;
      r[u] = i < n ? rr[i] : -1;
      v[u] = zero_v(V());
      if (r[u] >= 0 && on) ldg_v(xw + (long long)xr[i] * W + w, v[u]);
    }
#pragma unroll
    for (int u = 0; u < STEPS; ++u)
      if (r[u] >= 0 && on)
        atomic_or_v(acc + r[u] * acc_stride(GS * VEC, VEC) + q * VEC, v[u]);
  }
  __syncwarp();
}

// Copy a batch's tiles (ns <= 32 of them, 128 contiguous bytes each) into
// shared memory, transposed for reading by tile: lane l copies 16-byte
// pieces l, l+32, ... (coalesced), piece e being part e % 8 of tile e / 8.
// Asynchronous, bypassing L1, marked evict-first in L2: the tiles pass
// through once and should not push the frontier out of L2.
__device__ __forceinline__ void copy_batch(uint32_t* tb, const uint32_t* src,
                                           int ns, uint64_t policy) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int e = u * 32 + lane;
    if ((e >> 3) < ns) {
      const unsigned dst = (unsigned)__cvta_generic_to_shared(
          tb + (e >> 3) * TSTRIDE + (e & 7) * 4);
      asm volatile(
          "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n"
          ::"r"(dst), "l"(src + 4 * e), "l"(policy));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int VEC, int GS>
__global__ void __launch_bounds__(WARPS * 32)
bitadj_items_kernel(const uint32_t* __restrict__ tiles,
                    const int32_t* __restrict__ cols,
                    const int4* __restrict__ items,
                    const uint32_t* __restrict__ xw, uint32_t* __restrict__ y,
                    long long S, long long xrows, long long n, int W,
                    long long n_items) {
  using V = typename Vec<VEC>::T;
  constexpr int WS = GS * VEC;                  // words of a slice
  constexpr int AS = acc_stride(WS, VEC);
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const long long item = (long long)blockIdx.x * WARPS + wid;
  if (item >= n_items) return;                  // whole warps only
  uint32_t* acc = smem + wid * warp_words(AS);              // (32, AS)
  uint32_t* tb = acc + 32 * AS;                             // (32, 36)
  int32_t* xr = reinterpret_cast<int32_t*>(tb + BATCH * TSTRIDE);
  uint8_t* rr = reinterpret_cast<uint8_t*>(smem + WARPS * warp_words(AS))
                + wid * LIST;
  const int wb = blockIdx.y * WS;
  const int w = wb + (lane % GS) * VEC;         // this lane's first word
  const int4 it = items[item];                  // panel, s0, s1, split
  const long long base = (long long)it.x * S;
  const int s0 = it.y, s1 = it.z;
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  for (int i = lane; i < 32 * AS; i += 32) acc[i] = 0u;

  uint32_t touched = 0;                         // rows with a set bit
  int npairs = 0;
  if (s0 < s1) copy_batch(tb, tiles + (base + s0) * 32, min(BATCH, s1 - s0),
                          policy);
  int32_t cl = lane < s1 - s0 ? __ldg(cols + base + s0 + lane) : -1;
  for (int sb = s0; sb < s1; sb += BATCH) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncwarp();
    // lane j: tile j of the batch, its bits that name frontier rows below
    // xrows (none past the batch's end: cl = -1)
    const uint32_t* tw = tb + lane * TSTRIDE;
    const long long lim = xrows - (long long)cl * 32;
    const uint32_t vm = cl < 0 || lim <= 0 ? 0u
                        : lim >= 32 ? 0xffffffffu : (1u << lim) - 1u;
    uint32_t nz = 0;                            // rows with a bit here
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint4 q4 = *reinterpret_cast<const uint4*>(tw + 4 * i);
      nz |= (uint32_t)((q4.x & vm) != 0u) << (4 * i)
            | (uint32_t)((q4.y & vm) != 0u) << (4 * i + 1)
            | (uint32_t)((q4.z & vm) != 0u) << (4 * i + 2)
            | (uint32_t)((q4.w & vm) != 0u) << (4 * i + 3);
    }
    touched |= __reduce_or_sync(FULL, nz);
    // rounds, warp-uniform: each lane lists its next (row, bit) pair, at
    // its rank among the lanes listing one (ballot, popcount)
    uint32_t x = 0;
    int r = 0;
    while (__any_sync(FULL, (nz | x) != 0u)) {
      if (x == 0u && nz != 0u) {
        r = __ffs(nz) - 1;
        nz &= nz - 1u;
        x = tw[r] & vm;
      }
      const unsigned m = __ballot_sync(FULL, x != 0u);
      if (npairs + __popc(m) > LIST) {
        serve<VEC, GS>(xw, acc, xr, rr, npairs, W, w);
        npairs = 0;
      }
      if (x) {
        const int k = npairs + __popc(m & ((1u << lane) - 1u));
        xr[k] = (int32_t)(cl * 32 + __ffs(x) - 1);
        rr[k] = (uint8_t)r;
        x &= x - 1u;
      }
      npairs += __popc(m);
    }
    __syncwarp();                               // the batch is read
    // the next batch's tiles arrive while this one's rows are gathered
    const int sn = sb + BATCH;
    cl = -1;
    if (sn < s1) {
      copy_batch(tb, tiles + (base + sn) * 32, min(BATCH, s1 - sn), policy);
      cl = lane < s1 - sn ? __ldg(cols + base + sn + lane) : -1;
    }
    serve<VEC, GS>(xw, acc, xr, rr, npairs, W, w);
    npairs = 0;
  }
  __syncwarp();

  const long long p32 = (long long)it.x * 32;
  for (int i = lane; i < 32 * GS; i += 32) {    // GS vectors a row
    const int rw = i / GS;
    const int ww = wb + (i % GS) * VEC;
    if (ww >= W || p32 + rw >= n) continue;
    V a;
    if constexpr (VEC == 4) a = *reinterpret_cast<const uint4*>(acc + rw * AS + ww - wb);
    else a = acc[rw * AS + ww - wb];
    uint32_t* dst = y + (p32 + rw) * W + ww;
    if (!it.w) store_v(dst, a);                 // the panel's only item
    else if ((touched >> rw) & 1u) atomic_or_v(dst, a);
  }
}

template <int VEC, int GS>
static int launch(const void* tiles, const void* cols, const void* items,
                  long long n_items, const void* xw, void* y, long long S,
                  long long xrows, long long n, int W, unsigned slices,
                  cudaStream_t stream) {
  const size_t smem =
      (size_t)WARPS * (warp_words(acc_stride(GS * VEC, VEC)) * 4 + LIST);
  const dim3 grid((unsigned)((n_items + WARPS - 1) / WARPS), slices);
  bitadj_items_kernel<VEC, GS><<<grid, WARPS * 32, smem, stream>>>(
      (const uint32_t*)tiles, (const int32_t*)cols, (const int4*)items,
      (const uint32_t*)xw, (uint32_t*)y, S, xrows, n, W, n_items);
  return (int)cudaGetLastError();
}

// y (n, W) from occupied-first tiles (P, S, 32) and cols (P, S), read
// through the plan's items (n_items, 4); the plan's zero rows (zrows,
// n_zero) are zeroed first. Frontier rows at or past xrows read as zero.
// vec != 0 takes 16-byte vectors (W % 4 == 0 and 16-byte aligned xw and
// y). Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int bitadj_mxv_packed(const void* tiles, const void* cols,
                                 const void* items, long long n_items,
                                 const void* zrows, long long n_zero,
                                 const void* xw, void* y, long long S,
                                 long long xrows, long long n, int W, int vec,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (W <= 0 || n_items == 0) return 0;
  const int rc = zero_rows((const int32_t*)zrows, n_zero, (uint32_t*)y, W, s);
  if (rc != 0) return rc;
  if ((n_items + WARPS - 1) / WARPS > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  const int v = vec ? 4 : 1;
  // slices of at most 32 words keep a block's shared memory under 48 KB
  const int gs = group_lanes(W, v, vec ? 8 : 32);
  const long long slices = (W + gs * v - 1) / (gs * v);
  if (slices > 65535) return (int)cudaErrorInvalidConfiguration;
  const unsigned sl = (unsigned)slices;
#define BITADJ_CASE(V_, GS_)                                                  \
  case GS_:                                                                    \
    return launch<V_, GS_>(tiles, cols, items, n_items, xw, y, S, xrows, n, W, \
                           sl, s);
  if (vec) {
    switch (gs) {
      BITADJ_CASE(4, 1) BITADJ_CASE(4, 2) BITADJ_CASE(4, 4)
      BITADJ_CASE(4, 8)
    }
  } else {
    switch (gs) {
      BITADJ_CASE(1, 1) BITADJ_CASE(1, 2) BITADJ_CASE(1, 4)
      BITADJ_CASE(1, 8) BITADJ_CASE(1, 16) BITADJ_CASE(1, 32)
    }
  }
#undef BITADJ_CASE
  return (int)cudaErrorInvalidValue;
}
