// BSR x BSR SpGEMM numeric phase at the entry level: the same function as
// bsr_spgemm.cu, on the same symbolic plan and run pointer, but the work is
// spent per stored entry instead of per tile element.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bsr_spgemm.py
// (spgemm_blocks -> _spgemm_pallas -> pl.pallas_call, body _kernel), like
// the tile kernel; the wrapper picks one of the two by the operands' fill.
//
// Why: at Graph500 fill a 128-tile holds about 20 entries (median 5), so
// the tile kernel's b^3 multiply-adds a task are some 40,000x the products
// the data needs (2.1e12 against 52.8e6 for the scale-14 hop matrix). This
// kernel reads a per-tile CSR of each operand (built on the device by the
// wrapper: row_ptr local to the tile, a uint8 row and column and the fp32
// value of each nonzero, grouped by row and sorted by column; each tile's
// first entry at a 64-bit base) and visits only A's stored entries and the
// B rows they select.
//
// Schedule. Tile rows are cut into 32 bands (4 rows at b = 128). One warp,
// a thread block of its own, owns one band of one output tile: its rows'
// accumulator lives in shared memory (4 x 128 fp32, or a bitmap for
// dot_indicator), and it walks the tile's task run. One block per whole
// output tile, with a warp per band, left most warps of a block idle
// behind the band holding a power-law hub row (summed over the scale-14
// hop matrix's tiles, the busiest of 16 bands holds 4.8x the mean, by
// tools/spgemm_entry_stats.py), so bands are blocks and the card schedules
// them freely. Each A tile carries a 32-bit word of the bands that hold an
// entry: a task whose A tile is empty in this band costs one load. The
// warp takes 32 tasks of the run at a time and treats their A entries of
// its band as one stream (a warp prefix sum over the tasks' counts): each
// lane takes one visit a(i,k) of the stream, loads the bounds of B's row k
// and its first entry (j, b), all 32 lanes' loads in flight at once. The
// warp then replays the visits in stream order (empty B rows, 59% of the
// visits at the scale-14 hop matrix, skipped by a ballot); each staged
// product is broadcast by shuffle and accumulated by the lane that owns
// column j (j % 32), so one lane writes it in order with no atomic or
// barrier; the rest of a longer B row is split over the lanes (distinct j)
// between two __syncwarp. Every output element sums its terms in the tile
// kernel's (task, k) order, with fmaf: the result equals the tile kernel's
// bit for bit for finite inputs (a skipped zero term adds +-0 there), and
// two launches agree bit for bit. (More bands a warp, or more B entries
// staged a lane, measured slower on Graph500 tiles.)
//
// A non-complemented mask is read once into bits in shared memory; rows
// with no mask entry never read their B rows, products outside the mask
// are never accumulated, and a band whose rows hold no mask entry only
// writes zeros. A complemented mask drops products inside it. The epilogue
// applies the mask, clamps dot_indicator and writes the band's rows once
// with float4 stores.
//
// Modes (dot modes only), fp32:
//   0 dot            acc = fmaf(a, b, acc)
//   1 dot_indicator  bit |= 1, then c = bit
//   2 dot_pair       acc += 1
//   3 dot_first      acc = fmaf(a, 1, acc)
//
// What bounds it on an H100: neither peak. The data's work is one
// multiply-add per pair of stored entries (52.8e6 at the scale-14 hop
// matrix, under 2 us at the fp32 peak) and its bytes are the entry form and
// the mask and output tiles; what it waits on is the chain of dependent
// loads (task -> A entries -> B row bounds -> B entries), paid once per 32
// visits, and once more per visit whose B row holds more than one entry.
// Offsets into the entry arrays and the tiles are 64-bit.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int BT = 128;             // largest tile side (b <= 128)
constexpr int MW = BT / 32;         // 32-bit mask words per tile row
constexpr int BANDS = 32;           // row bands per tile (bits of a_bands),
                                    // one warp (a block) each
constexpr int RB = BT / BANDS;      // rows of a band, at most
constexpr unsigned FULL = 0xffffffffu;

// first row of band q (rows i with i * BANDS / b == q start here)
__device__ __forceinline__ int band_row(int q, int b) {
  return (q * b + BANDS - 1) / BANDS;
}

template <int MODE>
__global__ void __launch_bounds__(32)
bsr_spgemm_entry_kernel(const long long* __restrict__ a_base,
                        const int32_t* __restrict__ a_ptr,
                        const uint8_t* __restrict__ a_rows,
                        const uint8_t* __restrict__ a_cols,
                        const float* __restrict__ a_vals,
                        const int32_t* __restrict__ a_bands,
                        const long long* __restrict__ b_base,
                        const int32_t* __restrict__ b_ptr,
                        const uint8_t* __restrict__ b_cols,
                        const float* __restrict__ b_vals,
                        const float* __restrict__ mblk,
                        const int32_t* __restrict__ a_sel,
                        const int32_t* __restrict__ b_sel,
                        const int32_t* __restrict__ valid,
                        const int32_t* __restrict__ cptr,
                        float* __restrict__ c, int b, int complement) {
  __shared__ __align__(16) float acc[RB * BT];   // the block's rows (0, 2, 3)
  __shared__ uint32_t ind[RB * MW];              // dot_indicator bits (1)
  __shared__ uint32_t mrow[RB * MW];             // mask bits of the rows
  const int ct = blockIdx.x / BANDS, q = blockIdx.x % BANDS;
  const int r0 = band_row(q, b), nr = band_row(q + 1, b) - r0;
  if (nr == 0) return;                 // b < 32: these bands hold no row
  const int lane = threadIdx.x;
  const long long bb = (long long)b * b;
  // 0: no mask, 1: <M> keeps bits that are set, 2: <!M> those that are not
  const int mk = mblk ? (complement ? 2 : 1) : 0;

  if (MODE == 1) {
    for (int e = lane; e < RB * MW; e += 32) ind[e] = 0u;
  } else {
    for (int e = lane; e < nr * b; e += 32) acc[e] = 0.f;
  }
  bool live = true;
  if (mk) {
    const float* mt = mblk + (long long)ct * bb + (long long)r0 * b;
    bool any = false;
    for (int i = 0; i < nr; ++i) {
      for (int wd = 0; wd < MW; ++wd) {
        const int j = wd * 32 + lane;
        const unsigned bits = __ballot_sync(
            FULL, j < b && mt[(long long)i * b + j] != 0.f);
        if (lane == 0) mrow[i * MW + wd] = bits;
        any |= bits != 0u;
      }
    }
    live = mk != 1 || any;
  }
  __syncwarp();

  auto update = [&](int i, int j, float a, float v) {
    if (mk) {
      const unsigned bit = (mrow[i * MW + (j >> 5)] >> (j & 31)) & 1u;
      if (bit != (mk == 1 ? 1u : 0u)) return;
    }
    if (MODE == 1) {
      atomicOr(&ind[i * MW + (j >> 5)], 1u << (j & 31));
    } else {
      float* p = acc + i * b + j;
      if (MODE == 0) *p = fmaf(a, v, *p);
      else if (MODE == 2) *p = *p + 1.0f;
      else *p = fmaf(a, 1.0f, *p);
    }
  };

  if (live) {
    const int t0 = cptr[ct], t1 = cptr[ct + 1];
    for (int tb = t0; tb < t1; tb += 32) {
      // lane l looks at task tb + l: its A entries in this band
      const int t = tb + lane;
      long long e0 = 0, bbase = 0;
      int cnt = 0, bsel = 0;
      if (t < t1 && valid[t]) {
        const int as = a_sel[t];
        if (((unsigned)a_bands[as] >> q) & 1u) {
          const int32_t* ap = a_ptr + (long long)as * (b + 1);
          const int lo = ap[r0];
          e0 = a_base[as] + lo;
          cnt = ap[r0 + nr] - lo;
          bsel = b_sel[t];
          bbase = b_base[bsel];
        }
      }
      int incl = cnt;                  // the stream: tasks in run order
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += y;
      }
      const int excl = incl - cnt;
      const int total = __shfl_sync(FULL, incl, 31);
      for (int pb = 0; pb < total; pb += 32) {
        // lane l takes visit p of the stream: task s is the last lane
        // whose stream start is at or before p
        const int p = pb + lane;
        int s = 0;
#pragma unroll
        for (int step = 16; step > 0; step >>= 1) {
          const int x = __shfl_sync(FULL, excl, s + step);
          if (x <= p) s += step;
        }
        const long long es = __shfl_sync(FULL, e0, s);
        const int xs = __shfl_sync(FULL, excl, s);
        const int bs = __shfl_sync(FULL, bsel, s);
        const long long bbs = __shfl_sync(FULL, bbase, s);
        int i = 0, f0 = 0, n = 0, j0 = 0;
        float av = 0.f, v0 = 0.f;
        if (p < total) {
          const long long e = es + (p - xs);
          i = a_rows[e] - r0;
          const int k = a_cols[e];
          if (MODE == 0 || MODE == 3) av = a_vals[e];
          bool row_live = mk != 1;      // <M>: a row with no mask bit is skipped
          for (int wd = 0; wd < MW && !row_live; ++wd)
            row_live = mrow[i * MW + wd] != 0u;
          if (row_live) {
            const int32_t* bp = b_ptr + (long long)bs * (b + 1);
            f0 = bp[k];
            n = bp[k + 1] - f0;
            if (n > 0) {               // stage B's first entry of the row
              j0 = b_cols[bbs + f0];
              if (MODE == 0) v0 = b_vals[bbs + f0];
            }
          }
        }
        unsigned todo = __ballot_sync(FULL, n > 0);
        while (todo) {                 // visits in stream order
          const int src = __ffs(todo) - 1;
          todo &= todo - 1;
          const int ii = __shfl_sync(FULL, i, src);
          const float aa = __shfl_sync(FULL, av, src);
          const int m = __shfl_sync(FULL, n, src);
          const int j = __shfl_sync(FULL, j0, src);
          const float v = __shfl_sync(FULL, v0, src);
          if ((j & 31) == lane) update(ii, j, aa, v);   // the owner lane
          if (m > 1) {                 // the rest of the B row: lanes split it
            const int g0 = __shfl_sync(FULL, f0, src);
            const long long gb = __shfl_sync(FULL, bbs, src);
            __syncwarp();
            for (int f = g0 + 1 + lane; f < g0 + m; f += 32)
              update(ii, b_cols[gb + f], aa, MODE == 0 ? b_vals[gb + f] : 0.f);
            __syncwarp();
          }
        }
      }
    }
  }
  __syncwarp();

  float* out = c + (long long)ct * bb + (long long)r0 * b;
  auto value = [&](int i, int j) -> float {
    float o = MODE == 1 ? (float)((ind[i * MW + (j >> 5)] >> (j & 31)) & 1u)
                        : acc[i * b + j];
    if (mk) {
      const unsigned bit = (mrow[i * MW + (j >> 5)] >> (j & 31)) & 1u;
      if (bit != (mk == 1 ? 1u : 0u)) o = 0.f;
    }
    return o;
  };
  if ((b & 3) == 0) {
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int e = lane; e < nr * b / 4; e += 32) {
      const int i = (4 * e) / b, j = (4 * e) % b;
      o4[e] = make_float4(value(i, j), value(i, j + 1), value(i, j + 2),
                          value(i, j + 3));
    }
  } else {
    for (int e = lane; e < nr * b; e += 32) out[e] = value(e / b, e % b);
  }
}

// Launches on `stream`; returns a cudaError_t (0 = launched). The A and B
// entry forms may be the same arrays (A x A). mblk (the (nc, b, b) mask
// tiles aligned to the output tiles) may be null.
extern "C" int bsr_spgemm_entry(
    const void* a_base, const void* a_ptr, const void* a_rows,
    const void* a_cols, const void* a_vals, const void* a_bands,
    const void* b_base, const void* b_ptr, const void* b_cols,
    const void* b_vals, const void* mblk, const void* a_sel,
    const void* b_sel, const void* valid, const void* cptr, void* c, int nc,
    int b, int mode, int complement, void* stream) {
  if (nc == 0) return 0;
  if (b < 1 || b > BT || mode < 0 || mode > 3 || nc > (1 << 26))
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)nc * BANDS;
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(MD)                                                           \
  bsr_spgemm_entry_kernel<MD><<<grid, 32, 0, s>>>(                           \
      (const long long*)a_base, (const int32_t*)a_ptr,                       \
      (const uint8_t*)a_rows, (const uint8_t*)a_cols, (const float*)a_vals, \
      (const int32_t*)a_bands, (const long long*)b_base,                     \
      (const int32_t*)b_ptr, (const uint8_t*)b_cols, (const float*)b_vals,   \
      (const float*)mblk, (const int32_t*)a_sel, (const int32_t*)b_sel,      \
      (const int32_t*)valid, (const int32_t*)cptr, (float*)c, b, complement)
  switch (mode) {
    case 0: LAUNCH(0); break;
    case 1: LAUNCH(1); break;
    case 2: LAUNCH(2); break;
    default: LAUNCH(3); break;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
