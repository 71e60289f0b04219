// S1 stream_fold: one chunk's per-(series, window) moments, merged into the
// streaming state's window slice in place, with the slice's audit.
//
// Replaces opentsdb_tpu/ops/streaming.py: _chunk_moments (:246, its moment
// lanes), _segment_chunk_moments (:154), _merge (:462), _update (:504) and
// _update_sliced (:513).  The chunk is [S, n] time-sorted rows (pads at
// int64 max sort last); its local windows are edges[0..wc] and land in the
// state's columns [w0, w0 + wc) of a [S, W] grid.  Masked slots and NaN
// values take no part.  A cell holds n (int64) and the lanes its state
// carries, each a null pointer when absent: total, m2 (the centered sum
// of squares, two-pass in the chunk: the window mean, then the centered
// sum), lo, hi, first, last and prod (float64).  The merge is the Chan et
// al. one: m2 = m2_1 + m2_2 + delta^2 n1 n2 / n, delta the difference of
// the two means, 0 unless both sides hold points; first sticks and last
// overwrites (chunks arrive in time order); prod multiplies in time order.
// A cell the chunk does not reach is left as it is (every merge with an
// empty side is the identity).
//
// The audit (oob non-null): the valid points of the chunk inside the
// grid [grid_lo, grid_hi) but outside the slice's windows are added to
// *oob, so that a wrong w0 is counted and never drops points in silence.
//
// Bound on the H100: bytes.  The kernel must read val and mask once (9 B
// a point), ts where a window edge falls, and read and write n and each
// lane of the slice (8 B each).  At the headline chunk (1024 x 4096,
// ~64-window slice, one lane) about 39 MB + 2 MB, ~0.012 ms at 3.35 TB/s.
//
// Design: one launch a fold, the audit counted in it; a program owns a
// row and a tile of windows, and the slice's first and last tiles of a
// row also count its audit.  Each program loads the row's first and last
// timestamps and, into registers, the state cells it will merge (no load
// waits until the merge).  Edge positions come from seek_position
// (window_runs.cuh): an edge outside the row's [first, last] is clamped
// with no probe, any other reads the eight points around the line's
// guess (Seek's first probe) in one round of loads, which at a steady
// cadence brackets it.
//
//   fold_long (32 points a window and more on average: the headline
//   chunk, ~232 points in each window that holds any): a block a row and
//   64-window tile.  The tile's first and last edges are placed first,
//   the tile's run is copied into shared memory by cp.async in 16-byte
//   pieces (up to CAP points, the whole headline row), and the inner
//   edges are placed while the copy is in flight.  A warp reduces a
//   window out of shared memory: lanes stride the run with every load of
//   a step issued before any is used, then butterfly trees (sum, min,
//   max) and single-instruction reductions (count, first and last
//   offsets); the m2 pass, first, last and the time-ordered product read
//   shared memory too, and the lane that holds the cell's state merges
//   it.  A run longer than CAP is reduced the same way from device
//   memory.  Four blocks stay resident on an SM (64 registers a thread),
//   so one block's copy overlaps another's reduction; a persistent grid
//   that carried the next tile's copy through a second stage measured no
//   faster.
//
//   fold_short (config 2: about a point a 10 s window): a thread a window
//   reads its run from device memory in time order; a point is read by
//   one thread once (the m2 pass and first and last hit L1), so staging
//   would only add a copy.
//
// Every sum has one order fixed by the data (a lane's points in time
// order, then the butterfly tree; a thread's run in time order), so a
// run gives the same bits every time.  The merge is written with
// explicitly rounded operations (no fused multiply-add), as the plain
// version computes it.  One program owns each cell: no atomics but the
// audit's integer add.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "window_runs.cuh"

namespace {

constexpr int LONG_THREADS = 256;   // fold_long's block
constexpr int LONG_WARPS = LONG_THREADS / 32;
constexpr int SHORT_THREADS = 128;  // fold_short's block, a window a thread
constexpr int TILE_W = 64;          // windows a block, fold_long
constexpr int CELLS_A_LANE = TILE_W / LONG_WARPS;   // cells whose state a lane holds
constexpr int WARP_MIN_RUN = 32;    // mean points a window for fold_long
constexpr int CAP = 4096;           // points fold_long stages
constexpr int LOAD_DEPTH = 4;       // loads a lane has in flight, fold_long

struct State {
  int64_t* n;
  double* total;
  double* m2;
  double* lo;
  double* hi;
  double* first;
  double* last;
  double* prod;
};

// A state cell's values, or one chunk cell's moments.
struct Cell {
  int64_t cnt;
  double total, m2, lo, hi, first, last, prod;
};

// The state's cell idx, lanes it lacks left at 0.
__device__ __forceinline__ Cell load_cell(const State& st, int64_t idx) {
  Cell c = {};
  c.cnt = st.n[idx];
  if (st.total) c.total = st.total[idx];
  if (st.m2) c.m2 = st.m2[idx];
  if (st.lo) c.lo = st.lo[idx];
  if (st.hi) c.hi = st.hi[idx];
  if (st.first) c.first = st.first[idx];
  if (st.last) c.last = st.last[idx];
  if (st.prod) c.prod = st.prod[idx];
  return c;
}

// Merges the chunk's cell c (c.cnt > 0) into the state cell s, stored at idx.
__device__ __forceinline__ void merge_cell(const State& st, int64_t idx, const Cell& s,
                                           const Cell& c) {
  const int64_t n1 = s.cnt;
  const int64_t n = n1 + c.cnt;
  st.n[idx] = n;
  if (st.total) {
    st.total[idx] = __dadd_rn(s.total, c.total);
    if (st.m2) {
      const double nf1 = (double)n1, nf2 = (double)c.cnt;
      const double mean1 = __ddiv_rn(s.total, fmax(nf1, 1.0));
      const double mean2 = __ddiv_rn(c.total, nf2);
      const double delta = n1 > 0 ? __dsub_rn(mean2, mean1) : 0.0;
      const double term = __ddiv_rn(
          __dmul_rn(__dmul_rn(__dmul_rn(delta, delta), nf1), nf2), (double)n);
      st.m2[idx] = __dadd_rn(__dadd_rn(s.m2, c.m2), term);
    }
  }
  if (st.lo) st.lo[idx] = fmin(s.lo, c.lo);
  if (st.hi) st.hi[idx] = fmax(s.hi, c.hi);
  if (st.first && n1 == 0) st.first[idx] = c.first;
  if (st.last) st.last[idx] = c.last;
  if (st.prod) st.prod[idx] = __dmul_rn(s.prod, c.prod);
}

// A point's value and whether it takes part; the row's points are v[k + d]
// and m[k + d] (d shifts a row index into a staged copy).
__device__ __forceinline__ bool take(const double* v, const uint8_t* m, int64_t k, int64_t d,
                                     double& x) {
  x = v[k + d];
  return m[k + d] && !isnan(x);
}

struct Audit {
  unsigned long long* oob;   // null: no audit
  int64_t grid_lo, grid_hi;
};

// The audit's positions: the row's valid points in [grid_lo, edges[0])
// are [p[0], p[1]), those in [edges[wc], grid_hi) are [p[2], p[3]).  The
// program of the slice's first tile of a row counts the first range, that
// of its last tile the second.  Thread i in [0, 4) of such a block places
// p[i].
__device__ __forceinline__ void audit_position(const Audit& au, bool first_tile, bool last_tile,
                                               const int64_t* trow, int64_t n, int64_t f,
                                               int64_t l, const int64_t* edges, int wc, int i,
                                               int64_t* p) {
  if (au.oob == nullptr || i < 0 || i >= 4 || (i < 2 && !first_tile) ||
      (i >= 2 && !last_tile))
    return;
  const int64_t key = i == 0 ? au.grid_lo
                      : i == 1 ? max(edges[0], au.grid_lo)
                      : i == 2 ? min(edges[wc], au.grid_hi)
                               : au.grid_hi;
  p[i] = seek_position(trow, n, f, l, key);
}

// Counts the audit's ranges of the row (every thread of the block takes
// part; a warp adds its count once).
__device__ __forceinline__ void audit_count(const Audit& au, bool first_tile, bool last_tile,
                                            const double* vrow, const uint8_t* mrow,
                                            const int64_t* p) {
  if (au.oob == nullptr || (!first_tile && !last_tile)) return;
  int cnt = 0;
  double x;
  if (first_tile)
    for (int64_t k = p[0] + threadIdx.x; k < p[1]; k += blockDim.x) cnt += take(vrow, mrow, k, 0, x);
  if (last_tile)
    for (int64_t k = p[2] + threadIdx.x; k < p[3]; k += blockDim.x) cnt += take(vrow, mrow, k, 0, x);
  cnt = warp_sum_int(cnt);
  if ((threadIdx.x & 31) == 0 && cnt > 0) atomicAdd(au.oob, (unsigned long long)cnt);
}

// Copies bytes [src, src_end) of device memory into dst (16-byte aligned)
// in 16-byte pieces by cp.async, from the piece that holds src, whose
// offset in that piece is src's in dst.  A 16-byte aligned piece never
// crosses a page, so the bytes around the run that it also reads are
// mapped.
__device__ __forceinline__ void stage(void* dst, const void* src, const void* src_end) {
  const uintptr_t a = (uintptr_t)src & ~uintptr_t(15);
  const int pieces = (int)(((uintptr_t)src_end - a + 15) >> 4);
  for (int q = threadIdx.x; q < pieces; q += blockDim.x)
    __pipeline_memcpy_async((char*)dst + 16 * q, (const void*)(a + 16 * (uintptr_t)q), 16);
}

// A stage: a run's values, then its mask flags.
constexpr int VAL_BYTES = (CAP + 4) * 8;
constexpr int STAGE_BYTES = VAL_BYTES + CAP + 32;

// A warp a window of the tile's windows [0, tw) (p their edges' positions):
// the row's point k is v[k + d], its flag m[k + d].  Lanes stride the run
// LOAD_DEPTH loads deep, each lane's points in time order; the lane that
// holds the cell's state (cur) merges it.
__device__ __forceinline__ void fold_windows(const double* v, const uint8_t* m, int64_t d,
                                             const int64_t* p, int tw, const State& st,
                                             int64_t base, const Cell& cur) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = 0; i < CELLS_A_LANE; ++i) {
    const int j = warp + LONG_WARPS * i;
    if (j >= tw) break;
    const int64_t lo = p[j], hi = p[j + 1];
    if (lo == hi) continue;  // no point: the whole warp skips the cell
    Cell c;
    int cnt = 0;
    c.total = 0.0;
    c.lo = INFINITY;
    c.hi = -INFINITY;
    unsigned first = 0xffffffffu, end = 0;   // valid offsets from lo: first, last + 1
    const int len = (int)(hi - lo);
    const double* vr = v + (lo + d);
    const uint8_t* mr = m + (lo + d);
    for (int o0 = lane; o0 < len; o0 += 32 * LOAD_DEPTH) {
      // every load issued before any is used: offsets past the run read
      // its last point and are dropped
      double y[LOAD_DEPTH];
      uint8_t f[LOAD_DEPTH];
#pragma unroll
      for (int u = 0; u < LOAD_DEPTH; ++u) {
        const int o = min(o0 + 32 * u, len - 1);
        y[u] = vr[o];
        f[u] = mr[o];
      }
#pragma unroll
      for (int u = 0; u < LOAD_DEPTH; ++u) {
        const int o = o0 + 32 * u;
        if (o < len && f[u] && !isnan(y[u])) {
          cnt += 1;
          c.total += y[u];
          c.lo = fmin(c.lo, y[u]);
          c.hi = fmax(c.hi, y[u]);
          first = min(first, (unsigned)o);
          end = o + 1;
        }
      }
    }
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (cnt == 0) continue;  // the whole warp leaves the cell together
    c.cnt = cnt;
    c.total = warp_sum(c.total);
    c.lo = warp_min(c.lo);
    c.hi = warp_max(c.hi);
    const int64_t fi = lo + __reduce_min_sync(0xffffffffu, first);
    const int64_t la = lo + __reduce_max_sync(0xffffffffu, end) - 1;
    c.m2 = 0.0;
    if (st.m2) {
      const double mean = __ddiv_rn(c.total, (double)c.cnt);
      for (int64_t k = lo + lane; k < hi; k += 32) {
        double y;
        if (take(v, m, k, d, y)) {
          const double u = __dsub_rn(y, mean);
          c.m2 = __dadd_rn(c.m2, __dmul_rn(u, u));
        }
      }
      c.m2 = warp_sum(c.m2);
    }
    c.first = v[fi + d];
    c.last = v[la + d];
    c.prod = 1.0;
    if (lane == i) {
      if (st.prod) {
        // one lane multiplies in time order, as the reference's segment
        // product over a time-sorted run does
        for (int64_t k = fi; k <= la; ++k) {
          double y;
          if (take(v, m, k, d, y)) c.prod = __dmul_rn(c.prod, y);
        }
      }
      merge_cell(st, base + j, cur, c);
    }
  }
}

// A warp a window, out of a staged copy of the tile's run.  Block (x, y)
// covers windows [y * TILE_W, y * TILE_W + TILE_W) of row x.
__global__ void __launch_bounds__(LONG_THREADS, 4)
fold_long(const int64_t* __restrict__ ts, const double* __restrict__ val,
          const uint8_t* __restrict__ mask, const int64_t* __restrict__ edges, int64_t n,
          int wc, int64_t w, int64_t w0, State st, Audit au) {
  __shared__ __align__(16) unsigned char stg[STAGE_BYTES];
  __shared__ int64_t pos[TILE_W + 1];
  __shared__ int64_t apos[4];
  const int64_t row = blockIdx.x;
  const int t0 = blockIdx.y * TILE_W;
  const int tw = min(TILE_W, wc - t0);
  const int64_t* trow = ts + row * n;
  const double* vrow = val + row * n;
  const uint8_t* mrow = mask + row * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base = row * w + w0 + t0;
  const bool first_tile = blockIdx.y == 0, last_tile = blockIdx.y == gridDim.y - 1;

  // lane i < CELLS_A_LANE of warp v holds the state of window v + LONG_WARPS * i
  Cell cur = {};
  if (lane < CELLS_A_LANE && warp + LONG_WARPS * lane < tw)
    cur = load_cell(st, base + warp + LONG_WARPS * lane);
  const int64_t f = trow[0], l = trow[n - 1];
  if (threadIdx.x == 0) pos[0] = seek_position(trow, n, f, l, edges[t0]);
  if (threadIdx.x == 32) pos[tw] = seek_position(trow, n, f, l, edges[t0 + tw]);
  __syncthreads();
  const int64_t a = pos[0], e = pos[tw];
  const bool staged = e > a && e - a <= CAP;
  if (staged) {
    stage(stg, vrow + a, vrow + e);
    stage(stg + VAL_BYTES, mrow + a, mrow + e);
    __pipeline_commit();
  }
  // the inner edges, and the audit's, while the copy is in flight
  for (int i = threadIdx.x; i < tw; i += LONG_THREADS)
    if (i > 0) pos[i] = seek_position(trow, n, f, l, edges[t0 + i]);
  // the last four threads, which place no inner edge (tw <= TILE_W)
  audit_position(au, first_tile, last_tile, trow, n, f, l, edges, wc,
                 threadIdx.x - (LONG_THREADS - 4), apos);
  if (staged) __pipeline_wait_prior(0);
  __syncthreads();
  if (staged) {
    // the staged run: row index k at v[k + vo - a], its flag at m[k + mo - a]
    const int vo = (int)((uintptr_t)(vrow + a) & 15) / 8;
    const int mo = (int)((uintptr_t)(mrow + a) & 15);
    fold_windows((const double*)stg, stg + VAL_BYTES + (mo - vo), vo - a, pos, tw, st, base,
                 cur);
  } else {
    fold_windows(vrow, mrow, 0, pos, tw, st, base, cur);
  }
  audit_count(au, first_tile, last_tile, vrow, mrow, apos);
}

// A thread a window, in time order, for short runs.  Block (x, y) covers
// windows [y * SHORT_THREADS, y * SHORT_THREADS + SHORT_THREADS) of row x.
__global__ void __launch_bounds__(SHORT_THREADS)
fold_short(const int64_t* __restrict__ ts, const double* __restrict__ val,
           const uint8_t* __restrict__ mask, const int64_t* __restrict__ edges, int64_t n,
           int wc, int64_t w, int64_t w0, State st, Audit au) {
  __shared__ int64_t pos[SHORT_THREADS + 1];
  __shared__ int64_t apos[4];
  const int64_t row = blockIdx.x;
  const int t0 = blockIdx.y * SHORT_THREADS;
  const int tw = min(SHORT_THREADS, wc - t0);
  const int64_t* trow = ts + row * n;
  const double* vrow = val + row * n;
  const uint8_t* mrow = mask + row * n;
  const int j = threadIdx.x;
  const int64_t idx = row * w + w0 + t0 + j;
  Cell cur = {};
  if (j < tw) cur = load_cell(st, idx);
  const int64_t f = trow[0], l = trow[n - 1];
  for (int i = j; i <= tw; i += SHORT_THREADS) pos[i] = seek_position(trow, n, f, l, edges[t0 + i]);
  const bool first_tile = blockIdx.y == 0, last_tile = blockIdx.y == gridDim.y - 1;
  audit_position(au, first_tile, last_tile, trow, n, f, l, edges, wc, j, apos);
  __syncthreads();
  if (j < tw) {
    const int64_t lo = pos[j], hi = pos[j + 1];
    Cell c;
    c.cnt = 0;
    c.total = 0.0;
    c.lo = INFINITY;
    c.hi = -INFINITY;
    c.prod = 1.0;
    int64_t fi = -1, la = -1;
    for (int64_t k = lo; k < hi; ++k) {
      double x;
      if (take(vrow, mrow, k, 0, x)) {
        c.cnt += 1;
        c.total += x;
        c.lo = fmin(c.lo, x);
        c.hi = fmax(c.hi, x);
        c.prod = __dmul_rn(c.prod, x);
        if (fi < 0) fi = k;
        la = k;
      }
    }
    if (c.cnt > 0) {
      c.m2 = 0.0;
      if (st.m2) {
        const double mean = __ddiv_rn(c.total, (double)c.cnt);
        for (int64_t k = lo; k < hi; ++k) {
          double x;
          if (take(vrow, mrow, k, 0, x)) {
            const double e = __dsub_rn(x, mean);
            c.m2 = __dadd_rn(c.m2, __dmul_rn(e, e));
          }
        }
      }
      c.first = vrow[fi];
      c.last = vrow[la];
      merge_cell(st, idx, cur, c);
    }
  }
  audit_count(au, first_tile, last_tile, vrow, mrow, apos);
}

}  // namespace

// ts, val (float64), mask: the chunk [s, n]; edges: the slice's wc + 1
// edges; the state is [s, w], the slice its columns [w0, w0 + wc); lane
// pointers may be null; oob null skips the audit.
extern "C" int stream_fold(const void* ts, const void* val, const void* mask, const void* edges,
                           long long s, long long n, int wc, long long w, long long w0,
                           void* n_state, void* total, void* m2, void* lo, void* hi,
                           void* first, void* last, void* prod, void* oob, long long grid_lo,
                           long long grid_hi, void* stream) {
  if (s <= 0 || wc <= 0 || n <= 0) return 0;
  cudaStream_t cs = (cudaStream_t)stream;
  const State st{(int64_t*)n_state, (double*)total, (double*)m2, (double*)lo,
                 (double*)hi,       (double*)first, (double*)last, (double*)prod};
  const Audit au{(unsigned long long*)oob, grid_lo, grid_hi};
  if (n >= (long long)WARP_MIN_RUN * wc) {
    const dim3 grid((unsigned)s, (unsigned)((wc + TILE_W - 1) / TILE_W));
    fold_long<<<grid, LONG_THREADS, 0, cs>>>((const int64_t*)ts, (const double*)val,
                                              (const uint8_t*)mask, (const int64_t*)edges, n, wc,
                                              w, w0, st, au);
  } else {
    const dim3 grid((unsigned)s, (unsigned)((wc + SHORT_THREADS - 1) / SHORT_THREADS));
    fold_short<<<grid, SHORT_THREADS, 0, cs>>>((const int64_t*)ts, (const double*)val,
                                          (const uint8_t*)mask, (const int64_t*)edges, n, wc,
                                          w, w0, st, au);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* stream_fold_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
