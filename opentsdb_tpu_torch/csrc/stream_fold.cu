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
// Design: L1's (csrc/lane_partials.cu).  One block owns one row and a tile
// of windows and finds the tile's edge positions by binary search
// (window_runs.cuh).  Where runs are long (32 points a window on average
// and more) a warp reduces a window, lanes striding the run and butterfly
// trees combining them; where they are short (config 2: a point a 10 s
// window) a thread reduces a window in time order.  The merge is written
// with explicitly rounded operations (no fused multiply-add), as the plain
// version computes it.  One program owns each cell: no atomics but the
// audit's integer add.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "window_runs.cuh"

namespace {

constexpr int TILE_W = 64;          // windows per block, warp mode
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WARP_MIN_RUN = 32;    // mean points a window for warp mode

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

// One chunk cell's moments.
struct Cell {
  int cnt;
  double total, m2, lo, hi, first, last, prod;
};

__device__ __forceinline__ void merge_cell(const State& st, int64_t idx, const Cell& c) {
  if (c.cnt == 0) return;
  const int64_t n1 = st.n[idx];
  const int64_t n = n1 + c.cnt;
  st.n[idx] = n;
  if (st.total) {
    const double t1 = st.total[idx];
    st.total[idx] = __dadd_rn(t1, c.total);
    if (st.m2) {
      const double nf1 = (double)n1, nf2 = (double)c.cnt;
      const double mean1 = __ddiv_rn(t1, fmax(nf1, 1.0));
      const double mean2 = __ddiv_rn(c.total, nf2);
      const double delta = n1 > 0 ? __dsub_rn(mean2, mean1) : 0.0;
      const double term = __ddiv_rn(
          __dmul_rn(__dmul_rn(__dmul_rn(delta, delta), nf1), nf2), (double)n);
      st.m2[idx] = __dadd_rn(__dadd_rn(st.m2[idx], c.m2), term);
    }
  }
  if (st.lo) st.lo[idx] = fmin(st.lo[idx], c.lo);
  if (st.hi) st.hi[idx] = fmax(st.hi[idx], c.hi);
  if (st.first && n1 == 0) st.first[idx] = c.first;
  if (st.last) st.last[idx] = c.last;
  if (st.prod) st.prod[idx] = __dmul_rn(st.prod[idx], c.prod);
}

__device__ __forceinline__ bool take(const double* vrow, const uint8_t* mrow, int64_t k,
                                     double& v) {
  v = vrow[k];
  return mrow[k] && !isnan(v);
}

__device__ __forceinline__ long long warp_min_ll(long long x) {
  for (int off = 16; off > 0; off >>= 1) {
    const long long y = __shfl_xor_sync(0xffffffffu, x, off);
    x = y < x ? y : x;
  }
  return x;
}

__device__ __forceinline__ long long warp_max_ll(long long x) {
  for (int off = 16; off > 0; off >>= 1) {
    const long long y = __shfl_xor_sync(0xffffffffu, x, off);
    x = y > x ? y : x;
  }
  return x;
}

// A warp a window.
__global__ void __launch_bounds__(THREADS)
fold_warp(const int64_t* __restrict__ ts, const double* __restrict__ val,
          const uint8_t* __restrict__ mask, const int64_t* __restrict__ edges, int64_t n,
          int wc, int64_t w, int64_t w0, State st) {
  __shared__ int64_t pos[TILE_W + 1];
  const int64_t row = blockIdx.x;
  const int t0 = blockIdx.y * TILE_W;
  const int tw = min(TILE_W, wc - t0);
  const int64_t* trow = ts + row * n;
  const double* vrow = val + row * n;
  const uint8_t* mrow = mask + row * n;
  for (int i = threadIdx.x; i <= tw; i += THREADS) pos[i] = lower_bound(trow, n, edges[t0 + i]);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = warp; j < tw; j += WARPS) {
    const int64_t lo = pos[j], hi = pos[j + 1];
    Cell c;
    c.cnt = 0;
    c.total = 0.0;
    c.lo = INFINITY;
    c.hi = -INFINITY;
    long long fi = hi, la = -1;
    for (int64_t k = lo + lane; k < hi; k += 32) {
      double v;
      if (take(vrow, mrow, k, v)) {
        c.cnt += 1;
        c.total += v;
        c.lo = fmin(c.lo, v);
        c.hi = fmax(c.hi, v);
        fi = k < fi ? k : fi;
        la = k;
      }
    }
    c.cnt = warp_sum_int(c.cnt);
    if (c.cnt == 0) continue;  // the whole warp leaves the cell together
    c.total = warp_sum(c.total);
    c.lo = warp_min(c.lo);
    c.hi = warp_max(c.hi);
    fi = warp_min_ll(fi);
    la = warp_max_ll(la);
    c.m2 = 0.0;
    if (st.m2) {
      const double mean = __ddiv_rn(c.total, (double)c.cnt);
      for (int64_t k = lo + lane; k < hi; k += 32) {
        double v;
        if (take(vrow, mrow, k, v)) {
          const double d = __dsub_rn(v, mean);
          c.m2 = __dadd_rn(c.m2, __dmul_rn(d, d));
        }
      }
      c.m2 = warp_sum(c.m2);
    }
    c.first = vrow[fi];
    c.last = vrow[la];
    c.prod = 1.0;
    if (lane == 0) {
      if (st.prod) {
        // one lane multiplies in time order, as the reference's segment
        // product over a time-sorted run does
        for (int64_t k = fi; k <= la; ++k) {
          double v;
          if (take(vrow, mrow, k, v)) c.prod = __dmul_rn(c.prod, v);
        }
      }
      merge_cell(st, row * w + w0 + t0 + j, c);
    }
  }
}

// A thread a window, in time order, for short runs.  Block (x, y) covers
// THREADS windows of row x.
__global__ void __launch_bounds__(THREADS)
fold_thread(const int64_t* __restrict__ ts, const double* __restrict__ val,
            const uint8_t* __restrict__ mask, const int64_t* __restrict__ edges, int64_t n,
            int wc, int64_t w, int64_t w0, State st) {
  __shared__ int64_t pos[THREADS + 1];
  const int64_t row = blockIdx.x;
  const int t0 = blockIdx.y * THREADS;
  const int tw = min(THREADS, wc - t0);
  const int64_t* trow = ts + row * n;
  const double* vrow = val + row * n;
  const uint8_t* mrow = mask + row * n;
  for (int i = threadIdx.x; i <= tw; i += THREADS) pos[i] = lower_bound(trow, n, edges[t0 + i]);
  __syncthreads();
  const int j = threadIdx.x;
  if (j >= tw) return;
  const int64_t lo = pos[j], hi = pos[j + 1];
  Cell c;
  c.cnt = 0;
  c.total = 0.0;
  c.lo = INFINITY;
  c.hi = -INFINITY;
  c.prod = 1.0;
  int64_t fi = -1, la = -1;
  for (int64_t k = lo; k < hi; ++k) {
    double v;
    if (take(vrow, mrow, k, v)) {
      c.cnt += 1;
      c.total += v;
      c.lo = fmin(c.lo, v);
      c.hi = fmax(c.hi, v);
      c.prod = __dmul_rn(c.prod, v);
      if (fi < 0) fi = k;
      la = k;
    }
  }
  if (c.cnt == 0) return;
  c.m2 = 0.0;
  if (st.m2) {
    const double mean = __ddiv_rn(c.total, (double)c.cnt);
    for (int64_t k = lo; k < hi; ++k) {
      double v;
      if (take(vrow, mrow, k, v)) {
        const double d = __dsub_rn(v, mean);
        c.m2 = __dadd_rn(c.m2, __dmul_rn(d, d));
      }
    }
  }
  c.first = vrow[fi];
  c.last = vrow[la];
  merge_cell(st, row * w + w0 + t0 + j, c);
}

// The audit: a warp a row counts the valid points in [grid_lo, edges[0])
// and [edges[wc], grid_hi), the grid's points the slice does not hold.
__global__ void __launch_bounds__(THREADS)
fold_audit(const int64_t* __restrict__ ts, const double* __restrict__ val,
           const uint8_t* __restrict__ mask, const int64_t* __restrict__ edges, int64_t s,
           int64_t n, int wc, int64_t grid_lo, int64_t grid_hi,
           unsigned long long* __restrict__ oob) {
  const int64_t row = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= s) return;  // a whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int64_t* trow = ts + row * n;
  const double* vrow = val + row * n;
  const uint8_t* mrow = mask + row * n;
  const int64_t a0 = lower_bound(trow, n, grid_lo);
  const int64_t a1 = lower_bound(trow, n, max(edges[0], grid_lo));
  const int64_t b0 = lower_bound(trow, n, min(edges[wc], grid_hi));
  const int64_t b1 = lower_bound(trow, n, grid_hi);
  int cnt = 0;
  for (int64_t k = a0 + lane; k < a1; k += 32) {
    double v;
    cnt += take(vrow, mrow, k, v) ? 1 : 0;
  }
  for (int64_t k = b0 + lane; k < b1; k += 32) {
    double v;
    cnt += take(vrow, mrow, k, v) ? 1 : 0;
  }
  cnt = warp_sum_int(cnt);
  if (lane == 0 && cnt > 0) atomicAdd(oob, (unsigned long long)cnt);
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
  if (s <= 0 || wc <= 0) return 0;
  cudaStream_t cs = (cudaStream_t)stream;
  const State st{(int64_t*)n_state, (double*)total, (double*)m2, (double*)lo,
                 (double*)hi,       (double*)first, (double*)last, (double*)prod};
  if (n >= (long long)WARP_MIN_RUN * wc) {
    const dim3 grid((unsigned)s, (unsigned)((wc + TILE_W - 1) / TILE_W));
    fold_warp<<<grid, THREADS, 0, cs>>>((const int64_t*)ts, (const double*)val,
                                         (const uint8_t*)mask, (const int64_t*)edges, n, wc,
                                         w, w0, st);
  } else {
    const dim3 grid((unsigned)s, (unsigned)((wc + THREADS - 1) / THREADS));
    fold_thread<<<grid, THREADS, 0, cs>>>((const int64_t*)ts, (const double*)val,
                                           (const uint8_t*)mask, (const int64_t*)edges, n,
                                           wc, w, w0, st);
  }
  if (oob != nullptr) {
    const long long blocks = (s + WARPS - 1) / WARPS;
    fold_audit<<<(unsigned)blocks, THREADS, 0, cs>>>(
        (const int64_t*)ts, (const double*)val, (const uint8_t*)mask, (const int64_t*)edges,
        s, n, wc, grid_lo, grid_hi, (unsigned long long*)oob);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* stream_fold_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
