// P1 point_group_moments: raw points straight to [G, W] group-window
// moments, for any assignment of rows to groups.
//
// Replaces opentsdb_tpu/parallel/sharded.py:_group_moments (:52) and the
// per-chip segment reductions of _finish (:86), the body of
// sharded_group_downsample (:129) before its psum / pmin / pmax.  A point
// counts where its mask is set, it falls inside the windows (edges[0] <=
// ts < edges[W]) and its value, taken as f64, is not NaN; row r's points
// go to the cell (group of r, window).  Per (group, window) cell, by mode:
//
//   additive  the count (int64) and the sum (sum, zimsum, count, avg);
//   extreme   the count, the min and the max (min, mimmin, max, mimmax);
//   square    the count and the sum of squares v*v (squareSum);
//   centred   only the centred sum of squares (v - mean)^2 around the
//             cell's mean[G, W] (dev's second pass, the reference's
//             :112-122), into the sq lane.
//
// An empty cell holds the identities (0, 0, +inf, -inf, 0).
//
// Bound on the H100: bytes.  The function must read val (f64 or i64) and
// mask (u8) once, 9 bytes a point, ts only where a window edge falls, and
// write its [G, W] lanes once.  At 1024 x 65,536 points that is about 0.60
// GB, about 0.18 ms at 3.35 TB/s; dev's centred pass reads the points
// again.
//
// Design: the rows of a group need not be contiguous, so the wrapper
// builds a stable member list (members[], grouped by group in row order,
// and offsets[G + 1] into it; a CSR made on the device).  One block owns
// one (group, window tile) and is the only program that writes its cells:
// no atomics, no f64 atomics.  It takes the group's member rows a batch
// at a time.  Where runs are long (32 points a window and more on
// average: the headline's ~232 at 1h), the positions of every (member,
// edge) pair of the batch are found at once, a pair a thread, by
// seek_position (window_runs.cuh: an edge outside the row's first and
// last timestamps is clamped with no probe, any other reads the eight
// points around the line's guess in one round of loads); then a warp
// takes a (member, window) pair, its lanes striding the run eight loads
// deep (each lane's points in time order), reduces it with L1's butterfly
// tree, and puts the row's partial into shared memory, [members of the
// batch x tile]; each cell's thread then adds the batch's partials in row
// order.  A tile is 32 windows, so that the headline's 100 groups make
// 900 blocks, several resident on each SM.  Where runs are short a thread
// owns a window and adds each member's run in time order, the members in
// row order, after the batch's searches (Seek, four members in step)
// placed its edges.  Either way the order of every addition is fixed by
// the data alone, so a run gives the same bits every time.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "window_runs.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_W = 32;          // windows a block, warp form
constexpr int BATCH = 16;           // member rows a batch, warp form
constexpr int STEP_ROWS = 4;        // member rows searched in step, thread form
constexpr int DEPTH = 8;            // loads a lane has in flight, warp form
constexpr int WARP_MIN_RUN = 32;    // mean points a window for the warp form

enum Mode { ADDITIVE = 0, EXTREME = 1, SQUARE = 2, CENTRED = 3 };

struct Lanes {
  int64_t* cnt;
  double* tot;
  double* lo;
  double* hi;
  double* sq;
};

// The identities of a cell's first and second f64 accumulators.
__device__ __forceinline__ double ident_a(int mode) {
  return mode == EXTREME ? INFINITY : 0.0;
}

__device__ __forceinline__ double ident_b() { return -INFINITY; }

// Adds one point to the (count, a, b) accumulators of its mode.
__device__ __forceinline__ void add_point(int mode, double v, double mu,
                                          int& c, double& a, double& b) {
  c += 1;
  if (mode == EXTREME) {
    a = fmin(a, v);
    b = fmax(b, v);
  } else if (mode == SQUARE) {
    a += v * v;
  } else if (mode == CENTRED) {
    const double d = v - mu;
    a += d * d;
  } else {
    a += v;
  }
}

// Adds the point at k of a row if it takes part.
template <typename V>
__device__ __forceinline__ void add_slot(int mode, V x, uint8_t m, double mu,
                                         int& c, double& a, double& b) {
  const double v = (double)x;
  if (m && !isnan(v)) add_point(mode, v, mu, c, a, b);
}

// Folds a row's partial (c2, a2, b2) into a cell's accumulators.
__device__ __forceinline__ void fold(int mode, int64_t& c, double& a,
                                     double& b, int c2, double a2,
                                     double b2) {
  c += c2;
  if (mode == EXTREME) {
    a = fmin(a, a2);
    b = fmax(b, b2);
  } else {
    a += a2;
  }
}

__device__ __forceinline__ void write_cell(int mode, int64_t cell, int64_t c,
                                           double a, double b,
                                           const Lanes& out) {
  if (mode == CENTRED) {
    out.sq[cell] = a;
    return;
  }
  out.cnt[cell] = c;
  if (mode == EXTREME) {
    out.lo[cell] = a;
    out.hi[cell] = b;
  } else if (mode == SQUARE) {
    out.sq[cell] = a;
  } else {
    out.tot[cell] = a;
  }
}

// A warp a (member, window) pair; the batch's partials added to each
// cell in row order.  Block (g, y) covers TILE_W windows of group g.
template <typename V>
__global__ void __launch_bounds__(THREADS)
moments_warp(const int64_t* __restrict__ ts, const V* __restrict__ val,
             const uint8_t* __restrict__ mask,
             const int64_t* __restrict__ edges,
             const int64_t* __restrict__ members,
             const int64_t* __restrict__ offsets,
             const double* __restrict__ mean, int64_t n, int w, int mode,
             Lanes out) {
  __shared__ int64_t pos[BATCH][TILE_W + 1];
  __shared__ int part_c[BATCH][TILE_W];
  __shared__ double part_a[BATCH][TILE_W];
  __shared__ double part_b[BATCH][TILE_W];
  __shared__ double mu[TILE_W];
  const int64_t g = blockIdx.x;
  const int w0 = blockIdx.y * TILE_W;
  const int tw = min(TILE_W, w - w0);
  const int64_t r0 = offsets[g], r1 = offsets[g + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (mode == CENTRED && (int)threadIdx.x < tw)
    mu[threadIdx.x] = mean[g * w + w0 + threadIdx.x];
  int64_t acc_c = 0;             // thread j < tw owns cell j
  double acc_a = ident_a(mode), acc_b = ident_b();
  for (int64_t r = r0; r < r1; r += BATCH) {
    const int nb = (int)min((int64_t)BATCH, r1 - r);
    for (int q = threadIdx.x; q < nb * (tw + 1); q += THREADS) {
      const int mi = q / (tw + 1), i = q - mi * (tw + 1);
      const int64_t* trow = ts + members[r + mi] * n;
      pos[mi][i] = seek_position(trow, n, trow[0], trow[n - 1], edges[w0 + i]);
    }
    __syncthreads();   // the batch's positions are placed (and mu loaded)
    for (int q = warp; q < nb * tw; q += WARPS) {
      const int mi = q / tw, j = q - mi * tw;
      const int64_t row = members[r + mi];
      const V* vrow = val + row * n;
      const uint8_t* mrow = mask + row * n;
      const int64_t lo = pos[mi][j], hi = pos[mi][j + 1];
      const double mu_j = mode == CENTRED ? mu[j] : 0.0;
      int c = 0;
      double a = ident_a(mode), b = ident_b();
      for (int64_t k0 = lo + lane; k0 < hi; k0 += 32 * DEPTH) {
        // DEPTH loads a lane issued together, then added in time order
        V x[DEPTH];
        uint8_t m[DEPTH];
#pragma unroll
        for (int u = 0; u < DEPTH; ++u) {
          const int64_t k = k0 + 32 * u;
          m[u] = k < hi ? mrow[k] : 0;
          x[u] = k < hi ? vrow[k] : (V)0;
        }
#pragma unroll
        for (int u = 0; u < DEPTH; ++u) add_slot(mode, x[u], m[u], mu_j, c, a, b);
      }
      if (lo < hi) {   // the whole warp takes the branch together
        c = warp_sum_int(c);
        if (mode == EXTREME) {
          a = warp_min(a);
          b = warp_max(b);
        } else {
          a = warp_sum(a);
        }
      }
      if (lane == 0) {
        part_c[mi][j] = c;
        part_a[mi][j] = a;
        part_b[mi][j] = b;
      }
    }
    __syncthreads();   // the batch's partials are in
    if ((int)threadIdx.x < tw)
      for (int mi = 0; mi < nb; ++mi)
        fold(mode, acc_c, acc_a, acc_b, part_c[mi][threadIdx.x],
             part_a[mi][threadIdx.x], part_b[mi][threadIdx.x]);
  }
  if ((int)threadIdx.x < tw)
    write_cell(mode, g * (int64_t)w + w0 + threadIdx.x, acc_c, acc_a, acc_b,
               out);
}

// A thread a window: each member row's run added in time order, the rows
// in row order.  Block (g, y) covers THREADS windows of group g.
template <typename V>
__global__ void __launch_bounds__(THREADS)
moments_thread(const int64_t* __restrict__ ts, const V* __restrict__ val,
               const uint8_t* __restrict__ mask,
               const int64_t* __restrict__ edges,
               const int64_t* __restrict__ members,
               const int64_t* __restrict__ offsets,
               const double* __restrict__ mean, int64_t n, int w, int mode,
               Lanes out) {
  __shared__ int64_t pos[STEP_ROWS][THREADS + 1];
  const int64_t g = blockIdx.x;
  const int w0 = blockIdx.y * THREADS;
  const int tw = min(THREADS, w - w0);
  const int64_t r0 = offsets[g], r1 = offsets[g + 1];
  const int j = threadIdx.x;
  const double mu = (mode == CENTRED && j < tw) ? mean[g * w + w0 + j] : 0.0;
  int64_t c = 0;
  double a = ident_a(mode), b = ident_b();
  for (int64_t r = r0; r < r1; r += STEP_ROWS) {
    const int nb = (int)min((int64_t)STEP_ROWS, r1 - r);
    __syncthreads();   // the previous batch's runs are read
    for (int i = j; i <= tw; i += THREADS) {
      // the batch's rows searched in step: their probes are independent
      const int64_t x = edges[w0 + i];
      const int64_t* tr[STEP_ROWS];
      Seek sk[STEP_ROWS];
#pragma unroll
      for (int q = 0; q < STEP_ROWS; ++q) {
        tr[q] = ts + members[r + min(q, nb - 1)] * n;
        if (q < nb && n > 0) {
          sk[q].start(n, tr[q][0], tr[q][n - 1], x);
        } else {   // no such member, or no points: done
          sk[q].mode = 3;
          sk[q].hi = 0;
        }
      }
      bool busy = true;
      while (busy) {
        busy = false;
#pragma unroll
        for (int q = 0; q < STEP_ROWS; ++q) {
          if (sk[q].done()) continue;
          sk[q].take(tr[q][sk[q].probe()] < x);
          busy |= !sk[q].done();
        }
      }
#pragma unroll
      for (int q = 0; q < STEP_ROWS; ++q)
        if (q < nb) pos[q][i] = sk[q].hi;
    }
    __syncthreads();
    if (j < tw) {
      for (int q = 0; q < nb; ++q) {
        const int64_t row = members[r + q];
        const V* vrow = val + row * n;
        const uint8_t* mrow = mask + row * n;
        int rc = 0;
        for (int64_t k = pos[q][j]; k < pos[q][j + 1]; ++k)
          add_slot(mode, vrow[k], mrow[k], mu, rc, a, b);
        c += rc;
      }
    }
  }
  if (j < tw) write_cell(mode, g * (int64_t)w + w0 + j, c, a, b, out);
}

template <typename V>
int launch(const void* ts, const void* val, const void* mask,
           const void* edges, const void* members, const void* offsets,
           const void* mean, long long n, long long g, int w, int mode,
           Lanes out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n >= (long long)WARP_MIN_RUN * w) {
    const dim3 grid((unsigned)g, (unsigned)((w + TILE_W - 1) / TILE_W));
    moments_warp<V><<<grid, THREADS, 0, st>>>(
        (const int64_t*)ts, (const V*)val, (const uint8_t*)mask,
        (const int64_t*)edges, (const int64_t*)members,
        (const int64_t*)offsets, (const double*)mean, (int64_t)n, w, mode,
        out);
  } else {
    const dim3 grid((unsigned)g, (unsigned)((w + THREADS - 1) / THREADS));
    moments_thread<V><<<grid, THREADS, 0, st>>>(
        (const int64_t*)ts, (const V*)val, (const uint8_t*)mask,
        (const int64_t*)edges, (const int64_t*)members,
        (const int64_t*)offsets, (const double*)mean, (int64_t)n, w, mode,
        out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// ts[S, N] int64 (time-sorted rows), val[S, N] f64 (val_is_int 0) or
// int64 (1), mask[S, N] u8, edges[W + 1] int64, members[M] and
// offsets[G + 1] int64.  The lanes a mode does not write may be null; the
// centred mode reads mean[G, W] and writes only sq (its m2).
extern "C" int point_group_moments(const void* ts, const void* val,
                                   const void* mask, const void* edges,
                                   const void* members, const void* offsets,
                                   const void* mean, long long n, long long g,
                                   int w, int val_is_int, int mode, void* cnt,
                                   void* tot, void* lo, void* hi, void* sq,
                                   void* stream) {
  if (g <= 0 || w <= 0) return 0;
  if (mode < ADDITIVE || mode > CENTRED) return (int)cudaErrorInvalidValue;
  const Lanes out = {(int64_t*)cnt, (double*)tot, (double*)lo, (double*)hi,
                     (double*)sq};
  if (val_is_int)
    return launch<int64_t>(ts, val, mask, edges, members, offsets, mean, n,
                           g, w, mode, out, stream);
  return launch<double>(ts, val, mask, edges, members, offsets, mean, n, g,
                        w, mode, out, stream);
}

extern "C" const char* point_group_moments_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
