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
// no atomics, no f64 atomics.  It walks the group's member rows in row
// order; for each it finds the tile's edge positions in the row by binary
// search (window_runs.cuh, as L1 does) and adds each window's run.  Where
// runs are long (32 points a window and more on average) a warp reduces a
// window's run of the row with L1's butterfly tree and lane 0 adds the
// row's partial to the cell's accumulator in shared memory; where runs are
// short each thread owns one window and adds its points in time order.
// Either way the order of every addition is fixed by the data alone, so a
// run gives the same bits every time.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "window_runs.cuh"

namespace {

constexpr int TILE_W = 64;          // windows per block, warp mode
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WARP_MIN_RUN = 32;    // mean points a window for warp mode

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

// A warp a window of each member row; the row's partials added to the
// block's accumulators in row order.
template <typename V>
__global__ void __launch_bounds__(THREADS)
moments_warp(const int64_t* __restrict__ ts, const V* __restrict__ val,
             const uint8_t* __restrict__ mask,
             const int64_t* __restrict__ edges,
             const int64_t* __restrict__ members,
             const int64_t* __restrict__ offsets,
             const double* __restrict__ mean, int64_t n, int w, int mode,
             Lanes out) {
  __shared__ int64_t pos[TILE_W + 1];
  __shared__ int64_t acc_c[TILE_W];
  __shared__ double acc_a[TILE_W];
  __shared__ double acc_b[TILE_W];
  const int64_t g = blockIdx.x;
  const int w0 = blockIdx.y * TILE_W;
  const int tw = min(TILE_W, w - w0);
  const int64_t r0 = offsets[g], r1 = offsets[g + 1];
  for (int j = threadIdx.x; j < tw; j += THREADS) {
    acc_c[j] = 0;
    acc_a[j] = ident_a(mode);
    acc_b[j] = ident_b();
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int64_t r = r0; r < r1; ++r) {
    const int64_t row = members[r];
    const int64_t* trow = ts + row * n;
    const V* vrow = val + row * n;
    const uint8_t* mrow = mask + row * n;
    __syncthreads();   // the previous row's runs are read
    for (int i = threadIdx.x; i <= tw; i += THREADS)
      pos[i] = lower_bound(trow, n, edges[w0 + i]);
    __syncthreads();
    for (int j = warp; j < tw; j += WARPS) {
      const int64_t lo = pos[j], hi = pos[j + 1];
      if (lo >= hi) continue;   // the whole warp skips together
      const double mu = mode == CENTRED ? mean[g * w + w0 + j] : 0.0;
      int c = 0;
      double a = ident_a(mode), b = ident_b();
      for (int64_t k = lo + lane; k < hi; k += 32) {
        const double v = (double)vrow[k];
        if (mrow[k] && !isnan(v)) add_point(mode, v, mu, c, a, b);
      }
      c = warp_sum_int(c);
      if (mode == EXTREME) {
        a = warp_min(a);
        b = warp_max(b);
      } else {
        a = warp_sum(a);
      }
      if (lane == 0) {
        acc_c[j] += c;
        if (mode == EXTREME) {
          acc_a[j] = fmin(acc_a[j], a);
          acc_b[j] = fmax(acc_b[j], b);
        } else {
          acc_a[j] += a;
        }
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < tw; j += THREADS)
    write_cell(mode, g * (int64_t)w + w0 + j, acc_c[j], acc_a[j], acc_b[j],
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
  __shared__ int64_t pos[THREADS + 1];
  const int64_t g = blockIdx.x;
  const int w0 = blockIdx.y * THREADS;
  const int tw = min(THREADS, w - w0);
  const int64_t r0 = offsets[g], r1 = offsets[g + 1];
  const int j = threadIdx.x;
  const double mu = (mode == CENTRED && j < tw) ? mean[g * w + w0 + j] : 0.0;
  int64_t c = 0;
  double a = ident_a(mode), b = ident_b();
  for (int64_t r = r0; r < r1; ++r) {
    const int64_t row = members[r];
    const int64_t* trow = ts + row * n;
    const V* vrow = val + row * n;
    const uint8_t* mrow = mask + row * n;
    __syncthreads();   // the previous row's runs are read
    for (int i = threadIdx.x; i <= tw; i += THREADS)
      pos[i] = lower_bound(trow, n, edges[w0 + i]);
    __syncthreads();
    if (j < tw) {
      int rc = 0;
      for (int64_t k = pos[j]; k < pos[j + 1]; ++k) {
        const double v = (double)vrow[k];
        if (mrow[k] && !isnan(v)) add_point(mode, v, mu, rc, a, b);
      }
      c += rc;
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
