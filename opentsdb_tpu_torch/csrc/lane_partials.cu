// L1 lane_partials: the mergeable partials of every (series, window) cell
// over time-sorted rows: sum (f64), count (int32), min and max (f64).
//
// Replaces opentsdb_tpu/ops/pipeline.py:_lane_partials (the segment
// sums, min and max of the rollup-lane block builder and of the rollup
// job).  Masked points and NaN values take no part; an empty cell holds
// (0, 0, +inf, -inf), the identities under which cells merge.
//
// Bound on the H100: bytes.  The function must read val (f64 or i64) and
// mask (u8) once, 9 bytes a point, ts only where a window edge falls, and
// write 28 bytes a cell.  At 1024 x 65,536 points that is about 0.61 GB
// under 1h windows (W = 283), about 0.18 ms at 3.35 TB/s, and about 1.09
// GB under 1m windows (W ~ 16,930), about 0.33 ms.
//
// Design: K1's (csrc/window_moments.cu).  One block owns one row and a
// tile of TILE_W windows, finds the tile's edge positions by binary search
// (window_runs.cuh), and reduces each window's run.  Where runs are long
// (32 points a window and more on average) a warp reduces a window, lanes
// striding the run and a butterfly tree combining them: the same
// arithmetic in the same order as K1, so a cell's sum, count, min and max
// equal K1's sum, count, min and max of that window bit for bit on any
// data.  Where runs are short (1m windows over a 15 s cadence hold about
// 4 points) a warp would idle 28 of its lanes, so each thread reduces one
// window in time order; on integer data (exact f64 sums) the cells are
// again K1's bit for bit.  One program writes each cell: no atomics.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "window_runs.cuh"

namespace {

constexpr int TILE_W = 64;          // windows per block, warp mode
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WARP_MIN_RUN = 32;    // mean points a window for warp mode

__device__ __forceinline__ void write_cell(int64_t cell, int cnt, double sum,
                                           double mn, double mx,
                                           double* sums, int* counts,
                                           double* mins, double* maxs) {
  sums[cell] = sum;
  counts[cell] = cnt;
  mins[cell] = mn;
  maxs[cell] = mx;
}

// A warp a window: K1's reduction.
template <typename V>
__global__ void __launch_bounds__(THREADS)
lane_partials_warp(const int64_t* __restrict__ ts, const V* __restrict__ val,
                   const uint8_t* __restrict__ mask,
                   const int64_t* __restrict__ edges, int64_t n, int w,
                   double* __restrict__ sums, int* __restrict__ counts,
                   double* __restrict__ mins, double* __restrict__ maxs) {
  __shared__ int64_t pos[TILE_W + 1];
  const int64_t row = blockIdx.x;
  const int w0 = blockIdx.y * TILE_W;
  const int tw = min(TILE_W, w - w0);
  const int64_t* trow = ts + row * n;
  const V* vrow = val + row * n;
  const uint8_t* mrow = mask + row * n;
  for (int i = threadIdx.x; i <= tw; i += THREADS)
    pos[i] = lower_bound(trow, n, edges[w0 + i]);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = warp; j < tw; j += WARPS) {
    const int64_t lo = pos[j], hi = pos[j + 1];
    int cnt = 0;
    double sum = 0.0, mn = INFINITY, mx = -INFINITY;
    for (int64_t k = lo + lane; k < hi; k += 32) {
      const double v = (double)vrow[k];
      if (mrow[k] && !isnan(v)) {
        cnt += 1;
        sum += v;
        mn = fmin(mn, v);
        mx = fmax(mx, v);
      }
    }
    cnt = warp_sum_int(cnt);
    sum = warp_sum(sum);
    mn = warp_min(mn);
    mx = warp_max(mx);
    if (lane == 0)
      write_cell(row * (int64_t)w + w0 + j, cnt, sum, mn, mx, sums,
                    counts, mins, maxs);
  }
}

// A thread a window, in time order, for short runs.  Block (x, y) covers
// THREADS windows of row x.
template <typename V>
__global__ void __launch_bounds__(THREADS)
lane_partials_thread(const int64_t* __restrict__ ts,
                     const V* __restrict__ val,
                     const uint8_t* __restrict__ mask,
                     const int64_t* __restrict__ edges, int64_t n, int w,
                     double* __restrict__ sums, int* __restrict__ counts,
                     double* __restrict__ mins, double* __restrict__ maxs) {
  __shared__ int64_t pos[THREADS + 1];
  const int64_t row = blockIdx.x;
  const int w0 = blockIdx.y * THREADS;
  const int tw = min(THREADS, w - w0);
  const int64_t* trow = ts + row * n;
  const V* vrow = val + row * n;
  const uint8_t* mrow = mask + row * n;
  for (int i = threadIdx.x; i <= tw; i += THREADS)
    pos[i] = lower_bound(trow, n, edges[w0 + i]);
  __syncthreads();
  const int j = threadIdx.x;
  if (j >= tw) return;
  int cnt = 0;
  double sum = 0.0, mn = INFINITY, mx = -INFINITY;
  for (int64_t k = pos[j]; k < pos[j + 1]; ++k) {
    const double v = (double)vrow[k];
    if (mrow[k] && !isnan(v)) {
      cnt += 1;
      sum += v;
      mn = fmin(mn, v);
      mx = fmax(mx, v);
    }
  }
  write_cell(row * (int64_t)w + w0 + j, cnt, sum, mn, mx, sums, counts,
                mins, maxs);
}

template <typename V>
int launch(const void* ts, const void* val, const void* mask,
           const void* edges, long long s, long long n, int w, void* sums,
           void* counts, void* mins, void* maxs, void* stream) {
  if (s <= 0 || w <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (n >= (long long)WARP_MIN_RUN * w) {
    const dim3 grid((unsigned)s, (unsigned)((w + TILE_W - 1) / TILE_W));
    lane_partials_warp<V><<<grid, THREADS, 0, st>>>(
        (const int64_t*)ts, (const V*)val, (const uint8_t*)mask,
        (const int64_t*)edges, (int64_t)n, w, (double*)sums, (int*)counts,
        (double*)mins, (double*)maxs);
  } else {
    const dim3 grid((unsigned)s, (unsigned)((w + THREADS - 1) / THREADS));
    lane_partials_thread<V><<<grid, THREADS, 0, st>>>(
        (const int64_t*)ts, (const V*)val, (const uint8_t*)mask,
        (const int64_t*)edges, (int64_t)n, w, (double*)sums, (int*)counts,
        (double*)mins, (double*)maxs);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// val_is_int selects the value type: float64 (0) or exact int64 (1) rows.
extern "C" int lane_partials(const void* ts, const void* val, const void* mask,
                             const void* edges, long long s, long long n,
                             int w, int val_is_int, void* sums, void* counts,
                             void* mins, void* maxs, void* stream) {
  if (val_is_int)
    return launch<int64_t>(ts, val, mask, edges, s, n, w, sums, counts, mins,
                           maxs, stream);
  return launch<double>(ts, val, mask, edges, s, n, w, sums, counts, mins,
                        maxs, stream);
}

extern "C" const char* lane_partials_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
