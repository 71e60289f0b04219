// K4 window_order: per-(series, window) order and rank functions over
// time-sorted rows, then the fill policy.
//
// Replaces the order/rank branch of opentsdb_tpu/ops/downsample.py:
// downsample (:1165-1262: mult :1218, first/last/diff :1222, median and the
// LEGACY / R-3 / R-7 percentiles :1237 through ops/percentile.py:
// row_run_percentile and _estimate) and apply_fill.  Values are taken as
// float64 (an int64 row is converted first) and the output is float64
// (Downsampler.java:257); masked slots and NaN values take no part, and a
// window with none holds no data (mask = count > 0).
//
// Bound on the H100: bytes.  It must read val and mask once (9 B a point),
// ts only where a window edge falls, and write 9 B a window cell: 0.61 GB
// at the headline batch (1024 x 65,536 points, 283 1h windows), about
// 0.18 ms at 3.35 TB/s.  A rank function reads its window's run once more
// per radix pass (order_stats.cuh: eight, plus one for a second order
// statistic), from L1/L2 for a 1h window, from device memory for a
// 65,536-point "0all" run.
//
// Design: one warp owns one (row, window) cell.  Its lanes find the window's
// contiguous run by binary search over the edges, as K1 does, then reduce
// the run with the shared warp routine (order_stats::warp_order): first,
// last and diff from one strided pass, mult by one lane in time order (the
// reference's order: an overflow to inf before or after a zero is NaN or
// 0), median and percentiles by radix select.  Each cell has one writer:
// no atomics, deterministic results.
//
// Stacked form (B14, opentsdb_tpu/ops/pipeline.py:225, as K1's): Q members'
// batches are one [Q*S, N] batch and edges is [Q, W+1]; row r reads the
// edges of member r / rows_per_member.  A solo call passes
// rows_per_member = S and one edge row: one code path, so a stacked cell is
// bit for bit its solo cell.
//
// Int32 form (B10, as K1's): ts holds int32 offsets from the query's first
// window and edges the re-based [W+1] edges; the two binary searches read
// 4-byte words and find the same runs, so every cell is bit for bit the
// int64 form's.  The stacked launches stay int64.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "order_stats.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps, 8 cells a block
constexpr int WARPS = THREADS / 32;

// Number of row entries strictly below `key` (searchsorted side="left");
// T is int64 ms or int32 offsets from a base.
template <typename T>
__device__ __forceinline__ int64_t lower_bound(const T* row, int64_t n, T key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (row[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T, typename VIn>
__global__ void __launch_bounds__(THREADS)
window_order_kernel(const T* __restrict__ ts, const VIn* __restrict__ val,
                    const uint8_t* __restrict__ mask, const T* __restrict__ edges,
                    int64_t s, int64_t n, int w, int64_t rows_per_member, int code,
                    double q, int est, int fill_mode,
                    double fill_value, double* __restrict__ out,
                    uint8_t* __restrict__ out_mask) {
  __shared__ unsigned hist[WARPS][order_stats::BINS];
  const int warp = threadIdx.x >> 5;
  const int64_t cell = (int64_t)blockIdx.x * WARPS + warp;
  if (cell >= s * w) return;  // a whole warp leaves together
  const int64_t row = cell / w;
  const int wi = (int)(cell - row * w);
  const T* trow = ts + row * n;
  const VIn* vrow = val + row * n;
  const uint8_t* mrow = mask + row * n;
  // this row's member's window edges
  const T* medges = edges + (row / rows_per_member) * (int64_t)(w + 1);
  const int64_t lo = lower_bound(trow, n, medges[wi]);
  const int64_t hi = lower_bound(trow, n, medges[wi + 1]);
  auto get = [&](int64_t i, double& v) {
    const int64_t k = lo + i;
    if (!mrow[k]) return false;
    v = (double)vrow[k];
    return !isnan(v);
  };
  int64_t cnt;
  const double res = order_stats::warp_order<double>(get, hi - lo, code, q, est,
                                                     hist[warp], cnt);
  if ((threadIdx.x & 31) == 0) {
    const bool has = cnt > 0;
    out[cell] = has ? res : (fill_mode ? fill_value : NAN);
    // FILL_NONE exposes windows holding data; a fill exposes every one
    out_mask[cell] = (has || fill_mode) ? 1 : 0;
  }
}

template <typename T, typename VIn>
int launch(const void* ts, const void* val, const void* mask, const void* edges, long long s,
           long long n, int w, long long rows_per_member, int code, double q, int est,
           int fill_mode, double fill_value, void* out, void* out_mask, void* stream) {
  if (s <= 0 || w <= 0 || rows_per_member <= 0) return 0;
  const long long blocks = (s * w + WARPS - 1) / WARPS;
  window_order_kernel<T, VIn><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)ts, (const VIn*)val, (const uint8_t*)mask, (const T*)edges, s, n, w,
      (int64_t)rows_per_member, code, q, est, fill_mode, fill_value, (double*)out,
      (uint8_t*)out_mask);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ts(const void* ts, const void* val, const void* mask, const void* edges,
              long long s, long long n, int w, long long rows_per_member, int code,
              double q, int est, int fill_mode, double fill_value, int val_is_int,
              void* out, void* out_mask, void* stream) {
  if (val_is_int)
    return launch<T, int64_t>(ts, val, mask, edges, s, n, w, rows_per_member, code, q, est,
                              fill_mode, fill_value, out, out_mask, stream);
  return launch<T, double>(ts, val, mask, edges, s, n, w, rows_per_member, code, q, est,
                           fill_mode, fill_value, out, out_mask, stream);
}

}  // namespace

// code: order_stats::Order; q and est: the percentile and its estimator
// (order_stats::Est); val_is_int selects float64 (0) or int64 (1) rows;
// ts_is_i32 the timestamp type of ts and edges: int64 ms (0) or int32
// offsets from a base (1); edges holds s / rows_per_member rows of w + 1
// edges.
extern "C" int window_order(const void* ts, const void* val, const void* mask,
                            const void* edges, long long s, long long n, int w,
                            long long rows_per_member, int code, double q, int est,
                            int fill_mode, double fill_value, int val_is_int,
                            int ts_is_i32, void* out, void* out_mask, void* stream) {
  if (ts_is_i32)
    return launch_ts<int32_t>(ts, val, mask, edges, s, n, w, rows_per_member, code, q,
                              est, fill_mode, fill_value, val_is_int, out, out_mask,
                              stream);
  return launch_ts<int64_t>(ts, val, mask, edges, s, n, w, rows_per_member, code, q, est,
                            fill_mode, fill_value, val_is_int, out, out_mask, stream);
}

extern "C" const char* window_order_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
