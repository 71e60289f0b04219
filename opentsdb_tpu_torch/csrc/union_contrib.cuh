// A member series' contribution at a union slot: the code that U2
// union_reduce and U3 union_order share.
//
// Port of opentsdb_tpu/ops/union_agg.py:_series_contribution and
// interpolate (AggregationIterator.java nextLongValue :682 /
// nextDoubleValue :735).  A member participates at slot x when x lies
// within its first and last timestamp; it contributes its value at x or,
// lacking one, the interpolation of the aggregator's policy between its
// points around x (LERP, ZIM, MAX/MIN_IF_MISSING, PREV).  float64 values
// skip NaN contributions; int64 values are int mode, Java long arithmetic,
// wrapping, with a truncating division in LERP.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace union_contrib {

enum Policy { LERP = 0, ZIM = 1, MAX_IF_MISSING = 2, MIN_IF_MISSING = 3, PREV = 4 };

constexpr int COUNT_THREADS = 128;

// Valid points of a row whose mask is a prefix of ones, one thread a row.
__global__ void row_counts_kernel(const uint8_t* __restrict__ mask, int64_t s, int64_t n,
                                  int64_t* __restrict__ counts) {
  const int64_t r = (int64_t)blockIdx.x * COUNT_THREADS + threadIdx.x;
  if (r >= s) return;
  const uint8_t* m = mask + r * n;
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (m[mid]) lo = mid + 1; else hi = mid;
  }
  counts[r] = lo;
}

// Launches row_counts_kernel on `stream`; the launch's error code.
inline cudaError_t row_counts(const void* mask, int64_t s, int64_t n, void* counts,
                              cudaStream_t stream) {
  row_counts_kernel<<<(unsigned)((s + COUNT_THREADS - 1) / COUNT_THREADS), COUNT_THREADS, 0,
                      stream>>>((const uint8_t*)mask, s, n, (int64_t*)counts);
  return cudaGetLastError();
}

__device__ __forceinline__ double interpolate(int policy, int64_t x, int64_t x0, double y0,
                                              int64_t x1, double y1) {
  switch (policy) {
    case LERP: {
      double dx = (double)(x1 - x0);
      if (dx == 0.0) dx = 1.0;
      return y0 + (double)(x - x0) * (y1 - y0) / dx;
    }
    case ZIM: return 0.0;
    case MAX_IF_MISSING: return DBL_MAX;
    case MIN_IF_MISSING: return -DBL_MAX;
    default: return y0;  // PREV
  }
}

__device__ __forceinline__ int64_t interpolate(int policy, int64_t x, int64_t x0, int64_t y0,
                                               int64_t x1, int64_t y1) {
  switch (policy) {
    case LERP: {
      const int64_t dx = x1 - x0 > 1 ? x1 - x0 : 1;
      const int64_t num = (int64_t)((uint64_t)(x - x0) * ((uint64_t)y1 - (uint64_t)y0));
      return (int64_t)((uint64_t)y0 + (uint64_t)(num / dx));
    }
    case ZIM: return 0;
    case MAX_IF_MISSING: return INT64_MAX;
    case MIN_IF_MISSING: return INT64_MIN;
    default: return y0;  // PREV
  }
}

__device__ __forceinline__ bool skipped(double v) { return isnan(v); }
__device__ __forceinline__ bool skipped(int64_t) { return false; }

// Index of the first of a row's c points at or after x.
__device__ __forceinline__ int64_t first_at_or_after(const int64_t* __restrict__ tr, int64_t c,
                                                     int64_t x) {
  int64_t lo = 0, hi = c;
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (tr[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The contribution at x of a participating member (x within its first and
// last point), whose first point at or after x is pos.  Every union slot
// is a timestamp of some member, so a member without a point at x has
// points on both sides of it.
template <typename V>
__device__ __forceinline__ V contribution(const int64_t* __restrict__ tr,
                                          const V* __restrict__ vr, int64_t pos, int64_t x,
                                          int policy) {
  return tr[pos] == x ? vr[pos]
                      : interpolate(policy, x, tr[pos - 1], vr[pos - 1], tr[pos], vr[pos]);
}

}  // namespace union_contrib
