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

// The same contribution from the points around x already in registers:
// (x1, y1) the first point at or after x, (x0, y0) the one before it.
template <typename V>
__device__ __forceinline__ V contribution(int64_t x, int64_t x0, V y0, int64_t x1, V y1,
                                          int policy) {
  return x1 == x ? y1 : interpolate(policy, x, x0, y0, x1, y1);
}

// The contribution of row base / n (ts + base, val + base, c valid points)
// at x, with a binary search and no state; false where the member does not
// take part (x outside its points, or a NaN value).
template <typename V>
__device__ __forceinline__ bool contribution_at(const int64_t* __restrict__ ts,
                                                const V* __restrict__ val, int64_t base,
                                                int64_t c, int64_t x, int policy, V& v) {
  const int64_t* tr = ts + base;
  if (c <= 0 || x < tr[0] || x > tr[c - 1]) return false;
  v = contribution(tr, val + base, first_at_or_after(tr, c, x), x, policy);
  return !skipped(v);
}

// A member's cursor over ascending slots: the points around the last slot
// asked for stay in registers, and the cursor walks its row forward as the
// slots advance (one step a point passed, so a row that repeats a
// timestamp costs one step more, not a search).  at() gives exactly what
// contribution_at gives for the same x.  AHEAD keeps the point after them
// loaded too, so that a step waits on no load issued at that step.
template <typename V, bool AHEAD = false>
struct Cursor {
  int64_t base = 0, pos = 0, c = 0;
  int64_t lo = INT64_MAX, hi = INT64_MIN;  // first and last timestamps (none: empty)
  int64_t x0 = 0, x1 = 0, x2 = INT64_MAX;
  V y0 = 0, y1 = 0, y2 = 0;

  // Row base / n with c valid points, placed at the first point at or
  // after x.
  __device__ void start(const int64_t* __restrict__ ts, const V* __restrict__ val,
                        int64_t row_base, int64_t count, int64_t x) {
    base = row_base;
    c = count;
    if (c <= 0) return;
    const int64_t* tr = ts + base;
    lo = tr[0];
    hi = tr[c - 1];
    pos = first_at_or_after(tr, c, x);
    if (pos < c) {
      x1 = tr[pos];
      y1 = val[base + pos];
    }
    if (pos > 0) {
      x0 = tr[pos - 1];
      y0 = val[base + pos - 1];
    }
    if (AHEAD && pos + 1 < c) {
      x2 = tr[pos + 1];
      y2 = val[base + pos + 1];
    }
  }

  // The contribution at x, no earlier than the last x asked for; false
  // where the member does not take part.
  __device__ __forceinline__ bool at(const int64_t* __restrict__ ts, const V* __restrict__ val,
                                     int64_t x, int policy, V& v) {
    if (x < lo || x > hi) return false;
    while (x1 < x) {  // x <= hi: the walk stops inside the row
      x0 = x1;
      y0 = y1;
      ++pos;
      if constexpr (AHEAD) {
        x1 = x2;
        y1 = y2;
        if (pos + 1 < c) {
          x2 = ts[base + pos + 1];
          y2 = val[base + pos + 1];
        }
      } else {
        x1 = ts[base + pos];
        y1 = val[base + pos];
      }
    }
    v = contribution(x, x0, y0, x1, y1, policy);
    return !skipped(v);
  }
};

}  // namespace union_contrib
