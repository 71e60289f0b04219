// The window-run searches and the warp reductions that K1 window_moments,
// L1 lane_partials, L2 rollup_avg, S1 stream_fold, S2 sketch_fold, P1
// point_group_moments and U2 union_reduce share.
//
// Rows are time-sorted (pads at int64 max sort last), so the points of a
// window [e[w], e[w+1]) are the contiguous run [lower_bound(e[w]),
// lower_bound(e[w+1])) of their row.  The reductions are butterfly trees
// over a warp: every lane ends with the same result, and a given set of
// lane values gives the same result on every run.
#pragma once
#include <math.h>
#include <stdint.h>

// Number of row entries strictly below `key` (searchsorted side="left").
// T is the timestamp type: int64 ms, or the int32 offsets from a base
// that the device cache's re-based gather writes (pads at 2^31 - 2) with
// edges re-based alike; both give the same positions on the same points.
template <typename T>
__device__ __forceinline__ int64_t lower_bound(const T* row, int64_t n, T key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (row[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The search of a row of c time-sorted points (first f, last l) for the
// first point at or after x: a probe where the line from (0, f) to
// (c - 1, l) puts x, then probes stepping away from it by doubling
// strides until they bracket x, then bisection; the answer is hi.  A
// series at a steady cadence is found in a few probes, any other in
// about twice a bisection's.  probe() is the next index to read, take()
// its verdict (the point lies before x).
struct Seek {
  int64_t x, lo, hi, next, step;  // tr[lo] < x <= tr[hi] while searching
  int mode;                       // 2 the line's probe, 1 up, -1 down, 0 bisect, 3 done

  __device__ __forceinline__ void start(int64_t c, int64_t f, int64_t l, int64_t xx) {
    x = xx;
    mode = 3;
    if (x <= f) { hi = 0; return; }
    if (x > l) { hi = c; return; }
    lo = 0;  // f < x <= l: c >= 2 and the answer lies in [1, c - 1]
    hi = c - 1;
    const int64_t g = (int64_t)((double)(x - f) / (double)(l - f) * (double)(c - 1));
    next = g < 1 ? 1 : (g > c - 1 ? c - 1 : g);
    mode = 2;
    settle();
  }
  __device__ __forceinline__ bool done() const { return mode == 3; }
  __device__ __forceinline__ int64_t probe() const {
    return mode == 0 ? (lo + hi) >> 1 : next;
  }
  // a stride that passes the bracket, or a bracket of adjacent points,
  // turns the search to bisection or ends it
  __device__ __forceinline__ void settle() {
    if ((mode == 1 && next >= hi) || (mode == -1 && next <= lo)) mode = 0;
    if (mode == 0 && hi - lo <= 1) mode = 3;
  }
  __device__ __forceinline__ void take(bool below) {
    const int64_t p = probe();
    if (mode == 0) {
      if (below) lo = p; else hi = p;
    } else if (mode == 2) {
      step = 1;
      if (below) { lo = p; next = p + 1; mode = 1; }
      else { hi = p; next = p - 1; mode = -1; }
    } else if (mode == 1) {
      if (below) { lo = p; step *= 2; next = p + step; }
      else { hi = p; mode = 0; }
    } else {
      if (!below) { hi = p; step *= 2; next = p - step; }
      else { lo = p; mode = 0; }
    }
    settle();
  }
};

// The first of a row's c time-sorted points at or after x (lower_bound),
// f and l the row's first and last timestamps.  A key outside [f, l] is
// clamped with no probe.  Any other reads the eight points around the
// line's guess (as Seek's first probe places it) with one round of
// independent loads, which brackets x at a steady cadence; where they do
// not, a bisection of the side they leave finds it.
__device__ __forceinline__ int64_t seek_position(const int64_t* row, int64_t c, int64_t f,
                                                 int64_t l, int64_t x) {
  if (x <= f) return 0;
  if (x > l) return c;
  // f < x <= l, so c >= 2 and the answer lies in [1, c - 1]
  const int64_t g = (int64_t)((double)(x - f) / (double)(l - f) * (double)(c - 1));
  const int64_t q0 = max((int64_t)0, min(g - 3, c - 8));
  const int span = (int)min((int64_t)8, c - q0);
  int below = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) below += (i < span && row[q0 + i] < x) ? 1 : 0;
  if (below > 0 && below < span) return q0 + below;
  // the answer lies at or before q0 (row[q0] >= x), or past the eight
  int64_t lo = below == 0 ? 0 : q0 + span, hi = below == 0 ? q0 : c;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (row[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ double warp_sum(double x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ int warp_sum_int(int x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ double warp_min(double x) {
  for (int off = 16; off > 0; off >>= 1) x = fmin(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ double warp_max(double x) {
  for (int off = 16; off > 0; off >>= 1) x = fmax(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
