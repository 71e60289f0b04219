// The window-run search and the warp reductions that K1 window_moments,
// L1 lane_partials and L2 rollup_avg share.
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
