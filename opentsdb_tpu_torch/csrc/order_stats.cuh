// Order statistics and the order reduces, one warp per run: the device
// selection routine that K4 window_order, K5 group_order and U3 union_order
// share.
//
// Replaces the sorts behind opentsdb_tpu/ops/percentile.py (_estimate,
// row_run_percentile, column_run_percentile, masked_percentile) and the
// order reduces of ops/aggregators.py (_first_ordered, _last_ordered, _diff,
// _mult, _median, _none_agg, _percentile_agg).  The reference sorts every
// run (lax.sort of [S, N] rows or [S, W] columns) and gathers order
// statistics; here nothing is sorted.
//
// A run is m elements in order (time order in a window, row order in a
// group), read through an accessor get(i, v) that says whether element i
// takes part and gives its value.  Its k-th smallest value is found by a
// radix select over the order-preserving 64-bit key of the value: eight
// passes, each a 256-bin histogram (in this warp's shared counters) of the
// next 8 key bits among the elements whose higher bits match the prefix
// found so far.  The run is read from global memory on each pass and never
// staged, so a run of any length is exact: a 65,536-point "0all" window or a
// group of tens of thousands of rows takes the same route as a window of a
// few points.  The next order statistic follows from one more pass: the
// count of keys <= the k-th and the least key above it.
//
// Only elements that take part are counted, so n is the number of real
// values, and a real +inf sorts among them (as the reference's pads, keyed
// past every run, are never counted).  The estimators repeat the
// reference's arithmetic term for term with explicitly rounded operations
// (no fused multiply-add), since an int-mode percentile truncates its
// float result and one rounding apart can be one apart in the answer.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace order_stats {

// The kernels' order reduce codes (ops/aggregators.py ORDER_CODES).
enum Order { FIRST = 0, LAST = 1, DIFF = 2, NONE = 3, MULT = 4, MEDIAN = 5, PERCENTILE = 6 };
// Percentile estimators (ops/percentile.py EST_CODES).
enum Est { LEGACY = 0, R3 = 1, R7 = 2 };

constexpr unsigned FULL = 0xffffffffu;
constexpr int BINS = 256;  // shared counters a warp owns

// Order-preserving keys: key_of(a) < key_of(b) exactly when a < b
// (non-NaN doubles; -0.0 sorts just below +0.0).
__device__ __forceinline__ uint64_t key_of(double v) {
  const uint64_t b = (uint64_t)__double_as_longlong(v);
  return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}
__device__ __forceinline__ uint64_t key_of(int64_t v) {
  return (uint64_t)v ^ 0x8000000000000000ull;
}
__device__ __forceinline__ double double_of(uint64_t k) {
  return __longlong_as_double(
      (long long)((k >> 63) ? (k & 0x7fffffffffffffffull) : ~k));
}
__device__ __forceinline__ void value_of(uint64_t k, double& v) { v = double_of(k); }
__device__ __forceinline__ void value_of(uint64_t k, int64_t& v) {
  v = (int64_t)(k ^ 0x8000000000000000ull);
}

// Arithmetic of the reduces: float64 rounds each operation on its own,
// int64 wraps as Java longs do.
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ int64_t mul(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a * (uint64_t)b);
}
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ int64_t sub(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a - (uint64_t)b);
}

__device__ __forceinline__ long long warp_sum(long long x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}
__device__ __forceinline__ long long warp_min(long long x) {
  for (int off = 16; off > 0; off >>= 1) {
    const long long y = __shfl_xor_sync(FULL, x, off);
    x = y < x ? y : x;
  }
  return x;
}
__device__ __forceinline__ long long warp_max(long long x) {
  for (int off = 16; off > 0; off >>= 1) {
    const long long y = __shfl_xor_sync(FULL, x, off);
    x = y > x ? y : x;
  }
  return x;
}
__device__ __forceinline__ unsigned long long warp_min_key(unsigned long long x) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long y = __shfl_xor_sync(FULL, x, off);
    x = y < x ? y : x;
  }
  return x;
}
__device__ __forceinline__ double from_lane0(double x) { return __shfl_sync(FULL, x, 0); }
__device__ __forceinline__ int64_t from_lane0(int64_t x) {
  return (int64_t)__shfl_sync(FULL, (long long)x, 0);
}

// The key of the rank-th smallest (0-based) of the keys that keyed(i, k)
// accepts, i in [0, m).  Every lane of the warp calls it with the same
// arguments; rank is below the number of accepted keys.  hist holds BINS
// shared counters that only this warp uses.
template <typename Keyed>
__device__ uint64_t warp_select(Keyed keyed, int64_t m, int64_t rank, unsigned* hist) {
  const int lane = threadIdx.x & 31;
  uint64_t prefix = 0, high = 0;  // the key bits found so far, and their mask
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int b = lane; b < BINS; b += 32) hist[b] = 0;
    __syncwarp();
    for (int64_t i = lane; i < m; i += 32) {
      uint64_t k;
      if (keyed(i, k) && (k & high) == prefix) atomicAdd(&hist[(k >> shift) & 0xff], 1u);
    }
    __syncwarp();
    // a lane sums 8 neighbouring bins; a scan over the lanes finds the
    // lane, then the bin, that holds the rank
    unsigned local = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) local += hist[lane * 8 + b];
    unsigned incl = local;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += y;
    }
    const unsigned excl = incl - local;
    const bool mine = (int64_t)excl <= rank && rank < (int64_t)incl;
    const unsigned ballot = __ballot_sync(FULL, mine);
    const int src = ballot ? __ffs(ballot) - 1 : 0;
    int bin = 0;
    unsigned before = 0;
    if (mine) {
      unsigned c = excl;
      for (int b = 0; b < 8; ++b) {
        const unsigned h = hist[lane * 8 + b];
        if (rank < (int64_t)(c + h)) {
          bin = lane * 8 + b;
          before = c;
          break;
        }
        c += h;
      }
    }
    bin = __shfl_sync(FULL, bin, src);
    before = __shfl_sync(FULL, before, src);
    rank -= before;
    prefix |= (uint64_t)bin << shift;
    high |= 0xffull << shift;
    __syncwarp();  // every lane has read hist before the next pass clears it
  }
  return prefix;
}

// The 1-based order statistics at(k) of a run of n accepted keys, with k
// clipped to [1, n] as the reference's at() clips (percentile.py:86-89).
template <typename Keyed>
struct Ranks {
  Keyed keyed;
  int64_t m, n;
  unsigned* hist;

  __device__ int64_t clip(int64_t k) const { return k < 1 ? 0 : (k > n ? n - 1 : k - 1); }

  __device__ uint64_t at(int64_t k) const { return warp_select(keyed, m, clip(k), hist); }

  // at(k) and at(k + 1): the second from one more pass, the count of keys
  // <= at(k) and the least key above it.
  __device__ void pair(int64_t k, uint64_t& a, uint64_t& b) const {
    const int64_t ra = clip(k), rb = clip(k + 1);
    a = warp_select(keyed, m, ra, hist);
    if (rb == ra) {
      b = a;
      return;
    }
    const int lane = threadIdx.x & 31;
    long long le = 0;
    unsigned long long gt = ~0ull;
    for (int64_t i = lane; i < m; i += 32) {
      uint64_t key;
      if (keyed(i, key)) {
        if (key <= a) le += 1;
        else if (key < gt) gt = key;
      }
    }
    le = warp_sum(le);
    gt = warp_min_key(gt);
    b = le > rb ? a : gt;
  }
};

// Percentile q of the run's n accepted double keys by the estimator `est`:
// ops/percentile.py:_estimate, operation for operation.
template <typename Keyed>
__device__ double percentile(const Ranks<Keyed>& r, double q, int est) {
  const double nf = (double)r.n;
  uint64_t a, b;
  if (est == R3) {
    const double h = __ddiv_rn(__dmul_rn(nf, q), 100.0);
    return double_of(r.at((int64_t)ceil(__dsub_rn(h, 0.5))));
  }
  double h;
  if (est == R7) {
    h = __dadd_rn(__ddiv_rn(__dmul_rn(__dsub_rn(nf, 1.0), q), 100.0), 1.0);
  } else {  // LEGACY
    h = __ddiv_rn(__dmul_rn(q, __dadd_rn(nf, 1.0)), 100.0);
    if (h < 1.0) return double_of(r.at(1));
    if (h >= nf) return double_of(r.at(r.n));
  }
  const double fh = floor(h);
  r.pair((int64_t)fh, a, b);
  const double lo = double_of(a), hi = double_of(b);
  return __dadd_rn(lo, __dmul_rn(__dsub_rn(h, fh), __dsub_rn(hi, lo)));
}

// The order reduce `code` of a run: get(i, v) says whether element i of
// [0, m) takes part and gives its value v (type V: double, or int64 in int
// mode), in the run's order.  Returns the result on every lane and the
// count of elements taking part in n; with n == 0 the result is 0 and the
// caller writes its empty value.
//   FIRST, NONE  the first element taking part     LAST  the last
//   DIFF         last - first, 0 below two         MULT  the product, in
//                                                        the run's order
//   MEDIAN       the upper median, sorted[n / 2]
//   PERCENTILE   q by `est` over the values as float64; an int64 result is
//                the float's truncation, as (long) casts it
template <typename V, typename Get>
__device__ V warp_order(Get get, int64_t m, int code, double q, int est, unsigned* hist,
                        int64_t& n) {
  const int lane = threadIdx.x & 31;
  long long cnt = 0, first = m, last = -1;
  for (int64_t i = lane; i < m; i += 32) {
    V v;
    if (get(i, v)) {
      cnt += 1;
      first = i < first ? i : first;
      last = i;
    }
  }
  n = warp_sum(cnt);
  if (n == 0) return (V)0;
  first = warp_min(first);
  last = warp_max(last);
  V a, b;
  switch (code) {
    case FIRST:
    case NONE: get(first, a); return a;
    case LAST: get(last, b); return b;
    case DIFF:
      if (n < 2) return (V)0;
      get(first, a);
      get(last, b);
      return sub(b, a);
    case MULT: {
      // one lane multiplies in the run's order, as the reference does:
      // with an overflow to inf and a zero in one run, the order decides
      // between NaN and 0
      V prod = (V)1;
      if (lane == 0) {
        for (int64_t i = first; i <= last; ++i) {
          if (get(i, a)) prod = mul(prod, a);
        }
      }
      return from_lane0(prod);
    }
    case MEDIAN: {
      auto keyed = [&](int64_t i, uint64_t& k) {
        V v;
        if (!get(i, v)) return false;
        k = key_of(v);
        return true;
      };
      value_of(warp_select(keyed, m, n / 2, hist), a);
      return a;
    }
    default: {  // PERCENTILE, over the values as float64
      auto keyed = [&](int64_t i, uint64_t& k) {
        V v;
        if (!get(i, v)) return false;
        k = key_of((double)v);
        return true;
      };
      const Ranks<decltype(keyed)> r{keyed, m, n, hist};
      return (V)percentile(r, q, est);
    }
  }
}

}  // namespace order_stats
