// U2 union_reduce: at every union slot of every group, the group's members'
// exact or interpolated values, reduced: [S, N] + u[U] -> out[U].
//
// Replaces opentsdb_tpu/ops/union_agg.py:_series_contribution and
// union_aggregate (its tiles of [S, tile] contributions) with the moment
// reduces of ops/aggregators.py (_sum, _squaresum, _min, _max, _avg,
// _count, _dev) as the union arm of ops/pipeline.py:_pipeline and
// _union_batch_pipeline run them.  A member participates at slot x when x
// lies within its first and last timestamp; it contributes its value at x
// or, lacking one, its interpolation between the points around x (LERP,
// ZIM, MAX/MIN_IF_MISSING, PREV).  float64 values skip NaN contributions
// and give NaN where none participates (count gives 0); int64 values are
// int mode, Java long arithmetic, wrapping: a truncating division in LERP
// and avg, a truncated stddev for dev.
//
// Bound on the H100: bytes.  It must read ts, val and mask once (17 B a
// point) and u once and write out once (16 B a slot): 2.2 GB at the
// headline batch (6.7e7 points and ~6.7e7 slots in 100 groups of ~10
// rows), about 0.67 ms at 3.35 TB/s.  What it does instead is set by its
// probes: every slot searches every member row of its group.
//
// Design: a thread owns CH consecutive slots of the flat u (a chunk that
// crosses into the next group is done group by group) and walks its
// group's member rows in row order, as the reference reduces over axis 0:
// one binary search per row for the first slot, then a cursor walked
// forward for the rest; a row whose [first, last] misses the chunk is
// skipped after two loads.  The per-slot moments stay in registers in
// float64 (int64 in int mode); dev walks the rows a second time around the
// slot mean.  Neighbouring threads walk the same row at neighbouring
// places, so their probes share cache lines.  The [S, tile] contribution
// matrix of the reference is never formed, so nothing is tiled.  Each slot
// has one writer: no atomics, the same result on every run.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "union_contrib.cuh"

namespace {

using namespace union_contrib;

constexpr int THREADS = 128;
constexpr int CH = 8;  // union slots a thread owns

enum Agg { SUM = 0, COUNT = 1, AVG = 2, MIN = 3, MAX = 4, DEV = 5, SQUARESUM = 6 };

// The float64 sums round each product and each sum on its own (no fused
// multiply-add), as the reference does: an int-mode dev truncates a float
// result, so one rounding apart can be one apart in its answer.
__device__ double plus(double a, double b) { return __dadd_rn(a, b); }
__device__ int64_t plus(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);
}
__device__ double times(double a, double b) { return __dmul_rn(a, b); }
__device__ int64_t times(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a * (uint64_t)b);
}

template <typename V> struct Traits;
template <> struct Traits<double> {
  static constexpr bool is_float = true;
  __device__ static double lowest() { return -INFINITY; }
  __device__ static double highest() { return INFINITY; }
};
template <> struct Traits<int64_t> {
  static constexpr bool is_float = false;
  __device__ static int64_t lowest() { return INT64_MIN; }
  __device__ static int64_t highest() { return INT64_MAX; }
};

// Calls f(j, value) for every member contribution at x[0, len), rows in
// order.  Every x[j] is a timestamp of some member, so a member that
// participates without a point at x[j] has points on both sides of it.
template <typename V, typename F>
__device__ __forceinline__ void visit(const int64_t* __restrict__ ts,
                                      const V* __restrict__ val,
                                      const int64_t* __restrict__ counts, int64_t n,
                                      int64_t r0, int64_t r1, const int64_t (&x)[CH],
                                      int64_t x_last, int len, int policy, F f) {
  for (int64_t r = r0; r < r1; ++r) {
    const int64_t c = counts[r];
    if (c == 0) continue;
    const int64_t* tr = ts + r * n;
    const V* vr = val + r * n;
    const int64_t lo_ts = tr[0], hi_ts = tr[c - 1];
    if (x_last < lo_ts || x[0] > hi_ts) continue;
    int64_t pos = first_at_or_after(tr, c, x[0]);
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      if (j < len) {
        const int64_t xj = x[j];
        while (pos < c && tr[pos] < xj) ++pos;
        if (xj >= lo_ts && xj <= hi_ts) {
          const V v = contribution(tr, vr, pos, xj, policy);
          if (!skipped(v)) f(j, v);
        }
      }
    }
  }
}

template <typename V>
__device__ void reduce_run(const int64_t* __restrict__ ts, const V* __restrict__ val,
                           const int64_t* __restrict__ counts, int64_t n, int64_t r0,
                           int64_t r1, const int64_t* __restrict__ u, int64_t k0, int len,
                           int agg, int policy, V* __restrict__ out) {
  int64_t x[CH];
  V acc[CH];
  double dsum[CH];
  int64_t cnt[CH];
  const int64_t x_last = u[k0 + len - 1];
  const V ident = agg == MIN ? Traits<V>::highest()
                             : (agg == MAX ? Traits<V>::lowest() : (V)0);
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    x[j] = j < len ? u[k0 + j] : 0;
    acc[j] = ident;
    dsum[j] = 0.0;
    cnt[j] = 0;
  }
  visit<V>(ts, val, counts, n, r0, r1, x, x_last, len, policy, [&](int j, V v) {
    cnt[j] += 1;
    switch (agg) {
      case MIN: acc[j] = v < acc[j] ? v : acc[j]; break;
      case MAX: acc[j] = v > acc[j] ? v : acc[j]; break;
      case SQUARESUM: acc[j] = plus(acc[j], times(v, v)); break;
      case DEV: dsum[j] += (double)v; break;
      case COUNT: break;
      default: acc[j] = plus(acc[j], v); break;  // SUM, AVG
    }
  });
  if (agg == DEV) {
    double mean[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      mean[j] = dsum[j] / (double)(cnt[j] > 1 ? cnt[j] : 1);
      dsum[j] = 0.0;
    }
    visit<V>(ts, val, counts, n, r0, r1, x, x_last, len, policy, [&](int j, V v) {
      const double c = (double)v - mean[j];
      dsum[j] = plus(dsum[j], times(c, c));
    });
  }
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    if (j < len) {
      const int64_t nj = cnt[j] > 1 ? cnt[j] : 1;
      V res;
      switch (agg) {
        case COUNT: res = (V)cnt[j]; break;
        case AVG: res = acc[j] / (V)nj; break;  // truncates in int mode
        case DEV:  // the (long) cast truncates in int mode
          res = (V)(cnt[j] >= 2 ? sqrt(dsum[j] / (double)(cnt[j] - 1)) : 0.0);
          break;
        default: res = acc[j]; break;  // SUM, MIN, MAX, SQUARESUM
      }
      if constexpr (Traits<V>::is_float) {
        if (cnt[j] == 0 && agg != COUNT) res = NAN;
      }
      out[k0 + j] = res;
    }
  }
}

template <typename V>
__global__ void __launch_bounds__(THREADS)
union_reduce_kernel(const int64_t* __restrict__ ts, const V* __restrict__ val,
                    const int64_t* __restrict__ offsets, const int64_t* __restrict__ u,
                    const int64_t* __restrict__ uoff, const int64_t* __restrict__ counts,
                    int64_t n, int64_t g, int64_t total, int agg, int policy,
                    V* __restrict__ out) {
  int64_t k = ((int64_t)blockIdx.x * THREADS + threadIdx.x) * CH;
  const int64_t end = k + CH < total ? k + CH : total;
  while (k < end) {
    int64_t lo = 0, hi = g - 1;  // the group: last gi with uoff[gi] <= k
    while (lo < hi) {
      const int64_t mid = (lo + hi + 1) / 2;
      if (uoff[mid] <= k) lo = mid; else hi = mid - 1;
    }
    const int64_t stop = uoff[lo + 1] < end ? uoff[lo + 1] : end;
    reduce_run<V>(ts, val, counts, n, offsets[lo], offsets[lo + 1], u, k,
                  (int)(stop - k), agg, policy, out);
    k = stop;
  }
}

}  // namespace

extern "C" int union_reduce(const void* ts, const void* val, const void* mask,
                            const void* offsets, const void* u, const void* uoff,
                            long long s, long long n, long long g, long long total,
                            int agg, int policy, int val_is_int, void* counts,
                            void* out, void* stream) {
  if (s <= 0 || n <= 0 || g <= 0 || total <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = row_counts(mask, s, n, counts, st);
  if (err != cudaSuccess) return (int)err;
  const int64_t threads = (total + CH - 1) / CH;
  const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
  if (val_is_int) {
    union_reduce_kernel<int64_t><<<blocks, THREADS, 0, st>>>(
        (const int64_t*)ts, (const int64_t*)val, (const int64_t*)offsets,
        (const int64_t*)u, (const int64_t*)uoff, (const int64_t*)counts, n, g, total,
        agg, policy, (int64_t*)out);
  } else {
    union_reduce_kernel<double><<<blocks, THREADS, 0, st>>>(
        (const int64_t*)ts, (const double*)val, (const int64_t*)offsets,
        (const int64_t*)u, (const int64_t*)uoff, (const int64_t*)counts, n, g, total,
        agg, policy, (double*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* union_reduce_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
