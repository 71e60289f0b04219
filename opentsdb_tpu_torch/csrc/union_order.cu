// U3 union_order: at every union slot of every group, the order or rank
// reduce of the group's members' exact or interpolated values:
// [S, N] + u[U] -> out[U].
//
// Replaces the agg.reduce arm of opentsdb_tpu/ops/union_agg.py:
// union_aggregate (:209-225) over _series_contribution (:79) with the order
// reduces of ops/aggregators.py (_first_ordered, _last_ordered, _diff,
// _mult, _median, _none_agg :126-175, _percentile_agg :267 through
// ops/percentile.py:masked_percentile).  first/last/diff/none follow the
// members' row order.  float64 values skip NaN contributions and give NaN
// where none participates; int64 values are int mode: mult and diff wrap,
// the median is selected on the int64 value itself (exact above 2^53), and
// a percentile is computed over the values as float64 and truncated to a
// long.
//
// Bound on the H100: bytes, as for U2: read ts, val and mask once (17 B a
// point), u once, write out once: 2.2 GB at the headline batch, about
// 0.67 ms at 3.35 TB/s.  The staging below writes and reads each
// [member, slot] contribution once more (9 B each), and a rank function
// reads its slot's column once per radix pass.
//
// Design: the union axis is cut into tiles of `tile` slots, so that the
// [members, slots] contributions of a tile (members up to the largest
// group, maxm) fit a scratch buffer of tile * maxm cells, the reference's
// _UNION_TILE_CELLS (union_agg.py:123).  Per tile, two launches:
//   1. contributions: a thread owns one member index j and CH consecutive
//      slots; it finds its member row of the slot's group, binary-searches
//      the first slot and walks a cursor for the rest, and writes each
//      participating contribution (union_contrib.cuh, the code U2 runs)
//      and its flag to scratch[j * tile + slot];
//   2. reduce: a warp owns a slot and reduces its column of the group's
//      members with the shared warp routine (order_stats::warp_order), the
//      same selection K4 and K5 run.
// Each slot has one writer: no atomics, the same result on every run.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "order_stats.cuh"
#include "union_contrib.cuh"

namespace {

using namespace union_contrib;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CH = 8;  // union slots a thread of the contribution pass owns

// The group of flat union slot k: the last gi with uoff[gi] <= k.
__device__ __forceinline__ int64_t group_of(const int64_t* __restrict__ uoff, int64_t g,
                                            int64_t k) {
  int64_t lo = 0, hi = g - 1;
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) / 2;
    if (uoff[mid] <= k) lo = mid; else hi = mid - 1;
  }
  return lo;
}

template <typename V>
__global__ void __launch_bounds__(THREADS)
contrib_kernel(const int64_t* __restrict__ ts, const V* __restrict__ val,
               const int64_t* __restrict__ counts, const int64_t* __restrict__ offsets,
               const int64_t* __restrict__ u, const int64_t* __restrict__ uoff, int64_t n,
               int64_t g, int64_t k0, int64_t len, int64_t tile, int64_t maxm, int policy,
               V* __restrict__ scratch, uint8_t* __restrict__ flags) {
  const int64_t chunks = (len + CH - 1) / CH;
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= chunks * maxm) return;
  const int64_t j = t / chunks;  // the member's index within its group
  int64_t k = k0 + (t - j * chunks) * CH;
  const int64_t end = k + CH < k0 + len ? k + CH : k0 + len;
  while (k < end) {
    const int64_t gi = group_of(uoff, g, k);
    const int64_t stop = uoff[gi + 1] < end ? uoff[gi + 1] : end;
    const int64_t r = offsets[gi] + j;
    const int64_t c = r < offsets[gi + 1] ? counts[r] : 0;
    if (c > 0) {
      const int64_t* tr = ts + r * n;
      const V* vr = val + r * n;
      const int64_t lo_ts = tr[0], hi_ts = tr[c - 1];
      int64_t pos = first_at_or_after(tr, c, u[k]);
      for (int64_t kk = k; kk < stop; ++kk) {
        const int64_t x = u[kk];
        while (pos < c && tr[pos] < x) ++pos;
        if (x >= lo_ts && x <= hi_ts) {
          const int64_t cell = j * tile + (kk - k0);
          scratch[cell] = contribution(tr, vr, pos, x, policy);
          flags[cell] = 1;
        }
      }
    }
    k = stop;
  }
}

template <typename V>
__global__ void __launch_bounds__(THREADS)
reduce_kernel(const int64_t* __restrict__ offsets, const int64_t* __restrict__ uoff, int64_t g,
              int64_t k0, int64_t len, int64_t tile, int code, double q, int est,
              const V* __restrict__ scratch, const uint8_t* __restrict__ flags,
              V* __restrict__ out) {
  __shared__ unsigned hist[WARPS][order_stats::BINS];
  const int warp = threadIdx.x >> 5;
  const int64_t slot = (int64_t)blockIdx.x * WARPS + warp;
  if (slot >= len) return;  // a whole warp leaves together
  const int64_t gi = group_of(uoff, g, k0 + slot);
  auto get = [&](int64_t i, V& v) {  // both loads issued together
    const int64_t cell = i * tile + slot;
    const uint8_t flag = flags[cell];
    v = scratch[cell];
    return flag && !skipped(v);
  };
  int64_t cnt;
  const V res = order_stats::warp_order<V>(get, offsets[gi + 1] - offsets[gi], code, q, est,
                                           hist[warp], cnt);
  if ((threadIdx.x & 31) == 0) {
    V o = res;
    if constexpr (std::is_floating_point<V>::value) {
      if (cnt == 0) o = NAN;  // float64: nothing participates
    }
    out[k0 + slot] = o;
  }
}

template <typename V>
int run(const void* ts, const void* val, const void* offsets, const void* u,
        const void* uoff, long long n, long long g, long long total, int code, double q,
        int est, int policy, long long maxm, long long tile, const void* counts,
        void* scratch, void* flags, void* out, cudaStream_t st) {
  for (long long k0 = 0; k0 < total; k0 += tile) {
    const long long len = total - k0 < tile ? total - k0 : tile;
    cudaError_t err = cudaMemsetAsync(flags, 0, (size_t)(maxm * tile), st);
    if (err != cudaSuccess) return (int)err;
    const long long threads = (len + CH - 1) / CH * maxm;
    contrib_kernel<V><<<(unsigned)((threads + THREADS - 1) / THREADS), THREADS, 0, st>>>(
        (const int64_t*)ts, (const V*)val, (const int64_t*)counts, (const int64_t*)offsets,
        (const int64_t*)u, (const int64_t*)uoff, n, g, k0, len, tile, maxm, policy,
        (V*)scratch, (uint8_t*)flags);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    reduce_kernel<V><<<(unsigned)((len + WARPS - 1) / WARPS), THREADS, 0, st>>>(
        (const int64_t*)offsets, (const int64_t*)uoff, g, k0, len, tile, code, q, est,
        (const V*)scratch, (const uint8_t*)flags, (V*)out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// code: order_stats::Order; q and est: the percentile and its estimator;
// policy: union_contrib::Policy; val_is_int selects float64 (0) or int64
// (1) values and output.  maxm is the largest group's row count and tile
// the slots a tile holds; counts[S] (int64), scratch[maxm * tile] (the
// value type) and flags[maxm * tile] (bytes) are scratch buffers.
extern "C" int union_order(const void* ts, const void* val, const void* mask,
                           const void* offsets, const void* u, const void* uoff, long long s,
                           long long n, long long g, long long total, int code, double q,
                           int est, int policy, int val_is_int, long long maxm, long long tile,
                           void* counts, void* scratch, void* flags, void* out, void* stream) {
  if (s <= 0 || n <= 0 || g <= 0 || total <= 0 || maxm <= 0 || tile <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = row_counts(mask, s, n, counts, st);
  if (err != cudaSuccess) return (int)err;
  if (val_is_int)
    return run<int64_t>(ts, val, offsets, u, uoff, n, g, total, code, q, est, policy, maxm,
                        tile, counts, scratch, flags, out, st);
  return run<double>(ts, val, offsets, u, uoff, n, g, total, code, q, est, policy, maxm, tile,
                     counts, scratch, flags, out, st);
}

extern "C" const char* union_order_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
