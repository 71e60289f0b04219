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
// Bound on the H100: bytes or float64 operations, whichever is larger.  It
// must read ts, val and mask once (17 B a point) and u once and write out
// once (16 B a slot): 2.2 GB at the headline batch (6.7e7 points and
// ~6.7e7 slots in 100 groups of ~10 rows), about 0.66 ms at 3.35 TB/s;
// and at every member-slot pair where the member takes part an add, and
// where it interpolates a subtract, a multiply, a division and an add.
//
// Design: a first kernel reads each row's valid count, first and last
// timestamps.  Then a block owns TILE = 1,024 consecutive slots of the
// flat u and takes the groups they fall in one after another (a segment
// each); thread t owns CH = 8 consecutive slots of the tile and keeps their
// accumulators in registers.  The members are the outer loop, in row
// order, so that each slot adds its members in the reference's order.
// For a segment [a, b) the block first locates a batch of members' spans,
// one member a thread: two searches in step in device memory (Seek, in
// window_runs.cuh: a probe where the line through the row's first and
// last points puts the slot, then doubling strides, then bisection; a few
// probes for a series at a steady cadence) bracket the segment's first and last slot, and the
// span is the points from the one before u[a] to the first at or after
// u[b - 1], which without repeated timestamps is at most b - a + 1 points.
// A block scan of the spans' lengths packs consecutive members into
// stages of at most CAP points (two tiles' worth), which the block copies
// into shared memory with cp.async: a shallow group's whole segment is
// one stage, a deep group's (the fan-in of `sum:metric`, a few points a
// member a tile) a batch of 128 members a stage.  Each thread then takes
// the member's slots among its own that lie within the member's first and
// last point, places the first in the staged span by a short search and
// walks forward with the points around its slot in registers, stepping
// them by selects and computing the contribution at every slot, taken by a
// predicate (walk): a member costs a thread one search and a few loads,
// not a search a slot, and no branch stands between one slot's arithmetic
// and the next.  A span past CAP (a row that repeats its timestamps) is
// staged in pieces of CAP points that overlap by one, each answering for
// the slots whose first point at or after them lies past the piece's
// first point and at most at its last.  LERP, the one policy that
// divides, has kernels of its own, so that its walk carries no policy
// switch.  dev walks the spans a second time around each slot's mean: out
// of the same stage where one stage held the whole segment, else staged
// again.  The contributions and the reduces keep their expressions and
// their order, explicitly rounded (no fused multiply-add), so the outputs
// are the same bits as a walk of every member at every slot gives.  Each
// slot has one writer: no atomics, the same result on every run.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "union_contrib.cuh"
#include "window_runs.cuh"

namespace {

using namespace union_contrib;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS_AN_SM = 6;          // as its registers allow
constexpr int CH = 8;                    // union slots a thread owns
constexpr int TILE = THREADS * CH;       // union slots a block owns
constexpr int MEMBERS = THREADS;         // members a batch locates, one a thread
constexpr int CAP = 2 * TILE + 16;       // points a stage holds
constexpr unsigned FULL = 0xffffffffu;

enum Agg { SUM = 0, COUNT = 1, AVG = 2, MIN = 3, MAX = 4, DEV = 5, SQUARESUM = 6 };

// The float64 sums round each product and each sum on its own (no fused
// multiply-add), as the reference does: an int-mode dev truncates a float
// result, so one rounding apart can be one apart in its answer.
__device__ __forceinline__ double plus(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ int64_t plus(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);
}
__device__ __forceinline__ double times(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ int64_t times(int64_t a, int64_t b) {
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

template <typename V>
struct Args {
  const int64_t* ts;
  const V* val;
  const int64_t* offsets;
  const int64_t* u;
  const int64_t* uoff;
  const int64_t* counts;  // each row's valid points
  const int64_t* first;   // and its first and last timestamps
  const int64_t* last;
  int64_t n, g, total;
  int policy;
  V* out;
};

// A block's shared memory: a stage of points, and the located spans of a
// batch of MEMBERS rows.
template <typename V>
struct Shared {
  int64_t ts[CAP];
  V val[CAP];
  int64_t base[MEMBERS];       // the span's first point: row * n + index
  int64_t lo[MEMBERS];         // the member's first and last timestamps
  int64_t hi[MEMBERS];
  int len[MEMBERS];            // the span's points (0: no part in the segment)
  int off[MEMBERS];            // exclusive sum of packed lengths
  int warp_total[WARPS];
};

// A span's length as stages pack it: a span past CAP counts CAP + 1, so
// that it never shares a stage (it is staged in pieces of its own).
__device__ __forceinline__ int packed(int len) { return len <= CAP ? len : CAP + 1; }

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

// Each row's valid points (its mask a prefix of ones) and its first and
// last timestamps, one thread a row.
__global__ void row_spans_kernel(const uint8_t* __restrict__ mask,
                                 const int64_t* __restrict__ ts, int64_t s, int64_t n,
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
  counts[s + r] = lo > 0 ? ts[r * n] : 0;
  counts[2 * s + r] = lo > 0 ? ts[r * n + lo - 1] : 0;
}

// Locates the spans of members [r, min(r + MEMBERS, r1)) for the segment
// whose first and last slots are x_first and x_last, thread t member r + t,
// and their packed offsets.  Returns the batch's member count.
template <typename V>
__device__ int locate(Shared<V>& sh, const Args<V>& a, int64_t r, int64_t r1,
                      int64_t x_first, int64_t x_last) {
  const int t = threadIdx.x;
  const int64_t row = r + t;
  int len = 0;
  int64_t base = 0, lo = INT64_MAX, hi = INT64_MIN;
  if (row < r1) {
    const int64_t c = a.counts[row], f = a.first[row], l = a.last[row];
    if (c > 0) {
      const int64_t* tr = a.ts + row * a.n;
      if (x_last >= f && x_first <= l) {
        // the first points at or after x_first and x_last, two searches
        // in step
        Seek sf, sl;
        sf.start(c, f, l, x_first);
        sl.start(c, f, l, x_last);
        while (!sf.done() || !sl.done()) {
          const int64_t pf = sf.probe(), pl = sl.probe();
          const bool bf = !sf.done() && tr[pf] < x_first;
          const bool bl = !sl.done() && tr[pl] < x_last;
          if (!sf.done()) sf.take(bf);
          if (!sl.done()) sl.take(bl);
        }
        const int64_t p0 = sf.hi, q0 = sl.hi;
        const int64_t s0 = p0 > 0 ? p0 - 1 : 0, s1 = q0 < c ? q0 : c - 1;
        base = row * a.n + s0;
        len = (int)(s1 - s0 + 1);
        lo = f;
        hi = l;
      }
    }
  }
  sh.base[t] = base;
  sh.lo[t] = lo;
  sh.hi[t] = hi;
  sh.len[t] = len;
  int incl = packed(len);
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, d);
    if ((t & 31) >= d) incl += y;
  }
  if ((t & 31) == 31) sh.warp_total[t >> 5] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < (t >> 5); ++w) before += sh.warp_total[w];
  sh.off[t] = before + incl - packed(len);
  __syncthreads();
  return (int)(r1 - r < MEMBERS ? r1 - r : MEMBERS);
}

// Issues the copies of n points of the rows from flat index src into the
// stage at d, points k = first, first + step, ...
template <typename V>
__device__ __forceinline__ void copy_span(Shared<V>& sh, const Args<V>& a, int64_t src, int d,
                                          int n, int first, int step) {
  for (int k = first; k < n; k += step) {
    __pipeline_memcpy_async(&sh.ts[d + k], a.ts + src + k, sizeof(int64_t));
    __pipeline_memcpy_async(&sh.val[d + k], a.val + src + k, sizeof(V));
  }
}

// Calls f(j, value, take) at each of the thread's slots x[jl, jh): the
// member's contribution there, taken where the member takes part and it is
// not NaN.  tr, vr: its staged span of len points; [lo, hi]: the slots it
// answers for (its first and last timestamps, narrowed to a piece's).  The
// points around the slot stay in registers: a slot passes at most one
// point (every point is a slot), so each slot steps the cursor by a
// select, a row that repeats a timestamp stepping on in a loop; the
// contribution is computed at every slot and taken by a predicate, so that
// no branch stands between one slot's arithmetic and the next.  IS_LERP:
// the policy is LERP.
template <typename V, bool IS_LERP, typename F>
__device__ __forceinline__ void walk(const int64_t* __restrict__ tr, const V* __restrict__ vr,
                                     int len, int64_t lo, int64_t hi, const int64_t (&x)[CH],
                                     int jl, int jh, int policy, F& f) {
  // the slots it takes part in, [ja, jb): x ascends
  int ja = jl, jb = jl;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    if (j >= jl && j < jh) {
      ja += x[j] < lo;
      jb += x[j] <= hi;
    }
  }
  if (ja >= jb) return;
  int64_t xa = 0;
#pragma unroll
  for (int j = 0; j < CH; ++j)
    if (j == ja) xa = x[j];
  int pos = (int)first_at_or_after(tr, len, xa);
  int64_t x0 = 0, x1 = tr[pos];
  V y0 = 0, y1 = vr[pos];
  if (pos > 0) {
    x0 = tr[pos - 1];
    y0 = vr[pos - 1];
  }
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int64_t xj = x[j];
    const bool on = j >= ja && j < jb;
    const bool step = on && x1 < xj;  // xj <= hi: the span holds a point at or after it
    pos += step ? 1 : 0;
    x0 = step ? x1 : x0;
    y0 = step ? y1 : y0;
    x1 = tr[pos];
    y1 = vr[pos];
    if (on && x1 < xj) {
      do {  // a repeated timestamp
        x0 = x1;
        y0 = y1;
        ++pos;
        x1 = tr[pos];
        y1 = vr[pos];
      } while (x1 < xj);
    }
    const V iv = interpolate(IS_LERP ? (int)LERP : policy, xj, x0, y0, x1, y1);
    const V v = x1 == xj ? y1 : iv;
    f(j, v, on && !skipped(v));
  }
}

// One pass over the members [r0, r1) of the segment: locate a batch, then
// stage and reduce it stage by stage (a span past CAP in pieces of CAP
// points that overlap by one, each answering for the slots whose first
// point at or after them is past its first point and at most its last).
// Returns the member count where one batch and one stage held them all
// (the stage still holds them), else -1.
template <typename V, bool IS_LERP, typename F>
__device__ __forceinline__ int pass(Shared<V>& sh, const Args<V>& a, int64_t r0, int64_t r1,
                                    int64_t x_first, int64_t x_last, const int64_t (&x)[CH],
                                    int jl, int jh, F f) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int resident = -1;
  for (int64_t r = r0; r < r1; r += MEMBERS) {
    const int nb = locate(sh, a, r, r1, x_first, x_last);
    for (int p = 0; p < nb;) {
      const int from = sh.off[p];
      const int q = p + __syncthreads_count(t >= p && t < nb &&
                                            sh.off[t] - from + packed(sh.len[t]) <= CAP);
      if (q > p) {
        for (int i = p + warp; i < q; i += WARPS)
          copy_span(sh, a, sh.base[i], sh.off[i] - from, sh.len[i], lane, 32);
        __pipeline_commit();
        __pipeline_wait_prior(0);
        __syncthreads();
        if (jl < jh) {
          for (int i = p; i < q; ++i) {
            const int len = sh.len[i];
            if (len == 0) continue;
            const int d = sh.off[i] - from;
            walk<V, IS_LERP>(&sh.ts[d], &sh.val[d], len, sh.lo[i], sh.hi[i], x, jl, jh, a.policy,
                          f);
          }
        }
        __syncthreads();
        if (r == r0 && r + MEMBERS >= r1 && p == 0 && q == nb) resident = nb;
        p = q;
      } else {  // member p's span passes CAP: its pieces
        const int len = sh.len[p];
        const int64_t src = sh.base[p], lo = sh.lo[p], hi = sh.hi[p];
        for (int k0 = 0;; k0 += CAP - 1) {
          const int n = len - k0 < CAP ? len - k0 : CAP;
          copy_span(sh, a, src + k0, 0, n, t, THREADS);
          __pipeline_commit();
          __pipeline_wait_prior(0);
          __syncthreads();
          if (jl < jh) {
            walk<V, IS_LERP>(sh.ts, sh.val, n, k0 > 0 ? sh.ts[0] + 1 : lo,
                          k0 + n < len ? sh.ts[n - 1] : hi, x, jl, jh, a.policy, f);
          }
          __syncthreads();
          if (k0 + n >= len) break;
        }
        p += 1;
      }
    }
  }
  return resident;
}

// The segment [sa, sb) of the tile, all of group gi: each thread's slots
// in it reduced over the group's members and written.
template <typename V, int AGG, bool IS_LERP>
__device__ __forceinline__ void segment(Shared<V>& sh, const Args<V>& a, int64_t gi, int64_t sa,
                                        int64_t sb, int64_t k0, const int64_t (&x)[CH]) {
  using A = std::conditional_t<AGG == DEV, double, V>;
  const int64_t mine = k0 + (int64_t)threadIdx.x * CH;
  const int jl = (int)(sa - mine < 0 ? 0 : (sa - mine > CH ? CH : sa - mine));
  const int jh = (int)(sb - mine < 0 ? 0 : (sb - mine > CH ? CH : sb - mine));
  const int64_t x_first = a.u[sa], x_last = a.u[sb - 1];
  const int64_t r0 = a.offsets[gi], r1 = a.offsets[gi + 1];
  const A ident = AGG == MIN ? (A)Traits<V>::highest()
                             : (AGG == MAX ? (A)Traits<V>::lowest() : (A)0);
  A acc[CH];
  int cnt[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    acc[j] = ident;
    cnt[j] = 0;
  }
  const int resident = pass<V, IS_LERP>(
      sh, a, r0, r1, x_first, x_last, x, jl, jh, [&](int j, V v, bool take) {
        cnt[j] += take ? 1 : 0;
        if constexpr (AGG == MIN) acc[j] = take && v < acc[j] ? v : acc[j];
        else if constexpr (AGG == MAX) acc[j] = take && v > acc[j] ? v : acc[j];
        else if constexpr (AGG == SQUARESUM) acc[j] = take ? plus(acc[j], times(v, v)) : acc[j];
        else if constexpr (AGG == DEV) acc[j] = take ? acc[j] + (double)v : acc[j];
        else if constexpr (AGG != COUNT) acc[j] = take ? plus(acc[j], v) : acc[j];  // SUM, AVG
      });
  if constexpr (AGG == DEV) {
    double mean[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      mean[j] = acc[j] / (double)(cnt[j] > 1 ? cnt[j] : 1);
      acc[j] = 0.0;
    }
    auto centred = [&](int j, V v, bool take) {
      const double c = (double)v - mean[j];
      acc[j] = take ? plus(acc[j], times(c, c)) : acc[j];
    };
    if (resident >= 0) {
      if (jl < jh) {
        for (int i = 0; i < resident; ++i) {
          const int len = sh.len[i];
          if (len == 0) continue;
          walk<V, IS_LERP>(&sh.ts[sh.off[i]], &sh.val[sh.off[i]], len, sh.lo[i], sh.hi[i], x, jl,
                        jh, a.policy, centred);
        }
      }
      __syncthreads();
    } else {
      pass<V, IS_LERP>(sh, a, r0, r1, x_first, x_last, x, jl, jh, centred);
    }
  }
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    if (j >= jl && j < jh) {
      const int nj = cnt[j] > 1 ? cnt[j] : 1;
      V res;
      if constexpr (AGG == COUNT) res = (V)cnt[j];
      else if constexpr (AGG == AVG) res = acc[j] / (V)nj;  // truncates in int mode
      else if constexpr (AGG == DEV)  // the (long) cast truncates in int mode
        res = (V)(cnt[j] >= 2 ? sqrt(acc[j] / (double)(cnt[j] - 1)) : 0.0);
      else res = acc[j];  // SUM, MIN, MAX, SQUARESUM
      if constexpr (Traits<V>::is_float && AGG != COUNT) {
        if (cnt[j] == 0) res = NAN;
      }
      a.out[mine + j] = res;
    }
  }
}

template <typename V, int AGG, bool IS_LERP>
__global__ void __launch_bounds__(THREADS, BLOCKS_AN_SM) union_reduce_kernel(const Args<V> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared<V>& sh = *reinterpret_cast<Shared<V>*>(smem);
  const int64_t k0 = (int64_t)blockIdx.x * TILE;
  const int64_t k1 = k0 + TILE < a.total ? k0 + TILE : a.total;
  const int64_t mine = k0 + (int64_t)threadIdx.x * CH;
  int64_t x[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) x[j] = mine + j < k1 ? a.u[mine + j] : INT64_MAX;
  for (int64_t gi = group_of(a.uoff, a.g, k0);; ++gi) {
    const int64_t ga = a.uoff[gi], gb = a.uoff[gi + 1];
    const int64_t sa = ga > k0 ? ga : k0, sb = gb < k1 ? gb : k1;
    if (sa < sb) segment<V, AGG, IS_LERP>(sh, a, gi, sa, sb, k0, x);
    if (gb >= k1) break;
  }
}

template <typename V, int AGG, bool IS_LERP>
cudaError_t launch_kernel(const Args<V>& a, unsigned blocks, cudaStream_t st) {
  // the shared memory past 48 KB, set once a device
  static unsigned long long ready = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !(ready >> dev & 1ull)) {
    err = cudaFuncSetAttribute(union_reduce_kernel<V, AGG, IS_LERP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(Shared<V>));
    if (err != cudaSuccess) return err;
    if (dev < 64) ready |= 1ull << dev;
  }
  union_reduce_kernel<V, AGG, IS_LERP><<<blocks, THREADS, sizeof(Shared<V>), st>>>(a);
  return cudaGetLastError();
}

template <typename V, int AGG>
cudaError_t launch(const Args<V>& a, unsigned blocks, cudaStream_t st) {
  return a.policy == LERP ? launch_kernel<V, AGG, true>(a, blocks, st)
                          : launch_kernel<V, AGG, false>(a, blocks, st);
}

template <typename V>
cudaError_t dispatch(const Args<V>& a, int agg, unsigned blocks, cudaStream_t st) {
  switch (agg) {
    case SUM: return launch<V, SUM>(a, blocks, st);
    case COUNT: return launch<V, COUNT>(a, blocks, st);
    case AVG: return launch<V, AVG>(a, blocks, st);
    case MIN: return launch<V, MIN>(a, blocks, st);
    case MAX: return launch<V, MAX>(a, blocks, st);
    case DEV: return launch<V, DEV>(a, blocks, st);
    case SQUARESUM: return launch<V, SQUARESUM>(a, blocks, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// rows: 3 * s int64 of scratch, each row's valid points, first and last
// timestamps.
extern "C" int union_reduce(const void* ts, const void* val, const void* mask,
                            const void* offsets, const void* u, const void* uoff,
                            long long s, long long n, long long g, long long total,
                            int agg, int policy, int val_is_int, void* rows,
                            void* out, void* stream) {
  if (s <= 0 || n <= 0 || g <= 0 || total <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  row_spans_kernel<<<(unsigned)((s + COUNT_THREADS - 1) / COUNT_THREADS), COUNT_THREADS, 0, st>>>(
      (const uint8_t*)mask, (const int64_t*)ts, s, n, (int64_t*)rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((total + TILE - 1) / TILE);
  const int64_t* spans = (const int64_t*)rows;
  if (val_is_int) {
    const Args<int64_t> a{(const int64_t*)ts, (const int64_t*)val, (const int64_t*)offsets,
                          (const int64_t*)u,  (const int64_t*)uoff, spans, spans + s, spans + 2 * s,
                          n, g, total, policy, (int64_t*)out};
    return (int)dispatch(a, agg, blocks, st);
  }
  const Args<double> a{(const int64_t*)ts, (const double*)val, (const int64_t*)offsets,
                       (const int64_t*)u,  (const int64_t*)uoff, spans, spans + s, spans + 2 * s,
                       n, g, total, policy, (double*)out};
  return (int)dispatch(a, agg, blocks, st);
}

extern "C" const char* union_reduce_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
