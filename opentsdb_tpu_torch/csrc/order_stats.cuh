// Order statistics and the order reduces of a run: the device routines that
// K4 window_order, K5 group_order and U3 union_order share (S2 sketch_fold
// takes the selection too; U3's and K5's groups of at most 32 members sort
// or rank their few keys themselves, by the networks below or in place,
// and take only the estimators, through SortedRanks and rank_reduce).
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
// takes part and gives its value, or already staged in shared memory as
// keys (K4's and K5's pools, where an element that takes no part holds ~0,
// a key above every value's: the selection of a rank below the count of
// real keys never reaches it).
//
// Selection.  The k-th smallest value is found by a radix select over the
// order-preserving 64-bit key of the value, by a team: one warp, or a whole
// block on a long run (K4).  A pass counts, in 256 shared bins, the next 8
// key bits of the keys whose higher bits match the prefix found so far.
// Three things keep the passes few: the first pass starts at the highest
// byte in which the run's keys differ (from the AND and the OR of the keys;
// the bytes above are common to every key); once the chosen bin holds at
// most 32 keys they are gathered to shared memory and ranked directly (one
// key a lane, which also gives the next order statistic when it lies in
// the bin); and a run read from device memory whose chosen bin fits the
// team's narrowing room (cap keys) is gathered there, so that later passes
// read shared memory.  Otherwise the next order statistic follows from one
// more pass over the run: the count of keys <= the k-th and the least key
// above it.  The result is exact whatever the run's length, and
// independent of the order in which the keys are counted or gathered.
//
// Only elements that take part are counted, so n is the number of real
// values, and a real +inf sorts among them (as the reference's pads, keyed
// past every run, are never counted).  The estimators repeat the
// reference's arithmetic term for term with explicitly rounded operations
// (no fused multiply-add), since an int-mode percentile truncates its
// float result and one rounding apart can be one apart in the answer.
//
// The ordered product (mult).  The reference multiplies a run in its order
// (segment_prod, prod over rows), and IEEE multiplication is not
// associative at the ends of the range: with an overflow to inf and a zero
// in one run the order decides between NaN and 0.  warp_mult gives the
// ordered walk's answer with all 32 lanes.  The rule, the ordered walk's
// own:
//   - the first event decides: an overflow of the product or an inf value
//     makes it +-inf, a zero value makes it +-0;
//   - after +-inf a later zero value makes NaN; after +-0 a later inf
//     value makes NaN; otherwise the class holds to the end;
//   - the sign is the XOR of the signs of every value taking part;
//   - no event: the finite product, combined in another order, within
//     2(n - 1) * 2^-53 relative of the ordered one (the port's rtol is
//     1e-9: n up to ~4.5e6).
// Magnitudes are extended (a significand in [1, 2) and an int exponent),
// so they neither overflow nor underflow.  One strided pass gives the
// count, the XOR of the signs, the first zero and the first inf value, the
// magnitude of the product, and bounds on any prefix's magnitude (the sums
// of ceil(log2 |v|) over the values above 1 and of floor(log2 |v|) over
// those below).  Before the first zero or inf value every value is finite
// and non-zero, so the ordered walk can change class only by overflowing
// or underflowing there:
//   - bounds inside the normal range: no prefix can leave it, and the
//     class follows from the first zero and inf values alone;
//   - magnitudes that only grow (every |v| >= 1, the headline batch) or
//     only shrink: the product of the values before the first zero or inf
//     value says whether the walk has overflowed (underflowed) by then;
//   - otherwise lanes take contiguous chunks of the run (chunk
//     ceil(m / 32) | 1, a function of m alone), a warp scan gives each lane
//     the magnitude before its chunk, and a lane whose chunk may leave the
//     band of safe magnitudes re-walks it from there to find where.
// The margin: an extended magnitude of a prefix differs from the ordered
// walk's by at most (2i + 32) * 2^-53 relative; delta = (m + 64) * 2^-50 is
// 8x that.  A magnitude within 2 * delta of the overflow threshold
// (2^1024 (1 - 2^-54)) or at or below 2^-1022 (1 + 2 delta), before the
// class is decided (so any run that passes through the subnormals, where
// the ordered walk loses precision), sends the run to the ordered walk on
// one lane, inside the kernel.  A magnitude past the threshold by
// 2 * delta is an overflow, and the ordered walk overflows there too.
// int64 products wrap mod 2^64, which is exact in any order: one strided
// pass and a butterfly.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace order_stats {

// The kernels' order reduce codes (ops/aggregators.py ORDER_CODES).
enum Order { FIRST = 0, LAST = 1, DIFF = 2, NONE = 3, MULT = 4, MEDIAN = 5, PERCENTILE = 6 };
// Percentile estimators (ops/percentile.py EST_CODES).
enum Est { LEGACY = 0, R3 = 1, R7 = 2 };

constexpr unsigned FULL = 0xffffffffu;
constexpr int BINS = 256;   // shared counters a team owns
constexpr int SMALL = 32;   // keys ranked directly, one a lane
constexpr long long NONE_AT = 0x7fffffffffffffffll;

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

// A float64 result as the reduce's value type: an int64 one is Java's
// (long) cast, truncating, NaN to 0 and saturating at the long range (what
// cvt.rzi.s64.f64 does; written out so that no compiler may differ).
template <typename V>
__device__ __forceinline__ V of_double(double x) {
  if constexpr (std::is_floating_point<V>::value) {
    return x;
  } else {
    if (isnan(x)) return 0;
    if (x >= 9223372036854775808.0) return INT64_MAX;
    if (x < -9223372036854775808.0) return INT64_MIN;
    return (V)x;
  }
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

// ---- teams -----------------------------------------------------------------
// The threads that select together.  A team's threads all call the same
// routines with the same arguments; results are on every thread.

struct WarpTeam {
  __device__ int rank() const { return threadIdx.x & 31; }
  __device__ int size() const { return 32; }
  __device__ void sync() const { __syncwarp(); }
  __device__ bool leads() const { return true; }
  __device__ long long sum(long long x) const { return warp_sum(x); }
  __device__ unsigned long long min_key(unsigned long long x) const { return warp_min_key(x); }
  // bitwise AND and OR of 64-bit keys, a warp reduction of each half
  __device__ unsigned long long and_key(unsigned long long x) const {
    return ((unsigned long long)__reduce_and_sync(FULL, (unsigned)(x >> 32)) << 32) |
           __reduce_and_sync(FULL, (unsigned)x);
  }
  __device__ unsigned long long or_key(unsigned long long x) const {
    return ((unsigned long long)__reduce_or_sync(FULL, (unsigned)(x >> 32)) << 32) |
           __reduce_or_sync(FULL, (unsigned)x);
  }
  // values the leading warp computed, to every thread: here they are
  __device__ void publish(unsigned long long*, int) const {}
};

// A whole block (blockDim.x a multiple of 32); red is shared room for one
// 64-bit word a warp (at least 3).
struct BlockTeam {
  unsigned long long* red = nullptr;
  __device__ int rank() const { return threadIdx.x; }
  __device__ int size() const { return blockDim.x; }
  __device__ void sync() const { __syncthreads(); }
  __device__ bool leads() const { return threadIdx.x < 32; }
  template <typename Op>
  __device__ unsigned long long combine(unsigned long long x, Op op) const {
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
    __syncthreads();
    x = red[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) x = op(x, red[w]);
    __syncthreads();
    return x;
  }
  __device__ long long sum(long long x) const {
    return (long long)combine((unsigned long long)warp_sum(x),
                              [](unsigned long long a, unsigned long long b) { return a + b; });
  }
  __device__ unsigned long long min_key(unsigned long long x) const {
    return combine(warp_min_key(x),
                   [](unsigned long long a, unsigned long long b) { return b < a ? b : a; });
  }
  __device__ unsigned long long and_key(unsigned long long x) const {
    return combine(WarpTeam().and_key(x),
                   [](unsigned long long a, unsigned long long b) { return a & b; });
  }
  __device__ unsigned long long or_key(unsigned long long x) const {
    return combine(WarpTeam().or_key(x),
                   [](unsigned long long a, unsigned long long b) { return a | b; });
  }
  __device__ void publish(unsigned long long* v, int k) const {
    if (threadIdx.x == 0)
      for (int i = 0; i < k; ++i) red[i] = v[i];
    __syncthreads();
    for (int i = 0; i < k; ++i) v[i] = red[i];
    __syncthreads();
  }
};

// ---- selection ---------------------------------------------------------------

// One warp: the bin of hist holding the 0-based rank, the keys before it
// and the keys in it.  A lane sums 8 neighbouring bins; a scan over the
// lanes finds the lane, then the bin.
__device__ __forceinline__ void find_bin(const unsigned* hist, int64_t rank, unsigned& bin,
                                         unsigned& before, unsigned& count) {
  const int lane = threadIdx.x & 31;
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
  unsigned b0 = 0, c0 = 0, n0 = 0;
  if (mine) {
    unsigned c = excl;
    for (int b = 0; b < 8; ++b) {
      const unsigned h = hist[lane * 8 + b];
      if (rank < (int64_t)(c + h)) {
        b0 = lane * 8 + b;
        c0 = c;
        n0 = h;
        break;
      }
      c += h;
    }
  }
  bin = __shfl_sync(FULL, b0, src);
  before = __shfl_sync(FULL, c0, src);
  count = __shfl_sync(FULL, n0, src);
}

// The keys of a run: the staged pool's pool_n keys when pool_n >= 0, else
// the keys that keyed(i, k) accepts, i in [0, m).  f(k) on each, the
// team's threads striding.
template <typename Team, typename Keyed, typename F>
__device__ __forceinline__ void each_key(const Team& team, const Keyed& keyed, int64_t m,
                                         const uint64_t* pool, int64_t pool_n, F f) {
  if (pool_n >= 0) {
    for (int64_t i = team.rank(); i < pool_n; i += team.size()) f(pool[i]);
  } else {
    for (int64_t i = team.rank(); i < m; i += team.size()) {
      uint64_t k;
      if (keyed(i, k)) f(k);
    }
  }
}

// A selected key, and the next one in order when the selection saw it.
struct Picked {
  uint64_t key, next;
  bool has_next;
};

// The key of the rank-th smallest (0-based) key of the run (each_key's
// source), and the (rank + 1)-th when it lies among the keys the last pass
// kept.  kand and kor are the bitwise AND and OR of the run's keys (0 and
// ~0 when unknown): the bits above their first difference are common to
// every key, and they are equal when all keys are.  rank is below the
// number of keys.  hist holds BINS shared counters of the team (its first
// 65 words are also the room of the direct ranking); narrow is shared room
// for cap keys (cap 0: none) that a run read through keyed narrows into.
template <typename Team, typename Keyed>
__device__ Picked select(const Team& team, Keyed keyed, int64_t m, const uint64_t* pool,
                         int64_t pool_n, int64_t rank, uint64_t kand, uint64_t kor,
                         unsigned* hist, uint64_t* narrow, int64_t cap) {
  if (kand == kor) return Picked{kand, kand, true};
  int shift = (63 - __clzll((long long)(kand ^ kor))) & ~7;
  uint64_t high = shift >= 56 ? 0ull : (~0ull << (shift + 8));
  uint64_t prefix = kand & high;
  const uint64_t* src = pool;
  int64_t src_n = pool_n;
  unsigned* counter = hist + 2 * SMALL;
  for (;;) {
    for (int b = team.rank(); b < BINS; b += team.size()) hist[b] = 0;
    team.sync();
    each_key(team, keyed, m, src, src_n, [&](uint64_t k) {
      if ((k & high) == prefix) atomicAdd(&hist[(k >> shift) & 0xff], 1u);
    });
    team.sync();
    unsigned long long v[3] = {0, 0, 0};
    if (team.leads()) {
      unsigned bin, before, count;
      find_bin(hist, rank, bin, before, count);
      v[0] = bin;
      v[1] = before;
      v[2] = count;
    }
    team.publish(v, 3);
    team.sync();  // every read of hist is done before it is reused
    rank -= (int64_t)v[1];
    prefix |= v[0] << shift;
    high |= 0xffull << shift;
    const int64_t count = (int64_t)v[2];
    if (shift == 0) return Picked{prefix, prefix, rank + 1 < count};
    if (count <= SMALL || (src_n < 0 && count <= cap)) {
      // gather the chosen bin's keys: to the direct ranking's room, or to
      // the narrowing room for the passes left
      const bool small = count <= SMALL;
      if (team.rank() == 0) *counter = 0;
      team.sync();
      each_key(team, keyed, m, src, src_n, [&](uint64_t k) {
        if ((k & high) != prefix) return;
        const unsigned at = atomicAdd(counter, 1u);
        if (small) {
          hist[2 * at] = (unsigned)(k >> 32);
          hist[2 * at + 1] = (unsigned)k;
        } else {
          narrow[at] = k;
        }
      });
      team.sync();
      if (!small) {
        src = narrow;
        src_n = count;
        shift -= 8;
        continue;
      }
      // one key a lane: its rank is the count of keys below it
      unsigned long long res[3] = {0, 0, 0};
      if (team.leads()) {
        const int lane = threadIdx.x & 31;
        const uint64_t mine = lane < count
            ? ((uint64_t)hist[2 * lane] << 32) | hist[2 * lane + 1] : ~0ull;
        int64_t less = 0, eq = 0;
        for (int j = 0; j < (int)count; ++j) {
          const uint64_t o = ((uint64_t)hist[2 * j] << 32) | hist[2 * j + 1];
          less += o < mine;
          eq += o == mine;
        }
        const unsigned b = __ballot_sync(FULL, lane < count && less <= rank && rank < less + eq);
        const unsigned b2 =
            __ballot_sync(FULL, lane < count && less <= rank + 1 && rank + 1 < less + eq);
        res[0] = __shfl_sync(FULL, (unsigned long long)mine, __ffs(b) - 1);
        res[1] = __shfl_sync(FULL, (unsigned long long)mine, b2 ? __ffs(b2) - 1 : 0);
        res[2] = b2 ? 1 : 0;
      }
      team.publish(res, 3);
      team.sync();
      return Picked{res[0], res[1], res[2] != 0};
    }
    shift -= 8;
  }
}

// The 1-based order statistics at(k) of a run of n accepted keys, with k
// clipped to [1, n] as the reference's at() clips (percentile.py:86-89).
// The run: keyed over [0, m), or the pool's pool_n staged keys
// (pool_n >= 0); kand/kor, narrow/cap and the team as select takes them.
template <typename Keyed, typename Team = WarpTeam>
struct Ranks {
  Keyed keyed;
  int64_t m, n;
  unsigned* hist;
  uint64_t kand = 0, kor = ~0ull;
  const uint64_t* pool = nullptr;
  int64_t pool_n = -1;
  uint64_t* narrow = nullptr;
  int64_t cap = 0;
  Team team = Team();

  __device__ int64_t clip(int64_t k) const { return k < 1 ? 0 : (k > n ? n - 1 : k - 1); }

  __device__ Picked sel(int64_t rank) const {
    return select(team, keyed, m, pool, pool_n, rank, kand, kor, hist, narrow, cap);
  }

  __device__ uint64_t at(int64_t k) const { return sel(clip(k)).key; }

  // at(k) and at(k + 1): the second from the selection's last pass when it
  // kept it, else from one more pass over the run, the count of keys <=
  // at(k) and the least key above it.
  __device__ void pair(int64_t k, uint64_t& a, uint64_t& b) const {
    const int64_t ra = clip(k), rb = clip(k + 1);
    const Picked p = sel(ra);
    a = p.key;
    if (rb == ra || p.has_next) {
      b = rb == ra ? a : p.next;
      return;
    }
    long long le = 0;
    unsigned long long gt = ~0ull;
    each_key(team, keyed, m, pool, pool_n, [&](uint64_t key) {
      if (key <= a) le += 1;
      else if (key < gt) gt = key;
    });
    le = team.sum(le);
    gt = team.min_key(gt);
    b = le > rb ? a : gt;
  }
};

// The order statistics of n keys already sorted, keys[0] the least (U3's
// shallow groups): at() and pair() as Ranks gives them.
struct SortedRanks {
  const uint64_t* keys;
  int64_t n;

  __device__ int64_t clip(int64_t k) const { return k < 1 ? 0 : (k > n ? n - 1 : k - 1); }
  __device__ uint64_t at(int64_t k) const { return keys[clip(k)]; }
  __device__ void pair(int64_t k, uint64_t& a, uint64_t& b) const {
    a = keys[clip(k)];
    b = keys[clip(k + 1)];
  }
};

// Sorting networks over keys in registers (U3's and K5's shallow rows).
__device__ __forceinline__ void order2(uint64_t& a, uint64_t& b) {
  const uint64_t lo = a < b ? a : b;
  b = a < b ? b : a;
  a = lo;
}

// Batcher's odd-even merge of k[LO, LO + N), whose even and odd elements
// at stride R are sorted: templates, so that every index is a constant
// and the keys stay in registers.
template <int LO, int N, int R, int P>
__device__ __forceinline__ void merge_keys(uint64_t (&k)[P]) {
  if constexpr (2 * R < N) {
    merge_keys<LO, N, 2 * R>(k);
    merge_keys<LO + R, N, 2 * R>(k);
#pragma unroll
    for (int i = LO + R; i + R < LO + N; i += 2 * R) order2(k[i], k[i + R]);
  } else {
    order2(k[LO], k[LO + R]);
  }
}

// Batcher's odd-even merge sort of k[LO, LO + N), N a power of two.
template <int LO, int N, int P>
__device__ __forceinline__ void sort_keys(uint64_t (&k)[P]) {
  if constexpr (N > 1) {
    sort_keys<LO, N / 2>(k);
    sort_keys<LO + N / 2, N / 2>(k);
    merge_keys<LO, N, 1>(k);
  }
}

// Percentile q of the run's n accepted double keys by the estimator `est`:
// ops/percentile.py:_estimate, operation for operation.
template <typename R>
__device__ double percentile(const R& r, double q, int est) {
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

// The median (the upper one, at(n / 2 + 1)) or the percentile of a run's
// keys as the reduce's value type, from any of the rank sources above.
template <typename V, typename R>
__device__ __forceinline__ V rank_reduce(const R& r, int code, double q, int est) {
  V res;
  if (code == MEDIAN)
    value_of(r.at(r.n / 2 + 1), res);
  else
    res = of_double<V>(percentile(r, q, est));
  return res;
}

// ---- the ordered product -------------------------------------------------------

// |x| = s * 2^e, s in [1, 2): a magnitude that neither overflows nor
// underflows.
struct Ext {
  double s;
  int e;
};

// The magnitude of a finite, non-zero x, exactly (a subnormal too).
__device__ __forceinline__ Ext ext_of(double x) {
  uint64_t b = (uint64_t)__double_as_longlong(x) & 0x7fffffffffffffffull;
  int be = (int)(b >> 52);
  if (be == 0) {  // subnormal: scaled by 2^64 into the normal range, exactly
    b = (uint64_t)__double_as_longlong(__dmul_rn(__longlong_as_double((long long)b), 0x1p64));
    be = (int)(b >> 52) - 64;
  }
  return Ext{__longlong_as_double((long long)((b & 0x000fffffffffffffull) |
                                              0x3ff0000000000000ull)),
             be - 1023};
}

// a * b, one rounding of the significands (the renormalisation is exact).
__device__ __forceinline__ Ext ext_mul(Ext a, Ext b) {
  double s = __dmul_rn(a.s, b.s);
  int e = a.e + b.e;
  if (s >= 2.0) {
    s *= 0.5;
    e += 1;
  }
  return Ext{s, e};
}

__device__ __forceinline__ bool ext_less(Ext a, Ext b) {
  return a.e < b.e || (a.e == b.e && a.s < b.s);
}

// Where a prefix magnitude q lies for the ordered walk, with margin delta.
enum Band { SAFE = 0, OVER = 1, NEAR = 2 };
__device__ __forceinline__ int band(Ext q, double delta) {
  if (q.e >= 1025) return OVER;
  if (q.e >= 1022) {
    const double r = ldexp(q.s, q.e - 1024);  // exact, in [0.25, 2)
    if (r >= 1.0 + 2.0 * delta) return OVER;
    return r >= 1.0 - 2.0 * delta ? NEAR : SAFE;
  }
  if (q.e < -1022 || (q.e == -1022 && q.s < 1.0 + 2.0 * delta)) return NEAR;
  return SAFE;
}

// The ordered walk itself, on lane 0, to every lane.
template <typename Get>
__device__ double ordered_walk(Get get, int64_t m) {
  double p = 1.0;
  if ((threadIdx.x & 31) == 0) {
    for (int64_t i = 0; i < m; ++i) {
      double v;
      if (get(i, v)) p = __dmul_rn(p, v);
    }
  }
  return __shfl_sync(FULL, p, 0);
}

__device__ __forceinline__ Ext warp_ext_product(Ext x) {
  // a butterfly: the two lanes of a pair multiply the same two partials,
  // so every lane ends with the same product
  for (int off = 16; off > 0; off >>= 1) {
    const double ys = __shfl_xor_sync(FULL, x.s, off);
    const int ye = __shfl_xor_sync(FULL, x.e, off);
    x = ext_mul(x, Ext{ys, ye});
  }
  return x;
}

// The class after the run's first zero or inf value at stop (z the first
// zero value, f the first inf value), no overflow or underflow before it.
__device__ __forceinline__ double after_stop(long long z, long long f, long long stop,
                                             double sgn) {
  if (stop == z) return f != NONE_AT ? NAN : sgn * 0.0;
  return z != NONE_AT ? NAN : sgn * INFINITY;
}

// The general case: the first element where the ordered walk leaves the
// band before stop, from lane chunks in order.
template <typename Get>
__device__ double chunked_mult(Get get, int64_t m, long long z, long long f, long long stop,
                               double sgn, double delta) {
  const int lane = threadIdx.x & 31;
  const int64_t chunk = ((m + 31) >> 5) | 1;
  const int64_t c0 = (int64_t)lane * chunk < m ? (int64_t)lane * chunk : m;
  const int64_t c1 = c0 + chunk < m ? c0 + chunk : m;
  const int64_t c_end = c1 < stop ? c1 : stop;
  Ext prod{1.0, 0}, hi{1.0, 0}, lo{1.0, 0};
  for (int64_t i = c0; i < c_end; ++i) {
    double v;
    if (!get(i, v)) continue;
    prod = ext_mul(prod, ext_of(v));  // finite and non-zero before stop
    if (ext_less(hi, prod)) hi = prod;
    if (ext_less(prod, lo)) lo = prod;
  }
  // the magnitude before each chunk: a scan in lane order
  Ext incl = prod;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double ys = __shfl_up_sync(FULL, incl.s, off);
    const int ye = __shfl_up_sync(FULL, incl.e, off);
    if (lane >= off) incl = ext_mul(Ext{ys, ye}, incl);
  }
  Ext in{__shfl_up_sync(FULL, incl.s, 1), __shfl_up_sync(FULL, incl.e, 1)};
  if (lane == 0) in = Ext{1.0, 0};
  // chunks that may leave the band before stop (a wider margin, so that no
  // chunk whose walk leaves it is missed)
  const bool maybe = c0 < c_end && (band(ext_mul(in, hi), 2.0 * delta) != SAFE ||
                                    band(ext_mul(in, lo), 2.0 * delta) != SAFE);
  unsigned cand = __ballot_sync(FULL, maybe);
  while (cand) {
    const int src = __ffs(cand) - 1;
    int k = SAFE;
    if (lane == src) {
      Ext q = in;
      for (int64_t i = c0; i < c_end; ++i) {
        double v;
        if (!get(i, v)) continue;
        q = ext_mul(q, ext_of(v));
        k = band(q, delta);
        if (k != SAFE) break;
      }
    }
    k = __shfl_sync(FULL, k, src);
    if (k == NEAR) return ordered_walk(get, m);
    if (k == OVER) return z != NONE_AT ? NAN : sgn * INFINITY;
    cand &= cand - 1;
  }
  if (stop == NONE_AT) {
    const double ts = __shfl_sync(FULL, incl.s, 31);
    const int te = __shfl_sync(FULL, incl.e, 31);
    return sgn * ldexp(ts, te);
  }
  return after_stop(z, f, stop, sgn);
}

// The product of the run's values that take part (get(i, v) over [0, m),
// float64) with the ordered walk's answer; n is their count (0: the
// result is 0 and the caller writes its empty value).
template <typename Get>
__device__ double warp_mult(Get get, int64_t m, int64_t& n) {
  const int lane = threadIdx.x & 31;
  // 1. one strided pass, four loads in flight a lane; indices and counts
  // in 32 bits (runs of fewer than 2^32 elements), the log2 bounds
  // saturated a lane at +-2^20
  constexpr int UNROLL = 4;
  constexpr int SAT = 1 << 20;
  unsigned cnt = 0, neg = 0, zero_at = 0xffffffffu, inf_at = 0xffffffffu;
  int up = 0, down = 0;
  Ext tot{1.0, 0};
  for (int64_t base = lane; base < m; base += 32 * UNROLL) {
    double v[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) ok[u] = base + 32 * u < m && get(base + 32 * u, v[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      const unsigned i = (unsigned)(base + 32 * u);
      const uint64_t b = (uint64_t)__double_as_longlong(v[u]);
      const int be = (int)((b >> 52) & 0x7ff);
      const uint64_t frac = b & 0x000fffffffffffffull;
      cnt += 1;
      neg ^= (unsigned)(b >> 63);
      if (be == 0x7ff) {  // +-inf (NaN never takes part)
        inf_at = inf_at < i ? inf_at : i;
      } else if (be == 0 && frac == 0) {
        zero_at = zero_at < i ? zero_at : i;
      } else {
        // log2|v| lies in [e, e + 1), and is e exactly when s == 1
        const Ext x = be ? Ext{__longlong_as_double((long long)(frac | 0x3ff0000000000000ull)),
                               be - 1023}
                         : ext_of(v[u]);
        const int ceil_log2 = x.e + (x.s > 1.0 ? 1 : 0);
        tot = ext_mul(tot, x);
        up = min(up + (ceil_log2 > 0 ? ceil_log2 : 0), SAT);
        down = max(down + (x.e < 0 ? x.e : 0), -SAT);
      }
    }
  }
  n = (int64_t)__reduce_add_sync(FULL, cnt);
  if (n == 0) return 0.0;
  neg = __reduce_xor_sync(FULL, neg);
  const unsigned zu = __reduce_min_sync(FULL, zero_at), fu = __reduce_min_sync(FULL, inf_at);
  const long long z = zu == 0xffffffffu ? NONE_AT : (long long)zu;
  const long long f = fu == 0xffffffffu ? NONE_AT : (long long)fu;
  const long long stop = z < f ? z : f;
  up = __reduce_add_sync(FULL, up);
  down = __reduce_add_sync(FULL, down);
  tot = warp_ext_product(tot);
  const double sgn = neg ? -1.0 : 1.0;
  // 2. no prefix can leave the normal range: any order is the ordered one
  if (up <= 1023 && down >= -1021) {
    return stop == NONE_AT ? sgn * ldexp(tot.s, tot.e) : after_stop(z, f, stop, sgn);
  }
  const double delta = ((double)m + 64.0) * 0x1p-50;
  // 3. magnitudes that only grow (or only shrink): the product before the
  // first zero or inf value says where the walk ends
  if (down == 0 || up == 0) {
    Ext p = tot;
    if (stop != NONE_AT) {
      p = Ext{1.0, 0};
      for (int64_t i = lane; i < stop; i += 32) {
        double v;
        if (get(i, v)) p = ext_mul(p, ext_of(v));
      }
      p = warp_ext_product(p);
    }
    const int b = band(p, delta);
    if (b == NEAR) return ordered_walk(get, m);
    if (b == OVER) return z != NONE_AT ? NAN : sgn * INFINITY;
    return stop == NONE_AT ? sgn * ldexp(p.s, p.e) : after_stop(z, f, stop, sgn);
  }
  // 4. the general case
  return chunked_mult(get, m, z, f, stop, sgn, delta);
}

// int64: Java long products wrap mod 2^64, the same in any order.
template <typename Get>
__device__ int64_t warp_mult_int(Get get, int64_t m, int64_t& n) {
  const int lane = threadIdx.x & 31;
  long long cnt = 0;
  int64_t p = 1;
  for (int64_t i = lane; i < m; i += 32) {
    int64_t v;
    if (get(i, v)) {
      cnt += 1;
      p = mul(p, v);
    }
  }
  n = warp_sum(cnt);
  for (int off = 16; off > 0; off >>= 1)
    p = mul(p, (int64_t)__shfl_xor_sync(FULL, (long long)p, off));
  return n == 0 ? 0 : p;
}

// The order reduce `code` of a run by one warp: get(i, v) says whether
// element i of [0, m) takes part and gives its value v (type V: double, or
// int64 in int mode), in the run's order.  Returns the result on every lane
// and the count of elements taking part in n; with n == 0 the result is 0
// and the caller writes its empty value.  hist holds BINS shared counters
// that only this warp uses.
//   FIRST, NONE  the first element taking part     LAST  the last
//   DIFF         last - first, 0 below two         MULT  the ordered product
//                                                        (warp_mult)
//   MEDIAN       the upper median, sorted[n / 2]
//   PERCENTILE   q by `est` over the values as float64; an int64 result is
//                the float's truncation, as (long) casts it
template <typename V, typename Get>
__device__ V warp_order(Get get, int64_t m, int code, double q, int est, unsigned* hist,
                        int64_t& n) {
  if (code == MULT) {
    if constexpr (std::is_same<V, double>::value) return warp_mult(get, m, n);
    else return warp_mult_int(get, m, n);
  }
  const int lane = threadIdx.x & 31;
  const bool ranked = code == MEDIAN || code == PERCENTILE;
  long long cnt = 0, first = m, last = -1;
  unsigned long long kand = ~0ull, kor = 0;
  for (int64_t i = lane; i < m; i += 32) {
    V v;
    if (get(i, v)) {
      cnt += 1;
      first = i < first ? i : first;
      last = i;
      if (ranked) {
        const uint64_t k = code == MEDIAN ? key_of(v) : key_of((double)v);
        kand &= k;
        kor |= k;
      }
    }
  }
  n = warp_sum(cnt);
  if (n == 0) return (V)0;
  V a, b;
  switch (code) {
    case FIRST:
    case NONE: get(warp_min(first), a); return a;
    case LAST: get(warp_max(last), b); return b;
    case DIFF:
      if (n < 2) return (V)0;
      get(warp_min(first), a);
      get(warp_max(last), b);
      return sub(b, a);
    case MEDIAN: {
      auto keyed = [&](int64_t i, uint64_t& k) {
        V v;
        if (!get(i, v)) return false;
        k = key_of(v);
        return true;
      };
      const WarpTeam team;
      value_of(select(team, keyed, m, nullptr, -1, n / 2, team.and_key(kand),
                      team.or_key(kor), hist, nullptr, 0).key,
               a);
      return a;
    }
    default: {  // PERCENTILE, over the values as float64
      auto keyed = [&](int64_t i, uint64_t& k) {
        V v;
        if (!get(i, v)) return false;
        k = key_of((double)v);
        return true;
      };
      const WarpTeam team;
      const Ranks<decltype(keyed)> r{keyed, m, n, hist, team.and_key(kand), team.or_key(kor)};
      return of_double<V>(percentile(r, q, est));
    }
  }
}

}  // namespace order_stats
