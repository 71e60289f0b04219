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
// 0.67 ms at 3.35 TB/s.
//
// Design: one launch over the whole union, after row_counts.  A block owns
// CHUNK consecutive slots of the flat u and takes the groups they fall in
// one after another; each group goes to one of two paths by its member
// count m, so a call whose groups fall on both sides of 32 runs both.
//   - Shallow groups (m <= 32: a dashboard's {host=*} groups).  Teams of m
//     lanes (floor(32 / m) teams share a warp: three of 10 members) each
//     own a run of the block's slots of the group, taken m slots at a
//     time.  Lane j holds member j's cursor (union_contrib.cuh Cursor: one
//     binary search at the run's start, then a walk forward as the slots
//     advance, the next point already loaded) and computes its
//     contribution at each of the m slots in registers, into column j of
//     the slots' rows of shared memory; a ballot gives each slot's
//     participants.  Then lane i reduces slot i's row, members in row
//     order: first, last, diff and none from the participants' first and
//     last bit; mult the ordered product walked on the lane; median and
//     percentiles from the row's keys, sorted in registers by a sorting
//     network of 8 or 16 (keys of members that take no part sort last),
//     or ranked in place past 16 members (each key's rank the keys below
//     it plus the equal ones before it); the median is the (n/2)-th key,
//     a percentile order_stats' estimator over the ordered keys
//     (SortedRanks, RowRanks; the estimators' arithmetic unchanged).  The
//     m results are written together.
//   - Deep groups (m > 32: one group of a whole fleet, the fan-in of
//     `sum:metric`).  The block computes P slots at a time (P up to its 16
//     warps, as many as shared memory holds P x m contributions of): thread
//     t the members t, t + 512, ... (cursors for the first two of them, a
//     binary search a slot past 1024 members), staged in shared memory with
//     their participation bits; then each warp reduces one of the P slots
//     with order_stats::warp_order, the selection and ordered product K4
//     and K5 run.  A group too deep to stage one slot of (m past ~16,000)
//     is reduced a warp a slot straight from device memory, every access a
//     binary search.
// Nothing goes through device memory between contribution and reduce, and
// each slot has one writer: no atomics, the same result on every run.
// The selections are exact, so every result but mult is the same whatever
// the path; shallow mult is the ordered walk itself, deep mult warp_mult's
// (the ordered walk's class, its value within rounding).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "order_stats.cuh"
#include "union_contrib.cuh"

namespace {

using namespace union_contrib;
using order_stats::FULL;
using order_stats::rank_reduce;
using order_stats::sort_keys;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int64_t CHUNK = 4096;  // union slots a block owns
constexpr int SHALLOW = 32;      // members a team holds, one a lane
constexpr int ROW = 33;          // 8-byte words of a slot's row (32, and one against bank conflicts)
constexpr int WARP_WORDS = 32 * ROW;
constexpr int MPT = 2;           // members a thread of a deep group walks with a cursor
constexpr int HIST_BYTES = WARPS * order_stats::BINS * 4;
// A block's dynamic shared memory: the 16 warps' rows of the shallow
// path, or 16 slots of 1024 members (8 B and a bit each) and the warps'
// counters of the deep path.  One block an SM.
constexpr int SMEM = 149504;
static_assert(SMEM >= WARPS * WARP_WORDS * 8, "the shallow rows fit");
static_assert(SMEM - HIST_BYTES >= WARPS * (1024 * 8 + 32 * 4), "16 deep slots of 1024 fit");
enum Family { SCAN = 0, PRODUCT = 1, RANK = 2 };

template <typename V>
struct Args {
  const int64_t* ts;
  const V* val;
  const int64_t* counts;
  const int64_t* offsets;
  const int64_t* u;
  const int64_t* uoff;
  int64_t n, g, total;
  int code;
  double q;
  int est, policy;
  V* out;
};

template <typename V>
__device__ __forceinline__ V empty_value() {
  if constexpr (std::is_floating_point<V>::value) return NAN;  // nothing participates
  else return 0;
}

__device__ __forceinline__ uint64_t bits_of(double v) {
  return (uint64_t)__double_as_longlong(v);
}
__device__ __forceinline__ uint64_t bits_of(int64_t v) { return (uint64_t)v; }
__device__ __forceinline__ void from_bits(uint64_t b, double& v) {
  v = __longlong_as_double((long long)b);
}
__device__ __forceinline__ void from_bits(uint64_t b, int64_t& v) { v = (int64_t)b; }

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

// The key a rank function orders a value by: the median the value's own
// (the exact long in int mode), a percentile the float64's.
template <typename V>
__device__ __forceinline__ uint64_t rank_key(uint64_t bits, bool median) {
  V v;
  from_bits(bits, v);
  return median ? order_stats::key_of(v) : order_stats::key_of((double)v);
}

// A row's participants' values (bit j of part: member j) as keys sorted in
// registers, written back over the row's first P words: the n real keys
// first, then ~0 for the rest, where a rank below n never reaches them.
template <int P, typename V>
__device__ __forceinline__ void sort_row(uint64_t* row, unsigned part, bool median) {
  uint64_t k[P];
#pragma unroll
  for (int j = 0; j < P; ++j) k[j] = (part >> j) & 1u ? rank_key<V>(row[j], median) : ~0ull;
  sort_keys<0, P>(k);
#pragma unroll
  for (int j = 0; j < P; ++j) row[j] = k[j];
}

// The order statistics of a row's participating keys (bit j of part: key
// row[j]), w words, unsorted: each candidate's rank is the keys below it
// plus the equal ones before it.  For rows too wide to sort in registers.
struct RowRanks {
  const uint64_t* row;
  unsigned part;
  int w;
  int64_t n;

  __device__ int64_t clip(int64_t k) const { return k < 1 ? 0 : (k > n ? n - 1 : k - 1); }
  // the keys of ranks ra and rb (0-based)
  __device__ void pick(int64_t ra, int64_t rb, uint64_t& a, uint64_t& b) const {
    int found = 0;
    for (unsigned c = part; c && found != 3; c &= c - 1) {
      const int i = __ffs(c) - 1;
      const uint64_t key = row[i];
      int64_t rank = 0;
#pragma unroll 4
      for (int j = 0; j < w; ++j) {
        const uint64_t o = row[j];
        rank += ((part >> j) & 1u) && (o < key || (o == key && j < i));
      }
      if (rank == ra) {
        a = key;
        found |= 1;
      }
      if (rank == rb) {
        b = key;
        found |= 2;
      }
    }
  }
  __device__ uint64_t at(int64_t k) const {
    uint64_t a, b;
    pick(clip(k), clip(k), a, b);
    return a;
  }
  __device__ void pair(int64_t k, uint64_t& a, uint64_t& b) const {
    pick(clip(k), clip(k + 1), a, b);
  }
};

// Slots [k_begin, k_end) of a group of m <= 32 members, rows r0.., by the
// warp's teams; wsm is the warp's WARP_WORDS of shared memory.
template <int FAM, typename V>
__device__ void shallow(const Args<V>& a, int64_t k_begin, int64_t k_end, int64_t r0, int m,
                        uint64_t* wsm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w = m > 0 ? m : 1;  // the team's width: a lane a member
  const int teams = 32 / w, team = lane / w, l = lane % w, first = team * w;
  const unsigned low = w == 32 ? FULL : (1u << w) - 1;
  // the block's teams split the slots in runs of whole batches of w; the
  // lanes past the last team take none
  const int64_t all = (int64_t)WARPS * teams;
  int64_t per = (k_end - k_begin + all - 1) / all;
  per = (per + w - 1) / w * w;
  const int64_t b0 = k_begin + (int64_t)(warp * teams + team) * per;
  const int64_t b1 = team == teams ? b0 : (b0 + per < k_end ? b0 + per : k_end);
  Cursor<V, true> cur;
  if (b0 < b1) {  // below b0: no slot
    const int64_t r = r0 + l;
    cur.start(a.ts, a.val, r * a.n, a.counts[r], a.u[b0]);
  }
  uint64_t* rows = wsm + first * ROW;  // slot i of a batch: rows + i * ROW
  uint64_t* row = rows + l * ROW;      // this lane's slot's row
  for (int64_t k0 = b0; k0 < b0 + per; k0 += w) {
    // 1. each lane its member's contribution at the batch's w slots, into
    // column l of the slots' rows; lane i keeps slot i's participants
    const long long ux = k0 + l < b1 ? a.u[k0 + l] : 0;
    unsigned mine = 0;
    for (int i = 0; i < w; ++i) {
      const int64_t x = (int64_t)__shfl_sync(FULL, ux, first + i);
      V v = 0;
      const bool p = k0 + i < b1 && cur.at(a.ts, a.val, x, a.policy, v);
      if (p) rows[i * ROW + l] = bits_of(v);  // the rest is never read
      const unsigned tb = (__ballot_sync(FULL, p) >> first) & low;
      if (l == i) mine = tb;
    }
    __syncwarp();
    // 2. each lane reduces its slot's row, members in row order
    if (k0 + l < b1 && mine) {
      V res;
      if constexpr (FAM == SCAN) {
        V vf, vl;
        from_bits(row[__ffs(mine) - 1], vf);
        from_bits(row[31 - __clz(mine)], vl);
        res = vf;  // FIRST, NONE
        if (a.code == order_stats::LAST) res = vl;
        else if (a.code == order_stats::DIFF)
          res = __popc(mine) < 2 ? (V)0 : order_stats::sub(vl, vf);
      } else if constexpr (FAM == PRODUCT) {
        res = 1;  // the ordered walk
        for (unsigned b = mine; b; b &= b - 1) {
          V v;
          from_bits(row[__ffs(b) - 1], v);
          res = order_stats::mul(res, v);
        }
      } else {
        const bool median = a.code == order_stats::MEDIAN;
        const int64_t n = __popc(mine);
        if (w <= 16) {
          if (w <= 8) sort_row<8, V>(row, mine, median);
          else sort_row<16, V>(row, mine, median);
          res = rank_reduce<V>(order_stats::SortedRanks{row, n}, a.code, a.q, a.est);
        } else {
#pragma unroll 4
          for (int j = 0; j < w; ++j) row[j] = rank_key<V>(row[j], median);  // in place
          res = rank_reduce<V>(RowRanks{row, mine, w, n}, a.code, a.q, a.est);
        }
      }
      a.out[k0 + l] = res;
    } else if (k0 + l < b1) {
      a.out[k0 + l] = empty_value<V>();
    }
    __syncwarp();  // the rows are refilled by the next batch
  }
}

// Slots [k_begin, k_end) of a group of m > 32 members, rows r0.., by the
// whole block.
template <typename V>
__device__ void deep(const Args<V>& a, int64_t k_begin, int64_t k_end, int64_t r0, int64_t m,
                     unsigned char* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned* hist = (unsigned*)(smem + SMEM - HIST_BYTES) + warp * order_stats::BINS;
  const int64_t words = (m + 31) / 32;
  const int64_t fit = (int64_t)(SMEM - HIST_BYTES) / (m * 8 + words * 4);
  const int64_t slots = fit < WARPS ? fit : WARPS;
  if (slots == 0) {  // too deep to stage: a warp a slot from device memory
    for (int64_t k = k_begin + warp; k < k_end; k += WARPS) {
      const int64_t x = a.u[k];
      auto get = [&](int64_t i, V& v) {
        const int64_t r = r0 + i;
        return contribution_at(a.ts, a.val, r * a.n, a.counts[r], x, a.policy, v);
      };
      int64_t cnt;
      const V res = order_stats::warp_order<V>(get, m, a.code, a.q, a.est, hist, cnt);
      if (lane == 0) a.out[k] = cnt > 0 ? res : empty_value<V>();
    }
    return;
  }
  V* pool = (V*)smem;                                   // slot p: pool + p * m
  unsigned* part = (unsigned*)(smem + slots * m * 8);   // slot p: part + p * words
  const int64_t per_thread = (m + THREADS - 1) / THREADS;
  Cursor<V> cur[MPT];
#pragma unroll
  for (int q = 0; q < MPT; ++q) {
    const int64_t j = threadIdx.x + (int64_t)q * THREADS;
    if (j < m) {
      const int64_t r = r0 + j;
      cur[q].start(a.ts, a.val, r * a.n, a.counts[r], a.u[k_begin]);
    }
  }
  // member j's contribution at slot p: staged, and its bit set by a ballot
  // (a warp's 32 members share one word)
  auto stage = [&](int p, int64_t j, bool in, V v) {
    if (j < m) pool[p * m + j] = v;
    const unsigned b = __ballot_sync(FULL, in);
    if (lane == 0 && (j >> 5) < words) part[p * words + (j >> 5)] = b;
  };
  for (int64_t k = k_begin; k < k_end; k += slots) {
    const int np = (int)(k_end - k < slots ? k_end - k : slots);
    for (int p = 0; p < np; ++p) {
      const int64_t x = a.u[k + p];
#pragma unroll
      for (int q = 0; q < MPT; ++q) {
        if (q < per_thread) {
          const int64_t j = threadIdx.x + (int64_t)q * THREADS;
          V v = 0;
          const bool in = j < m && cur[q].at(a.ts, a.val, x, a.policy, v);
          stage(p, j, in, v);
        }
      }
      for (int64_t q = MPT; q < per_thread; ++q) {
        const int64_t j = threadIdx.x + q * THREADS;
        V v = 0;
        bool in = false;
        if (j < m) {
          const int64_t r = r0 + j;
          in = contribution_at(a.ts, a.val, r * a.n, a.counts[r], x, a.policy, v);
        }
        stage(p, j, in, v);
      }
    }
    __syncthreads();
    if (warp < np) {
      const V* pv = pool + warp * m;
      const unsigned* pb = part + warp * words;
      auto get = [&](int64_t i, V& v) {
        v = pv[i];
        return ((pb[i >> 5] >> (i & 31)) & 1u) != 0;
      };
      int64_t cnt;
      const V res = order_stats::warp_order<V>(get, m, a.code, a.q, a.est, hist, cnt);
      if (lane == 0) a.out[k + warp] = cnt > 0 ? res : empty_value<V>();
    }
    __syncthreads();  // the pool is refilled by the next slots
  }
}

template <int FAM, typename V>
__global__ void __launch_bounds__(THREADS, 1) union_order_kernel(const Args<V> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t k_first = (int64_t)blockIdx.x * CHUNK;
  const int64_t k_last = k_first + CHUNK < a.total ? k_first + CHUNK : a.total;
  int64_t gi = group_of(a.uoff, a.g, k_first);
  for (int64_t k = k_first; k < k_last; ++gi) {  // a group at a time
    const int64_t end = a.uoff[gi + 1] < k_last ? a.uoff[gi + 1] : k_last;
    if (end <= k) continue;  // a group without slots
    const int64_t r0 = a.offsets[gi], m = a.offsets[gi + 1] - r0;
    if (m <= SHALLOW)
      shallow<FAM, V>(a, k, end, r0, (int)m, (uint64_t*)smem + (threadIdx.x >> 5) * WARP_WORDS);
    else
      deep<V>(a, k, end, r0, m, smem);
    __syncthreads();  // shared memory changes hands between the paths
    k = end;
  }
}

template <int FAM, typename V>
cudaError_t launch_family(const Args<V>& a, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      union_order_kernel<FAM, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  union_order_kernel<FAM, V>
      <<<(unsigned)((a.total + CHUNK - 1) / CHUNK), THREADS, SMEM, st>>>(a);
  return cudaGetLastError();
}

template <typename V>
int run(const Args<V>& a, cudaStream_t st) {
  switch (a.code) {
    case order_stats::FIRST:
    case order_stats::LAST:
    case order_stats::DIFF:
    case order_stats::NONE: return (int)launch_family<SCAN, V>(a, st);
    case order_stats::MULT: return (int)launch_family<PRODUCT, V>(a, st);
    default: return (int)launch_family<RANK, V>(a, st);
  }
}

}  // namespace

// code: order_stats::Order; q and est: the percentile and its estimator;
// policy: union_contrib::Policy; val_is_int selects float64 (0) or int64
// (1) values and output.  counts[S] (int64) is scratch: each row's valid
// points.
extern "C" int union_order(const void* ts, const void* val, const void* mask,
                           const void* offsets, const void* u, const void* uoff, long long s,
                           long long n, long long g, long long total, int code, double q,
                           int est, int policy, int val_is_int, void* counts, void* out,
                           void* stream) {
  if (s <= 0 || n <= 0 || g <= 0 || total <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = row_counts(mask, s, n, counts, st);
  if (err != cudaSuccess) return (int)err;
  if (val_is_int)
    return run<int64_t>(Args<int64_t>{(const int64_t*)ts, (const int64_t*)val,
                                      (const int64_t*)counts, (const int64_t*)offsets,
                                      (const int64_t*)u, (const int64_t*)uoff, n, g, total,
                                      code, q, est, policy, (int64_t*)out},
                        st);
  return run<double>(Args<double>{(const int64_t*)ts, (const double*)val,
                                  (const int64_t*)counts, (const int64_t*)offsets,
                                  (const int64_t*)u, (const int64_t*)uoff, n, g, total, code, q,
                                  est, policy, (double*)out},
                     st);
}

extern "C" const char* union_order_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
