// K5 group_order: the grouped cross-series order and rank reduces,
// [S, W] -> [G, W].
//
// Replaces opentsdb_tpu/ops/group_agg.py:ordered_group_reduce (first, last,
// diff and none in row order, the order series entered the group, :563-566;
// mult; the upper median; the LEGACY / R-3 / R-7 percentiles through
// ops/percentile.py:column_run_percentile) and the presence fold of
// grid_group_aggregate (:641): per (group, window), over the member cells
// that participate and are not NaN; NaN where none does; out_mask = some
// member is present in that window.
//
// Bound on the H100: bytes.  It reads contrib (f64), participate and
// present (u8) once, 10 B a series cell, and writes 9 B a group cell: at
// 1024 x 283 series cells about 2.9 MB, under 1 us at 3.35 TB/s, so a
// launch's latency sets the time at the main path's sizes.
//
// Design: groups are contiguous row runs [offsets[g], offsets[g+1]) (the
// planner emits them that way).  A block of 128 threads owns one group and
// a tile of adjacent windows; it reads its group's size m from offsets and
// takes one of three routes by m.  The tile comes from the grid's mean
// group depth, which the host knows without reading the offsets: 128
// windows where the mean is at most 32 rows, else 1 (a single group of
// 1024 rows over 283 windows is then 283 blocks, where a wider tile would
// leave most of the card idle).
//   - Shallow groups (m <= 32: the dashboard's `{group=*}` panels).  A
//     thread a (group, window) cell of the tile: it loads
//     the group's m rows at once into registers (adjacent lanes read
//     adjacent windows of a row, so each row is one coalesced load) and
//     folds presence from them.  first, last, diff and none take the first
//     and last participating value; mult is the ordered walk itself;
//     median and percentiles sort the participants' keys in registers by a
//     network of 8, 16 or 32 (order_stats::sort_keys; the rest, ~0, sort
//     last) and take the estimators over them (SortedRanks).
//   - Deep groups (32 < m <= POOL_KEYS, 4,224).  The block stages the group's
//     rows x as many of the tile's windows as the pool holds into shared
//     memory as order-preserving keys (a cell that takes no part holds ~0,
//     above every value's key), reading row segments, a thread's loads of
//     16 cells issued before their stores, and folds presence on the way;
//     then each window's pool is reduced: the first and last key that is
//     not ~0, the radix select in its pool form (order_stats::select,
//     Ranks) by the whole block where a pass holds one window (the deep
//     grid's tile) and by a warp a window otherwise, and mult by
//     order_stats::warp_mult over the keys' values, a warp a window.
//   - Deeper groups (m > POOL_KEYS: tens of thousands of rows) stay in
//     device memory: a warp a window, order_stats::warp_order reading the
//     column on each pass.
// Each cell has one writer: no atomics on results, the same result on
// every run.  The selections are exact, so every result but mult equals
// the reference's sorted order statistics whatever the route; a deep or
// deeper group's mult is warp_mult's (the ordered walk's class, its value
// within rounding), a shallow group's the ordered walk.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "order_stats.cuh"

namespace {

using order_stats::FULL;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int SHALLOW = 32;       // rows a thread walks for its cell
constexpr int WIDE_TILE = 128;    // windows a block owns in a shallow grid
constexpr int DEEP_TILE = 1;      // and in a deep one
constexpr int ROW = 33;           // words of a shallow thread's row (32, and one against
                                  // bank conflicts)
constexpr int POOL_KEYS = 4224;   // keys a block stages (the shallow rows' room)
constexpr int STAGE = 16;         // elements a thread loads at once when staging
constexpr int HIST_WORDS = WARPS * order_stats::BINS;
static_assert(POOL_KEYS >= THREADS * ROW, "the shallow rows fit in the pool");
static_assert(WIDE_TILE >= DEEP_TILE && WIDE_TILE <= THREADS, "a pass's flags fit");
enum Family { SCAN = 0, PRODUCT = 1, RANK = 2 };
constexpr uint64_t ABSENT = ~0ull;  // the key of a cell that takes no part

struct Args {
  const double* contrib;
  const uint8_t* participate;
  const uint8_t* present;
  const int64_t* offsets;
  int64_t g;
  int w, tile, code;
  double q;
  int est;
  double* out;
  uint8_t* out_mask;
};

// One cell of a group of m <= P rows from r0 (P 8, 16 or 32), by one
// thread: every row's loads issued at once, the reduce in registers.
template <int FAM, int P>
__device__ void shallow_cell(const Args& a, int64_t r0, int m, int col, int64_t cell,
                             uint64_t* row) {
  const double* __restrict__ cp = a.contrib + r0 * a.w + col;
  const uint8_t* __restrict__ pp = a.participate + r0 * a.w + col;
  const uint8_t* __restrict__ ep = a.present + r0 * a.w + col;
  double v[P];
  uint8_t pb[P], eb[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    v[j] = 0.0;
    pb[j] = eb[j] = 0;
    if (j < m) {
      const int64_t k = (int64_t)j * a.w;
      v[j] = cp[k];
      pb[j] = pp[k];
      eb[j] = ep[k];
    }
  }
  unsigned part = 0;
  bool any = false;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    part |= (unsigned)(pb[j] && !isnan(v[j])) << j;
    any = any || eb[j];
  }
  double res = NAN;
  if (part) {
    if constexpr (FAM == SCAN) {
      double first = 0.0, last = 0.0;
#pragma unroll
      for (int j = P - 1; j >= 0; --j)
        if ((part >> j) & 1u) first = v[j];
#pragma unroll
      for (int j = 0; j < P; ++j)
        if ((part >> j) & 1u) last = v[j];
      res = first;  // FIRST, NONE
      if (a.code == order_stats::LAST) res = last;
      else if (a.code == order_stats::DIFF)
        res = __popc(part) < 2 ? 0.0 : order_stats::sub(last, first);
    } else if constexpr (FAM == PRODUCT) {
      res = 1.0;  // the ordered walk
#pragma unroll
      for (int j = 0; j < P; ++j)
        if ((part >> j) & 1u) res = order_stats::mul(res, v[j]);
    } else {
      // the participants' keys sorted (the rest, ~0, last), then ranked
      uint64_t k[P];
#pragma unroll
      for (int j = 0; j < P; ++j) k[j] = (part >> j) & 1u ? order_stats::key_of(v[j]) : ABSENT;
      order_stats::sort_keys<0, P>(k);
#pragma unroll
      for (int j = 0; j < P; ++j) row[j] = k[j];
      res = order_stats::rank_reduce<double>(
          order_stats::SortedRanks{row, (int64_t)__popc(part)}, a.code, a.q, a.est);
    }
  }
  a.out[cell] = res;
  a.out_mask[cell] = any ? 1 : 0;
}

// The reduce of one window's run of m elements in device memory by one
// warp; get(i, v) says whether element i takes part and gives its value.
// Writes the cell on lane 0.
template <typename Get>
__device__ void warp_cell(const Args& a, Get get, int64_t m, int64_t cell, bool any,
                          unsigned* hist) {
  int64_t cnt;
  const double res = order_stats::warp_order<double>(get, m, a.code, a.q, a.est, hist, cnt);
  if ((threadIdx.x & 31) == 0) {
    a.out[cell] = cnt > 0 ? res : NAN;
    a.out_mask[cell] = any ? 1 : 0;
  }
}

// One window's staged pool of m keys (ABSENT: no part), by a team: one
// warp (mult: warp_mult's ordered-walk class needs one), or the whole
// block.  Writes the cell on the team's first thread.
template <int FAM, typename Team>
__device__ void pool_cell(const Args& a, const Team& team, const uint64_t* pool, int64_t m,
                          int64_t cell, bool any, unsigned* hist) {
  double res;
  int64_t n;
  if constexpr (FAM == PRODUCT) {
    auto get = [&](int64_t i, double& v) {
      const uint64_t k = pool[i];
      v = order_stats::double_of(k);
      return k != ABSENT;
    };
    res = order_stats::warp_mult(get, m, n);
  } else {
    // the count, the first and last participant (the last as m - 1 - i,
    // so that both are minima) and the keys' AND and OR
    long long cnt = 0;
    unsigned long long first = ~0ull, back = ~0ull, kand = ~0ull, kor = 0;
    for (int64_t i = team.rank(); i < m; i += team.size()) {
      const uint64_t k = pool[i];
      if (k == ABSENT) continue;
      cnt += 1;
      first = (unsigned long long)i < first ? i : first;
      back = (unsigned long long)(m - 1 - i);
      kand &= k;
      kor |= k;
    }
    n = team.sum(cnt);
    if (n == 0) {
      res = 0.0;
    } else if constexpr (FAM == SCAN) {
      const double vf = order_stats::double_of(pool[team.min_key(first)]);
      const double vl = order_stats::double_of(pool[m - 1 - (int64_t)team.min_key(back)]);
      res = vf;  // FIRST, NONE
      if (a.code == order_stats::LAST) res = vl;
      else if (a.code == order_stats::DIFF) res = n < 2 ? 0.0 : order_stats::sub(vl, vf);
    } else {
      auto unused = [](int64_t, uint64_t&) { return false; };
      const order_stats::Ranks<decltype(unused), Team> r{
          unused, m, n, hist, team.and_key(kand), team.or_key(kor), pool, m, nullptr, 0, team};
      res = order_stats::rank_reduce<double>(r, a.code, a.q, a.est);
    }
  }
  if (team.rank() == 0) {
    a.out[cell] = n > 0 ? res : NAN;
    a.out_mask[cell] = any ? 1 : 0;
  }
}

template <int FAM>
__global__ void __launch_bounds__(THREADS) group_order_kernel(const Args a) {
  __shared__ __align__(16) uint64_t pool[POOL_KEYS];
  __shared__ unsigned hist[HIST_WORDS];
  __shared__ int flags[WIDE_TILE];
  __shared__ unsigned long long red[WARPS];  // the block team's reductions
  const int tiles = (a.w + a.tile - 1) / a.tile;
  const int64_t gi = blockIdx.x / tiles;
  const int c0 = (int)(blockIdx.x - gi * tiles) * a.tile;
  const int c1 = c0 + a.tile < a.w ? c0 + a.tile : a.w;
  const int64_t r0 = a.offsets[gi], m = a.offsets[gi + 1] - r0;
  const int64_t base = gi * a.w;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (m <= SHALLOW) {
    uint64_t* row = pool + threadIdx.x * ROW;
    for (int col = c0 + threadIdx.x; col < c1; col += THREADS) {
      if (m <= 8) shallow_cell<FAM, 8>(a, r0, (int)m, col, base + col, row);
      else if (m <= 16) shallow_cell<FAM, 16>(a, r0, (int)m, col, base + col, row);
      else shallow_cell<FAM, 32>(a, r0, (int)m, col, base + col, row);
    }
    return;
  }
  unsigned* my_hist = hist + warp * order_stats::BINS;
  if (m > POOL_KEYS) {
    for (int col = c0 + warp; col < c1; col += WARPS) {
      const double* cp = a.contrib + r0 * a.w + col;
      const uint8_t* pp = a.participate + r0 * a.w + col;
      const uint8_t* ep = a.present + r0 * a.w + col;
      auto get = [&](int64_t i, double& v) {  // both loads issued together
        const uint8_t p = pp[i * a.w];
        v = cp[i * a.w];
        return p && !isnan(v);
      };
      bool any = false;
      for (int64_t i = lane; i < m; i += 32) any = any || ep[i * a.w];
      warp_cell(a, get, m, base + col, __any_sync(FULL, any), my_hist);
    }
    return;
  }
  // windows a pass stages: as many as the pool holds m keys of
  const int per = (int)(POOL_KEYS / m);
  for (int cs = c0; cs < c1; cs += per) {
    const int nc = c1 - cs < per ? c1 - cs : per;
    if ((int)threadIdx.x < nc) flags[threadIdx.x] = 0;
    __syncthreads();
    // element e is (row e / nc, window e % nc): a row's windows are
    // adjacent; a thread issues the loads of STAGE elements, then stores
    const int count = (int)m * nc;
    const uint64_t magic = 0xffffffffull / nc + 1;  // e / nc = e * magic >> 32 (e < 2^32 / nc)
    for (int e0 = threadIdx.x; e0 < count; e0 += STAGE * THREADS) {
      double v[STAGE];
      uint8_t pb[STAGE], eb[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int e = e0 + u * THREADS;
        if (e < count) {
          const int r = (int)((uint64_t)e * magic >> 32);
          const int64_t k = (r0 + r) * a.w + cs + (e - r * nc);
          v[u] = a.contrib[k];
          pb[u] = a.participate[k];
          eb[u] = a.present[k];
        }
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int e = e0 + u * THREADS;
        if (e < count) {
          const int r = (int)((uint64_t)e * magic >> 32), c = e - r * nc;
          if (eb[u]) flags[c] = 1;
          pool[c * m + r] = pb[u] && !isnan(v[u]) ? order_stats::key_of(v[u]) : ABSENT;
        }
      }
    }
    __syncthreads();
    bool done = false;
    if constexpr (FAM != PRODUCT) {
      if (nc == 1) {  // one window: the whole block reduces it
        pool_cell<FAM>(a, order_stats::BlockTeam{red}, pool, m, base + cs, flags[0] != 0, hist);
        done = true;
      }
    }
    if (!done)
      for (int c = warp; c < nc; c += WARPS)
        pool_cell<FAM>(a, order_stats::WarpTeam(), pool + c * m, m, base + cs + c,
                       flags[c] != 0, my_hist);
    __syncthreads();  // the pool is refilled by the next pass
  }
}

int run(const Args& a, cudaStream_t st) {
  const int tiles = (a.w + a.tile - 1) / a.tile;
  const unsigned blocks = (unsigned)(a.g * tiles);
  switch (a.code) {
    case order_stats::FIRST:
    case order_stats::LAST:
    case order_stats::DIFF:
    case order_stats::NONE: group_order_kernel<SCAN><<<blocks, THREADS, 0, st>>>(a); break;
    case order_stats::MULT: group_order_kernel<PRODUCT><<<blocks, THREADS, 0, st>>>(a); break;
    default: group_order_kernel<RANK><<<blocks, THREADS, 0, st>>>(a); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// s: the rows of contrib (with g, the grid's mean group depth, which picks
// the tile); code: order_stats::Order; q and est: the percentile and its
// estimator.
extern "C" int group_order(const void* contrib, const void* participate, const void* present,
                           const void* offsets, long long s, long long g, int w, int code,
                           double q, int est, void* out, void* out_mask, void* stream) {
  if (g <= 0 || w <= 0) return 0;
  const int tile = s <= (long long)SHALLOW * g ? WIDE_TILE : DEEP_TILE;
  return run(Args{(const double*)contrib, (const uint8_t*)participate, (const uint8_t*)present,
                  (const int64_t*)offsets, g, w, tile, code, q, est, (double*)out,
                  (uint8_t*)out_mask},
             (cudaStream_t)stream);
}

extern "C" const char* group_order_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
