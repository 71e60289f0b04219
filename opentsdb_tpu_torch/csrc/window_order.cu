// K4 window_order: per-(series, window) order and rank functions over
// time-sorted rows, then the fill policy.
//
// Replaces the order/rank branch of opentsdb_tpu/ops/downsample.py:
// downsample (:1165-1262: mult :1218, first/last/diff :1222, median and the
// LEGACY / R-3 / R-7 percentiles :1237 through ops/percentile.py:
// row_run_percentile and _estimate) and apply_fill.  Values are taken as
// float64 (an int64 row is converted first) and the output is float64
// (Downsampler.java:257); masked slots and NaN values take no part, and a
// window with none holds no data (mask = count > 0).
//
// Bound on the H100: bytes.  It must read val and mask once (9 B a point),
// ts only where a window edge falls, and write 9 B a window cell: 0.61 GB
// at the headline batch (1024 x 65,536 points, 283 1h windows), about
// 0.18 ms at 3.35 TB/s.
//
// Design: rows are time-sorted (pads at int64 max sort last), so a window
// is a contiguous run of its row.  One block owns one row and a tile of
// TILE_W windows, as K1 does: its threads find the tile's TILE_W + 1 edge
// positions once, by window_runs.cuh's binary search, then each warp takes
// whole windows of the tile.  Each family of functions has its own kernel
// (a template on the family), so that each keeps its own registers and
// shared memory:
//   - first, last, diff: a warp ballots 32 slots at a time from each end
//     of the run towards the first and the last value taking part; it
//     reads a few slots, not the run.
//   - mult: the warp-parallel ordered product (order_stats.cuh
//     warp_mult): one strided pass over the run, four loads in flight a
//     lane, decides most runs (a product that cannot leave the normal
//     range, or magnitudes that only grow, as the headline batch's do);
//     the rest take the chunked ordered analysis, and a run that comes
//     near DBL_MAX or 2^-1022 before its class is decided takes the
//     ordered walk on one lane, inside the kernel.  The class (finite,
//     +-inf, +-0, NaN) is always the ordered walk's.
//   - median and percentiles: a run of up to CAP_W points is staged into
//     the warp's shared room with cp.async and turned in place into the
//     keys of its values (NO_KEY where a point takes no part); the radix
//     select and the second order statistic then read only shared memory
//     (usually one counting pass, then the chosen bin's few keys ranked
//     directly).  A run longer than CAP_W is taken by the whole block after
//     the warps' runs: staged the same way up to CAP_B points, else
//     selected in device memory by the block, narrowed into shared memory
//     as soon as the candidates fit.
// Every cell has one writer, after a fixed sequence of shuffles and
// scans; nothing is atomic but the shared-memory counts and gathers of the
// selection, whose result does not depend on their order.  So a cell's
// result depends only on its own run: the passes of mult stride from the
// run's start with a fixed lane count, and the run's length alone chooses
// the warp or the block that takes it.
//
// Stacked form (B14, opentsdb_tpu/ops/pipeline.py:225, as K1's): Q members'
// batches are one [Q*S, N] batch and edges is [Q, W+1]; row r reads the
// edges of member r / rows_per_member.  A solo call passes
// rows_per_member = S and one edge row: one code path, so a stacked cell is
// bit for bit its solo cell.
//
// Int32 form (B10, as K1's): ts holds int32 offsets from the query's first
// window and edges the re-based [W+1] edges; the search reads 4-byte words
// and finds the same runs, so every cell is bit for bit the int64 form's.
// The stacked launches stay int64.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "order_stats.cuh"
#include "window_runs.cuh"

namespace {

using order_stats::FULL;

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int TILE_W = 128;              // windows a block
constexpr int CAP_W = 256;               // points of a run a warp stages
constexpr int ITEMS = CAP_W / 32;        // points a lane stages
constexpr int CAP_B = WARPS * CAP_W;     // points of a run the block stages
enum Family { SCAN = 0, PRODUCT = 1, RANK = 2 };
// A staged point that takes no part: above every key of a value.
constexpr uint64_t NO_KEY = ~0ull;

// Shared memory of the rank family beyond the edge positions: a room a
// warp (together the block's stage of CAP_B keys for a long run), each
// warp's counters and the block's reduction words.
constexpr size_t RANK_SMEM =
    (size_t)CAP_B * 8 + (size_t)WARPS * order_stats::BINS * 4 + WARPS * 8;

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

template <typename VIn>
__device__ __forceinline__ double as_double(uint64_t raw) {
  if constexpr (std::is_integral<VIn>::value)
    return (double)(int64_t)raw;
  else
    return __longlong_as_double((long long)raw);
}

// The rank functions' staging by a team: room[i] (thread i % size copies
// it with cp.async) becomes the key of point i's value, or NO_KEY where it
// takes no part (past every key, and never reached by a rank below the
// count of keys).  Each thread converts only what it copied.  Returns the
// count of keys, and their bitwise AND and OR.
template <typename Team, typename VIn>
__device__ int64_t stage_keys(const Team& team, const VIn* v, const uint8_t* mk, int64_t m,
                              uint64_t* room, uint64_t& kand, uint64_t& kor) {
  const int r = team.rank(), sz = team.size();
  unsigned keep = 0;  // bit j: the mask byte of this thread's j-th point
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int64_t i = r + (int64_t)sz * j;
    if (i < m) {
      cp_async8(room + i, v + i);
      keep |= (mk[i] ? 1u : 0u) << j;
    }
  }
  cp_async_wait_all();
  long long cnt = 0;
  unsigned long long all = ~0ull, any = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int64_t i = r + (int64_t)sz * j;
    if (i < m) {
      const double d = as_double<VIn>(room[i]);
      uint64_t k = NO_KEY;
      if (((keep >> j) & 1u) && !isnan(d)) {
        k = order_stats::key_of(d);
        cnt += 1;
        all &= k;
        any |= k;
      }
      room[i] = k;
    }
  }
  kand = team.and_key(all);
  kor = team.or_key(any);
  team.sync();
  return team.sum(cnt);
}

// Median or percentile of a run's n keys (staged, or read through keyed).
template <typename Team, typename Keyed>
__device__ double rank_of(const Team& team, Keyed keyed, int64_t m, const uint64_t* pool,
                          int64_t pool_n, uint64_t* narrow, int64_t cap, int64_t n,
                          uint64_t kand, uint64_t kor, unsigned* hist, int code, double q,
                          int est) {
  const order_stats::Ranks<Keyed, Team> r{keyed, m,    n,      hist, kand, kor,
                                          pool,  pool_n, narrow, cap,  team};
  if (code == order_stats::MEDIAN) return order_stats::double_of(r.at(n / 2 + 1));
  return order_stats::percentile(r, q, est);
}

template <int FAM, typename T, typename VIn>
__global__ void __launch_bounds__(THREADS, FAM == RANK ? 5 : 8)
window_order_kernel(const T* __restrict__ ts, const VIn* __restrict__ val,
                    const uint8_t* __restrict__ mask, const T* __restrict__ edges,
                    int64_t n, int w, int64_t rows_per_member, int code, double q, int est,
                    int fill_mode, double fill_value, double* __restrict__ out,
                    uint8_t* __restrict__ out_mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int64_t pos[TILE_W + 1];
  const int64_t row = blockIdx.x;
  const int w0 = blockIdx.y * TILE_W;
  const int tw = min(TILE_W, w - w0);
  const T* trow = ts + row * n;
  const VIn* vrow = val + row * n;
  const uint8_t* mrow = mask + row * n;
  // this row's member's window edges
  const T* medges = edges + (row / rows_per_member) * (int64_t)(w + 1);
  for (int i = threadIdx.x; i <= tw; i += THREADS) pos[i] = lower_bound(trow, n, medges[w0 + i]);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  auto write = [&](int j, bool has, double res) {
    const int64_t cell = row * (int64_t)w + w0 + j;
    out[cell] = has ? res : (fill_mode ? fill_value : NAN);
    // FILL_NONE exposes windows holding data; a fill exposes every one
    out_mask[cell] = (has || fill_mode) ? 1 : 0;
  };
  auto value = [&](int64_t k, double& v) {  // both loads issued together
    const uint8_t keep = mrow[k];
    v = (double)vrow[k];
    return keep && !isnan(v);
  };

  if constexpr (FAM == SCAN) {
    for (int j = warp; j < tw; j += WARPS) {
      const int64_t lo = pos[j], hi = pos[j + 1];
      int64_t first = -1, last = -1;
      for (int64_t base = lo; base < hi; base += 32) {
        double v;
        const unsigned b = __ballot_sync(FULL, base + lane < hi && value(base + lane, v));
        if (b) {
          first = base + __ffs(b) - 1;
          break;
        }
      }
      if (first >= 0) {
        for (int64_t top = hi; top > first; top -= 32) {
          double v;
          const unsigned b =
              __ballot_sync(FULL, top - 1 - lane >= first && value(top - 1 - lane, v));
          if (b) {
            last = top - __ffs(b);
            break;
          }
        }
      }
      if (lane == 0) {
        double res = 0.0;
        if (first >= 0) {
          double a, b;
          value(first, a);
          value(last, b);
          if (code == order_stats::LAST) res = b;
          else if (code == order_stats::DIFF) res = first < last ? __dsub_rn(b, a) : 0.0;
          else res = a;  // FIRST, NONE
        }
        write(j, first >= 0, res);
      }
    }
  } else if constexpr (FAM == PRODUCT) {
    for (int j = warp; j < tw; j += WARPS) {
      const int64_t lo = pos[j];
      int64_t cnt;
      const double res = order_stats::warp_mult(
          [&](int64_t i, double& v) { return value(lo + i, v); }, pos[j + 1] - lo, cnt);
      if (lane == 0) write(j, cnt > 0, res);
    }
  } else {  // RANK
    uint64_t* stage = (uint64_t*)smem;                            // CAP_B keys
    unsigned* hist = (unsigned*)(stage + CAP_B);                  // WARPS x BINS
    unsigned long long* red = (unsigned long long*)(hist + WARPS * order_stats::BINS);
    auto none = [](int64_t, uint64_t&) { return false; };
    // 1. the runs that fit a warp's room, a warp a run
    {
      const order_stats::WarpTeam team;
      uint64_t* room = stage + warp * CAP_W;
      unsigned* h = hist + warp * order_stats::BINS;
      for (int j = warp; j < tw; j += WARPS) {
        const int64_t lo = pos[j], m = pos[j + 1] - lo;
        if (m > CAP_W) continue;
        uint64_t kand, kor;
        const int64_t cnt = stage_keys(team, vrow + lo, mrow + lo, m, room, kand, kor);
        const double res =
            cnt > 0 ? rank_of(team, none, 0, room, m, nullptr, 0, cnt, kand, kor, h, code, q,
                              est)
                    : 0.0;
        if (lane == 0) write(j, cnt > 0, res);
        __syncwarp();  // the room is reused by the warp's next window
      }
    }
    __syncthreads();
    // 2. the longer runs, the whole block on each
    const order_stats::BlockTeam team{red};
    for (int j = 0; j < tw; ++j) {
      const int64_t lo = pos[j], m = pos[j + 1] - lo;
      if (m <= CAP_W) continue;
      uint64_t kand, kor;
      int64_t cnt;
      double res = 0.0;
      if (m <= CAP_B) {
        cnt = stage_keys(team, vrow + lo, mrow + lo, m, stage, kand, kor);
        if (cnt > 0)
          res = rank_of(team, none, 0, stage, m, nullptr, 0, cnt, kand, kor, hist, code, q,
                        est);
      } else {
        auto keyed = [&](int64_t i, uint64_t& k) {
          double v;
          if (!value(lo + i, v)) return false;
          k = order_stats::key_of(v);
          return true;
        };
        long long c = 0;
        unsigned long long all = ~0ull, any = 0;
        for (int64_t i = threadIdx.x; i < m; i += THREADS) {
          uint64_t k;
          if (keyed(i, k)) {
            c += 1;
            all &= k;
            any |= k;
          }
        }
        cnt = team.sum(c);
        kand = team.and_key(all);
        kor = team.or_key(any);
        if (cnt > 0)
          res = rank_of(team, keyed, m, nullptr, -1, stage, CAP_B, cnt, kand, kor, hist, code,
                        q, est);
      }
      if (threadIdx.x == 0) write(j, cnt > 0, res);
      __syncthreads();  // the stage is reused by the next long run
    }
  }
}

template <typename T, typename VIn>
int launch(const void* ts, const void* val, const void* mask, const void* edges, long long s,
           long long n, int w, long long rows_per_member, int code, double q, int est,
           int fill_mode, double fill_value, void* out, void* out_mask, void* stream) {
  if (s <= 0 || w <= 0 || rows_per_member <= 0) return 0;
  const dim3 grid((unsigned)s, (unsigned)((w + TILE_W - 1) / TILE_W));
  const cudaStream_t st = (cudaStream_t)stream;
#define K4_ARGS                                                                          \
  (const T*)ts, (const VIn*)val, (const uint8_t*)mask, (const T*)edges, (int64_t)n, w,   \
      (int64_t)rows_per_member, code, q, est, fill_mode, fill_value, (double*)out,       \
      (uint8_t*)out_mask
  switch (code) {
    case order_stats::FIRST:
    case order_stats::LAST:
    case order_stats::DIFF:
    case order_stats::NONE:
      window_order_kernel<SCAN, T, VIn><<<grid, THREADS, 0, st>>>(K4_ARGS);
      break;
    case order_stats::MULT:
      window_order_kernel<PRODUCT, T, VIn><<<grid, THREADS, 0, st>>>(K4_ARGS);
      break;
    default:
      window_order_kernel<RANK, T, VIn><<<grid, THREADS, RANK_SMEM, st>>>(K4_ARGS);
  }
#undef K4_ARGS
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ts(const void* ts, const void* val, const void* mask, const void* edges,
              long long s, long long n, int w, long long rows_per_member, int code,
              double q, int est, int fill_mode, double fill_value, int val_is_int,
              void* out, void* out_mask, void* stream) {
  if (val_is_int)
    return launch<T, int64_t>(ts, val, mask, edges, s, n, w, rows_per_member, code, q, est,
                              fill_mode, fill_value, out, out_mask, stream);
  return launch<T, double>(ts, val, mask, edges, s, n, w, rows_per_member, code, q, est,
                           fill_mode, fill_value, out, out_mask, stream);
}

}  // namespace

// code: order_stats::Order; q and est: the percentile and its estimator
// (order_stats::Est); val_is_int selects float64 (0) or int64 (1) rows;
// ts_is_i32 the timestamp type of ts and edges: int64 ms (0) or int32
// offsets from a base (1); edges holds s / rows_per_member rows of w + 1
// edges.
extern "C" int window_order(const void* ts, const void* val, const void* mask,
                            const void* edges, long long s, long long n, int w,
                            long long rows_per_member, int code, double q, int est,
                            int fill_mode, double fill_value, int val_is_int,
                            int ts_is_i32, void* out, void* out_mask, void* stream) {
  if (ts_is_i32)
    return launch_ts<int32_t>(ts, val, mask, edges, s, n, w, rows_per_member, code, q,
                              est, fill_mode, fill_value, val_is_int, out, out_mask,
                              stream);
  return launch_ts<int64_t>(ts, val, mask, edges, s, n, w, rows_per_member, code, q, est,
                            fill_mode, fill_value, val_is_int, out, out_mask, stream);
}

extern "C" const char* window_order_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
