// S2 sketch_fold: each (series, window) cell's exact 64-point equi-rank grid
// of one chunk, merged into the streaming state's quantile sketch in place.
//
// Replaces the sketch branch of opentsdb_tpu/ops/streaming.py
// _chunk_moments (:333-349: the (window, value) row sort), _rank_grid
// (:351), _interp_rows (:384) and _merge_sketch (:406).  The chunk is
// [S, n] time-sorted rows; its local windows are edges[0..wc] and land in
// the state's columns [w0, w0 + wc) of a [S, W] grid whose sketch is q
// float32 [S, W, 64] and whose counts n int64 [S, W] are read before the
// moment fold (S1) adds the chunk.  Masked slots and NaN values take no
// part.
//
// For a cell with m points in its run and c valid ones:
//   1. the chunk grid: g[j] = value at fractional rank (j + 0.5) / 64 of
//      the c sorted values, linearly interpolated between the order
//      statistics floor(r) and floor(r) + 1 (clipped to the run), computed
//      in float64 and rounded to float32; all zeros when c = 0;
//   2. the merge of (q_state, n1) with (g, c): the 128 points sorted by
//      value (a side with no points sorts last, then takes the greatest
//      carried value; ties keep the state's points first, as the
//      reference's stable argsort does), each weighing n/64 at its
//      midpoint rank; the merged grid reads the mixture at the 64
//      midpoint targets, an equal-valued bracket giving its lower value,
//      so that a real +inf survives.  Every cell of the slice is merged,
//      as the reference merges it.
//
// Bound on the H100: bytes.  The kernel must read val and mask once (9 B
// a point), ts where an edge falls, and read and write the slice's sketch
// (256 B a cell each way) and read its counts.  At the headline chunk
// (1024 x 4096, a 64-window slice) about 37 MB + 34 MB, ~0.021 ms at
// 3.35 TB/s.
//
// Design: a block (256 threads) owns a cell.  A run of up to 4,096 points
// is staged in shared memory as order-preserving 64-bit keys
// (order_stats.cuh key_of; slots that take no part key past every value)
// and bitonic-sorted by the block; the grid reads the sorted keys.  A
// longer run (a "0all" window over a whole chunk row) is never staged:
// each of the block's warps finds its share of the 128 order statistics by
// the radix select of order_stats.cuh, reading the run from device memory
// on each pass.  The merge ranks the 128 points by counting (a thread a
// point, ties by position), then one thread accumulates the midpoint
// ranks (exact: every weight is a multiple of 1/64) and 64 threads read
// the targets.  Arithmetic is explicitly rounded (no fused multiply-add),
// in the reference's types: the interpolation of the merge takes the
// difference of two float32 values in float32.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "order_stats.cuh"
#include "window_runs.cuh"

namespace {

constexpr int K = 64;             // summary points (ops/streaming.py SKETCH_K)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SORT_CAP = 4096;    // longest run staged and sorted
constexpr uint64_t NO_KEY = ~0ull;

__device__ __forceinline__ double grid_point(int j, double cf) {
  // fractional 0-based rank of target j, clipped to [0, max(c - 1, 0)]
  double fr = __dsub_rn(__dmul_rn(__ddiv_rn((double)j + 0.5, (double)K), cf), 0.5);
  fr = fmin(fmax(fr, 0.0), fmax(__dsub_rn(cf, 1.0), 0.0));
  return fr;
}

__device__ __forceinline__ double lerp(double a, double b, double frac) {
  return __dadd_rn(a, __dmul_rn(frac, __dsub_rn(b, a)));
}

__global__ void __launch_bounds__(THREADS)
sketch_fold_kernel(const int64_t* __restrict__ ts, const double* __restrict__ val,
                   const uint8_t* __restrict__ mask, const int64_t* __restrict__ edges,
                   int64_t n, int wc, int64_t w, int64_t w0,
                   const int64_t* __restrict__ n_state, float* __restrict__ q_state) {
  __shared__ uint64_t keys[SORT_CAP];          // the run; then the merge's points
  __shared__ unsigned hist[WARPS][order_stats::BINS];
  __shared__ double grid[K];
  __shared__ int64_t run_lo, run_hi;
  __shared__ int valid_part[WARPS];

  const int64_t cell = blockIdx.x;
  const int64_t row = cell / wc;
  const int j = (int)(cell - row * wc);
  const int64_t* trow = ts + row * n;
  const double* vrow = val + row * n;
  const uint8_t* mrow = mask + row * n;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    run_lo = lower_bound(trow, n, edges[j]);
    run_hi = lower_bound(trow, n, edges[j + 1]);
  }
  __syncthreads();
  const int64_t lo = run_lo, m = run_hi - run_lo;
  auto get = [&](int64_t i, double& v) {
    v = vrow[lo + i];
    return mrow[lo + i] && !isnan(v);
  };

  // the chunk's count c of the cell
  int part = 0;
  for (int64_t i = tid; i < m; i += THREADS) {
    double v;
    part += get(i, v) ? 1 : 0;
  }
  part = warp_sum_int(part);
  if (lane == 0) valid_part[warp] = part;
  __syncthreads();
  int64_t c = 0;
  for (int i = 0; i < WARPS; ++i) c += valid_part[i];
  const double cf = (double)c;

  // 1. the chunk grid, in float64
  if (c > 0 && m <= SORT_CAP) {
    int p = 1;
    while (p < m) p <<= 1;
    for (int i = tid; i < p; i += THREADS) {
      double v;
      keys[i] = (i < m && get(i, v)) ? order_stats::key_of(v) : NO_KEY;
    }
    __syncthreads();
    for (int k = 2; k <= p; k <<= 1) {
      for (int h = k >> 1; h > 0; h >>= 1) {
        for (int i = tid; i < p; i += THREADS) {
          const int ixj = i ^ h;
          if (ixj > i) {
            const uint64_t a = keys[i], b = keys[ixj];
            if ((a > b) == ((i & k) == 0)) {
              keys[i] = b;
              keys[ixj] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    if (tid < K) {
      const double fr = grid_point(tid, cf);
      const double fl = floor(fr);
      const int64_t r = (int64_t)fl;
      const int64_t r2 = min(r + 1, c - 1);
      grid[tid] = lerp(order_stats::double_of(keys[r]), order_stats::double_of(keys[r2]),
                       __dsub_rn(fr, fl));
    }
  } else if (c > 0) {
    auto keyed = [&](int64_t i, uint64_t& k) {
      double v;
      if (!get(i, v)) return false;
      k = order_stats::key_of(v);
      return true;
    };
    const order_stats::Ranks<decltype(keyed)> ranks{keyed, m, c, hist[warp]};
    for (int t = warp; t < K; t += WARPS) {
      const double fr = grid_point(t, cf);
      const double fl = floor(fr);
      uint64_t a, b;
      ranks.pair((int64_t)fl + 1, a, b);  // 1-based: order statistics r, r + 1
      if (lane == 0)
        grid[t] = lerp(order_stats::double_of(a), order_stats::double_of(b),
                       __dsub_rn(fr, fl));
    }
  } else if (tid < K) {
    grid[tid] = 0.0;
  }
  __syncthreads();

  // 2. the merge with the state's grid of the cell
  const int64_t sidx = row * w + w0 + j;
  float* qrow = q_state + sidx * K;
  const int64_t n1 = n_state[sidx];
  const double nf1 = (double)n1, nf2 = cf;
  const double total = __dadd_rn(nf1, nf2);
  // the 128 points: value (float32), weight, sentinel, sort key
  float* pv = reinterpret_cast<float*>(keys);                 // [2K] sorted values
  double* pw = reinterpret_cast<double*>(keys + K);           // [2K] sorted weights
  uint8_t* ps = reinterpret_cast<uint8_t*>(keys + 3 * K);     // [2K] sorted sentinels
  double* cum = reinterpret_cast<double*>(keys + 4 * K);      // [2K] midpoint ranks
  uint64_t* pk = keys + 6 * K;                                // [2K] keys, input order
  float v_in = 0.0f;
  double w_in = 0.0;
  bool s_in = false;
  if (tid < 2 * K) {
    if (tid < K) {
      v_in = qrow[tid];
      w_in = __ddiv_rn(nf1, (double)K);
    } else {
      v_in = __double2float_rn(grid[tid - K]);
      w_in = __ddiv_rn(nf2, (double)K);
    }
    s_in = w_in <= 0.0;
    pk[tid] = order_stats::key_of((double)(s_in ? INFINITY : v_in));
  }
  __syncthreads();
  if (tid < 2 * K) {
    const uint64_t mine = pk[tid];
    int rank = 0;
    for (int u = 0; u < 2 * K; ++u) {
      const uint64_t other = pk[u];
      rank += (other < mine || (other == mine && u < tid)) ? 1 : 0;
    }
    pv[rank] = v_in;
    pw[rank] = w_in;
    ps[rank] = s_in ? 1 : 0;
  }
  __syncthreads();
  if (tid == 0) {
    // the greatest carried value (NaN if one is NaN, as jnp.max gives it)
    float vmax = -INFINITY;
    for (int i = 0; i < 2 * K; ++i) {
      if (ps[i]) continue;
      const float x = pv[i];
      vmax = (isnan(x) || isnan(vmax)) ? NAN : fmaxf(vmax, x);
    }
    double run = 0.0;
    for (int i = 0; i < 2 * K; ++i) {
      if (ps[i]) pv[i] = vmax;
      run = __dadd_rn(run, pw[i]);
      cum[i] = __dsub_rn(run, __dmul_rn(0.5, pw[i]));
    }
  }
  __syncthreads();
  if (tid < K) {
    float out = 0.0f;
    if (n1 + c > 0) {
      const double target = __dmul_rn(__ddiv_rn((double)tid + 0.5, (double)K), total);
      int a = 0, b = 2 * K;  // the number of midpoint ranks below the target
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (cum[mid] < target) a = mid + 1; else b = mid;
      }
      const int ilo = max(a - 1, 0), ihi = min(a, 2 * K - 1);
      const double x_lo = cum[ilo], x_hi = cum[ihi];
      const float f_lo = pv[ilo], f_hi = pv[ihi];
      const double dx = __dsub_rn(x_hi, x_lo);
      const double frac = dx > 0.0 ? __ddiv_rn(__dsub_rn(target, x_lo), dx) : 0.0;
      double res;
      if (f_lo == f_hi || dx <= 0.0)
        res = (double)f_lo;
      else
        res = __dadd_rn((double)f_lo, __dmul_rn(frac, (double)__fsub_rn(f_hi, f_lo)));
      out = __double2float_rn(res);
    }
    qrow[tid] = out;
  }
}

}  // namespace

// ts, val (float64), mask: the chunk [s, n]; edges: the slice's wc + 1
// edges; n_state [s, w] int64 (read only) and q_state [s, w, 64] float32,
// the slice their columns [w0, w0 + wc).
extern "C" int sketch_fold(const void* ts, const void* val, const void* mask, const void* edges,
                           long long s, long long n, int wc, long long w, long long w0,
                           const void* n_state, void* q_state, void* stream) {
  if (s <= 0 || wc <= 0) return 0;
  const long long cells = s * (long long)wc;
  sketch_fold_kernel<<<(unsigned)cells, THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)ts, (const double*)val, (const uint8_t*)mask, (const int64_t*)edges, n,
      wc, w, w0, (const int64_t*)n_state, (float*)q_state);
  return (int)cudaGetLastError();
}

extern "C" const char* sketch_fold_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
