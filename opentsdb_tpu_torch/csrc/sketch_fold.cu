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
// Design: two kernels on the stream, no synchronisation between them.
//   - The warp path, every cell whose run holds at most 256 points.  A
//     block owns 64 consecutive cells (across rows where the slice is
//     narrow); its threads find the cells' run edges at once, one
//     lower_bound an edge, a cell's end taken from its neighbour's start in
//     the same row.  A warp then owns a cell.  The run's values come in
//     coalesced, E = 1, 2, 4 or 8 a lane by the run's length, become
//     order-preserving 64-bit keys (order_stats.cuh key_of; a slot that
//     takes no part keys past every value) and are sorted by a bitonic
//     network in registers with shuffles (no block barrier); the 64 grid
//     targets are read from the sorted keys in the warp's shared room, two
//     a lane.  A cell with no valid point skips the sort.  The merge is the
//     same warp's: 128 points, 4 a lane, keyed by value with the point's
//     index in the low 7 bits (a float32 widened to float64 has 29 zero low
//     bits, so the key stays order-preserving and equal values order by
//     index, the stable order; -0.0 keys as +0.0 and a NaN of either sign
//     past every value, as the reference's argsort orders them), sorted by
//     the same network; the greatest
//     carried value by an ordered warp tree (each pair the earlier points
//     first, so it equals the serial walk's maximum, NaN rule included);
//     the midpoint ranks by a warp scan, which is exact, and so the serial
//     walk's bits, while every partial sum is a multiple of 1/128 below
//     2^46 (n1 + c < 2^46); the 64 targets two a lane.
//   - The block path, a cell whose run passes 256 points: the warp path
//     appends it to a list (its count zeroed by one memset first), and a
//     second kernel, one block a listed cell over a grid of a few blocks
//     an SM, stages a run of up to 4,096 points in shared memory as keys
//     and bitonic-sorts it by the block; a longer run (a "0all" window
//     over a whole chunk row) is never staged: each of the block's warps
//     finds its share of the 128 order statistics by the radix select of
//     order_stats.cuh, reading the run from device memory on each pass.
//     Its first warp then merges as the warp path does.  Each kernel's
//     shared memory is sized to its path.
// Every cell's result is a function of its sorted keys and the merge's
// order alone, so it is the same whichever path and network computes it.
// Arithmetic is explicitly rounded (no fused multiply-add), in the
// reference's types: the interpolation of the merge takes the difference
// of two float32 values in float32.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "order_stats.cuh"
#include "window_runs.cuh"

namespace {

using order_stats::FULL;

constexpr int K = 64;             // summary points (ops/streaming.py SKETCH_K)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CELLS = 64;         // cells a block of the warp path owns
constexpr int WARP_RUN = 256;     // longest run the warp path sorts
constexpr int SORT_CAP = 4096;    // longest run the block path stages and sorts
constexpr uint64_t NO_KEY = ~0ull;

// A warp's shared room: the sorted run (then the merge's midpoint ranks
// and values), the chunk's grid, and the merge's points by index.
struct Room {
  uint64_t keys[WARP_RUN];
  double grid[K];
  float vals[2 * K];
};

__device__ __forceinline__ double grid_point(int j, double cf) {
  // fractional 0-based rank of target j, clipped to [0, max(c - 1, 0)]
  double fr = __dsub_rn(__dmul_rn(__ddiv_rn((double)j + 0.5, (double)K), cf), 0.5);
  fr = fmin(fmax(fr, 0.0), fmax(__dsub_rn(cf, 1.0), 0.0));
  return fr;
}

__device__ __forceinline__ double lerp(double a, double b, double frac) {
  return __dadd_rn(a, __dmul_rn(frac, __dsub_rn(b, a)));
}

// Sorts the warp's 32 * E keys ascending, element lane * E + r in k[r]:
// a bitonic network, partners within a lane swapped in registers, across
// lanes exchanged by shuffles.
template <int E>
__device__ __forceinline__ void warp_sort(uint64_t (&k)[E], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * E; size <<= 1) {
#pragma unroll
    for (int h = size >> 1; h > 0; h >>= 1) {
      if (h < E) {
#pragma unroll
        for (int r = 0; r < E; ++r) {
          if ((r ^ h) > r) {
            const bool up = ((lane * E + r) & size) == 0;
            const uint64_t a = k[r], b = k[r ^ h];
            const bool swap = (a > b) == up;
            k[r] = swap ? b : a;
            k[r ^ h] = swap ? a : b;
          }
        }
      } else {
        const int lh = h / E;
        const bool lower = (lane & lh) == 0;
#pragma unroll
        for (int r = 0; r < E; ++r) {
          const uint64_t other = __shfl_xor_sync(FULL, k[r], lh);
          const bool up = ((lane * E + r) & size) == 0;
          k[r] = (lower == up) ? (k[r] < other ? k[r] : other) : (k[r] > other ? k[r] : other);
        }
      }
    }
  }
}

// The chunk grid of a run of m <= 32 * E points at vrow/mrow[lo, lo + m)
// into room.grid; returns the run's valid count c (the grid is left
// untouched where c = 0).
template <int E>
__device__ __forceinline__ int warp_grid(const double* __restrict__ vrow, const uint8_t* __restrict__ mrow,
                         int64_t lo, int m, Room& room, int lane) {
  uint64_t k[E];
  int c = 0;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int i = r * 32 + lane;
    bool ok = false;
    double v = 0.0;
    if (i < m) {
      v = vrow[lo + i];
      ok = mrow[lo + i] && !isnan(v);
    }
    k[r] = ok ? order_stats::key_of(v) : NO_KEY;
    c += __popc(__ballot_sync(FULL, ok));
  }
  if (c == 0) return 0;
  warp_sort<E>(k, lane);
#pragma unroll
  for (int r = 0; r < E; ++r) room.keys[lane * E + r] = k[r];
  __syncwarp();
  const double cf = (double)c;
  for (int t = lane; t < K; t += 32) {
    const double fr = grid_point(t, cf);
    const double fl = floor(fr);
    const int r = (int)fl;
    const int r2 = min(r + 1, c - 1);
    room.grid[t] = lerp(order_stats::double_of(room.keys[r]),
                        order_stats::double_of(room.keys[r2]), __dsub_rn(fr, fl));
  }
  __syncwarp();
  return c;
}

// The merge's sort key of a point's value: order-preserving, with -0.0
// equal to +0.0 and a NaN of either sign above every value, as the
// reference's stable argsort orders them.
__device__ __forceinline__ uint64_t merge_key(float v) {
  if (isnan(v)) return ~0ull;
  return order_stats::key_of(v == 0.0f ? 0.0 : (double)v);
}

// NaN if either is NaN, else the greater: the serial walk's step.
__device__ __forceinline__ float carried_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

// The merge of one cell by one warp: the state's grid qrow (n1 points)
// with the chunk's room.grid (c points, zeros where c = 0), written to
// qrow in place.
__device__ __forceinline__ void warp_merge(Room& room, float* __restrict__ qrow, int64_t n1, int64_t c,
                           int lane) {
  if (n1 + c <= 0) {
    qrow[lane] = 0.0f;
    qrow[lane + 32] = 0.0f;
    return;
  }
  const double nf1 = (double)n1, nf2 = (double)c;
  const double w1 = __ddiv_rn(nf1, (double)K), w2 = __ddiv_rn(nf2, (double)K);
  const double total = __dadd_rn(nf1, nf2);
  // point e = lane * 4 + r: the state's 0-63 (lanes 0-15), the chunk's
  // 64-127; key: the value (+inf for a side with no points), index low
  const bool state = lane < 16;
  const bool sentinel = (state ? w1 : w2) <= 0.0;
  uint64_t k[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int e = lane * 4 + r;
    const float v = state ? qrow[e] : (c > 0 ? __double2float_rn(room.grid[e - K]) : 0.0f);
    room.vals[e] = v;
    k[r] = (merge_key(sentinel ? INFINITY : v) & ~127ull) | (uint64_t)e;
  }
  warp_sort<4>(k, lane);
  __syncwarp();
  // sorted position lane * 4 + r: its value, weight and sentinel
  float pv[4];
  double pw[4];
  bool ps[4];
  float vmax = -INFINITY;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int e = (int)(k[r] & 127);
    pv[r] = room.vals[e];
    pw[r] = e < K ? w1 : w2;
    ps[r] = pw[r] <= 0.0;
    if (!ps[r]) vmax = carried_max(vmax, pv[r]);
  }
  // the greatest carried value, lanes combined in order
  for (int d = 1; d < 32; d <<= 1) vmax = carried_max(vmax, __shfl_down_sync(FULL, vmax, d));
  vmax = __shfl_sync(FULL, vmax, 0);
  // the midpoint ranks: a warp scan of the running weight
  double part[4], run = 0.0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    run = __dadd_rn(run, pw[r]);
    part[r] = run;
  }
  double incl = run;
  for (int d = 1; d < 32; d <<= 1) {
    const double y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl = __dadd_rn(incl, y);
  }
  double before = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) before = 0.0;
  double* cum = reinterpret_cast<double*>(room.keys);            // [2K]
  float* sv = reinterpret_cast<float*>(room.keys + 2 * K);       // [2K]
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = lane * 4 + r;
    cum[i] = __dsub_rn(__dadd_rn(before, part[r]), __dmul_rn(0.5, pw[r]));
    sv[i] = ps[r] ? vmax : pv[r];
  }
  __syncwarp();
  for (int t = lane; t < K; t += 32) {
    const double target = __dmul_rn(__ddiv_rn((double)t + 0.5, (double)K), total);
    int a = 0, b = 2 * K;  // the number of midpoint ranks below the target
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (cum[mid] < target) a = mid + 1; else b = mid;
    }
    const int ilo = max(a - 1, 0), ihi = min(a, 2 * K - 1);
    const double x_lo = cum[ilo], x_hi = cum[ihi];
    const float f_lo = sv[ilo], f_hi = sv[ihi];
    const double dx = __dsub_rn(x_hi, x_lo);
    const double frac = dx > 0.0 ? __ddiv_rn(__dsub_rn(target, x_lo), dx) : 0.0;
    double res;
    if (f_lo == f_hi || dx <= 0.0)
      res = (double)f_lo;
    else
      res = __dadd_rn((double)f_lo, __dmul_rn(frac, (double)__fsub_rn(f_hi, f_lo)));
    qrow[t] = __double2float_rn(res);
  }
  __syncwarp();
}

struct Chunk {
  const int64_t* ts;
  const double* val;
  const uint8_t* mask;
  const int64_t* edges;
  int64_t n, cells;
  int wc;
  int64_t w, w0;
  const int64_t* n_state;
  float* q_state;
  unsigned long long* list;  // [0]: the count; then the listed cells
};

__global__ void __launch_bounds__(THREADS) sketch_fold_warp_kernel(const Chunk a) {
  __shared__ int64_t run_lo[CELLS], run_hi[CELLS];
  __shared__ Room rooms[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t c0 = (int64_t)blockIdx.x * CELLS;
  // the run edges: thread t the start of cell c0 + t, thread CELLS + t its
  // end where the next cell lies in another row or block
  if (tid < 2 * CELLS) {
    const int i = tid & (CELLS - 1);
    const int64_t cell = c0 + i;
    if (cell < a.cells) {
      const int64_t row = cell / a.wc;
      const int j = (int)(cell - row * a.wc);
      const int64_t* trow = a.ts + row * a.n;
      if (tid < CELLS) {
        run_lo[i] = lower_bound(trow, a.n, a.edges[j]);
      } else if (i == CELLS - 1 || j == a.wc - 1 || cell + 1 == a.cells) {
        run_hi[i] = lower_bound(trow, a.n, a.edges[j + 1]);
      }
    }
  }
  __syncthreads();
  if (tid < CELLS && c0 + tid < a.cells) {
    const int64_t cell = c0 + tid;
    const int j = (int)(cell % a.wc);
    if (!(tid == CELLS - 1 || j == a.wc - 1 || cell + 1 == a.cells)) run_hi[tid] = run_lo[tid + 1];
  }
  __syncthreads();
  Room& room = rooms[warp];
  for (int i = warp; i < CELLS && c0 + i < a.cells; i += WARPS) {
    const int64_t cell = c0 + i;
    const int64_t lo = run_lo[i], m = run_hi[i] - lo;
    if (m > WARP_RUN) {
      if (lane == 0) a.list[1 + atomicAdd(a.list, 1ull)] = (unsigned long long)cell;
      continue;
    }
    const int64_t row = cell / a.wc;
    const int64_t j = cell - row * a.wc;
    const double* vrow = a.val + row * a.n;
    const uint8_t* mrow = a.mask + row * a.n;
    int c = 0;
    if (m > 128) c = warp_grid<8>(vrow, mrow, lo, (int)m, room, lane);
    else if (m > 64) c = warp_grid<4>(vrow, mrow, lo, (int)m, room, lane);
    else if (m > 32) c = warp_grid<2>(vrow, mrow, lo, (int)m, room, lane);
    else if (m > 0) c = warp_grid<1>(vrow, mrow, lo, (int)m, room, lane);
    const int64_t sidx = row * a.w + a.w0 + j;
    warp_merge(room, a.q_state + sidx * K, a.n_state[sidx], c, lane);
  }
}

__global__ void __launch_bounds__(THREADS) sketch_fold_block_kernel(const Chunk a) {
  __shared__ uint64_t keys[SORT_CAP];
  __shared__ unsigned hist[WARPS][order_stats::BINS];
  __shared__ Room room;
  __shared__ int64_t run_lo, run_hi;
  __shared__ int valid_part[WARPS];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned long long listed = a.list[0];
  for (unsigned long long li = blockIdx.x; li < listed; li += gridDim.x) {
    const int64_t cell = (int64_t)a.list[1 + li];
    const int64_t row = cell / a.wc;
    const int j = (int)(cell - row * a.wc);
    const int64_t* trow = a.ts + row * a.n;
    const double* vrow = a.val + row * a.n;
    const uint8_t* mrow = a.mask + row * a.n;
    if (tid == 0) {
      run_lo = lower_bound(trow, a.n, a.edges[j]);
      run_hi = lower_bound(trow, a.n, a.edges[j + 1]);
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

    // the chunk grid, in float64
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
              const uint64_t x = keys[i], y = keys[ixj];
              if ((x > y) == ((i & k) == 0)) {
                keys[i] = y;
                keys[ixj] = x;
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
        room.grid[tid] = lerp(order_stats::double_of(keys[r]), order_stats::double_of(keys[r2]),
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
        uint64_t x, y;
        ranks.pair((int64_t)fl + 1, x, y);  // 1-based: order statistics r, r + 1
        if (lane == 0)
          room.grid[t] = lerp(order_stats::double_of(x), order_stats::double_of(y),
                              __dsub_rn(fr, fl));
      }
    }
    __syncthreads();
    if (warp == 0) {
      const int64_t sidx = row * a.w + a.w0 + j;
      warp_merge(room, a.q_state + sidx * K, a.n_state[sidx], c, lane);
    }
    __syncthreads();
  }
}

}  // namespace

// ts, val (float64), mask: the chunk [s, n]; edges: the slice's wc + 1
// edges; n_state [s, w] int64 (read only) and q_state [s, w, 64] float32,
// the slice their columns [w0, w0 + wc); list: s * wc + 1 words of
// scratch for the cells of the block path.
extern "C" int sketch_fold(const void* ts, const void* val, const void* mask, const void* edges,
                           long long s, long long n, int wc, long long w, long long w0,
                           const void* n_state, void* q_state, void* list, void* stream) {
  if (s <= 0 || wc <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const Chunk a{(const int64_t*)ts, (const double*)val, (const uint8_t*)mask,
                (const int64_t*)edges, n, s * (long long)wc, wc, w, w0,
                (const int64_t*)n_state, (float*)q_state, (unsigned long long*)list};
  cudaError_t err = cudaMemsetAsync(list, 0, sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  sketch_fold_warp_kernel<<<(unsigned)((a.cells + CELLS - 1) / CELLS), THREADS, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // a few blocks an SM walk the listed cells; none listed, they return
  const long long blocks = a.cells < 4ll * sms ? a.cells : 4ll * sms;
  sketch_fold_block_kernel<<<(unsigned)blocks, THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* sketch_fold_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
