// L2 rollup_avg: the average of every (series, window) cell from a sum
// lane and a count lane, then the fill policy.
//
// Replaces the quotient half of opentsdb_tpu/ops/pipeline.py
// _rollup_avg_pipeline and _group_rollup_avg (Downsampler.java:155-210,
// the avg read of a rollup table): both lanes downsample with a windowed
// sum, and a window whose two sums are present and whose count is above 0
// holds sum / count.  Under FILL_NONE the other windows are masked (NaN);
// a fill exposes every window with its value in them, as apply_fill does.
// The sum lane's row and the count lane's row of a series have their own
// timestamps (a cell written to one lane may be missing from the other);
// the values of either lane may be float64 or exact int64.
//
// Bound on the H100: bytes.  The function must read each lane's val and
// mask once (9 bytes a lane point), ts only where a window edge falls,
// and write 9 bytes a window cell.  For a 1h-avg over the 1m lanes of
// 1024 series x 16,930 cells that is about 0.31 GB, about 0.09 ms at
// 3.35 TB/s.
//
// Design: K1's (csrc/window_moments.cu), over two rows.  One block owns a
// row and a tile of windows and binary-searches the tile's edges in both
// of the row's lanes (window_runs.cuh).  With 32 lane points a window and
// more on average, a warp sums a window's two runs in K1's order, so the
// two sums are K1's bit for bit and the quotient is the one the reference
// forms from them; with fewer, each thread sums one window's two runs in
// time order (exact on integer data).  One program writes each cell.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "window_runs.cuh"

namespace {

constexpr int TILE_W = 64;          // windows per block, warp mode
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WARP_MIN_RUN = 32;    // mean lane points a window for warp mode

struct Lane {
  const int64_t* ts;
  const void* val;
  const uint8_t* mask;
  int64_t n;
};

__device__ __forceinline__ void write_cell(int64_t cell, int s_cnt,
                                           double s_sum, int c_cnt,
                                           double c_sum, int fill_mode,
                                           double fill_value, double* out,
                                           uint8_t* out_mask) {
  const bool ok = s_cnt > 0 && c_cnt > 0 && c_sum > 0.0;
  out[cell] = ok ? s_sum / c_sum : (fill_mode ? fill_value : NAN);
  out_mask[cell] = (ok || fill_mode) ? 1 : 0;
}

// The warp's share of one run: lane-strided count and sum.
template <typename V>
__device__ __forceinline__ void warp_run(const V* vrow, const uint8_t* mrow,
                                         int64_t lo, int64_t hi, int lane,
                                         int& cnt, double& sum) {
  cnt = 0;
  sum = 0.0;
  for (int64_t k = lo + lane; k < hi; k += 32) {
    const double v = (double)vrow[k];
    if (mrow[k] && !isnan(v)) {
      cnt += 1;
      sum += v;
    }
  }
  cnt = warp_sum_int(cnt);
  sum = warp_sum(sum);
}

template <typename V>
__device__ __forceinline__ void serial_run(const V* vrow, const uint8_t* mrow,
                                           int64_t lo, int64_t hi, int& cnt,
                                           double& sum) {
  cnt = 0;
  sum = 0.0;
  for (int64_t k = lo; k < hi; ++k) {
    const double v = (double)vrow[k];
    if (mrow[k] && !isnan(v)) {
      cnt += 1;
      sum += v;
    }
  }
}

// Edge positions [0, tw] of a tile in one lane's row, into pos.
__device__ __forceinline__ void tile_edges(const Lane& lane, int64_t row,
                                           const int64_t* edges, int w0,
                                           int tw, int64_t* pos) {
  const int64_t* trow = lane.ts + row * lane.n;
  for (int i = threadIdx.x; i <= tw; i += blockDim.x)
    pos[i] = lower_bound(trow, lane.n, edges[w0 + i]);
}

template <typename VS, typename VC>
__global__ void __launch_bounds__(THREADS)
rollup_avg_warp(Lane sl, Lane cl, const int64_t* __restrict__ edges, int w,
                int fill_mode, double fill_value, double* __restrict__ out,
                uint8_t* __restrict__ out_mask) {
  __shared__ int64_t spos[TILE_W + 1], cpos[TILE_W + 1];
  const int64_t row = blockIdx.x;
  const int w0 = blockIdx.y * TILE_W;
  const int tw = min(TILE_W, w - w0);
  tile_edges(sl, row, edges, w0, tw, spos);
  tile_edges(cl, row, edges, w0, tw, cpos);
  __syncthreads();
  const VS* svals = (const VS*)sl.val + row * sl.n;
  const VC* cvals = (const VC*)cl.val + row * cl.n;
  const uint8_t* smask = sl.mask + row * sl.n;
  const uint8_t* cmask = cl.mask + row * cl.n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = warp; j < tw; j += WARPS) {
    int s_cnt, c_cnt;
    double s_sum, c_sum;
    warp_run(svals, smask, spos[j], spos[j + 1], lane, s_cnt, s_sum);
    warp_run(cvals, cmask, cpos[j], cpos[j + 1], lane, c_cnt, c_sum);
    if (lane == 0)
      write_cell(row * (int64_t)w + w0 + j, s_cnt, s_sum, c_cnt, c_sum,
                 fill_mode, fill_value, out, out_mask);
  }
}

template <typename VS, typename VC>
__global__ void __launch_bounds__(THREADS)
rollup_avg_thread(Lane sl, Lane cl, const int64_t* __restrict__ edges,
                  int w, int fill_mode, double fill_value,
                  double* __restrict__ out, uint8_t* __restrict__ out_mask) {
  __shared__ int64_t spos[THREADS + 1], cpos[THREADS + 1];
  const int64_t row = blockIdx.x;
  const int w0 = blockIdx.y * THREADS;
  const int tw = min(THREADS, w - w0);
  tile_edges(sl, row, edges, w0, tw, spos);
  tile_edges(cl, row, edges, w0, tw, cpos);
  __syncthreads();
  const int j = threadIdx.x;
  if (j >= tw) return;
  int s_cnt, c_cnt;
  double s_sum, c_sum;
  serial_run((const VS*)sl.val + row * sl.n, sl.mask + row * sl.n, spos[j],
             spos[j + 1], s_cnt, s_sum);
  serial_run((const VC*)cl.val + row * cl.n, cl.mask + row * cl.n, cpos[j],
             cpos[j + 1], c_cnt, c_sum);
  write_cell(row * (int64_t)w + w0 + j, s_cnt, s_sum, c_cnt, c_sum,
             fill_mode, fill_value, out, out_mask);
}

template <typename VS, typename VC>
int launch(Lane sl, Lane cl, const int64_t* edges, long long s, int w,
           int fill_mode, double fill_value, double* out, uint8_t* out_mask,
           cudaStream_t st) {
  const long long longest = sl.n > cl.n ? sl.n : cl.n;
  if (longest >= (long long)WARP_MIN_RUN * w) {
    const dim3 grid((unsigned)s, (unsigned)((w + TILE_W - 1) / TILE_W));
    rollup_avg_warp<VS, VC><<<grid, THREADS, 0, st>>>(
        sl, cl, edges, w, fill_mode, fill_value, out, out_mask);
  } else {
    const dim3 grid((unsigned)s, (unsigned)((w + THREADS - 1) / THREADS));
    rollup_avg_thread<VS, VC><<<grid, THREADS, 0, st>>>(
        sl, cl, edges, w, fill_mode, fill_value, out, out_mask);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// sum_is_int / cnt_is_int select each lane's value type: float64 (0) or
// exact int64 (1).
extern "C" int rollup_avg(const void* ts_s, const void* val_s,
                          const void* mask_s, long long n_s,
                          const void* ts_c, const void* val_c,
                          const void* mask_c, long long n_c,
                          const void* edges, long long s, int w,
                          int fill_mode, double fill_value, int sum_is_int,
                          int cnt_is_int, void* out, void* out_mask,
                          void* stream) {
  if (s <= 0 || w <= 0) return 0;
  const Lane sl{(const int64_t*)ts_s, val_s, (const uint8_t*)mask_s, n_s};
  const Lane cl{(const int64_t*)ts_c, val_c, (const uint8_t*)mask_c, n_c};
  const int64_t* e = (const int64_t*)edges;
  double* o = (double*)out;
  uint8_t* om = (uint8_t*)out_mask;
  cudaStream_t st = (cudaStream_t)stream;
  if (sum_is_int && cnt_is_int)
    return launch<int64_t, int64_t>(sl, cl, e, s, w, fill_mode, fill_value,
                                    o, om, st);
  if (sum_is_int)
    return launch<int64_t, double>(sl, cl, e, s, w, fill_mode, fill_value,
                                   o, om, st);
  if (cnt_is_int)
    return launch<double, int64_t>(sl, cl, e, s, w, fill_mode, fill_value,
                                   o, om, st);
  return launch<double, double>(sl, cl, e, s, w, fill_mode, fill_value, o,
                                om, st);
}

extern "C" const char* rollup_avg_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
