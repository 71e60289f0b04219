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
// 1024 x 283 series cells and 100 x 283 group cells about 3.2 MB, about
// 1 us at 3.35 TB/s, so launch cost dominates at that size.  A rank
// function reads its cell's column run once more per radix pass, from
// L1/L2.
//
// Design: groups are contiguous row runs [offsets[g], offsets[g+1]) (the
// planner emits them that way).  One warp owns one (group, window) cell and
// walks its rows with the shared warp routine (order_stats::warp_order);
// the selection reads the column from global memory on each pass, so a
// group of any size (all 1024 rows of the headline batch, or tens of
// thousands) is exact without staging.  Each cell has one writer: no
// atomics, deterministic results.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "order_stats.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps, 8 cells a block
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
group_order_kernel(const double* __restrict__ contrib, const uint8_t* __restrict__ participate,
                   const uint8_t* __restrict__ present, const int64_t* __restrict__ offsets,
                   int64_t g, int w, int code, double q, int est, double* __restrict__ out,
                   uint8_t* __restrict__ out_mask) {
  __shared__ unsigned hist[WARPS][order_stats::BINS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t cell = (int64_t)blockIdx.x * WARPS + warp;
  if (cell >= g * w) return;  // a whole warp leaves together
  const int64_t gi = cell / w;
  const int col = (int)(cell - gi * w);
  const int64_t r0 = offsets[gi], r1 = offsets[gi + 1];
  auto get = [&](int64_t i, double& v) {  // both loads issued together
    const int64_t k = (r0 + i) * w + col;
    const uint8_t part = participate[k];
    v = contrib[k];
    return part && !isnan(v);
  };
  int64_t cnt;
  const double res = order_stats::warp_order<double>(get, r1 - r0, code, q, est, hist[warp],
                                                     cnt);
  bool any = false;
  for (int64_t r = r0 + lane; r < r1; r += 32) any = any || present[r * w + col];
  any = __any_sync(order_stats::FULL, any);
  if (lane == 0) {
    out[cell] = cnt > 0 ? res : NAN;
    out_mask[cell] = any ? 1 : 0;
  }
}

}  // namespace

// code: order_stats::Order; q and est: the percentile and its estimator.
extern "C" int group_order(const void* contrib, const void* participate, const void* present,
                           const void* offsets, long long g, int w, int code, double q,
                           int est, void* out, void* out_mask, void* stream) {
  if (g <= 0 || w <= 0) return 0;
  const long long blocks = (g * w + WARPS - 1) / WARPS;
  group_order_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const double*)contrib, (const uint8_t*)participate, (const uint8_t*)present,
      (const int64_t*)offsets, g, w, code, q, est, (double*)out, (uint8_t*)out_mask);
  return (int)cudaGetLastError();
}

extern "C" const char* group_order_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
