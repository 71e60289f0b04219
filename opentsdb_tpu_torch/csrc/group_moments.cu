// K3 group_moments: the grouped cross-series reduce, [S, W] -> [G, W].
//
// Replaces opentsdb_tpu/ops/group_agg.py:moment_group_reduce (in all its
// modes: segment scatter, one-hot matmul, the _SortedGroups reset-scans and
// the _blocked_group_fold) and the presence fold of grid_group_aggregate:
// per (group, window) count, sum, avg, min, max, squareSum and the two-pass
// dev of the participating, non-NaN member cells; NaN where the count is 0
// (except for count); out_mask = some member is present in that window.
//
// Bound on the H100: bytes.  It reads contrib (f64), participate (u8) and
// present (u8) once, 10 bytes a series cell, and writes 9 bytes a group
// cell: at 1024 x 283 series cells and 100 x 283 group cells about 3.2 MB,
// about 1 us at 3.35 TB/s, so launch cost dominates at that size.
//
// Design: the planner emits groups as contiguous row runs (gid
// non-decreasing); the wrapper turns gid into row offsets[G + 1] on the
// host.  The fold is group_fold.cuh's, which T1 shares: a block is one
// group and a tile of windows, one thread a cell adding the group's rows
// in row order, read directly or staged through shared memory as the
// grid's mean group depth decides.  The aggregator is a template
// argument, so an instance keeps only its own lanes.  dev's second pass
// reads the group's rows again and folds the centred squares around the
// cell's mean.  Each cell has one writer: no atomics, deterministic
// results, float64 throughout.
#include "group_fold.cuh"

namespace {

using namespace group_fold;

// ops/aggregators.py MOMENT_CODES
enum Agg { AGG_SUM = 0, AGG_COUNT = 1, AGG_AVG = 2, AGG_MIN = 3, AGG_MAX = 4,
           AGG_DEV = 5, AGG_SQUARESUM = 6 };

template <int AGG>
__host__ __device__ constexpr unsigned lanes() {
  return L_CNT | L_PRES |
         (AGG == AGG_SUM || AGG == AGG_AVG || AGG == AGG_DEV
              ? L_SUM : 0u) |
         (AGG == AGG_MIN ? L_MIN : 0u) |
         (AGG == AGG_MAX ? L_MAX : 0u) |
         (AGG == AGG_SQUARESUM ? L_SQ : 0u);
}

struct Args {
  Grid a;
  const int64_t* offsets;
  long long g;
  double* out;
  uint8_t* out_mask;
  cudaStream_t stream;
  bool staged;
};

template <int TW, int AGG, bool STAGED>
__global__ void __launch_bounds__(THREADS)
group_moments_kernel(Grid a, const int64_t* __restrict__ offsets,
                     double* __restrict__ out, uint8_t* __restrict__ out_mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t g = blockIdx.x;
  const int c0 = blockIdx.y * TW;
  const int tw = min(TW, a.w - c0);
  const int64_t r0 = offsets[g], r1 = offsets[g + 1];
  Cell<int> c;
  if (r1 > r0) {
    fold_rows<TW, true, lanes<AGG>(), STAGED>(c, smem, a, r0, r1, c0, tw,
                                              0.0);
    if (AGG == AGG_DEV) {
      const double mean = c.cnt > 0 ? c.sum / (double)c.cnt : 0.0;
      fold_rows<TW, false, L_M2, STAGED>(c, smem, a, r0, r1, c0, tw, mean);
    }
  }
  if ((int)threadIdx.x >= tw) return;
  double res;
  switch (AGG) {
    case AGG_COUNT: res = (double)c.cnt; break;
    case AGG_AVG: res = c.sum / (double)(c.cnt > 1 ? c.cnt : 1); break;
    case AGG_MIN: res = c.mn; break;
    case AGG_MAX: res = c.mx; break;
    case AGG_SQUARESUM: res = c.sq; break;
    case AGG_DEV:
      res = c.cnt >= 2 ? sqrt(c.m2 / (double)(c.cnt - 1)) : 0.0;
      break;
    default: res = c.sum; break;  // AGG_SUM
  }
  const int64_t cell = g * a.w + c0 + threadIdx.x;
  out[cell] = (c.cnt > 0 || AGG == AGG_COUNT) ? res : NAN;
  out_mask[cell] = c.pres > 0 ? 1 : 0;
}

template <int TW, int AGG>
int launch(const Args& k) {
  const dim3 grid((unsigned)k.g, (unsigned)((k.a.w + TW - 1) / TW));
  if (k.staged)
    group_moments_kernel<TW, AGG, true>
        <<<grid, THREADS, smem_bytes<TW>(), k.stream>>>(k.a, k.offsets, k.out,
                                                         k.out_mask);
  else
    group_moments_kernel<TW, AGG, false>
        <<<grid, THREADS, 0, k.stream>>>(k.a, k.offsets, k.out, k.out_mask);
  return (int)cudaGetLastError();
}

template <int TW>
int launch_tile(int agg, const Args& k) {
  switch (agg) {
    case AGG_SUM: return launch<TW, AGG_SUM>(k);
    case AGG_COUNT: return launch<TW, AGG_COUNT>(k);
    case AGG_AVG: return launch<TW, AGG_AVG>(k);
    case AGG_MIN: return launch<TW, AGG_MIN>(k);
    case AGG_MAX: return launch<TW, AGG_MAX>(k);
    case AGG_DEV: return launch<TW, AGG_DEV>(k);
    case AGG_SQUARESUM: return launch<TW, AGG_SQUARESUM>(k);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// s: the grid's rows, whose mean a group decides the staging.
extern "C" int group_moments(const void* contrib, const void* participate,
                             const void* present, const void* offsets,
                             long long s, long long g, int w, int agg,
                             void* out, void* out_mask, void* stream) {
  if (g <= 0 || w <= 0) return 0;
  const Args k{{(const double*)contrib, (const uint8_t*)participate,
                (const uint8_t*)present, w},
               (const int64_t*)offsets, g, (double*)out, (uint8_t*)out_mask,
               (cudaStream_t)stream, fold_staged(s, g)};
  switch (fold_tile(g, w)) {
    case 128: return launch_tile<128>(agg, k);
    case 64: return launch_tile<64>(agg, k);
    case 32: return launch_tile<32>(agg, k);
    default: return launch_tile<16>(agg, k);
  }
}

extern "C" const char* group_moments_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
