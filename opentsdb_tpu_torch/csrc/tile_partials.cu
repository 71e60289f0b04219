// T1 tile_partials: one series tile's [S_t, W] contributions folded into
// [G, W] partial group moments that stay on the device across tiles.
//
// Replaces opentsdb_tpu/ops/tiling.py:_lane_fold (:238), the per-tile
// segment_sum / segment_min / segment_max of the striped rollup-lane
// serve.  Per (group, window) cell it adds, over the tile's member rows
// whose cell participates and is not NaN, the count (int64) and either
// the sum (additive mode) or the min and the max (extreme mode); and over
// every member row the count of rows whose cell holds a real value
// (present), from which the out-mask derives.  The accumulators carry
// what earlier tiles added: the host finish (ops/tiling.py
// finish_lane_fold) then gives moment_group_reduce's arithmetic.
//
// Bound on the H100: bytes.  A tile cell is read once (contrib f64,
// participate and present u8: 10 bytes); a group cell's accumulators are
// read and written once (cnt, present and tot: 24 + 24 bytes; extreme
// mode cnt, present, lo and hi: 32 + 32).  At a 256-row tile of 1m
// windows (W = 16,931) in 100 groups about 58 MB, about 17 us at
// 3.35 TB/s.
//
// Design: the tile's rows arrive in group order (gid non-decreasing), so
// the wrapper turns them into row offsets[G + 1] relative to the tile.
// One thread owns one (group, window) cell: a block is one group and a
// tile of THREADS consecutive windows, so a warp's loads coalesce along
// W.  The thread starts from the accumulator, adds its group's rows in
// row order and stores it back: no atomics, one answer on every run, and
// the sums come out in the same order as K3 (group_moments.cu) adding the
// whole grid's rows, so the fold of all tiles equals K3 bit for bit.
// Groups with no row in the tile are left untouched.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
tile_partials_kernel(const double* __restrict__ contrib,
                     const uint8_t* __restrict__ participate,
                     const uint8_t* __restrict__ present,
                     const int64_t* __restrict__ offsets, int w, int extreme,
                     int64_t* __restrict__ cnt, int64_t* __restrict__ pres,
                     double* __restrict__ tot, double* __restrict__ lo,
                     double* __restrict__ hi) {
  const int64_t g = blockIdx.x;
  const int col = blockIdx.y * THREADS + threadIdx.x;
  if (col >= w) return;
  const int64_t r0 = offsets[g], r1 = offsets[g + 1];
  if (r0 >= r1) return;
  const int64_t cell = g * w + col;
  int64_t c = cnt[cell];
  int64_t p = pres[cell];
  if (extreme) {
    double mn = lo[cell], mx = hi[cell];
    for (int64_t r = r0; r < r1; ++r) {
      const int64_t i = r * w + col;
      const double v = contrib[i];
      p += present[i] ? 1 : 0;
      if (participate[i] && !isnan(v)) {
        c += 1;
        mn = fmin(mn, v);
        mx = fmax(mx, v);
      }
    }
    lo[cell] = mn;
    hi[cell] = mx;
  } else {
    double sum = tot[cell];
    for (int64_t r = r0; r < r1; ++r) {
      const int64_t i = r * w + col;
      const double v = contrib[i];
      p += present[i] ? 1 : 0;
      if (participate[i] && !isnan(v)) {
        c += 1;
        sum += v;
      }
    }
    tot[cell] = sum;
  }
  cnt[cell] = c;
  pres[cell] = p;
}

}  // namespace

extern "C" int tile_partials(const void* contrib, const void* participate,
                             const void* present, const void* offsets,
                             long long g, int w, int extreme, void* cnt,
                             void* pres, void* tot, void* lo, void* hi,
                             void* stream) {
  if (g <= 0 || w <= 0) return 0;
  const dim3 grid((unsigned)g, (unsigned)((w + THREADS - 1) / THREADS));
  tile_partials_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const double*)contrib, (const uint8_t*)participate,
      (const uint8_t*)present, (const int64_t*)offsets, w, extreme,
      (int64_t*)cnt, (int64_t*)pres, (double*)tot, (double*)lo, (double*)hi);
  return (int)cudaGetLastError();
}

extern "C" const char* tile_partials_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
