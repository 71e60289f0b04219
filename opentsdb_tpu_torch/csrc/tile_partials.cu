// T1 tile_partials: one series tile's [S_t, W] contributions folded into
// [G, W] partial group moments that stay on the device across tiles.
//
// Replaces opentsdb_tpu/ops/tiling.py:_lane_fold (:238), the per-tile
// segment_sum / segment_min / segment_max of the striped rollup-lane
// serve, and the per-shard partial moments of the mesh's grouped tail,
// opentsdb_tpu/parallel/sharded.py:_local_grid_tail (:223), before their
// psum / pmin / pmax.  Per (group, window) cell, over the tile's member
// rows whose cell participates and is not NaN, by mode:
//
//   additive  the count (int64) and the sum;
//   extreme   the count, the min and the max;
//   square    the count and the sum of squares x*x (squareSum);
//   centred   only the centred sum of squares (x - mean)^2 around the
//             cell's mean[G, W] (dev's second pass, the mean taken from
//             the combined first pass), into the m2 lane.
//
// The first three also count, over every member row, the rows whose cell
// holds a real value (present), from which the out-mask derives.  The
// accumulators carry what earlier tiles (or nothing, for a shard's
// partials) added: the host finish (ops/tiling.py finish_lane_fold) then
// gives moment_group_reduce's arithmetic.
//
// Bound on the H100: bytes.  A tile cell is read once (contrib f64,
// participate u8, and present u8 in the first three modes: 10 bytes, 9
// centred); a group cell's accumulators are read and written once
// (additive cnt, present and tot: 24 + 24 bytes; extreme cnt, present, lo
// and hi: 32 + 32; square cnt, present and sq: 24 + 24; centred mean and
// m2 read, m2 written: 16 + 8).  At a 256-row tile of 1m windows
// (W = 16,931) whose rows fall in 25 groups: additive and square 63.7 MB
// (19.0 us at 3.35 TB/s), extreme 70.4 MB (21.0 us), centred 49.2 MB
// (14.7 us).
//
// Design: the tile's rows arrive in group order (gid non-decreasing), so
// the wrapper turns them into row offsets[G + 1] relative to the tile.
// One thread owns one (group, window) cell: a block is one group and a
// tile of THREADS consecutive windows, so a warp's loads coalesce along
// W.  The thread starts from the accumulator, adds its group's rows in
// row order and stores it back: no atomics, one answer on every run, and
// the sums come out in the same order as K3 (group_moments.cu) adding the
// whole grid's rows (the same expressions, so squares and centred squares
// contract alike), so the fold of all tiles equals K3 bit for bit.
// Groups with no row in the tile are left untouched.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

enum Mode { ADDITIVE = 0, EXTREME = 1, SQUARE = 2, CENTRED = 3 };

__global__ void __launch_bounds__(THREADS)
tile_partials_kernel(const double* __restrict__ contrib,
                     const uint8_t* __restrict__ participate,
                     const uint8_t* __restrict__ present,
                     const int64_t* __restrict__ offsets,
                     const double* __restrict__ mean, int w, int mode,
                     int64_t* __restrict__ cnt, int64_t* __restrict__ pres,
                     double* __restrict__ tot, double* __restrict__ lo,
                     double* __restrict__ hi, double* __restrict__ sq) {
  const int64_t g = blockIdx.x;
  const int col = blockIdx.y * THREADS + threadIdx.x;
  if (col >= w) return;
  const int64_t r0 = offsets[g], r1 = offsets[g + 1];
  if (r0 >= r1) return;
  const int64_t cell = g * w + col;
  if (mode == CENTRED) {
    const double mu = mean[cell];
    double m2 = sq[cell];
    for (int64_t r = r0; r < r1; ++r) {
      const int64_t i = r * w + col;
      const double v = contrib[i];
      if (participate[i] && !isnan(v)) {
        const double c = v - mu;
        m2 += c * c;
      }
    }
    sq[cell] = m2;
    return;
  }
  int64_t c = cnt[cell];
  int64_t p = pres[cell];
  if (mode == EXTREME) {
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
  } else if (mode == SQUARE) {
    double s2 = sq[cell];
    for (int64_t r = r0; r < r1; ++r) {
      const int64_t i = r * w + col;
      const double v = contrib[i];
      p += present[i] ? 1 : 0;
      if (participate[i] && !isnan(v)) {
        c += 1;
        s2 += v * v;
      }
    }
    sq[cell] = s2;
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

// The lanes a mode does not use may be null (they are never touched);
// mean is read in the centred mode only.
extern "C" int tile_partials(const void* contrib, const void* participate,
                             const void* present, const void* offsets,
                             const void* mean, long long g, int w, int mode,
                             void* cnt, void* pres, void* tot, void* lo,
                             void* hi, void* sq, void* stream) {
  if (g <= 0 || w <= 0) return 0;
  if (mode < ADDITIVE || mode > CENTRED) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)g, (unsigned)((w + THREADS - 1) / THREADS));
  tile_partials_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const double*)contrib, (const uint8_t*)participate,
      (const uint8_t*)present, (const int64_t*)offsets, (const double*)mean,
      w, mode, (int64_t*)cnt, (int64_t*)pres, (double*)tot, (double*)lo,
      (double*)hi, (double*)sq);
  return (int)cudaGetLastError();
}

extern "C" const char* tile_partials_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
