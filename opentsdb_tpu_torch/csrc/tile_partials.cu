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
// The fold is group_fold.cuh's, which K3 (group_moments.cu) shares: a
// block is one group and a tile of windows, one thread owns one (group,
// window) cell, and the group's rows are read directly or staged through
// shared memory as the tile's mean group depth decides.
// The thread starts from the accumulator, adds its group's rows in row
// order and stores it back: no atomics, one answer on every run, and the
// sums come out in the same order, through the same fold_row, as K3
// adding the whole grid's rows, so the fold of all tiles equals K3 bit
// for bit.  The mode is a template argument: an instance carries only its
// own lanes, and the centred one stages no presence.  Groups with no row
// in the tile are left untouched.
#include "group_fold.cuh"

namespace {

using namespace group_fold;

enum Mode { ADDITIVE = 0, EXTREME = 1, SQUARE = 2, CENTRED = 3 };

template <int MODE>
__host__ __device__ constexpr unsigned lanes() {
  return MODE == CENTRED ? L_M2
       : MODE == EXTREME ? (L_CNT | L_PRES | L_MIN | L_MAX)
       : MODE == SQUARE  ? (L_CNT | L_PRES | L_SQ)
                         : (L_CNT | L_PRES | L_SUM);
}

struct Lanes {
  int64_t* cnt;
  int64_t* pres;
  double* tot;
  double* lo;
  double* hi;
  double* sq;   // sq, or the centred mode's m2
};

template <int TW, int MODE, bool STAGED>
__global__ void __launch_bounds__(THREADS)
tile_partials_kernel(Grid a, const int64_t* __restrict__ offsets,
                     const double* __restrict__ mean, Lanes acc) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr unsigned L = lanes<MODE>();
  const int64_t g = blockIdx.x;
  const int c0 = blockIdx.y * TW;
  const int tw = min(TW, a.w - c0);
  const int64_t r0 = offsets[g], r1 = offsets[g + 1];
  if (r0 >= r1) return;
  const bool mine = (int)threadIdx.x < tw;
  const int64_t cell = g * a.w + c0 + threadIdx.x;
  Cell<int64_t> c;
  double mu = 0.0;
  if (mine) {
    if (L & L_CNT) c.cnt = acc.cnt[cell];
    if (L & L_PRES) c.pres = acc.pres[cell];
    if (L & L_SUM) c.sum = acc.tot[cell];
    if (L & L_MIN) c.mn = acc.lo[cell];
    if (L & L_MAX) c.mx = acc.hi[cell];
    if (L & L_SQ) c.sq = acc.sq[cell];
    if (L & L_M2) {
      c.m2 = acc.sq[cell];
      mu = mean[cell];
    }
  }
  fold_rows<TW, MODE != CENTRED, L, STAGED>(c, smem, a, r0, r1, c0, tw, mu);
  if (!mine) return;
  if (L & L_CNT) acc.cnt[cell] = c.cnt;
  if (L & L_PRES) acc.pres[cell] = c.pres;
  if (L & L_SUM) acc.tot[cell] = c.sum;
  if (L & L_MIN) acc.lo[cell] = c.mn;
  if (L & L_MAX) acc.hi[cell] = c.mx;
  if (L & L_SQ) acc.sq[cell] = c.sq;
  if (L & L_M2) acc.sq[cell] = c.m2;
}

struct Args {
  Grid a;
  const int64_t* offsets;
  const double* mean;
  long long g;
  Lanes acc;
  cudaStream_t stream;
  bool staged;
};

template <int TW, int MODE>
int launch(const Args& k) {
  const dim3 grid((unsigned)k.g, (unsigned)((k.a.w + TW - 1) / TW));
  if (k.staged)
    tile_partials_kernel<TW, MODE, true>
        <<<grid, THREADS, smem_bytes<TW>(), k.stream>>>(k.a, k.offsets,
                                                         k.mean, k.acc);
  else
    tile_partials_kernel<TW, MODE, false>
        <<<grid, THREADS, 0, k.stream>>>(k.a, k.offsets, k.mean, k.acc);
  return (int)cudaGetLastError();
}

template <int TW>
int launch_tile(int mode, const Args& k) {
  switch (mode) {
    case ADDITIVE: return launch<TW, ADDITIVE>(k);
    case EXTREME: return launch<TW, EXTREME>(k);
    case SQUARE: return launch<TW, SQUARE>(k);
    default: return launch<TW, CENTRED>(k);
  }
}

}  // namespace

// The lanes a mode does not use may be null (they are never touched);
// mean is read in the centred mode only.
// s: the tile's rows, whose mean a group decides the staging.
extern "C" int tile_partials(const void* contrib, const void* participate,
                             const void* present, const void* offsets,
                             const void* mean, long long s, long long g,
                             int w, int mode,
                             void* cnt, void* pres, void* tot, void* lo,
                             void* hi, void* sq, void* stream) {
  if (g <= 0 || w <= 0) return 0;
  if (mode < ADDITIVE || mode > CENTRED) return (int)cudaErrorInvalidValue;
  const Args k{{(const double*)contrib, (const uint8_t*)participate,
                (const uint8_t*)present, w},
               (const int64_t*)offsets, (const double*)mean, g,
               {(int64_t*)cnt, (int64_t*)pres, (double*)tot, (double*)lo,
                (double*)hi, (double*)sq},
               (cudaStream_t)stream, fold_staged(s, g)};
  switch (fold_tile(g, w)) {
    case 128: return launch_tile<128>(mode, k);
    case 64: return launch_tile<64>(mode, k);
    case 32: return launch_tile<32>(mode, k);
    default: return launch_tile<16>(mode, k);
  }
}

extern "C" const char* tile_partials_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
