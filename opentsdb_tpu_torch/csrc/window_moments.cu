// K1 window_moments: per-(series, window) moments over time-sorted rows,
// then the fill policy.
//
// Replaces opentsdb_tpu/ops/downsample.py:downsample for the moment family
// (sum zimsum pfsum count avg min mimmin max mimmax dev squareSum): its
// _window_scan_setup + _edge_search + _prefix_downsample (count, sum, avg,
// squareSum, two-pass dev), _extreme_downsample / _extreme_subblock (min,
// max) and apply_fill.
//
// Bound on the H100: bytes.  The function must read val (f64 or i64) and
// mask (u8) once, 9 bytes a point, but ts only where a window edge falls:
// one lookup per edge and row.  It writes 9 bytes a window cell and does a
// few flops a point.  At 1024 x 65,536 points and 283 windows that is
// about 0.61 GB, about 0.18 ms at 3.35 TB/s.
//
// Design: rows are time-sorted (pads at int64 max sort last), so a window is
// a contiguous run of its row.  One block owns one row and a tile of TILE_W
// windows: its threads find the tile's TILE_W + 1 edge positions by binary
// search over the row (log2 N reads of ts each, never a pass over all of
// it), then each warp reduces whole windows, lanes striding the run so that
// the loads of val and mask are coalesced.  One pass gives count, sum,
// squares, min and max; dev re-reads its run (now in L1/L2) for the centred
// second moment around the window mean.  Every output cell is written by
// one warp after a fixed shuffle tree: no atomics, deterministic results,
// float64 accumulation throughout.  The TPU tricks of the JAX version (int32
// compaction, clean-batch count skip, hier/compare_all search, sub-block
// scans) do not carry over: Hopper has native int64 and float64.
//
// Stacked form (B14, opentsdb_tpu/ops/pipeline.py:225
// _stacked_group_pipeline, the vmap of _group_pipeline over a member axis):
// Q members' [S, N] batches are one [Q*S, N] batch, and edges is [Q, W+1],
// one row of window edges a member.  Row r reads the edges of member
// r / rows_per_member; a solo call passes rows_per_member = S and one edge
// row, so solo and stacked run the same code and a member's cells are bit
// for bit its solo cells.
//
// Int32 form (B10, the reference's _compact_ts over a pre-compacted batch,
// opentsdb_tpu/ops/downsample.py:515-534): ts holds int32 offsets from the
// query's first window (the device cache's re-based gather, G1's int32
// form) and edges the [W+1] edges re-based and clipped alike.  The search
// reads 4-byte words instead of 8; the values, the accumulation and the
// output are the int64 form's, and the run positions are equal on the
// same points, so every cell is bit for bit the int64 form's.  The
// stacked launches stay int64 (the batcher builds its batches on the
// host).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "window_runs.cuh"

namespace {

constexpr int TILE_W = 64;          // windows per block
constexpr int THREADS = 256;        // 8 warps
constexpr int WARPS = THREADS / 32;

enum Agg { SUM = 0, COUNT = 1, AVG = 2, MIN = 3, MAX = 4, DEV = 5, SQUARESUM = 6 };

template <typename T, typename V>
__global__ void __launch_bounds__(THREADS)
window_moments_kernel(const T* __restrict__ ts, const V* __restrict__ val,
                      const uint8_t* __restrict__ mask,
                      const T* __restrict__ edges, int64_t n, int w,
                      int64_t rows_per_member, int agg, int fill_mode,
                      double fill_value,
                      double* __restrict__ out, uint8_t* __restrict__ out_mask) {
  __shared__ int64_t pos[TILE_W + 1];
  const int64_t row = blockIdx.x;
  const int w0 = blockIdx.y * TILE_W;
  const int tw = min(TILE_W, w - w0);
  const T* trow = ts + row * n;
  const V* vrow = val + row * n;
  const uint8_t* mrow = mask + row * n;
  // this row's member's window edges
  const T* medges = edges + (row / rows_per_member) * (int64_t)(w + 1);

  // Edge positions of the tile.
  for (int i = threadIdx.x; i <= tw; i += THREADS) {
    pos[i] = lower_bound(trow, n, medges[w0 + i]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const double empty = fill_mode ? fill_value : NAN;
  for (int j = warp; j < tw; j += WARPS) {
    const int wi = w0 + j;
    const int64_t cell = row * (int64_t)w + wi;
    const int64_t lo = pos[j], hi = pos[j + 1];
    int cnt = 0;
    double sum = 0.0, sq = 0.0, mn = INFINITY, mx = -INFINITY;
    for (int64_t k = lo + lane; k < hi; k += 32) {
      const double v = (double)vrow[k];
      if (mrow[k] && !isnan(v)) {
        cnt += 1;
        sum += v;
        sq += v * v;
        mn = fmin(mn, v);
        mx = fmax(mx, v);
      }
    }
    cnt = warp_sum_int(cnt);
    double res;
    switch (agg) {
      case COUNT: res = (double)cnt; break;
      case AVG: res = warp_sum(sum) / (double)max(cnt, 1); break;
      case MIN: res = warp_min(mn); break;
      case MAX: res = warp_max(mx); break;
      case SQUARESUM: res = warp_sum(sq); break;
      case DEV: {
        const double mean = warp_sum(sum) / (double)max(cnt, 1);
        double m2 = 0.0;
        if (cnt >= 2) {
          for (int64_t k = lo + lane; k < hi; k += 32) {
            const double v = (double)vrow[k];
            if (mrow[k] && !isnan(v)) {
              const double c = v - mean;
              m2 += c * c;
            }
          }
        }
        m2 = warp_sum(m2);
        res = cnt >= 2 ? sqrt(m2 / (double)(cnt - 1)) : 0.0;
        break;
      }
      default: res = warp_sum(sum); break;  // SUM
    }
    if (lane == 0) {
      const bool has = cnt > 0;
      out[cell] = has ? res : empty;
      // FILL_NONE exposes windows holding data; a fill exposes every one
      out_mask[cell] = (has || fill_mode) ? 1 : 0;
    }
  }
}

template <typename T, typename V>
int launch(const void* ts, const void* val, const void* mask, const void* edges,
           long long s, long long n, int w, long long rows_per_member, int agg,
           int fill_mode, double fill_value, void* out, void* out_mask,
           void* stream) {
  if (s <= 0 || w <= 0 || rows_per_member <= 0) return 0;
  const dim3 grid((unsigned)s, (unsigned)((w + TILE_W - 1) / TILE_W));
  window_moments_kernel<T, V><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)ts, (const V*)val, (const uint8_t*)mask, (const T*)edges,
      (int64_t)n, w, (int64_t)rows_per_member, agg, fill_mode, fill_value,
      (double*)out, (uint8_t*)out_mask);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ts(const void* ts, const void* val, const void* mask, const void* edges,
              long long s, long long n, int w, long long rows_per_member, int agg,
              int fill_mode, double fill_value, int val_is_int, void* out,
              void* out_mask, void* stream) {
  if (val_is_int)
    return launch<T, int64_t>(ts, val, mask, edges, s, n, w, rows_per_member,
                              agg, fill_mode, fill_value, out, out_mask, stream);
  return launch<T, double>(ts, val, mask, edges, s, n, w, rows_per_member, agg,
                           fill_mode, fill_value, out, out_mask, stream);
}

}  // namespace

// val_is_int selects the value type: float64 (0) or exact int64 (1) rows;
// ts_is_i32 the timestamp type of ts and edges: int64 ms (0) or int32
// offsets from a base (1); edges holds s / rows_per_member rows of w + 1
// edges.
extern "C" int window_moments(const void* ts, const void* val, const void* mask,
                              const void* edges, long long s, long long n,
                              int w, long long rows_per_member, int agg,
                              int fill_mode, double fill_value, int val_is_int,
                              int ts_is_i32, void* out, void* out_mask,
                              void* stream) {
  if (ts_is_i32)
    return launch_ts<int32_t>(ts, val, mask, edges, s, n, w, rows_per_member,
                              agg, fill_mode, fill_value, val_is_int, out,
                              out_mask, stream);
  return launch_ts<int64_t>(ts, val, mask, edges, s, n, w, rows_per_member, agg,
                            fill_mode, fill_value, val_is_int, out, out_mask,
                            stream);
}

extern "C" const char* window_moments_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
