// K2 grid_fill_rate: the optional rate, then each series' gap value on the
// downsampled [S, W] grid.
//
// Replaces opentsdb_tpu/ops/rate.py:rate (with _prev_valid_index) as the
// grouped pipeline applies it to the grid, then
// opentsdb_tpu/ops/group_agg.py:grid_contributions (with
// union_agg.interpolate and union_agg._next_valid): a series missing window
// k contributes the value its aggregator's interpolation policy gives
// (LERP, ZIM, MAX/MIN_IF_MISSING, PREV), and participates only between its
// first and last present window.  Where every window is present the
// contribution is the value itself (the reference's hole-free lane).
//
// Bound on the H100: bytes, and far below launch cost at the main path's
// size: it reads v (f64), m (u8) and wts (i64) once and writes contrib
// (f64), participate (u8) and present (u8), 19 bytes a cell; at
// 1024 x 283 cells that is about 5.5 MB, under 2 us at 3.35 TB/s.
//
// Design: one thread owns one row and walks its W windows in order, twice.
// The first walk computes the rate against the previous valid window
// (counter_max rollover, reset_value, drop_resets) into contrib/present; the
// second walk fills each run of absent windows at once from the valid
// windows on either side of it, so the previous/next-valid scans of the JAX
// version become one forward walk with no scratch.  Absent windows that do
// not participate (before the first or after the last present window) get
// NaN: every consumer masks them by `participate`.  No atomics: each cell
// has one writer.  Left slow on purpose for now (one thread per row is a
// few warps for the whole card); its time is recorded, not tuned.
//
// Stacked form (B14, opentsdb_tpu/ops/pipeline.py:225): Q members' [S, W]
// grids are one [Q*S, W] grid and wts is [Q, W], each member's window
// timestamps; row s reads the row of member s / rows_per_member.  A solo
// call passes rows_per_member = S and one wts row.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Policy { LERP = 0, ZIM = 1, MAX_IF_MISSING = 2, MIN_IF_MISSING = 3, PREV = 4 };

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
grid_fill_rate_kernel(const double* __restrict__ v, const uint8_t* __restrict__ m,
                      const int64_t* __restrict__ wts_all, int64_t s_rows, int w,
                      int64_t rows_per_member, int do_rate, int counter,
                      int drop_resets,
                      double counter_max, double reset_value, int policy,
                      double* __restrict__ contrib, uint8_t* __restrict__ participate,
                      uint8_t* __restrict__ present) {
  const int64_t s = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (s >= s_rows) return;
  // this row's member's window timestamps
  const int64_t* wts = wts_all + (s / rows_per_member) * w;
  const double* vr = v + s * w;
  const uint8_t* mr = m + s * w;
  double* cr = contrib + s * w;
  uint8_t* pr = participate + s * w;
  uint8_t* er = present + s * w;

  // Walk 1: the series' values (rated if asked) and their validity.
  if (do_rate) {
    int prev = -1;
    for (int k = 0; k < w; ++k) {
      const bool mk = mr[k] != 0;
      bool ok = mk && prev >= 0;
      double r = NAN;
      if (ok) {
        double dt = (double)(wts[k] - wts[prev]) / 1000.0;
        if (dt == 0.0) dt = INFINITY;
        const double diff = vr[k] - vr[prev];
        if (counter) {
          const bool negative = diff < 0.0;
          if (drop_resets) {
            r = diff / dt;
            ok = !negative;
          } else {
            const double roll_rate = (counter_max - vr[prev] + vr[k]) / dt;
            const bool suppressed = reset_value > 0.0 && roll_rate > reset_value;
            r = negative ? (suppressed ? 0.0 : roll_rate) : diff / dt;
          }
        } else {
          r = diff / dt;
        }
      }
      cr[k] = ok ? r : NAN;
      er[k] = ok ? 1 : 0;
      if (mk) prev = k;
    }
  } else {
    for (int k = 0; k < w; ++k) {
      cr[k] = vr[k];
      er[k] = mr[k] != 0;
    }
  }

  // Walk 2: fill each run [k, nxt) of absent windows between valid prev and
  // valid nxt (nxt == w: none after it).
  int prev = -1;
  int k = 0;
  while (k < w) {
    if (er[k]) {
      pr[k] = 1;
      prev = k;
      ++k;
      continue;
    }
    int nxt = k + 1;
    while (nxt < w && !er[nxt]) ++nxt;
    const bool part = prev >= 0 && nxt < w;
    for (int j = k; j < nxt; ++j) {
      double c = NAN;
      if (part) {
        const double y0 = cr[prev];
        switch (policy) {
          case LERP: {
            const int64_t x0 = wts[prev];
            double dx = (double)(wts[nxt] - x0);
            if (dx == 0.0) dx = 1.0;
            c = y0 + (double)(wts[j] - x0) * (cr[nxt] - y0) / dx;
            break;
          }
          case ZIM: c = 0.0; break;
          case MAX_IF_MISSING: c = DBL_MAX; break;
          case MIN_IF_MISSING: c = -DBL_MAX; break;
          default: c = y0; break;  // PREV
        }
      }
      cr[j] = c;
      pr[j] = part ? 1 : 0;
    }
    k = nxt;
  }
}

}  // namespace

// wts holds s / rows_per_member rows of w window timestamps.
extern "C" int grid_fill_rate(const void* v, const void* m, const void* wts,
                              long long s, int w, long long rows_per_member,
                              int do_rate, int counter, int drop_resets,
                              double counter_max, double reset_value,
                              int policy, void* contrib, void* participate,
                              void* present, void* stream) {
  if (s <= 0 || w <= 0 || rows_per_member <= 0) return 0;
  const unsigned blocks = (unsigned)((s + THREADS - 1) / THREADS);
  grid_fill_rate_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const double*)v, (const uint8_t*)m, (const int64_t*)wts, (int64_t)s, w,
      (int64_t)rows_per_member, do_rate, counter, drop_resets, counter_max,
      reset_value, policy,
      (double*)contrib, (uint8_t*)participate, (uint8_t*)present);
  return (int)cudaGetLastError();
}

extern "C" const char* grid_fill_rate_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
