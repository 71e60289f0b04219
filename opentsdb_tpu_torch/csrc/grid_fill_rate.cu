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
// Bound on the H100: bytes.  It reads v (f64), m (u8) and wts (i64) once
// and writes contrib (f64), participate (u8) and present (u8), 19 bytes a
// cell (the stacked form reads one wts row a member): at 1024 x 283 cells
// about 5.5 MB, under 2 us at 3.35 TB/s, below a launch's own floor; the
// 1m grid [1024, 16,931] is 0.33 GB, ~0.1 ms.
//
// Design.  The previous-valid and next-present searches are scans, and a
// row is cut into SEGS segments, one warp each, so that a wide row is
// walked by eight warps at once and no warp waits on a block barrier
// inside its walk.  A block is eight warps: eight rows of one segment (W <= 128, such
// as a stacked panel's 60), four rows of two, two of four (the headline's
// 283 windows) or one of eight (the 1m grid's 16,931); the host picks
// SEGS by W.  A warp walks its segment in chunks of 128 cells: the chunk
// is copied into shared memory with consecutive lanes on consecutive
// cells (v, m and the window timestamps; the next chunk's loads are in
// flight in registers while this one is computed), then each lane takes
// ITEMS consecutive cells of it.
//   - pass 0 (with a rate, SEGS > 1): each warp finds its segment's last
//     raw-valid window (m alone); after a block barrier a warp takes the
//     last one before its segment, and that window's value and timestamp,
//     as its rate carry.
//   - pass 1, forward: an exclusive max-scan of the raw-valid indices
//     (within the lane, then across the warp with __shfl_up_sync) gives
//     each cell its previous valid window; the carry holds the last valid
//     index, value and timestamp of the earlier chunks, so no cell
//     gathers from device memory.  A second max-scan, of the present
//     indices, gives each absent cell its previous present window, which
//     pass 1 parks in the cell's contrib slot (its bits, an int64; -2
//     where it lies before the segment) until pass 2 overwrites it.
//     Pass 1 writes contrib (the rated value), present, and participate
//     for the present cells, and notes the chunks that hold an absent
//     cell.  After a block barrier each warp takes the last present
//     window before its segment and the first one after it from the
//     other warps' segments.
//   - pass 2, backward, over the chunks that hold an absent cell (a chunk
//     without is all present: its first cell is the next present window
//     of the chunks before it, and pass 1 wrote all of it): an exclusive
//     suffix min-scan of the present indices, with a carry of the first
//     present window after the chunk, gives each absent cell its next
//     present window, and the parked index its previous one.  A
//     neighbour in the chunk is read from shared memory, one outside it
//     from contrib as pass 1 wrote it.  A warp's last chunk of pass 1 is
//     still staged, so a segment of one chunk reads device memory once.
//     Pass 2 writes contrib and participate of the absent cells.
// Results go back through shared memory, so the stores are coalesced
// too.  Each cell is written by one thread once a pass; no atomics.
// Each per-cell expression has one fixed order (LERP: y0 + (double)(x -
// x0) * (y1 - y0) / dx), none with a product that nvcc could contract
// into an FMA, so a cell's bits do not depend on the warp, segment or
// chunk that computes it: stacked cells equal solo cells, and a tile's
// cells the whole grid's.  Absent windows that do not participate
// (before the first or after the last present window) get NaN: every
// consumer masks them by `participate`.
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

enum Policy {
  LERP = 0, ZIM = 1, MAX_IF_MISSING = 2, MIN_IF_MISSING = 3, PREV = 4
};

constexpr int THREADS = 256;            // a block: eight warps
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 4;                // consecutive cells a lane takes
constexpr int CHUNK = 32 * ITEMS;       // cells a warp stages at once
constexpr int BEFORE = -2;              // parked: before the segment
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const double* v;
  const uint8_t* m;
  const int64_t* wts;
  int64_t s, rows_per_member;
  int w, do_rate, counter, drop_resets, policy;
  double counter_max, reset_value;
  // written in both passes and read back in pass 2: plain (coherent) loads
  double* contrib;
  uint8_t* participate;
  uint8_t* present;
};

// Exclusive max-scan of one int a lane over the warp (identity -1);
// *total gets the warp's maximum.
__device__ __forceinline__ int excl_max(int x, int* total) {
  const int lane = threadIdx.x & 31;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl = max(incl, y);
  }
  *total = __shfl_sync(FULL, incl, 31);
  const int excl = __shfl_up_sync(FULL, incl, 1);
  return lane == 0 ? -1 : excl;
}

// Exclusive suffix min-scan (the lanes after this one; identity none);
// *total gets the warp's minimum.
__device__ __forceinline__ int excl_suffix_min(int x, int none, int* total) {
  const int lane = threadIdx.x & 31;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_down_sync(FULL, incl, d);
    if (lane + d < 32) incl = min(incl, y);
  }
  *total = __shfl_sync(FULL, incl, 0);
  const int excl = __shfl_down_sync(FULL, incl, 1);
  return lane == 31 ? none : excl;
}

// A warp's chunk: values (contrib in pass 2), window timestamps, and
// flags (m, then present; pass 2: bit 0 participate, bit 1 present).
struct Stage {
  double v[CHUNK];
  int64_t ts[CHUNK];
  uint8_t f[CHUNK];
};

template <int SEGS>
__global__ void __launch_bounds__(THREADS)
grid_fill_rate_kernel(const Args a) {
  constexpr int ROWS = WARPS / SEGS;
  __shared__ Stage stage[WARPS];
  // each warp's segment: last raw-valid, first and last present window
  __shared__ int seg_valid[WARPS], seg_first[WARPS], seg_last[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seg = warp % SEGS;
  const int row0 = warp - seg;           // the row's first warp
  const int64_t row = (int64_t)blockIdx.x * ROWS + warp / SEGS;
  const bool live = row < a.s;           // a dead warp joins the barriers
  const int w = a.w;
  const int span = ((w + SEGS - 1) / SEGS + CHUNK - 1) / CHUNK * CHUNK;
  const int lo = live ? min(w, seg * span) : 0;
  const int hi = live ? min(w, lo + span) : 0;
  const int64_t off = live ? row * w : 0;
  const int64_t* wts = a.wts + (live ? row / a.rows_per_member * w : 0);
  Stage& sh = stage[warp];
  const int nchunks = (hi - lo + CHUNK - 1) / CHUNK;
  const int k0 = lane * ITEMS;   // this lane's first cell of a chunk

  // The next chunk's cells this lane stages (j = lane + 32 q), loaded
  // while the current chunk is computed.
  double rv[ITEMS];
  int64_t rt[ITEMS];
  uint8_t rf[ITEMS];
  auto fetch = [&](const double* vsrc, const uint8_t* fsrc, int c) {
    const int base = lo + c * CHUNK, n = min(CHUNK, hi - base);
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      const int j = lane + q * 32;
      if (j < n) {
        rv[q] = vsrc[off + base + j];
        rf[q] = fsrc[off + base + j];
        rt[q] = wts[base + j];
      }
    }
  };
  auto stage_in = [&](int n) {
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      const int j = lane + q * 32;
      if (j < n) {
        sh.v[j] = rv[q];
        sh.f[j] = rf[q];
        sh.ts[j] = rt[q];
      }
    }
  };
  if (nchunks > 0) fetch(a.v, a.m, 0);

  // Pass 0: the rate's carry into the segment, the last raw-valid window
  // of the segments before it.
  int cv = -1;           // the last raw-valid window before the chunk
  double cv_v = 0.0;
  int64_t cv_t = 0;
  if (SEGS > 1 && a.do_rate) {
    int last = -1;
    for (int k = lo + lane; k < hi; k += 32)
      if (a.m[off + k]) last = k;
    last = __reduce_max_sync(FULL, last);
    if (lane == 0) seg_valid[warp] = last;
    __syncthreads();
    for (int j = 0; j < seg; ++j) cv = max(cv, seg_valid[row0 + j]);
    if (cv >= 0) {
      cv_v = a.v[off + cv];
      cv_t = wts[cv];
    }
  }

  // Pass 1, forward: the rate against the previous raw-valid window, and
  // each absent cell's previous present window parked in its contrib.
  int cp = seg == 0 ? -1 : BEFORE;   // the last present window before
  int first = w;                     // the segment's first present window
  // bit c: chunk c holds an absent cell (chunks from 64 on count as such)
  unsigned long long dirty = 0ULL;
  for (int c = 0; c < nchunks; ++c) {
    const int base = lo + c * CHUNK, n = min(CHUNK, hi - base);
    stage_in(n);
    if (c + 1 < nchunks) fetch(a.v, a.m, c + 1);
    __syncwarp();
    double x[ITEMS];
    bool mk[ITEMS];
    int last_m = -1;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int k = k0 + i;
      mk[i] = k < n && sh.f[k] != 0;
      x[i] = k < n ? sh.v[k] : 0.0;
      if (mk[i]) last_m = base + k;
    }
    int tot_m;
    const int excl_m = excl_max(last_m, &tot_m);
    double r[ITEMS];
    bool ok[ITEMS];
    int prev = excl_m >= 0 ? excl_m : cv;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int k = k0 + i;
      r[i] = x[i];
      ok[i] = mk[i];
      if (!a.do_rate) continue;
      ok[i] = mk[i] && prev >= 0;
      r[i] = NAN;
      if (ok[i]) {
        const bool here = prev >= base;
        const double vp = here ? sh.v[prev - base] : cv_v;
        const int64_t tp = here ? sh.ts[prev - base] : cv_t;
        double dt = (double)(sh.ts[k] - tp) / 1000.0;
        if (dt == 0.0) dt = INFINITY;
        const double diff = x[i] - vp;
        if (a.counter) {
          const bool negative = diff < 0.0;
          if (a.drop_resets) {
            r[i] = diff / dt;
            ok[i] = !negative;
          } else {
            const double roll_rate = (a.counter_max - vp + x[i]) / dt;
            const bool suppressed = a.reset_value > 0.0
                                    && roll_rate > a.reset_value;
            r[i] = negative ? (suppressed ? 0.0 : roll_rate) : diff / dt;
          }
        } else {
          r[i] = diff / dt;
        }
      }
      if (mk[i]) prev = base + k;
    }
    int tot_p = tot_m, pp = excl_m;   // without a rate, present is m
    int mine = w;                     // this lane's first present cell
#pragma unroll
    for (int i = ITEMS - 1; i >= 0; --i)
      if (ok[i]) mine = base + k0 + i;
    if (a.do_rate) {
      int last_p = -1;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i)
        if (ok[i]) last_p = base + k0 + i;
      pp = excl_max(last_p, &tot_p);
    }
    if (first == w) first = __reduce_min_sync(FULL, mine);
    bool absent = false;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) absent |= k0 + i < n && !ok[i];
    if (c < 64 && __any_sync(FULL, absent)) dirty |= 1ULL << c;
    if (pp < 0) pp = cp;
    if (tot_m >= 0) {
      cv = tot_m;
      cv_v = sh.v[tot_m - base];
      cv_t = sh.ts[tot_m - base];
    }
    if (tot_p >= 0) cp = tot_p;
    double out[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (ok[i]) {
        out[i] = r[i];
        pp = base + k0 + i;
      } else {
        out[i] = __longlong_as_double((long long)pp);
      }
    }
    __syncwarp();   // every read of the stage is done
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int k = k0 + i;
      if (k < n) {
        sh.v[k] = out[i];
        sh.f[k] = ok[i] ? 1 : 0;
      }
    }
    __syncwarp();
    // (a lane stores and then restages only its own cells j); a present
    // cell participates, an absent one is settled in pass 2
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      const int j = lane + q * 32;
      if (j < n) {
        a.contrib[off + base + j] = sh.v[j];
        a.present[off + base + j] = sh.f[j];
        a.participate[off + base + j] = sh.f[j];
      }
    }
  }

  // Between the passes: the last present window before the segment and
  // the first one after it, from the row's other segments.
  int before = -1;       // a parked BEFORE's window
  int cn = w;            // the first present window after the chunk
  if (SEGS > 1) {
    if (lane == 0) {
      seg_first[warp] = first;
      seg_last[warp] = cp >= lo ? cp : -1;
    }
    __syncthreads();
    for (int j = 0; j < seg; ++j) before = max(before, seg_last[row0 + j]);
    for (int j = seg + 1; j < SEGS; ++j) cn = min(cn, seg_first[row0 + j]);
  }

  // Pass 2, backward: each absent cell's gap value between its previous
  // (parked) and next present windows, in the chunks that hold one; a
  // chunk without is all present, and its first cell is the next present
  // window of the chunks before it.  The last chunk is still staged; the
  // next chunk to visit is loaded while one is computed.
  auto holes_below = [&](int c) {   // the last chunk below c with a hole
    if (c > 64) return c - 1;
    const unsigned long long below =
        c == 64 ? dirty : dirty & ((1ULL << c) - 1ULL);
    return below ? 63 - __clzll((long long)below) : -1;
  };
  int pending = -1;      // the chunk in the registers
  for (int c = nchunks - 1; c >= 0; --c) {
    const int base = lo + c * CHUNK, n = min(CHUNK, hi - base);
    if (c < 64 && !((dirty >> c) & 1ULL)) {
      cn = base;
      continue;
    }
    if (c < nchunks - 1) {
      if (pending != c) fetch(a.contrib, a.present, c);
      stage_in(n);
    }
    pending = holes_below(c);
    if (pending >= 0) fetch(a.contrib, a.present, pending);
    __syncwarp();
    bool pres[ITEMS];
    int first_p = w;
#pragma unroll
    for (int i = ITEMS - 1; i >= 0; --i) {
      const int k = k0 + i;
      pres[i] = k < n && sh.f[k] != 0;
      if (pres[i]) first_p = base + k;
    }
    int tot_n;
    int nx = excl_suffix_min(first_p, w, &tot_n);
    if (nx >= w) nx = cn;
    double out[ITEMS];
    uint8_t flag[ITEMS];
#pragma unroll
    for (int i = ITEMS - 1; i >= 0; --i) {
      const int k = k0 + i;
      out[i] = 0.0;
      flag[i] = 3;
      if (k >= n) continue;
      if (pres[i]) {
        nx = base + k;
        continue;
      }
      // an absent cell: its contrib slot holds the parked index
      int pv = (int)__double_as_longlong(sh.v[k]);
      if (pv == BEFORE) pv = before;
      const bool part = pv >= 0 && nx < w;
      double cval = NAN;
      if (part) {
        const bool here = pv >= base;
        const double y0 = here ? sh.v[pv - base] : a.contrib[off + pv];
        switch (a.policy) {
          case LERP: {
            // a neighbour outside the chunk: contrib as pass 1 wrote it
            const int64_t x0 = here ? sh.ts[pv - base] : wts[pv];
            const bool next_here = nx < base + n;
            const int64_t x1 = next_here ? sh.ts[nx - base] : wts[nx];
            const double y1 =
                next_here ? sh.v[nx - base] : a.contrib[off + nx];
            double dx = (double)(x1 - x0);
            if (dx == 0.0) dx = 1.0;
            cval = y0 + (double)(sh.ts[k] - x0) * (y1 - y0) / dx;
            break;
          }
          case ZIM: cval = 0.0; break;
          case MAX_IF_MISSING: cval = DBL_MAX; break;
          case MIN_IF_MISSING: cval = -DBL_MAX; break;
          default: cval = y0; break;  // PREV
        }
      }
      out[i] = cval;
      flag[i] = part ? 1 : 0;
    }
    if (tot_n < w) cn = tot_n;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int k = k0 + i;
      if (k < n) {
        if (!pres[i]) sh.v[k] = out[i];
        sh.f[k] = flag[i];
      }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      const int j = lane + q * 32;
      if (j < n) {
        const uint8_t f = sh.f[j];
        if (!(f & 2)) {
          a.participate[off + base + j] = f & 1;
          a.contrib[off + base + j] = sh.v[j];
        }
      }
    }
  }
}

template <int SEGS>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int ROWS = WARPS / SEGS;
  const unsigned blocks = (unsigned)((a.s + ROWS - 1) / ROWS);
  grid_fill_rate_kernel<SEGS><<<blocks, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
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
  const Args a{(const double*)v, (const uint8_t*)m, (const int64_t*)wts,
               (int64_t)s, (int64_t)rows_per_member, w, do_rate, counter,
               drop_resets, policy, counter_max, reset_value,
               (double*)contrib, (uint8_t*)participate, (uint8_t*)present};
  const cudaStream_t st = (cudaStream_t)stream;
  // a segment of one to two chunks a warp, at most eight a row
  const int chunks = (w + CHUNK - 1) / CHUNK;
  if (chunks <= 1) return launch<1>(a, st);
  if (chunks <= 2) return launch<2>(a, st);
  if (chunks <= 4) return launch<4>(a, st);
  return launch<8>(a, st);
}

extern "C" const char* grid_fill_rate_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
