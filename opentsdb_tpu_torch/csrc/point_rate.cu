// R point_rate: the rate over raw [S, N] rows, with the surviving points
// moved to the front of their row.
//
// Replaces opentsdb_tpu/ops/rate.py:rate (with _prev_valid_index) as the
// union arm of ops/pipeline.py:_pipeline applies it to raw rows with their
// own timestamps, all_int included, and the ops/union_agg.py:compact_rows
// that follows it there: per point, the per-second rate against the
// previous valid point of its row (counter rollover against counter_max,
// reset_value suppression, drop_resets; with integer values a Java long
// difference, wrapping, before the divide).  A row's first point and a
// dropped reset carry no rate; the points that do are written first, in
// time order, and the rest of the row holds PAD_TS, NaN and 0.
//
// Bound on the H100: bytes.  It reads ts (i64), val (f64 or i64) and mask
// (u8) once and writes ts, rate (f64) and mask once: 17 bytes in and 17
// out a point, 2.3 GB at the headline batch of 1024 x 65,536 points,
// about 0.68 ms at 3.35 TB/s.
//
// Design: one block owns one row and walks it in tiles of THREADS points,
// one point a thread, loads and stores coalesced.  Two block scans a tile
// carry the row's sequential state across it: a max-scan of valid indexes
// gives every point its previous valid point (the scan of the JAX version,
// with the carry from earlier tiles), and a sum-scan of the survivors
// gives each its place in the compacted row.  The previous point's ts and
// value are re-read from memory, almost always from the cache line the
// neighbouring thread just loaded.  Each output slot has one writer.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int64_t PAD_TS = INT64_MAX;

struct MaxOp {
  __device__ int64_t operator()(int64_t a, int64_t b) const { return a > b ? a : b; }
};
struct SumOp {
  __device__ int64_t operator()(int64_t a, int64_t b) const { return a + b; }
};

// Inclusive scan of x over the block in thread order; *total is the
// block-wide result.  Every thread of the block must call it.
template <typename Op>
__device__ int64_t block_scan(int64_t x, int64_t ident, Op op, int64_t* warp_tot,
                              int64_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x = op(x, y);
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int64_t w = lane < WARPS ? warp_tot[lane] : ident;
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w = op(w, y);
    }
    if (lane < WARPS) warp_tot[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x = op(x, warp_tot[warp - 1]);
  *total = warp_tot[WARPS - 1];
  __syncthreads();  // warp_tot is reused by the next scan
  return x;
}

// The long difference a - b, wrapping like Java's, as a double.
__device__ double diff_of(int64_t a, int64_t b) {
  return (double)(int64_t)((uint64_t)a - (uint64_t)b);
}
__device__ double diff_of(double a, double b) { return a - b; }

// counter_max - prev + cur, in the value's arithmetic.
__device__ double rolled_of(int64_t cur, int64_t prev, int64_t counter_max) {
  return (double)(int64_t)((uint64_t)counter_max - (uint64_t)prev + (uint64_t)cur);
}
__device__ double rolled_of(double cur, double prev, int64_t counter_max) {
  return (double)counter_max - prev + cur;
}

template <typename V>
__global__ void __launch_bounds__(THREADS)
point_rate_kernel(const int64_t* __restrict__ ts, const V* __restrict__ val,
                  const uint8_t* __restrict__ mask, int64_t n, int counter,
                  int drop_resets, int64_t counter_max, int64_t reset_value,
                  int64_t* __restrict__ out_ts, double* __restrict__ out_val,
                  uint8_t* __restrict__ out_mask) {
  __shared__ int64_t warp_tot[WARPS];
  const int64_t row = blockIdx.x;
  const int64_t* tr = ts + row * n;
  const V* vr = val + row * n;
  const uint8_t* mr = mask + row * n;
  int64_t* ot = out_ts + row * n;
  double* ov = out_val + row * n;
  uint8_t* om = out_mask + row * n;

  int64_t last_valid = -1;  // the last valid index before this tile's k-1
  int64_t written = 0;      // surviving points written so far
  for (int64_t base = 0; base < n; base += THREADS) {
    const int64_t k = base + threadIdx.x;
    const bool valid = k < n && mr[k];
    // previous valid index: a max-scan over slot k-1 of every thread
    const int64_t before = (k >= 1 && k - 1 < n && mr[k - 1]) ? k - 1 : -1;
    int64_t tile_max;
    const int64_t scanned = block_scan(before, (int64_t)-1, MaxOp(), warp_tot, &tile_max);
    const int64_t prev = scanned > last_valid ? scanned : last_valid;
    last_valid = tile_max > last_valid ? tile_max : last_valid;

    bool keep = false;
    int64_t t = 0;
    double r = NAN;
    if (valid && prev >= 0) {
      t = tr[k];
      double dt = (double)(t - tr[prev]) / 1000.0;
      if (dt == 0.0) dt = INFINITY;
      const V cur = vr[k], pv = vr[prev];
      const double diff = diff_of(cur, pv);
      keep = true;
      if (counter) {
        const bool negative = diff < 0.0;
        if (drop_resets) {
          r = diff / dt;
          keep = !negative;
        } else {
          const double roll = rolled_of(cur, pv, counter_max) / dt;
          const bool suppressed = reset_value > 0 && roll > (double)reset_value;
          r = negative ? (suppressed ? 0.0 : roll) : diff / dt;
        }
      } else {
        r = diff / dt;
      }
    }
    int64_t kept;
    const int64_t place = block_scan((int64_t)(keep ? 1 : 0), (int64_t)0, SumOp(),
                                     warp_tot, &kept);
    if (keep) {
      const int64_t at = written + place - 1;
      ot[at] = t;
      ov[at] = r;
      om[at] = 1;
    }
    written += kept;
  }
  for (int64_t k = written + threadIdx.x; k < n; k += THREADS) {
    ot[k] = PAD_TS;
    ov[k] = NAN;
    om[k] = 0;
  }
}

}  // namespace

extern "C" int point_rate(const void* ts, const void* val, const void* mask,
                          long long s, long long n, int val_is_int, int counter,
                          int drop_resets, long long counter_max,
                          long long reset_value, void* out_ts, void* out_val,
                          void* out_mask, void* stream) {
  if (s <= 0 || n <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (val_is_int) {
    point_rate_kernel<int64_t><<<(unsigned)s, THREADS, 0, st>>>(
        (const int64_t*)ts, (const int64_t*)val, (const uint8_t*)mask, n, counter,
        drop_resets, counter_max, reset_value, (int64_t*)out_ts, (double*)out_val,
        (uint8_t*)out_mask);
  } else {
    point_rate_kernel<double><<<(unsigned)s, THREADS, 0, st>>>(
        (const int64_t*)ts, (const double*)val, (const uint8_t*)mask, n, counter,
        drop_resets, counter_max, reset_value, (int64_t*)out_ts, (double*)out_val,
        (uint8_t*)out_mask);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* point_rate_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
