// S3 stream_finish: each (series, window) cell's downsampled value from the
// streaming state, then the fill policy.
//
// Replaces opentsdb_tpu/ops/streaming.py _finish (:596) with
// sketch_quantile (:444), and the fill of opentsdb_tpu/ops/downsample.py
// apply_fill (:1270).  The state is [S, W]: n int64 and the float64 lanes
// total, m2, lo, hi, first, last and prod, or for a rank function the
// float32 sketch q [S, W, 64]; a pointer the function does not read may be
// null.  A cell holds data when n > 0; under FILL_NONE (fill_mode 0) an
// empty cell is masked out with NaN, otherwise every cell is exposed and
// an empty one holds fill_value.
//   sum: total            count: n             avg: total / n
//   squareSum: m2 + total^2 / n (the exact identity for the sum of squares)
//   dev: sqrt(m2 / (n - 1)), 0 below two points
//   min: lo   max: hi   first   last   diff: last - first, 0 below two
//   mult: prod
//   quantile: linear interpolation of the sketch's midpoint-rank grid at
//             rank pct / 100 * n (median is pct 50; the ep*r3 and ep*r7
//             estimators collapse into it, below the sketch's rank error)
//
// Bound on the H100: bytes.  A fused elementwise pass: it must read n and
// the lanes the function needs (8 B each a cell, 256 B for a sketch) and
// write 9 B a cell.  Config 2's grid (128 x 720,897 cells, one lane):
// about 2.3 GB, ~0.7 ms at 3.35 TB/s.
//
// Design: a thread a cell, grid-strided; a quantile binary-searches the
// 64-point grid.  Operations are explicitly rounded (no fused
// multiply-add), as the plain version computes them.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int K = 64;           // summary points (ops/streaming.py SKETCH_K)
constexpr int THREADS = 256;

// ops/streaming.py FINISH_CODES
enum Finish {
  SUM = 0, COUNT = 1, AVG = 2, SQUARE_SUM = 3, DEV = 4, MIN = 5, MAX = 6,
  FIRST = 7, LAST = 8, DIFF = 9, MULT = 10, QUANTILE = 11
};

struct Lanes {
  const int64_t* n;
  const double* total;
  const double* m2;
  const double* lo;
  const double* hi;
  const double* first;
  const double* last;
  const double* prod;
  const float* q;
};

// The reference's sketch_quantile for one cell.
__device__ double quantile(const float* qc, int64_t n, double pct) {
  const double nf = fmax((double)n, 1.0);
  const double target = __dmul_rn(__ddiv_rn(pct, 100.0), nf);
  // the number of midpoint ranks (j + 0.5) / K * nf below the target
  int a = 0, b = K;
  while (a < b) {
    const int mid = (a + b) >> 1;
    const double x = __dmul_rn(__ddiv_rn((double)mid + 0.5, (double)K), nf);
    if (x < target) a = mid + 1; else b = mid;
  }
  const int ilo = max(a - 1, 0), ihi = min(a, K - 1);
  const double x_lo = __dmul_rn(__ddiv_rn((double)ilo + 0.5, (double)K), nf);
  const double x_hi = __dmul_rn(__ddiv_rn((double)ihi + 0.5, (double)K), nf);
  const float f_lo = qc[ilo], f_hi = qc[ihi];
  const double dx = __dsub_rn(x_hi, x_lo);
  const double frac = dx > 0.0 ? __ddiv_rn(__dsub_rn(target, x_lo), dx) : 0.0;
  if (f_lo == f_hi || dx <= 0.0) return (double)f_lo;
  return __dadd_rn((double)f_lo, __dmul_rn(frac, (double)__fsub_rn(f_hi, f_lo)));
}

__global__ void __launch_bounds__(THREADS)
finish_kernel(Lanes st, int64_t cells, int code, double pct, int fill_mode,
              double fill_value, double* __restrict__ out, uint8_t* __restrict__ out_mask) {
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < cells;
       i += (int64_t)gridDim.x * THREADS) {
    const int64_t n = st.n[i];
    if (n <= 0) {
      out[i] = fill_mode ? fill_value : NAN;
      out_mask[i] = fill_mode ? 1 : 0;
      continue;
    }
    const double nf = (double)n;
    double v;
    switch (code) {
      case SUM: v = st.total[i]; break;
      case COUNT: v = nf; break;
      case AVG: v = __ddiv_rn(st.total[i], nf); break;
      case SQUARE_SUM: {
        const double t = st.total[i];
        v = __dadd_rn(st.m2[i], __ddiv_rn(__dmul_rn(t, t), nf));
        break;
      }
      case DEV: v = n >= 2 ? __dsqrt_rn(__ddiv_rn(st.m2[i], (double)(n - 1))) : 0.0; break;
      case MIN: v = st.lo[i]; break;
      case MAX: v = st.hi[i]; break;
      case FIRST: v = st.first[i]; break;
      case LAST: v = st.last[i]; break;
      case DIFF: v = n >= 2 ? __dsub_rn(st.last[i], st.first[i]) : 0.0; break;
      case MULT: v = st.prod[i]; break;
      default: v = quantile(st.q + i * K, n, pct); break;
    }
    out[i] = v;
    out_mask[i] = 1;
  }
}

}  // namespace

// n [cells] int64; the lanes [cells] float64 and q [cells, 64] float32,
// null where the function does not read them; code: enum Finish.
extern "C" int stream_finish(const void* n, const void* total, const void* m2, const void* lo,
                             const void* hi, const void* first, const void* last,
                             const void* prod, const void* q, long long cells, int code,
                             double pct, int fill_mode, double fill_value, void* out,
                             void* out_mask, void* stream) {
  if (cells <= 0) return 0;
  const Lanes st{(const int64_t*)n,     (const double*)total, (const double*)m2,
                 (const double*)lo,     (const double*)hi,    (const double*)first,
                 (const double*)last,   (const double*)prod,  (const float*)q};
  long long blocks = (cells + THREADS - 1) / THREADS;
  if (blocks > 1048576) blocks = 1048576;
  finish_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      st, cells, code, pct, fill_mode, fill_value, (double*)out, (uint8_t*)out_mask);
  return (int)cudaGetLastError();
}

extern "C" const char* stream_finish_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
