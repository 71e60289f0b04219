// H2 histogram_percentile: the percentile pick of a histogram query,
// [R, B] int64 counts, mid[B], percs[P] -> [P, R] float64.
//
// Replaces opentsdb_tpu/histogram/kernels.py:percentile_rows (the
// SimpleHistogram.percentile midpoint rule over every row at once).  Per
// row, as the reference computes it:
//   share[j] = (double)cum[j] * 100.0 / (double)max(total, 1), the multiply
//     then the IEEE division, cum the running int64 sum along B;
//   for each p in [1, 100]: the midpoint of the first bucket whose share
//     >= p; bucket 0's midpoint when none reaches p (argmax of an
//     all-false row), which happens for p = 100 when the rounding of
//     total * 100.0 / total lands just under 100 (totals of 2^48 and up);
//   a row with no mass answers 0.0; p outside [1, 100] answers -1.0,
//   even on a row with no mass.
//
// Bound on the H100: bytes.  Each count is read once (8 B a cell), each
// answer written once (8 B): at 23,040 x 32 cells and 4 percentiles
// ~6.6 MB, ~2 us at 3.35 TB/s, so the launch sets the pace.
//
// Design: one warp a row.  Lanes load 32 neighbouring buckets at once
// (coalesced), a warp reduce gives the total, then for each p a warp
// inclusive scan of each 32-bucket chunk (carried across chunks) and a
// ballot of share >= p; the first set lane is the bucket.  The scan
// adds in unsigned 64-bit arithmetic, which wraps as the reference's
// int64 cumsum does.  No multiply-add can form: the share is a multiply
// and a division.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
percentile_kernel(const int64_t* __restrict__ counts,
                  const double* __restrict__ mid,
                  const double* __restrict__ percs, int64_t r, int b, int np,
                  double* __restrict__ out) {
  const int64_t row = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= r) return;  // the whole warp leaves together
  const int64_t* c = counts + row * (int64_t)b;

  unsigned long long total = 0;
  for (int j = lane; j < b; j += 32) total += (unsigned long long)c[j];
  for (int d = 16; d > 0; d >>= 1) total += __shfl_xor_sync(FULL, total, d);
  const long long tot = (long long)total;
  const bool has = tot > 0;
  const double denom = (double)(tot > 1 ? tot : 1LL);

  for (int k = 0; k < np; ++k) {
    const double p = percs[k];
    double res;
    if (!(p >= 1.0 && p <= 100.0)) {
      res = -1.0;
    } else if (!has) {
      res = 0.0;
    } else {
      int found = 0;
      unsigned long long carry = 0;
      for (int base = 0; base < b; base += 32) {
        const int j = base + lane;
        unsigned long long v = j < b ? (unsigned long long)c[j] : 0ULL;
        for (int d = 1; d < 32; d <<= 1) {
          const unsigned long long y = __shfl_up_sync(FULL, v, d);
          if (lane >= d) v += y;
        }
        const unsigned long long cum = carry + v;
        const double share = (double)(long long)cum * 100.0 / denom;
        const unsigned hit = __ballot_sync(FULL, j < b && share >= p);
        if (hit) {
          found = base + __ffs(hit) - 1;
          break;
        }
        carry = __shfl_sync(FULL, cum, 31);
      }
      res = mid[found];
    }
    if (lane == 0) out[(int64_t)k * r + row] = res;
  }
}

}  // namespace

extern "C" int histogram_percentile(const void* counts, const void* mid,
                                    const void* percs, long long r, int b,
                                    int np, void* out, void* stream) {
  if (r <= 0 || np <= 0) return 0;
  const long long blocks = (r + WARPS - 1) / WARPS;
  percentile_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)counts, (const double*)mid, (const double*)percs, r, b,
      np, (double*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* histogram_percentile_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
