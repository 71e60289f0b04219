// H2 histogram_percentile: the percentile pick of a histogram query,
// [R, B] int64 counts, mid[B], percs[P] -> [P, R] float64.
//
// Replaces opentsdb_tpu/histogram/kernels.py:percentile_rows (the
// SimpleHistogram.percentile midpoint rule over every row at once).  Per
// row, as the reference computes it:
//   share[j] = (double)cum[j] * 100.0 / (double)max(total, 1), the multiply
//     then the IEEE division (__dmul_rn, __ddiv_rn: no contraction into a
//     multiply-add and no reciprocal, which would move ties), cum the
//     running int64 sum along B, which wraps as the reference's cumsum;
//   for each p in [1, 100]: the midpoint of the first bucket whose share
//     >= p; bucket 0's midpoint when none reaches p (argmax of an
//     all-false row), which happens for p = 100 when the rounding of
//     total * 100.0 / total lands just under 100 (totals of 2^48 and up);
//   a row with total <= 0 answers 0.0 (negative counts included); p
//   outside [1, 100] (NaN too) answers -1.0, even on such a row.
//
// Bound on the card: bytes.  Each count is read once (8 B a cell), each
// answer written once (8 B): the planner's batch [23,040, 32] at P = 4 is
// 6.6 MB, 0.0020 ms at 3.35 TB/s, and [92,160, 32] 26.5 MB, 0.0079 ms
// (the H100 SXM's data-sheet rate at its 700 W limit; measured on an
// NVIDIA H100 80GB HBM3 at 700.00 W).  Past the bytes the work is one
// IEEE float64 division a bucket and a compare a bucket and p; on the
// card those, and not the bytes, set most of the time once the scan and
// the ballots are shared by every p.
//
// Design: one scan a row, shared by every p.  A lane holds K neighbouring
// buckets (16-byte loads where the run lies in the row and its address
// allows them), so the row's running sum is the lane's own prefix plus one
// segment scan of the lanes' sums (__shfl_up_sync at the segment's width);
// the total is the segment's last running sum, known before any share.
// Each bucket's share is computed once; then each p takes one ballot (the
// lanes holding a bucket that reaches it, masked to the segment) and one
// shuffle (that lane's first such bucket).  The layout by B:
//   K = 8 where the grid still gives every SM two blocks, else 4, else 2
//     (small grids: more lanes a row, more blocks, a shorter chain a
//     lane), a row the power of two at or above B / K lanes: at K = 8, B
//     <= 8 is a thread a row (32 rows a warp), B = 32 four lanes (8 rows
//     a warp), B <= 256 up to a warp a row, all in registers: one read;
//   B > 256: a warp a row and a second read of the row in the same launch:
//     the first pass sums the total, the second walks chunks of 256 with
//     the carry and stops once every p is found.  The cut is where a lane
//     would hold more than 8 counts (and 8 shares) in registers; the
//     second read hits L1 or L2.
// The percentiles come through shared memory, 16 a pass (any P runs in
// passes), each one's validity decided once a block; the block's counts,
// its first pass's percentiles and the midpoints are all loaded before any
// is used.  Each row's answer is staged as a code (a bucket, "no mass" or
// "outside [1, 100]") and the block stores its [P, rows] answers as one
// contiguous run a p, the midpoints read from shared memory.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PC = 16;         // percentiles a pass
constexpr int KB = 8;          // buckets a lane, at most
constexpr int MIN_BLOCKS = 2;  // blocks an SM below which a lane takes fewer
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_MASS = -1;    // codes beside a bucket index: 0.0
constexpr int OUTSIDE = -2;    // and -1.0
typedef unsigned long long u64;

// Buckets j .. j + K - 1 of row c (j a multiple of K, K even), zero past
// the row's end: 16-byte loads where the run lies in the row and its
// address allows them.
template <int K>
__device__ __forceinline__ void load_run(const int64_t* c, int j, int b,
                                         u64 (&v)[K]) {
  if (j + K <= b && (reinterpret_cast<uintptr_t>(c + j) & 15) == 0) {
#pragma unroll
    for (int e = 0; e < K; e += 2) {
      const longlong2 t =
          __ldg(reinterpret_cast<const longlong2*>(c + j + e));
      v[e] = (u64)t.x;
      v[e + 1] = (u64)t.y;
    }
  } else {
    const long long* p = reinterpret_cast<const long long*>(c) + j;
#pragma unroll
    for (int e = 0; e < K; ++e) v[e] = j + e < b ? (u64)__ldg(p + e) : 0ULL;
  }
}

// Inclusive scan over the w lanes of a segment (s: the lane in it).
template <int W>
__device__ __forceinline__ u64 segment_scan(u64 x, int s) {
#pragma unroll
  for (int d = 1; d < W; d <<= 1) {
    const u64 y = __shfl_up_sync(FULL, x, d, W);
    if (s >= d) x += y;
  }
  return x;
}

// The lane's K buckets turned into their running sums along the row:
// its own prefix, offset by `carry` and the segment's lanes before it.
// Returns the segment's inclusive sum at this lane.
template <int W, int K>
__device__ __forceinline__ u64 running_sums(u64 (&v)[K], u64 carry, int s) {
#pragma unroll
  for (int e = 1; e < K; ++e) v[e] += v[e - 1];
  const u64 inc = carry + segment_scan<W>(v[K - 1], s);
  const u64 before = inc - v[K - 1];
#pragma unroll
  for (int e = 0; e < K; ++e) v[e] += before;
  return inc;
}

// The shares of buckets j .. j + K - 1 from their running sums; -inf past
// the row's end, which no p in [1, 100] reaches.
template <int K>
__device__ __forceinline__ void shares(const u64 (&cum)[K], int j, int b,
                                       double denom, double (&share)[K]) {
#pragma unroll
  for (int e = 0; e < K; ++e) {
    const double sh =
        __ddiv_rn(__dmul_rn((double)(long long)cum[e], 100.0), denom);
    share[e] = j + e < b ? sh : -INFINITY;
  }
}

// The first of the lane's K buckets whose share reaches p, K where none.
template <int K>
__device__ __forceinline__ int first_reaching(const double (&share)[K],
                                              double p) {
  int first = K;
#pragma unroll
  for (int e = K - 1; e >= 0; --e)
    if (share[e] >= p) first = e;
  return first;
}

__device__ __forceinline__ double denom_of(long long tot) {
  return (double)(tot > 1 ? tot : 1LL);
}

// A pass's percentiles into shared memory and their validity bits, by the
// first warp: lane k holds percentile k of the pass (pc of them).
__device__ __forceinline__ void stage_percs(double p, int pc, double* sp,
                                            unsigned* svalid) {
  const int k = threadIdx.x;
  const unsigned ok = __ballot_sync(FULL, k < pc && p >= 1.0 && p <= 100.0);
  if (k < pc) sp[k] = p;
  if (k == 0) *svalid = ok;
}

// The block's staged codes out as one run a p.
template <int ROWS>
__device__ __forceinline__ void store_codes(const int (*code)[ROWS],
                                            const double* mid, int64_t r,
                                            int64_t row0, int p0, int pc,
                                            double* out) {
  const int here = (int)(r - row0 < ROWS ? r - row0 : ROWS);
  for (int i = threadIdx.x; i < pc * ROWS; i += THREADS) {
    const int k = i / ROWS, rr = i % ROWS;
    if (rr < here) {
      const int cd = code[k][rr];
      out[(int64_t)(p0 + k) * r + row0 + rr] =
          cd >= 0 ? mid[cd] : (cd == NO_MASS ? 0.0 : -1.0);
    }
  }
}

// Rows of up to 32 K buckets: a segment of W lanes a row, K buckets a
// lane, all held in registers.  Every load a block needs (its counts, the
// first pass's percentiles, the midpoints) goes out before any is used.
template <int W, int K>
__global__ void __launch_bounds__(THREADS)
rows_kernel(const int64_t* __restrict__ counts,
            const double* __restrict__ mid, const double* __restrict__ percs,
            int64_t r, int b, int np, double* __restrict__ out) {
  static_assert(32 * K <= THREADS, "a thread a midpoint");
  constexpr int ROWS = THREADS / W;
  __shared__ double sp[PC];
  __shared__ unsigned svalid;
  __shared__ double smid[32 * K];
  __shared__ int code[PC][ROWS];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int s = lane & (W - 1);
  const int base = lane & ~(W - 1);  // the segment's first lane
  const unsigned seg = W == 32 ? FULL : (1u << W) - 1;
  const int local = t / W;
  const int64_t row0 = (int64_t)blockIdx.x * ROWS;
  const bool live = row0 + local < r;
  const int j = s * K;

  u64 v[K];
  if (live) {
    load_run<K>(counts + (row0 + local) * (int64_t)b, j, b, v);
  } else {
#pragma unroll
    for (int e = 0; e < K; ++e) v[e] = 0;
  }
  const int pc0 = np < PC ? np : PC;
  const double p = t < pc0 ? __ldg(percs + t) : 0.0;
  const double m = t < b ? __ldg(mid + t) : 0.0;

  // the total, the segment's last running sum, before any share
  const long long tot =
      (long long)__shfl_sync(FULL, running_sums<W, K>(v, 0ULL, s), W - 1, W);
  const bool has = tot > 0;
  double share[K];
  shares<K>(v, j, live ? b : 0, denom_of(tot), share);
  if (t < b) smid[t] = m;
  if (t < 32) stage_percs(p, pc0, sp, &svalid);

  for (int p0 = 0; p0 < np; p0 += PC) {
    const int pc = np - p0 < PC ? np - p0 : PC;
    if (p0 > 0 && t < 32)
      stage_percs(t < pc ? __ldg(percs + p0 + t) : 0.0, pc, sp, &svalid);
    __syncthreads();
    const unsigned valid = svalid;
    for (int k = 0; k < pc; ++k) {
      int cd = OUTSIDE;
      if ((valid >> k) & 1) {
        const int first = first_reaching<K>(share, sp[k]);
        const unsigned any = (__ballot_sync(FULL, first < K) >> base) & seg;
        const int f = any ? __ffs(any) - 1 : 0;
        const int e = __shfl_sync(FULL, first, f, W);
        cd = !has ? NO_MASS : (any ? f * K + e : 0);
      }
      if (s == 0) code[k][local] = cd;
    }
    __syncthreads();
    store_codes<ROWS>(code, smid, r, row0, p0, pc, out);
  }
}

// Rows of more than 32 K buckets: a warp a row, the counts read twice
// (the total, then the walk in chunks of 32 K with the carry until every
// p is found).
template <int K>
__global__ void __launch_bounds__(THREADS)
long_rows_kernel(const int64_t* __restrict__ counts,
                 const double* __restrict__ mid,
                 const double* __restrict__ percs, int64_t r, int b, int np,
                 double* __restrict__ out) {
  constexpr int ROWS = THREADS / 32;
  __shared__ double sp[PC];
  __shared__ unsigned svalid;
  __shared__ int code[PC][ROWS];
  const int lane = threadIdx.x & 31;
  const int local = threadIdx.x / 32;
  const int64_t row0 = (int64_t)blockIdx.x * ROWS;
  const bool live = row0 + local < r;  // the same for the whole warp
  const int64_t* c = counts + (row0 + local) * (int64_t)b;

  u64 total = 0;
  if (live) {
    for (int j = lane * K; j < b; j += 32 * K) {
      u64 v[K];
      load_run<K>(c, j, b, v);
#pragma unroll
      for (int e = 0; e < K; ++e) total += v[e];
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) total += __shfl_xor_sync(FULL, total, d);
  const long long tot = (long long)total;
  const bool has = live && tot > 0;
  const double denom = denom_of(tot);

  for (int p0 = 0; p0 < np; p0 += PC) {
    const int pc = np - p0 < PC ? np - p0 : PC;
    if (threadIdx.x < 32)
      stage_percs(lane < pc ? __ldg(percs + p0 + lane) : 0.0, pc, sp,
                  &svalid);
    __syncthreads();
    const unsigned valid = svalid;
    if (lane == 0) {
      for (int k = 0; k < pc; ++k)
        code[k][local] = !((valid >> k) & 1) ? OUTSIDE : (has ? 0 : NO_MASS);
    }
    unsigned open = has ? valid : 0u;
    u64 carry = 0;
    for (int j0 = 0; open && j0 < b; j0 += 32 * K) {
      const int j = j0 + lane * K;
      u64 v[K];
      load_run<K>(c, j, b, v);
      const u64 inc = running_sums<32, K>(v, carry, lane);
      double share[K];
      shares<K>(v, j, b, denom, share);
      for (unsigned o = open; o; o &= o - 1) {
        const int k = __ffs(o) - 1;
        const int first = first_reaching<K>(share, sp[k]);
        const unsigned any = __ballot_sync(FULL, first < K);
        const int f = any ? __ffs(any) - 1 : 0;
        const int e = __shfl_sync(FULL, first, f);
        if (any) {
          if (lane == 0) code[k][local] = j0 + f * K + e;
          open &= ~(1u << k);
        }
      }
      carry = __shfl_sync(FULL, inc, 31);
    }
    __syncthreads();
    store_codes<ROWS>(code, mid, r, row0, p0, pc, out);
  }
}

template <int W, int K>
int launch_rows(const void* counts, const void* mid, const void* percs,
                long long r, int b, int np, void* out, cudaStream_t stream) {
  const long long blocks = (r + THREADS / W - 1) / (THREADS / W);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rows_kernel<W, K><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const int64_t*)counts, (const double*)mid, (const double*)percs, r, b,
      np, (double*)out);
  return (int)cudaGetLastError();
}

// Lanes a row at K buckets a lane: the power of two at or above b / K.
int lanes_for(int b, int k) {
  int w = 1;
  while (w * k < b) w <<= 1;
  return w;
}

long long blocks_at(long long r, int b, int k) {
  const int rows = THREADS / lanes_for(b, k);
  return (r + rows - 1) / rows;
}

template <int K>
int launch_k(const void* counts, const void* mid, const void* percs,
             long long r, int b, int np, void* out, cudaStream_t st) {
  switch (lanes_for(b, K)) {
    case 1: return launch_rows<1, K>(counts, mid, percs, r, b, np, out, st);
    case 2: return launch_rows<2, K>(counts, mid, percs, r, b, np, out, st);
    case 4: return launch_rows<4, K>(counts, mid, percs, r, b, np, out, st);
    case 8: return launch_rows<8, K>(counts, mid, percs, r, b, np, out, st);
    case 16: return launch_rows<16, K>(counts, mid, percs, r, b, np, out, st);
    default: return launch_rows<32, K>(counts, mid, percs, r, b, np, out, st);
  }
}

}  // namespace

extern "C" int histogram_percentile(const void* counts, const void* mid,
                                    const void* percs, long long r, int b,
                                    int np, void* out, void* stream) {
  if (r <= 0 || np <= 0) return 0;
  if (b < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (b > 32 * KB) {
    const long long blocks = (r + THREADS / 32 - 1) / (THREADS / 32);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    long_rows_kernel<KB><<<(unsigned)blocks, THREADS, 0, st>>>(
        (const int64_t*)counts, (const double*)mid, (const double*)percs, r,
        b, np, (double*)out);
    return (int)cudaGetLastError();
  }
  // KB buckets a lane where the grid still gives every SM MIN_BLOCKS
  // blocks, else fewer (more lanes a row, more blocks, a shorter chain a
  // lane), down to 2
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int k = KB;
  while (k > 2 && 32 * (k / 2) >= b && blocks_at(r, b, k) < MIN_BLOCKS * sms)
    k >>= 1;
  if (k == 8) return launch_k<8>(counts, mid, percs, r, b, np, out, st);
  if (k == 4) return launch_k<4>(counts, mid, percs, r, b, np, out, st);
  return launch_k<2>(counts, mid, percs, r, b, np, out, st);
}

extern "C" const char* histogram_percentile_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
