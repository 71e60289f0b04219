// MA moving_average: the Java MovingAverage loop over runs of evaluation
// slots, sums[T] -> out[T], one run a row.
//
// Replaces opentsdb_tpu/ops/aggregators.py:java_moving_average (:177-214,
// Aggregators.MovingAverage :709-760) in its three positions: after the
// window sums of a downsample (ops/downsample.py:1121-1136, a run is a
// series' windows), after the group sums on the grid (ops/group_agg.py:
// 540-551, a run is a group's windows) and after the union sums
// (ops/union_agg.py:179-207, a run is a group's union slots).  Each live
// slot's output is the mean of the N live sums before it, exclusive of its
// own, and 0 until N live slots have passed; dead slots neither produce nor
// consume window state and hold 0.  The window sum is a difference of
// running sums, as the reference takes it (hi - lo of its cumsum), not a
// direct sum, which would round differently under cancellation.  int64
// sums are int mode: wrapping sums and a truncating long division.
//
// Bound on the H100: bytes.  It reads sums (8 B) and live (1 B) once and
// writes 8 B a slot: at the downsample position of the headline batch
// (1024 x 283 windows) 7.2 MB, about 2 us; at the union position (~6.7e7
// slots) about 1 GB, 0.3 ms.
//
// Design: two launches.  The running sums are the one sequential part (the
// reference's cumsum arithmetic, in order), so the first launch gives each
// run one warp (a block of its own, so runs spread over the SMs): the warp
// stages the next CHUNK slots' sums and live flags in shared memory with
// coalesced loads, then one lane walks them in order and only stores:
// pre[k], the sum of the first k live sums, and for each slot the index of
// its pre[k] (k its live slots before it), or -1 where the slot is dead or
// fewer than N live slots precede it.  The walk waits on a chain of adds,
// not on device memory.  The second launch gives every slot a thread:
// out = (pre[k] - pre[k - N]) / N, or 0 at index -1.  The two sums are the
// same additions in the same order from zero as the reference's cumsum
// gathers, bit for bit.  pre holds one entry a slot and one a run, the
// index one a slot.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int LANES = 32;     // the walk's warp
constexpr int CHUNK = 1024;   // slots the walk stages at once

__device__ __forceinline__ double plus(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ int64_t plus(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);
}
__device__ __forceinline__ double mean(double wsum, int64_t nw) {
  return __ddiv_rn(wsum, (double)nw);
}
__device__ __forceinline__ int64_t mean(int64_t wsum, int64_t nw) { return wsum / nw; }
__device__ __forceinline__ double minus(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ int64_t minus(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a - (uint64_t)b);
}

template <typename V>
__global__ void __launch_bounds__(LANES)
running_sums_kernel(const V* __restrict__ sums, const uint8_t* __restrict__ live,
                    const int64_t* __restrict__ offsets, int64_t nw, V* __restrict__ pre,
                    int64_t* __restrict__ at) {
  __shared__ V stage[CHUNK];
  __shared__ uint8_t stage_live[CHUNK];
  const int64_t row = blockIdx.x;
  const int lane = threadIdx.x;
  const int64_t a = offsets[row], b = offsets[row + 1];
  const int64_t base = a + row;  // this run's pre: b - a + 1 entries
  V hi = 0;
  int64_t before = 0;  // live slots before t (lane 0's walk)
  for (int64_t t0 = a; t0 < b; t0 += CHUNK) {
    const int len = (int)(b - t0 < CHUNK ? b - t0 : CHUNK);
    for (int i = lane; i < len; i += LANES) {
      stage[i] = sums[t0 + i];
      stage_live[i] = live == nullptr ? 1 : live[t0 + i];
    }
    __syncwarp();
    if (lane == 0) {
#pragma unroll 8
      for (int i = 0; i < len; ++i) {
        const int64_t t = t0 + i;
        if (!stage_live[i]) {
          at[t] = -1;
          continue;
        }
        at[t] = before >= nw ? base + before : -1;
        pre[base + before] = hi;
        hi = plus(hi, stage[i]);
        ++before;
      }
    }
    __syncwarp();  // the walk has read the stage before it is refilled
  }
}

template <typename V>
__global__ void __launch_bounds__(THREADS)
window_means_kernel(const V* __restrict__ pre, const int64_t* __restrict__ at, int64_t total,
                    int64_t nw, V* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= total) return;
  const int64_t k = at[t];
  out[t] = k < 0 ? (V)0 : mean(minus(pre[k], pre[k - nw]), nw);
}

template <typename V>
int launch(const void* sums, const void* live, const void* offsets, long long r,
           long long nw, long long total, void* pre, void* at, void* out, cudaStream_t st) {
  running_sums_kernel<V><<<(unsigned)r, LANES, 0, st>>>(
      (const V*)sums, (const uint8_t*)live, (const int64_t*)offsets, nw, (V*)pre,
      (int64_t*)at);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  window_means_kernel<V><<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      (const V*)pre, (const int64_t*)at, total, nw, (V*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// Run i is slots [offsets[i], offsets[i+1]) of the flat sums and out, total
// slots in all; live (bytes) may be null: every slot is live.  val_is_int
// selects float64 (0) or int64 (1) sums and output.  pre (the sums' type,
// total + r entries) and at (int64, total entries) are scratch.
extern "C" int moving_average(const void* sums, const void* live, const void* offsets,
                              long long r, long long n_window, int val_is_int,
                              long long total, void* pre, void* at, void* out,
                              void* stream) {
  if (r <= 0 || total <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (val_is_int)
    return launch<int64_t>(sums, live, offsets, r, n_window, total, pre, at, out, st);
  return launch<double>(sums, live, offsets, r, n_window, total, pre, at, out, st);
}

extern "C" const char* moving_average_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
