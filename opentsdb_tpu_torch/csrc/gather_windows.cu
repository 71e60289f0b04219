// G1 gather_windows: the device series cache's batch gather, packed column
// buffers [P] -> one padded [S, N] batch.
//
// Replaces opentsdb_tpu/storage/device_cache.py:_gather_windows (:443), its
// int64-timestamp form: out_ts[i, j] = ts_buf[starts[i] + j],
// out_val[i, j] = val_buf[starts[i] + j], mask[i, j] = j < lengths[i]; the
// other slots hold PAD_TS (int64 max) and 0.0, as build_batch pads a row.
// The buffer index is clamped to [0, P - 1] as the reference clamps it, so
// no start or length can send a read out of the buffers.
//
// Bound on the H100: bytes.  Each requested point is read once from each
// buffer (16 B) and each output slot written once (8 + 8 + 1 = 17 B): at
// 1024 rows x 65,536 points 1.07 GB read and 1.14 GB written, ~0.66 ms at
// 3.35 TB/s.  It does no arithmetic beyond the index.
//
// Int32 form (the reference's ts_base gather, :464-475, with the
// planner's pre-compaction base, opentsdb_tpu/ops/downsample.py:498
// precompact_base): out_ts[i, j] = clip(ts_buf[k] - ts_base, 0,
// I32_PAD_TS) as int32 where j < lengths[i], I32_PAD_TS (2^31 - 2, past
// every re-based edge) elsewhere; values and mask as above.  K1's and
// K4's int32 forms read it with edges re-based alike.  Bound: 16 B read
// and 4 + 8 + 1 = 13 B written a slot, 1.95 GB at 1024 x 65,536, ~0.58 ms
// at 3.35 TB/s.
//
// Design: one thread per output slot, a 2-D grid of (N-tile, row); the
// rows beyond grid.y's limit are walked by a stride.  Neighbouring threads
// read neighbouring buffer words and write neighbouring output words, so
// every load and store is coalesced; the row's start and length are one
// broadcast load a block.  No shared memory, no atomics.  The timestamp's
// output type is a template parameter: one body for both forms.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t PAD_TS = INT64_MAX;
constexpr int32_t I32_PAD_TS = 2147483646;  // 2^31 - 2
constexpr unsigned MAX_GRID_Y = 65535;

// The stored timestamp of a point: as it is, or re-based and clipped.
__device__ __forceinline__ void put_ts(int64_t* out, int64_t o, int64_t ts, int64_t) {
  out[o] = ts;
}
__device__ __forceinline__ void put_ts(int32_t* out, int64_t o, int64_t ts, int64_t base) {
  const int64_t off = ts - base;
  out[o] = (int32_t)(off < 0 ? 0 : (off > I32_PAD_TS ? I32_PAD_TS : off));
}
__device__ __forceinline__ void put_pad(int64_t* out, int64_t o) { out[o] = PAD_TS; }
__device__ __forceinline__ void put_pad(int32_t* out, int64_t o) { out[o] = I32_PAD_TS; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_windows_kernel(const int64_t* __restrict__ ts_buf, const double* __restrict__ val_buf,
                      int64_t p, const int64_t* __restrict__ starts,
                      const int64_t* __restrict__ lengths, int64_t s, int64_t n,
                      int64_t ts_base, T* __restrict__ out_ts,
                      double* __restrict__ out_val, uint8_t* __restrict__ out_mask) {
  const int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (j >= n) return;
  for (int64_t row = blockIdx.y; row < s; row += gridDim.y) {
    const int64_t start = starts[row];
    const int64_t len = lengths[row];
    const int64_t o = row * n + j;
    if (j < len) {
      int64_t k = start + j;
      k = k < 0 ? 0 : (k >= p ? p - 1 : k);
      put_ts(out_ts, o, ts_buf[k], ts_base);
      out_val[o] = val_buf[k];
      out_mask[o] = 1;
    } else {
      put_pad(out_ts, o);
      out_val[o] = 0.0;
      out_mask[o] = 0;
    }
  }
}

}  // namespace

// ts_buf/val_buf: the [P] column buffers (P >= 1); starts/lengths: [S]
// int64 on the device; out_ts/out_val/out_mask: [S, N], out_ts int32
// offsets from ts_base when ts_is_i32, else int64 ms (ts_base unread).
extern "C" int gather_windows(const void* ts_buf, const void* val_buf, long long p,
                              const void* starts, const void* lengths, long long s,
                              long long n, long long ts_base, int ts_is_i32,
                              void* out_ts, void* out_val, void* out_mask,
                              void* stream) {
  if (s <= 0 || n <= 0 || p <= 0) return 0;
  const long long tiles = (n + THREADS - 1) / THREADS;
  const dim3 grid((unsigned)tiles, (unsigned)(s < MAX_GRID_Y ? s : MAX_GRID_Y));
  if (ts_is_i32)
    gather_windows_kernel<int32_t><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)ts_buf, (const double*)val_buf, (int64_t)p, (const int64_t*)starts,
        (const int64_t*)lengths, (int64_t)s, (int64_t)n, (int64_t)ts_base,
        (int32_t*)out_ts, (double*)out_val, (uint8_t*)out_mask);
  else
    gather_windows_kernel<int64_t><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)ts_buf, (const double*)val_buf, (int64_t)p, (const int64_t*)starts,
        (const int64_t*)lengths, (int64_t)s, (int64_t)n, (int64_t)ts_base,
        (int64_t*)out_ts, (double*)out_val, (uint8_t*)out_mask);
  return (int)cudaGetLastError();
}

extern "C" const char* gather_windows_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
