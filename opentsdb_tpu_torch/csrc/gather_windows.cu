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
// Design: one thread per output slot, a 2-D grid of (N-tile, row); the
// rows beyond grid.y's limit are walked by a stride.  Neighbouring threads
// read neighbouring buffer words and write neighbouring output words, so
// every load and store is coalesced; the row's start and length are one
// broadcast load a block.  No shared memory, no atomics.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t PAD_TS = INT64_MAX;
constexpr unsigned MAX_GRID_Y = 65535;

__global__ void __launch_bounds__(THREADS)
gather_windows_kernel(const int64_t* __restrict__ ts_buf, const double* __restrict__ val_buf,
                      int64_t p, const int64_t* __restrict__ starts,
                      const int64_t* __restrict__ lengths, int64_t s, int64_t n,
                      int64_t* __restrict__ out_ts, double* __restrict__ out_val,
                      uint8_t* __restrict__ out_mask) {
  const int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (j >= n) return;
  for (int64_t row = blockIdx.y; row < s; row += gridDim.y) {
    const int64_t start = starts[row];
    const int64_t len = lengths[row];
    const int64_t o = row * n + j;
    if (j < len) {
      int64_t k = start + j;
      k = k < 0 ? 0 : (k >= p ? p - 1 : k);
      out_ts[o] = ts_buf[k];
      out_val[o] = val_buf[k];
      out_mask[o] = 1;
    } else {
      out_ts[o] = PAD_TS;
      out_val[o] = 0.0;
      out_mask[o] = 0;
    }
  }
}

}  // namespace

// ts_buf/val_buf: the [P] column buffers (P >= 1); starts/lengths: [S]
// int64 on the device; out_ts/out_val/out_mask: [S, N].
extern "C" int gather_windows(const void* ts_buf, const void* val_buf, long long p,
                              const void* starts, const void* lengths, long long s,
                              long long n, void* out_ts, void* out_val, void* out_mask,
                              void* stream) {
  if (s <= 0 || n <= 0 || p <= 0) return 0;
  const long long tiles = (n + THREADS - 1) / THREADS;
  const dim3 grid((unsigned)tiles, (unsigned)(s < MAX_GRID_Y ? s : MAX_GRID_Y));
  gather_windows_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)ts_buf, (const double*)val_buf, (int64_t)p, (const int64_t*)starts,
      (const int64_t*)lengths, (int64_t)s, (int64_t)n, (int64_t*)out_ts, (double*)out_val,
      (uint8_t*)out_mask);
  return (int)cudaGetLastError();
}

extern "C" const char* gather_windows_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
