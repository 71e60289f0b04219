// H1 histogram_accumulate: the bucket scatter of a histogram query,
// nnz (cell, count) entries -> the [R, B] int64 count grid.
//
// Replaces opentsdb_tpu/histogram/kernels.py:accumulate_rows (a
// jax.ops.segment_sum of the int64 counts over seg = row * B + bucket).
// Every group of a query shares the grid: its rows are the groups'
// data-bearing windows stacked.
//
// Bound on the H100: bytes.  Each entry is read once (8 B seg + 8 B
// count) and each grid cell written once (8 B): at nnz 1.9e8 that is
// ~3 GB, ~0.9 ms at 3.35 TB/s.  Where many entries land in one cell (a
// coarse downsample: thousands of entries a cell) the L2 atomic units,
// not the memory, may set the pace.
//
// Design: one launch zeroes the grid and the error flag, a second adds
// every entry's count into its cell with a native 64-bit atomicAdd on
// unsigned long long, grid-stride, coalesced reads of seg and cnt.
// Integer addition is associative, so the grid is the same on every run
// whatever order the atomics land in: the plain version (index_add_) and
// this kernel agree exactly.  Zero counts add nothing and are skipped.
// A negative count (a JSON bucket map may carry one) is added as the
// reference's segment sum adds it: its two's complement wraps the
// unsigned atomic to the signed int64 sum.  An entry whose cell lies
// outside [0, R * B) is not added; it sets the flag, which the wrapper
// reads and raises on.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;

__global__ void __launch_bounds__(THREADS)
zero_kernel(unsigned long long* __restrict__ grid, int64_t cells,
            int* __restrict__ flag) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < cells;
       i += stride)
    grid[i] = 0ULL;
  if (blockIdx.x == 0 && threadIdx.x == 0) *flag = 0;
}

__global__ void __launch_bounds__(THREADS)
scatter_kernel(const int64_t* __restrict__ seg,
               const int64_t* __restrict__ cnt, int64_t nnz, int64_t cells,
               unsigned long long* __restrict__ grid,
               int* __restrict__ flag) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  int bad = 0;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < nnz;
       i += stride) {
    const int64_t s = seg[i];
    const int64_t c = cnt[i];
    if (s < 0 || s >= cells) {
      bad = 1;
    } else if (c != 0) {
      atomicAdd(grid + s, (unsigned long long)c);
    }
  }
  if (bad) atomicOr(flag, bad);
}

int blocks_for(int64_t n) {
  const int64_t b = (n + THREADS - 1) / THREADS;
  return (int)(b < MAX_BLOCKS ? (b > 0 ? b : 1) : MAX_BLOCKS);
}

}  // namespace

extern "C" int histogram_accumulate(const void* seg, const void* cnt,
                                    long long nnz, long long cells,
                                    void* grid, void* flag, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  zero_kernel<<<blocks_for(cells), THREADS, 0, st>>>(
      (unsigned long long*)grid, cells, (int*)flag);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nnz <= 0) return (int)err;
  scatter_kernel<<<blocks_for(nnz), THREADS, 0, st>>>(
      (const int64_t*)seg, (const int64_t*)cnt, nnz, cells,
      (unsigned long long*)grid, (int*)flag);
  return (int)cudaGetLastError();
}

extern "C" const char* histogram_accumulate_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
