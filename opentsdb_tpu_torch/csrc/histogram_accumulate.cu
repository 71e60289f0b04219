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
// Design: the grid and its stray-entry flag are one buffer of R * B + 1
// int64, the flag last, zeroed by one cudaMemsetAsync; then one launch
// adds every entry's count into its cell with a native 64-bit atomicAdd
// on unsigned long long.  A warp takes tiles of 32 x RUN consecutive
// entries, grid-stride: lane l reads entries l, l + 32, ..., so each load
// is coalesced, and a lane adds the entries of its run that hit the cell
// its previous entry hit in a register, one atomic a run of equal cells.
// In the planner's order a series' points follow each other, so under a
// coarse downsample the entries of one cell sit a point's buckets apart
// (32 for a 32-bucket histogram), and such a cell (case (c) of
// chip_smoke.py phase 7: ~3,840 entries) takes ~1/16 of the atomics.  A
// lane's RUN loads of a tile are all in flight at once.  Integer addition
// is associative, so the grid is the same on every run whatever order
// the atomics land in: the plain
// version (index_add_) and this kernel agree exactly.  A sum of zero adds
// nothing and is skipped.  A negative count (a JSON bucket map may carry
// one) is added as the reference's segment sum adds it: its two's
// complement wraps the unsigned sum to the signed int64 one.  An entry
// whose cell lies outside [0, R * B) is not added; it sets the flag.
// The kernel synchronises nothing: the wrapper hands the flag to its
// caller, which reads it with the copy it makes of the answer
// (histogram/kernels.py accumulate_rows_deferred).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int RUN = 16;                  // entries a lane reads, 32 apart
constexpr int TILE = 32 * RUN;           // entries a warp takes at once
constexpr int MAX_BLOCKS = 132 * 16;

__global__ void __launch_bounds__(THREADS)
scatter_kernel(const int64_t* __restrict__ seg,
               const int64_t* __restrict__ cnt, int64_t nnz, int64_t cells,
               unsigned long long* __restrict__ grid) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int64_t stride = ((int64_t)gridDim.x * THREADS >> 5) * TILE;
  bool bad = false;
  for (int64_t t0 = warp * TILE; t0 < nnz; t0 += stride) {
    int64_t s[RUN];
    unsigned long long c[RUN];
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      const int64_t i = t0 + lane + 32 * j;
      s[j] = i < nnz ? seg[i] : -1;
      c[j] = i < nnz ? (unsigned long long)cnt[i] : 0ULL;
      if (i < nnz && (s[j] < 0 || s[j] >= cells)) bad = true;
    }
    int64_t cell = -1;
    unsigned long long sum = 0ULL;
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      if (s[j] < 0 || s[j] >= cells) continue;
      if (s[j] != cell) {
        if (sum != 0ULL) atomicAdd(grid + cell, sum);
        cell = s[j];
        sum = 0ULL;
      }
      sum += c[j];
    }
    if (sum != 0ULL) atomicAdd(grid + cell, sum);
  }
  if (bad) grid[cells] = 1ULL;
}

}  // namespace

// grid: cells + 1 int64, the grid and then the stray-entry flag.
extern "C" int histogram_accumulate(const void* seg, const void* cnt,
                                    long long nnz, long long cells,
                                    void* grid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(grid, 0, (size_t)(cells + 1) * 8, st);
  if (err != cudaSuccess || nnz <= 0) return (int)err;
  const int64_t tiles = (nnz + TILE - 1) / TILE;
  const int64_t want = (tiles + THREADS / 32 - 1) / (THREADS / 32);
  const int blocks = (int)(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  scatter_kernel<<<blocks, THREADS, 0, st>>>(
      (const int64_t*)seg, (const int64_t*)cnt, nnz, cells,
      (unsigned long long*)grid);
  return (int)cudaGetLastError();
}

extern "C" const char* histogram_accumulate_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
