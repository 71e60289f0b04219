// U1 union_merge: per group, the sorted unique union of its member rows'
// timestamps, all groups in one flat u[U] with group offsets uoff[G + 1].
//
// Replaces opentsdb_tpu/ops/union_agg.py:union_timestamps (a sort of all
// S*N padded timestamps, then a first-of-run mask) as the union arm of
// ops/pipeline.py:_pipeline runs it once per group.  Rows arrive with their
// valid points as a time-sorted prefix (the batch builders, or R after a
// rate) and groups as contiguous row runs [offsets[g], offsets[g+1]).
//
// Bound on the H100: bytes.  It must read each point's timestamp once
// (8 B) and write each union slot once (8 B): 1.1 GB at the headline batch
// (6.7e7 points, ~6.7e7 slots), about 0.32 ms at 3.35 TB/s.  What it does
// instead is set by its probes: every point searches every other row of its
// group, P x (S_g - 1) probes at log N each, about 1.1e10 at the headline
// batch (S_g ~ 10) and 1.6e10 for 1024 rows in one group over 6 hours.
//
// Design: rows are sorted already, so no sort runs.  A point's place in its
// group's merged sequence (ties broken by row) is its own index plus, for
// every other member row, the count of that row's points before it; it is
// the first of a run of equal timestamps unless an earlier row (or the
// previous slot of its own row) holds the same timestamp.  A thread ranks
// CH consecutive points of a row: one binary search per other row for the
// first, then a cursor walked forward for the rest.  The ranks scatter the
// timestamps and run-start flags into a merged sequence with one writer a
// slot, and a three-step scan (tile counts, one block scanning them and
// placing the group offsets, tile-local scans) compacts the run starts
// into u.  Six launches on one stream; nothing is atomic, so the result is
// the same on every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CH = 8;                  // points a thread ranks
constexpr int ITEMS = 16;              // merged slots a thread compacts
constexpr int TILE = THREADS * ITEMS;  // merged slots a block compacts

// Inclusive sum over the block in thread order; *total is the block's sum.
// Every thread of the block must call it.
__device__ int64_t block_sum_scan(int64_t x, int64_t* warp_tot, int64_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int64_t w = lane < WARPS ? warp_tot[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < WARPS) warp_tot[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x += warp_tot[warp - 1];
  *total = warp_tot[WARPS - 1];
  __syncthreads();
  return x;
}

// Valid points of a row whose mask is a prefix of ones.
__device__ int64_t prefix_count(const uint8_t* m, int64_t n) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (m[mid]) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// First index in t[0, c) whose value is >= x (upper: > x).
__device__ int64_t search(const int64_t* t, int64_t c, int64_t x, bool upper) {
  int64_t lo = 0, hi = c;
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (t[mid] < x || (upper && t[mid] == x)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// 1. pofs[r] = valid points in rows before r (pofs[s] = all): one block.
__global__ void __launch_bounds__(THREADS)
row_offsets_kernel(const uint8_t* __restrict__ mask, int64_t s, int64_t n,
                   int64_t* __restrict__ pofs) {
  __shared__ int64_t warp_tot[WARPS];
  int64_t carry = 0;
  for (int64_t base = 0; base < s; base += THREADS) {
    const int64_t r = base + threadIdx.x;
    const int64_t c = r < s ? prefix_count(mask + r * n, n) : 0;
    int64_t total;
    const int64_t incl = block_sum_scan(c, warp_tot, &total);
    if (r < s) pofs[r] = carry + incl - c;
    carry += total;
  }
  if (threadIdx.x == 0) pofs[s] = carry;
}

// 2. Each point's place in its group's merged sequence, and whether it
// starts a run of equal timestamps.
__global__ void __launch_bounds__(THREADS)
rank_kernel(const int64_t* __restrict__ ts, const int64_t* __restrict__ pofs,
            const int64_t* __restrict__ offsets, int64_t s, int64_t n, int64_t g,
            int64_t chunks, int64_t* __restrict__ merged,
            uint8_t* __restrict__ first) {
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t r = tid / chunks;
  if (r >= s) return;
  const int64_t i0 = (tid % chunks) * CH;
  const int64_t cnt = pofs[r + 1] - pofs[r];
  if (i0 >= cnt || r < offsets[0] || r >= offsets[g]) return;
  int64_t lo = 0, hi = g - 1;  // the group: last gi with offsets[gi] <= r
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) / 2;
    if (offsets[mid] <= r) lo = mid; else hi = mid - 1;
  }
  const int64_t a = offsets[lo], b = offsets[lo + 1];
  const int m = cnt - i0 < CH ? (int)(cnt - i0) : CH;
  const int64_t* tr = ts + r * n;
  int64_t t[CH], rank[CH];
  bool fst[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    if (j < m) {
      t[j] = tr[i0 + j];
      rank[j] = i0 + j;
      fst[j] = i0 + j == 0 || tr[i0 + j - 1] != t[j];
    }
  }
  for (int64_t r2 = a; r2 < b; ++r2) {
    const int64_t c2 = pofs[r2 + 1] - pofs[r2];
    if (r2 == r || c2 == 0) continue;
    const int64_t* t2 = ts + r2 * n;
    const bool earlier = r2 < r;  // an earlier row's equal point comes first
    int64_t pos = search(t2, c2, t[0], earlier);
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      if (j < m) {
        while (pos < c2 && (t2[pos] < t[j] || (earlier && t2[pos] == t[j]))) ++pos;
        rank[j] += pos;
        if (earlier && pos > 0 && t2[pos - 1] == t[j]) fst[j] = false;
      }
    }
  }
  const int64_t base = pofs[a];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    if (j < m) {
      merged[base + rank[j]] = t[j];
      first[base + rank[j]] = fst[j] ? 1 : 0;
    }
  }
}

// 3. Run starts per tile of the merged sequence.
__global__ void __launch_bounds__(THREADS)
tile_count_kernel(const uint8_t* __restrict__ first, int64_t cap,
                  int64_t* __restrict__ tiles) {
  __shared__ int64_t warp_tot[WARPS];
  const int64_t base = (int64_t)blockIdx.x * TILE;
  int64_t c = 0;
  for (int i = 0; i < ITEMS; ++i) {
    const int64_t k = base + (int64_t)i * THREADS + threadIdx.x;
    if (k < cap) c += first[k];
  }
  int64_t total;
  block_sum_scan(c, warp_tot, &total);
  if (threadIdx.x == 0) tiles[blockIdx.x] = total;
}

// 4. One block: exclusive scan of the tile counts (tiles[nb] = U), then
// uoff[gi] = run starts before group gi's first merged slot.
__global__ void __launch_bounds__(THREADS)
scan_tiles_kernel(const uint8_t* __restrict__ first, const int64_t* __restrict__ pofs,
                  const int64_t* __restrict__ offsets, int64_t g, int64_t nb,
                  int64_t* __restrict__ tiles, int64_t* __restrict__ uoff) {
  __shared__ int64_t warp_tot[WARPS];
  int64_t carry = 0;
  for (int64_t base = 0; base < nb; base += THREADS) {
    const int64_t i = base + threadIdx.x;
    const int64_t c = i < nb ? tiles[i] : 0;
    int64_t total;
    const int64_t incl = block_sum_scan(c, warp_tot, &total);
    if (i < nb) tiles[i] = carry + incl - c;
    carry += total;
  }
  if (threadIdx.x == 0) tiles[nb] = carry;
  __syncthreads();
  for (int64_t gi = threadIdx.x; gi <= g; gi += THREADS) {
    const int64_t at = pofs[offsets[gi]];
    const int64_t tile = at / TILE;
    int64_t c = tiles[tile];
    for (int64_t k = tile * TILE; k < at; ++k) c += first[k];
    uoff[gi] = c;
  }
}

// 5. Compact the run starts of each tile into u.
__global__ void __launch_bounds__(THREADS)
compact_kernel(const int64_t* __restrict__ merged, const uint8_t* __restrict__ first,
               const int64_t* __restrict__ tiles, int64_t cap,
               int64_t* __restrict__ u) {
  __shared__ int64_t warp_tot[WARPS];
  const int64_t k0 = (int64_t)blockIdx.x * TILE + (int64_t)threadIdx.x * ITEMS;
  uint8_t f[ITEMS];
  int64_t c = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    f[i] = k0 + i < cap ? first[k0 + i] : 0;
    c += f[i];
  }
  int64_t total;
  int64_t at = tiles[blockIdx.x] + block_sum_scan(c, warp_tot, &total) - c;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (f[i]) u[at++] = merged[k0 + i];
  }
}

}  // namespace

extern "C" int union_merge(const void* ts, const void* mask, const void* offsets,
                           long long s, long long n, long long g, void* merged,
                           void* first, void* scans, long long scans_len,
                           void* u, void* uoff, void* stream) {
  if (s <= 0 || n <= 0 || g <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int64_t cap = (int64_t)s * n;
  const int64_t nb = (cap + TILE - 1) / TILE;
  if (scans_len < s + 2 + nb) return (int)cudaErrorInvalidValue;
  int64_t* pofs = (int64_t*)scans;
  int64_t* tiles = pofs + s + 1;
  // slots of rows outside every group are never ranked: no run starts
  cudaError_t err = cudaMemsetAsync(first, 0, (size_t)cap, st);
  if (err != cudaSuccess) return (int)err;
  row_offsets_kernel<<<1, THREADS, 0, st>>>((const uint8_t*)mask, s, n, pofs);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int64_t chunks = (n + CH - 1) / CH;
  const int64_t threads = (int64_t)s * chunks;
  rank_kernel<<<(unsigned)((threads + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      (const int64_t*)ts, pofs, (const int64_t*)offsets, s, n, g, chunks,
      (int64_t*)merged, (uint8_t*)first);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tile_count_kernel<<<(unsigned)nb, THREADS, 0, st>>>((const uint8_t*)first, cap, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scan_tiles_kernel<<<1, THREADS, 0, st>>>((const uint8_t*)first, pofs,
                                           (const int64_t*)offsets, g, nb, tiles,
                                           (int64_t*)uoff);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  compact_kernel<<<(unsigned)nb, THREADS, 0, st>>>(
      (const int64_t*)merged, (const uint8_t*)first, tiles, cap, (int64_t*)u);
  return (int)cudaGetLastError();
}

extern "C" const char* union_merge_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
