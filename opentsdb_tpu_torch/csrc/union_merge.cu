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
// (6.7e7 points, ~6.7e7 slots), about 0.32 ms at 3.35 TB/s.  The merge
// below moves more: each round reads and writes every point (16 B), and
// the compaction reads the merged sequence and its run-start flags again:
// ceil(log2 S_g) rounds, 4 at the headline batch (S_g ~ 10), ~5.4 GB.
//
// Design: the rows are sorted already, so no sort runs; they are merged
// pairwise.  The points of the grouped rows are packed in row order, row r
// at pofs[r] (its valid-prefix count scanned; rows outside every group
// count 0).  Round k merges runs of 2^k rows in pairs: the run that starts
// at row ps (ps - offsets[g] a multiple of 2^(k+1)) with the run after it,
// each clipped at its group's end, into [pofs[ps], pofs[pe]) of the other
// buffer; rows keep their order, so no pair crosses a group and run
// boundaries come from pofs alone.  Round 0 reads the rows in place.  Each
// round is two launches: one thread a tile boundary finds its pair and the
// merge-path split there (how many of the first d outputs come from the
// first run), then a block a tile of TILE output slots stages both input
// spans of each pair it covers in shared memory with cp.async, each thread
// finds its own split in shared memory and merges ITEMS outputs, and the
// tile is written back coalesced: one writer a slot.  Ties go to the
// earlier run, and duplicates stay until the end.  In the last round each
// pair is a whole group, so its block also writes each slot's run-start
// flag (the group's first slot, or a timestamp unlike the one before) and
// its tile's count of them.  Then one block scans the tile counts and
// places the group offsets, and each tile compacts its run starts into u.
// The two buffers of the rounds are `merged` and u itself (the last round
// writes `merged`), so the scratch is the P-sized merged sequence and its
// flags.  Nothing is atomic, so the result is the same on every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// slots a thread merges or compacts: odd, so that a warp's threads write
// their merged slots to distinct shared banks
constexpr int ITEMS = 9;
constexpr int TILE = THREADS * ITEMS;  // slots a block merges or compacts
constexpr int PART = 6;                // words a tile boundary's partition holds

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

// The last index i in [0, k) with a[i] <= x (a non-decreasing, a[0] <= x).
__device__ int64_t last_at_most(const int64_t* a, int64_t k, int64_t x) {
  int64_t lo = 0, hi = k - 1;
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) / 2;
    if (a[mid] <= x) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// How many of the first d outputs of the merge of a[0, na) and b[0, nb)
// come from a, ties to a.
__device__ __forceinline__ int64_t merge_split(const int64_t* a, int64_t na, const int64_t* b,
                                               int64_t nb, int64_t d) {
  int64_t lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - 1 - mid]) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// One round's view of the packed sequence: runs of `half` rows merged in
// pairs, read from the rows in place (round 0) or from src.
struct Round {
  const int64_t* ts;
  int64_t n;
  const int64_t* src;  // null in round 0
  const int64_t* pofs;
  const int64_t* offsets;
  int64_t g, half;

  // The pair of row r of group gi: its first row, its second run's first
  // row and its end.
  __device__ void pair(int64_t r, int64_t gi, int64_t& ps, int64_t& pm, int64_t& pe) const {
    const int64_t a = offsets[gi], b = offsets[gi + 1];
    ps = a + (r - a) / (2 * half) * (2 * half);
    pm = ps + half < b ? ps + half : b;
    pe = ps + 2 * half < b ? ps + 2 * half : b;
  }
  // The run that starts at row r.
  __device__ const int64_t* run(int64_t r) const { return src ? src + pofs[r] : ts + r * n; }
};

// 1. pofs[r] = valid points in the grouped rows before r (pofs[s] = P):
// one block.
__global__ void __launch_bounds__(THREADS)
row_offsets_kernel(const uint8_t* __restrict__ mask, const int64_t* __restrict__ offsets,
                   int64_t g, int64_t s, int64_t n, int64_t* __restrict__ pofs) {
  __shared__ int64_t warp_tot[WARPS];
  const int64_t r0 = offsets[0], r1 = offsets[g];
  int64_t carry = 0;
  for (int64_t base = 0; base < s; base += THREADS) {
    const int64_t r = base + threadIdx.x;
    const int64_t c = r < s && r >= r0 && r < r1 ? prefix_count(mask + r * n, n) : 0;
    int64_t total;
    const int64_t incl = block_sum_scan(c, warp_tot, &total);
    if (r < s) pofs[r] = carry + incl - c;
    carry += total;
  }
  if (threadIdx.x == 0) pofs[s] = carry;
}

// 2. Per tile boundary b (output slot b * TILE < P): the pair holding it
// (its first row and group), the merge-path split there, and the pair's
// first slot and its two runs' lengths.
__global__ void __launch_bounds__(THREADS)
partition_kernel(Round rd, int64_t s, int64_t nb, int64_t* __restrict__ part) {
  const int64_t b = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (b > nb) return;
  const int64_t o = b * TILE;
  if (o >= rd.pofs[s]) return;
  const int64_t r = last_at_most(rd.pofs, s + 1, o);  // a row holding slot o
  const int64_t gi = last_at_most(rd.offsets, rd.g + 1, r);
  int64_t ps, pm, pe;
  rd.pair(r, gi, ps, pm, pe);
  const int64_t base = rd.pofs[ps], mid = rd.pofs[pm];
  const int64_t na = mid - base, nbb = rd.pofs[pe] - mid;
  int64_t* p = part + PART * b;
  p[0] = ps;
  p[1] = gi;
  p[2] = merge_split(rd.run(ps), na, rd.run(pm), nbb, o - base);
  p[3] = base;
  p[4] = na;
  p[5] = nbb;
}

// 3. Merge the tile's slots of every pair it covers into dst; in the last
// round, also the run-start flags and the tile's count of them.
__global__ void __launch_bounds__(THREADS, 4)
merge_kernel(Round rd, int64_t s, const int64_t* __restrict__ part, int64_t* __restrict__ dst,
             int last, uint8_t* __restrict__ first, int64_t* __restrict__ tiles) {
  __shared__ __align__(16) int64_t buf[TILE];
  __shared__ int64_t warp_tot[WARPS];
  const int64_t b = blockIdx.x;
  const int64_t total = rd.pofs[s];
  const int64_t o0 = b * TILE;
  if (o0 >= total) {
    if (last && threadIdx.x == 0) tiles[b] = 0;
    return;
  }
  const int64_t o1 = o0 + TILE < total ? o0 + TILE : total;
  const int64_t* p = part + PART * b;
  int64_t ps = p[0], gi = p[1], i0 = p[2], base = p[3], na = p[4], nbb = p[5];
  int64_t starts = 0;  // this thread's run starts
  int64_t cur = o0;
  for (bool head = true; cur < o1; head = false) {
    int64_t pm, pe, ps2;
    rd.pair(ps, gi, ps2, pm, pe);
    if (!head) {
      base = rd.pofs[ps];
      na = rd.pofs[pm] - base;
      nbb = rd.pofs[pe] - rd.pofs[pm];
    }
    const int64_t end = base + na + nbb;
    const int64_t seg_end = end < o1 ? end : o1;
    if (seg_end > cur) {
      // the first run's span [i0, i1) and the second's [j0, j1)
      const int64_t i1 = seg_end == o1 && o1 < end ? part[PART * (b + 1) + 2] : na;
      const int64_t j0 = cur - base - i0, j1 = seg_end - base - i1;
      const int64_t la = i1 - i0, len = seg_end - cur;
      const int64_t* A = rd.run(ps);
      const int64_t* B = rd.run(pm);
      for (int64_t t = threadIdx.x; t < la; t += THREADS) cp_async8(buf + t, A + i0 + t);
      for (int64_t t = threadIdx.x; t < len - la; t += THREADS)
        cp_async8(buf + la + t, B + j0 + t);
      cp_async_wait_all();
      __syncthreads();
      const int64_t d = (int64_t)threadIdx.x * ITEMS < len ? (int64_t)threadIdx.x * ITEMS : len;
      int64_t ia = merge_split(buf, la, buf + la, len - la, d), ib = d - ia;
      int64_t outv[ITEMS];
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        if (d + k < len) {
          const bool take_a = ia < la && (ib >= len - la || buf[ia] <= buf[la + ib]);
          outv[k] = take_a ? buf[ia++] : buf[la + ib++];
        }
      }
      // the element before the segment in merged order (a pair's start
      // has none: in the last round it starts a group)
      int64_t prev = 0;
      if (last && cur > base) {
        const int64_t pa = i0 > 0 ? A[i0 - 1] : INT64_MIN, pb = j0 > 0 ? B[j0 - 1] : INT64_MIN;
        prev = pa > pb ? pa : pb;
      }
      __syncthreads();  // every split is read before the merged slots land
#pragma unroll
      for (int k = 0; k < ITEMS; ++k)
        if (d + k < len) buf[d + k] = outv[k];
      __syncthreads();
      for (int64_t t = threadIdx.x; t < len; t += THREADS) {
        const int64_t x = buf[t];
        dst[cur + t] = x;
        if (last) {
          const bool start = t > 0 ? x != buf[t - 1] : (cur == base || x != prev);
          first[cur + t] = start ? 1 : 0;
          starts += start;
        }
      }
      __syncthreads();  // the tile's slots are out before the next pair's land
      cur = seg_end;
    }
    // the next pair: it starts where this one ends, in this group or the
    // next non-empty one
    ps = pe;
    i0 = 0;
    while (gi < rd.g && ps >= rd.offsets[gi + 1]) ++gi;
  }
  if (last) {
    int64_t sum;
    block_sum_scan(starts, warp_tot, &sum);
    if (threadIdx.x == 0) tiles[b] = sum;
  }
}

// 4. One block: exclusive scan of the tile counts (tiles[nb] = U), each
// thread over a contiguous chunk of them, then uoff[gi] = run starts
// before group gi's first merged slot.
__global__ void __launch_bounds__(THREADS)
scan_tiles_kernel(const uint8_t* __restrict__ first, const int64_t* __restrict__ pofs,
                  const int64_t* __restrict__ offsets, int64_t g, int64_t nb,
                  int64_t* __restrict__ tiles, int64_t* __restrict__ uoff) {
  __shared__ int64_t warp_tot[WARPS];
  const int64_t per = (nb + THREADS - 1) / THREADS;
  const int64_t t0 = threadIdx.x * per < nb ? threadIdx.x * per : nb;
  const int64_t t1 = t0 + per < nb ? t0 + per : nb;
  int64_t c = 0;
  for (int64_t i = t0; i < t1; ++i) c += tiles[i];
  int64_t total;
  int64_t run = block_sum_scan(c, warp_tot, &total) - c;
  for (int64_t i = t0; i < t1; ++i) {
    const int64_t x = tiles[i];
    tiles[i] = run;
    run += x;
  }
  if (threadIdx.x == 0) tiles[nb] = total;
  __syncthreads();
  // a warp a group: the run starts in its first slot's tile before it
  const int lane = threadIdx.x & 31;
  for (int64_t gi = threadIdx.x >> 5; gi <= g; gi += WARPS) {
    const int64_t at = pofs[offsets[gi]];
    const int64_t tile = at / TILE;
    int64_t c2 = 0;
    for (int64_t k = tile * TILE + lane; k < at; k += 32) c2 += first[k];
    for (int off = 16; off > 0; off >>= 1) c2 += __shfl_xor_sync(0xffffffffu, c2, off);
    if (lane == 0) uoff[gi] = tiles[tile] + c2;
  }
}

// 5. Compact the run starts of each tile into u, through shared memory
// so that both the reads and the writes are coalesced: the tile's slots
// come in striped, each thread takes ITEMS neighbouring ones (an odd
// stride: distinct banks), a block scan places its run starts, which move
// down in place, and the compacted span goes out striped.
__global__ void __launch_bounds__(THREADS)
compact_kernel(const int64_t* __restrict__ merged, const uint8_t* __restrict__ first,
               const int64_t* __restrict__ tiles, const int64_t* __restrict__ total,
               int64_t* __restrict__ u) {
  __shared__ __align__(16) int64_t buf[TILE];
  __shared__ uint8_t flag[TILE];
  __shared__ int64_t warp_tot[WARPS];
  const int64_t k0 = (int64_t)blockIdx.x * TILE;
  const int64_t len = *total - k0 < TILE ? *total - k0 : TILE;
  if (len <= 0) return;
  for (int t = threadIdx.x; t < len; t += THREADS) {
    cp_async8(buf + t, merged + k0 + t);
    flag[t] = first[k0 + t];
  }
  cp_async_wait_all();
  __syncthreads();
  const int d = threadIdx.x * ITEMS;
  int64_t x[ITEMS];
  int c = 0;
  unsigned take = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const bool f = d + i < len && flag[d + i];
    x[i] = f ? buf[d + i] : 0;
    take |= (f ? 1u : 0u) << i;
    c += f ? 1 : 0;
  }
  int64_t count;
  const int64_t at = block_sum_scan(c, warp_tot, &count) - c;  // syncs: all read
  int k = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if ((take >> i) & 1u) {
      buf[at + k] = x[i];
      k += 1;
    }
  }
  __syncthreads();
  int64_t* out = u + tiles[blockIdx.x];
  for (int t = threadIdx.x; t < count; t += THREADS) out[t] = buf[t];
}

}  // namespace

// offsets[g + 1]: the groups' row runs; rounds = ceil(log2(the largest
// group's rows)), at least 1.  merged[s * n] and first[s * n] are scratch,
// u[s * n] the output and the second buffer of the rounds; scans holds
// s + 1 row offsets, nb + 1 tile counts and 6 (nb + 1) partition words, nb
// = ceil(s * n / TILE).
extern "C" int union_merge(const void* ts, const void* mask, const void* offsets,
                           long long s, long long n, long long g, long long rounds,
                           void* merged, void* first, void* scans, long long scans_len,
                           void* u, void* uoff, void* stream) {
  if (s <= 0 || n <= 0 || g <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int64_t cap = (int64_t)s * n;
  const int64_t nb = (cap + TILE - 1) / TILE;
  if (rounds < 1 || scans_len < s + 1 + (1 + PART) * (nb + 1))
    return (int)cudaErrorInvalidValue;
  int64_t* pofs = (int64_t*)scans;
  int64_t* tiles = pofs + s + 1;
  int64_t* part = tiles + nb + 1;
  row_offsets_kernel<<<1, THREADS, 0, st>>>((const uint8_t*)mask, (const int64_t*)offsets, g,
                                            s, n, pofs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Round rd{(const int64_t*)ts, n, nullptr, pofs, (const int64_t*)offsets, g, 1};
  for (long long k = 0; k < rounds; ++k) {
    // the last round writes merged, the one before it u, and so on back
    int64_t* dst = (int64_t*)(((rounds - 1 - k) % 2 == 0) ? merged : u);
    rd.half = 1ll << k;
    partition_kernel<<<(unsigned)((nb + 1 + THREADS - 1) / THREADS), THREADS, 0, st>>>(
        rd, s, nb, part);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int last = k == rounds - 1;
    merge_kernel<<<(unsigned)nb, THREADS, 0, st>>>(rd, s, part, dst, last, (uint8_t*)first,
                                                   tiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    rd.src = dst;
  }
  scan_tiles_kernel<<<1, THREADS, 0, st>>>((const uint8_t*)first, pofs,
                                           (const int64_t*)offsets, g, nb, tiles,
                                           (int64_t*)uoff);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  compact_kernel<<<(unsigned)nb, THREADS, 0, st>>>((const int64_t*)merged,
                                                   (const uint8_t*)first, tiles, pofs + s,
                                                   (int64_t*)u);
  return (int)cudaGetLastError();
}

extern "C" const char* union_merge_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
