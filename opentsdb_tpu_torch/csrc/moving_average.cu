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
// Bound on the H100: bytes, and for float64 the chain of ordered adds.  It
// reads sums (8 B) and live (1 B) once and writes 8 B a slot: at the
// downsample position of the headline batch (1024 x 283 windows) 7.2 MB,
// about 2 us; at the union position (~6.7e7 slots) about 1 GB, 0.3 ms.  But
// the float64 running sum of a run is one chain of dependent adds in slot
// order (the reference's cumsum arithmetic, which the answer's bits
// follow): a run of L live slots takes at least L times the card's
// dependent float64 add latency (chip_smoke.py measures it with
// moving_average_chain below).
//
// Design: pre[k], the sum of a run's first k live sums from 0 in order, is
// written to a ring in shared memory, and out = (pre[k] - pre[k - N]) / N
// is read from it (pre goes to device memory only for a window past
// RING_N).  Everything but the ordered adds is off the chain.
//   - Long float64 runs (a mean run of LONG_RUN slots or more: the union
//     position) take a block each, its four warps a pipeline over chunks of
//     BLOCK_CHUNK slots, one __syncthreads a step: warp 1 loads chunk s + 1
//     and compacts its live slots by ballot and popc into a dense shared
//     array of live sums, with each slot's live index; lane 0 of warp 0
//     walks chunk s's dense sums, only loads, adds and stores into the
//     ring; warps 2 and 3 write chunk s - 1's outputs, coalesced.  The ring
//     holds two chunks and the N running sums before them.
//   - Shorter runs (the downsample and grid positions) and every int64 run
//     take a warp each, four runs a block: the warp compacts a chunk of
//     WARP_CHUNK slots, lane 0 walks it (float64), or a warp scan gives
//     every slot its running sum at once (int64: wrapping adds are
//     associative, so any order gives the same bits), then the warp writes
//     the chunk's outputs; the next chunk's loads are in flight meanwhile.
// The sums are the same additions in the same order from zero as the
// reference's cumsum gathers, bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int RING_N = 768;          // the longest window the rings hold
constexpr int64_t LONG_RUN = 4096;   // mean run length from which a run takes a block
constexpr int RUN_WARPS = 4;         // runs a block of the warp form
constexpr int WARP_CHUNK = 256;      // slots the warp form takes at once, 8 a lane
constexpr int WARP_RING = 1024;      // >= WARP_CHUNK + RING_N, a power of two
constexpr int BLOCK_THREADS = 128;   // the block form: walker, loader, two writers
constexpr int BLOCK_CHUNK = 512;     // slots a step of the block form, 16 a loader lane
constexpr int BLOCK_RING = 2048;     // >= 2 * BLOCK_CHUNK + RING_N, a power of two

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

// A run's running sums by live index: a ring in shared memory (mask its
// size - 1), or the run's stretch of device memory (mask ~0).
template <typename V>
struct Pre {
  V* p;
  int64_t mask;
  __device__ V& operator[](int64_t k) const { return p[k & mask]; }
  // the entries from k on that lie in one stretch, before the ring wraps
  __device__ int64_t stretch(int64_t k) const {
    return mask == ~0ll ? INT64_MAX : mask + 1 - (k & mask);
  }
};

// Live slot with live index k of a run: its window mean, 0 before N.
template <typename V>
__device__ __forceinline__ V window_mean(const Pre<V>& pre, int64_t k, int64_t nw) {
  return k < nw ? (V)0 : mean(minus(pre[k], pre[k - nw]), nw);
}

// The walk: out[i] = hi, then hi += dense[i], for n live sums.  Only the
// adds depend on each other: every load and store has a fixed offset, the
// next eight sums are loaded while the adds of eight run, and each running
// sum of eight has a register of its own until it is stored (a store reads
// its register late, and an add that overwrote it would wait for that).
__device__ __forceinline__ double walk(const double* __restrict__ dense, int n,
                                       double* __restrict__ out, double hi) {
  int i = 0;
  if (n >= 8) {
    double v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = dense[j];
    for (; i + 16 <= n; i += 8) {
      double next[8], run[9];
#pragma unroll
      for (int j = 0; j < 8; ++j) next[j] = dense[i + 8 + j];
      run[0] = hi;
#pragma unroll
      for (int j = 0; j < 8; ++j) run[j + 1] = __dadd_rn(run[j], v[j]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        out[i + j] = run[j];
        v[j] = next[j];
      }
      hi = run[8];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      out[i + j] = hi;
      hi = __dadd_rn(hi, v[j]);
    }
    i += 8;
  }
  for (; i < n; ++i) {
    out[i] = hi;
    hi = __dadd_rn(hi, dense[i]);
  }
  return hi;
}

// A chunk's n live sums walked into pre[k0], pre[k0 + 1], ...: in at most
// two stretches of the ring.
__device__ __forceinline__ double walk_chunk(const double* dense, int n, const Pre<double>& pre,
                                             int64_t k0, double hi) {
  for (int done = 0; done < n;) {
    const int64_t room = pre.stretch(k0 + done);
    const int len = room < n - done ? (int)room : n - done;
    hi = walk(dense + done, len, &pre[k0 + done], hi);
    done += len;
  }
  return hi;
}

// A warp a run, RUN_WARPS runs a block.  SPILL: the running sums in device
// memory (a window past RING_N); the two forms are compiled apart, so that
// the walk's stores go to a known kind of memory.
template <typename V, bool SPILL>
__global__ void __launch_bounds__(RUN_WARPS * 32)
ma_warp_kernel(const V* __restrict__ sums, const uint8_t* __restrict__ live,
               const int64_t* __restrict__ offsets, int64_t r, int64_t nw, V* __restrict__ gpre,
               V* __restrict__ out) {
  constexpr int ITEMS = WARP_CHUNK / 32;
  __shared__ V dense_all[RUN_WARPS][WARP_CHUNK];
  __shared__ V ring_all[RUN_WARPS][WARP_RING];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t run = (int64_t)blockIdx.x * RUN_WARPS + warp;
  if (run >= r) return;
  const int64_t a = offsets[run], b = offsets[run + 1];
  V* dense = dense_all[warp];
  const Pre<V> pre = SPILL ? Pre<V>{gpre + a + run, ~0ll}
                           : Pre<V>{ring_all[warp], WARP_RING - 1};
  const unsigned below = (1u << lane) - 1;
  V s[ITEMS];
  bool lv[ITEMS];
  auto load = [&](int64_t c0, V (&sv)[ITEMS], bool (&lvv)[ITEMS]) {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int64_t t = c0 + j * 32 + lane;
      const bool in = t < b;
      sv[j] = in ? sums[t] : (V)0;
      lvv[j] = in && (live == nullptr || live[t]);
    }
  };
  load(a, s, lv);
  V hi = 0;             // float64: lane 0's running sum; int64: every lane's carry
  int64_t before = 0;   // live slots before the chunk
  for (int64_t c0 = a; c0 < b; c0 += WARP_CHUNK) {
    int rel[ITEMS];
    int count = 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const unsigned bal = __ballot_sync(FULL, lv[j]);
      rel[j] = count + __popc(bal & below);
      if constexpr (std::is_floating_point<V>::value) {
        if (lv[j]) dense[rel[j]] = s[j];
      } else {
        // the running sum at each slot by a warp scan of the live sums
        const V w = lv[j] ? s[j] : (V)0;
        V incl = w;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const V y = (V)__shfl_up_sync(FULL, (long long)incl, off);
          if (lane >= off) incl = plus(incl, y);
        }
        if (lv[j]) pre[before + rel[j]] = plus(hi, minus(incl, w));
        hi = plus(hi, (V)__shfl_sync(FULL, (long long)incl, 31));
      }
      count += __popc(bal);
    }
    V sn[ITEMS];  // the next chunk's loads, in flight during the walk
    bool ln[ITEMS];
    load(c0 + WARP_CHUNK, sn, ln);
    if constexpr (std::is_floating_point<V>::value) {
      __syncwarp();
      if (lane == 0) hi = walk_chunk(dense, count, pre, before, hi);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int64_t t = c0 + j * 32 + lane;
      if (t < b) out[t] = lv[j] ? window_mean(pre, before + rel[j], nw) : (V)0;
    }
    before += count;
    __syncwarp();  // dense and the ring are refilled by the next chunk
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      s[j] = sn[j];
      lv[j] = ln[j];
    }
  }
}

// A block a long float64 run: walker, loader and writers in a pipeline
// (SPILL as for the warp form).
template <bool SPILL>
__global__ void __launch_bounds__(BLOCK_THREADS)
ma_block_kernel(const double* __restrict__ sums, const uint8_t* __restrict__ live,
                const int64_t* __restrict__ offsets, int64_t nw, double* __restrict__ gpre,
                double* __restrict__ out) {
  constexpr int ITEMS = BLOCK_CHUNK / 32;     // slots a loader lane
  constexpr int WRITERS = BLOCK_THREADS - 64;
  __shared__ double dense[2][BLOCK_CHUNK];   // chunk c's live sums: dense[c % 2]
  __shared__ int lidx[3][BLOCK_CHUNK];       // each slot's live index in its chunk, or -1
  __shared__ int cnt[3];                     // chunk c's live slots: cnt[c % 3]
  __shared__ double ring[BLOCK_RING];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t run = blockIdx.x;
  const int64_t a = offsets[run], b = offsets[run + 1];
  const int64_t chunks = (b - a + BLOCK_CHUNK - 1) / BLOCK_CHUNK;
  const Pre<double> pre = SPILL ? Pre<double>{gpre + a + run, ~0ll}
                                : Pre<double>{ring, BLOCK_RING - 1};
  double hi = 0.0;     // the walker's running sum
  int64_t before = 0;  // live slots before the chunk a role is at (walker, writers)
  // step s: load chunk s, walk chunk s - 1, write chunk s - 2
  for (int64_t s = 0; s < chunks + 2; ++s) {
    if (warp == 0) {
      const int64_t c = s - 1;
      if (c >= 0 && c < chunks) {
        const int n = cnt[c % 3];
        if (lane == 0) hi = walk_chunk(dense[c % 2], n, pre, before, hi);
        before += n;
      }
    } else if (warp == 1) {
      if (s < chunks) {
        const int64_t c0 = a + s * BLOCK_CHUNK;
        double v[ITEMS];
        bool lv[ITEMS];
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
          const int64_t t = c0 + j * 32 + lane;
          const bool in = t < b;
          v[j] = in ? sums[t] : 0.0;
          lv[j] = in && (live == nullptr || live[t]);
        }
        double* d = dense[s % 2];
        int* li = lidx[s % 3];
        const unsigned below = (1u << lane) - 1;
        int count = 0;
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
          const unsigned bal = __ballot_sync(FULL, lv[j]);
          const int rel = count + __popc(bal & below);
          if (lv[j]) d[rel] = v[j];
          li[j * 32 + lane] = lv[j] ? rel : -1;
          count += __popc(bal);
        }
        if (lane == 0) cnt[s % 3] = count;
      }
    } else {
      const int64_t c = s - 2;
      if (c >= 0) {
        const int64_t c0 = a + c * BLOCK_CHUNK;
        const int* li = lidx[c % 3];
        for (int i = threadIdx.x - 64; i < BLOCK_CHUNK; i += WRITERS) {
          const int64_t t = c0 + i;
          if (t < b) out[t] = li[i] < 0 ? 0.0 : window_mean(pre, before + li[i], nw);
        }
        before += cnt[c % 3];
      }
    }
    __syncthreads();
  }
}

__global__ void chain_kernel(long long adds, double step, double* out) {
  double x = 0.0;
  for (long long i = 0; i < adds; ++i) x = __dadd_rn(x, step);
  *out = x;
}

template <typename V, bool SPILL>
int launch_warps(const void* sums, const void* live, const void* offsets, long long r,
                 long long nw, void* pre, void* out, cudaStream_t st) {
  ma_warp_kernel<V, SPILL>
      <<<(unsigned)((r + RUN_WARPS - 1) / RUN_WARPS), RUN_WARPS * 32, 0, st>>>(
          (const V*)sums, (const uint8_t*)live, (const int64_t*)offsets, r, nw, (V*)pre,
          (V*)out);
  return (int)cudaGetLastError();
}

template <bool SPILL>
int launch(const void* sums, const void* live, const void* offsets, long long r,
           long long nw, int val_is_int, long long total, void* pre, void* out,
           cudaStream_t st) {
  if (val_is_int) return launch_warps<int64_t, SPILL>(sums, live, offsets, r, nw, pre, out, st);
  if (total / r < LONG_RUN)
    return launch_warps<double, SPILL>(sums, live, offsets, r, nw, pre, out, st);
  ma_block_kernel<SPILL><<<(unsigned)r, BLOCK_THREADS, 0, st>>>(
      (const double*)sums, (const uint8_t*)live, (const int64_t*)offsets, nw, (double*)pre,
      (double*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// Run i is slots [offsets[i], offsets[i+1]) of the flat sums and out, total
// slots in all; live (bytes) may be null: every slot is live.  val_is_int
// selects float64 (0) or int64 (1) sums and output.  pre (the sums' type,
// total + r entries) holds the running sums of a window past RING_N (768)
// slots, and is null otherwise.
extern "C" int moving_average(const void* sums, const void* live, const void* offsets,
                              long long r, long long n_window, int val_is_int,
                              long long total, void* pre, void* out, void* stream) {
  if (r <= 0 || total <= 0) return 0;
  if (n_window < 1 || (n_window > RING_N) != (pre != nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (pre != nullptr)
    return launch<true>(sums, live, offsets, r, n_window, val_is_int, total, pre, out, st);
  return launch<false>(sums, live, offsets, r, n_window, val_is_int, total, pre, out, st);
}

// The card's dependent float64 add latency: one thread, `adds` dependent
// __dadd_rn of `step`, the sum to out[0].  Not a port of anything: MA's
// chain bound is the longest run's live slots times this latency.
extern "C" int moving_average_chain(long long adds, double step, void* out, void* stream) {
  chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(adds, step, (double*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* moving_average_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
