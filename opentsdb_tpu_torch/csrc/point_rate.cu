// R point_rate: the rate over raw [S, N] rows, with the surviving points
// moved to the front of their row.
//
// Replaces opentsdb_tpu/ops/rate.py:rate (with _prev_valid_index) as the
// union arm of ops/pipeline.py:_pipeline applies it to raw rows with their
// own timestamps, all_int included, and the ops/union_agg.py:compact_rows
// that follows it there: per point, the per-second rate against the
// previous valid point of its row (counter rollover against counter_max,
// reset_value suppression, drop_resets; with integer values a Java long
// difference, wrapping, before the divide).  A row's first point and a
// dropped reset carry no rate; the points that do are written first, in
// time order, and the rest of the row holds PAD_TS, NaN and 0.
//
// Bound on the H100: bytes.  It reads ts (i64), val (f64 or i64) and mask
// (u8) once and writes ts, rate (f64) and mask once: 17 bytes in and 17
// out a point, 2.3 GB at the headline batch of 1024 x 65,536 points,
// about 0.68 ms at 3.35 TB/s.
//
// Design: one block owns one row and walks it in tiles of THREADS x P
// points; a thread owns P consecutive points of a tile.
//   - Loads.  ts and val move into a ring of two shared stages by cp.async
//     (8 bytes a thread, adjacent threads on adjacent points), the mask by
//     ordinary byte loads held in registers; both are issued for the next
//     tile before the current one is worked, so a tile's latency overlaps
//     the work of the one before.  A stage pads one word after every P, so
//     that a thread reading its P points hits no bank twice.
//   - One block scan a tile, of a pair: the last valid point before each
//     thread's run (a max of indexes) and the valid points before it (a
//     sum).  The thread then walks its run in registers, the previous valid
//     point's ts and value carried along, starting from the scanned index
//     (read from the stage) or from the tiles before; the arithmetic is
//     the reference's term for term.  Without drop_resets a point survives
//     when it is valid and not the row's first valid point, so the sum
//     places every survivor; with drop_resets a second scan counts them.
//   - Writes.  The survivors go to the stage at their compacted places,
//     then out in order, adjacent threads on adjacent slots.  The pad tail
//     and the whole output mask (ones before the survivors' count, zeros
//     after) are written once the row ends, 16 bytes a store.
// A row of at most 2,048 points is one tile, of as many threads as it
// needs.  Each output slot has one writer.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int P = 8;               // points a thread owns in a tile
constexpr int LONG_THREADS = 128;  // a block over a row of several tiles
constexpr int MAX_THREADS = 256;   // the widest one-tile block
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int64_t PAD_TS = INT64_MAX;

// Word of tile point e in a stage: one pad word after every P.
__device__ __forceinline__ int slot(int e) { return e + e / P; }

__device__ __forceinline__ void copy8(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void copies_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void copies_wait() { asm volatile("cp.async.wait_group 0;\n" ::); }

// A stage's 8-byte word as a value, and back.
__device__ __forceinline__ void from_word(uint64_t w, int64_t& v) { v = (int64_t)w; }
__device__ __forceinline__ void from_word(uint64_t w, double& v) {
  v = __longlong_as_double((long long)w);
}
__device__ __forceinline__ uint64_t word_of(double v) {
  return (uint64_t)__double_as_longlong(v);
}

// The long difference a - b, wrapping like Java's, as a double.
__device__ double diff_of(int64_t a, int64_t b) {
  return (double)(int64_t)((uint64_t)a - (uint64_t)b);
}
__device__ double diff_of(double a, double b) { return a - b; }

// counter_max - prev + cur, in the value's arithmetic.
__device__ double rolled_of(int64_t cur, int64_t prev, int64_t counter_max) {
  return (double)(int64_t)((uint64_t)counter_max - (uint64_t)prev + (uint64_t)cur);
}
__device__ double rolled_of(double cur, double prev, int64_t counter_max) {
  return (double)counter_max - prev + cur;
}

struct Opts {
  int counter, drop_resets;
  int64_t counter_max, reset_value;
};

// The rate of point (t, cur) against the previous valid point (pt, pv);
// false where it is a dropped reset.
template <typename V>
__device__ __forceinline__ bool rate_of(int64_t t, V cur, int64_t pt, V pv, const Opts& o,
                                        double& r) {
  double dt = (double)(t - pt) / 1000.0;
  if (dt == 0.0) dt = INFINITY;
  const double diff = diff_of(cur, pv);
  if (o.counter) {
    const bool negative = diff < 0.0;
    if (o.drop_resets) {
      r = diff / dt;
      return !negative;
    }
    const double roll = rolled_of(cur, pv, o.counter_max) / dt;
    const bool suppressed = o.reset_value > 0 && roll > (double)o.reset_value;
    r = negative ? (suppressed ? 0.0 : roll) : diff / dt;
    return true;
  }
  r = diff / dt;
  return true;
}

// Exclusive block scan of (max of a, sum of b) in thread order; the
// block's totals in *amax and *bsum.  red holds 2 * MAX_WARPS ints that no
// other thread reads until the next __syncthreads.
__device__ __forceinline__ void scan_pair(int a, int b, int* red, int& a_before, int& b_before,
                                          int& amax, int& bsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int x = a, y = b;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int xu = __shfl_up_sync(0xffffffffu, x, d);
    const int yu = __shfl_up_sync(0xffffffffu, y, d);
    if (lane >= d) {
      x = xu > x ? xu : x;
      y += yu;
    }
  }
  if (lane == 31) {
    red[warp] = x;
    red[MAX_WARPS + warp] = y;
  }
  __syncthreads();
  int xa = __shfl_up_sync(0xffffffffu, x, 1), ya = __shfl_up_sync(0xffffffffu, y, 1);
  if (lane == 0) {
    xa = -1;
    ya = 0;
  }
  amax = -1;
  bsum = 0;
  for (int i = 0; i < warps; ++i) {
    const int wx = red[i], wy = red[MAX_WARPS + i];
    if (i < warp) {
      xa = wx > xa ? wx : xa;
      ya += wy;
    }
    amax = wx > amax ? wx : amax;
    bsum += wy;
  }
  a_before = xa;
  b_before = ya;
}

// Sets p[0, count) to value, 16-byte stores where the span allows.
template <typename T>
__device__ void fill(T* p, int64_t count, T value) {
  constexpr int per = 16 / sizeof(T);
  const int64_t mis = (int64_t)(((uintptr_t)p & 15) / sizeof(T));
  int64_t head = mis ? per - mis : 0;
  head = head < count ? head : count;
  for (int64_t i = threadIdx.x; i < head; i += blockDim.x) p[i] = value;
  const int64_t vecs = (count - head) / per;
  union {
    T v[per];
    uint4 u;
  } pat;
#pragma unroll
  for (int i = 0; i < per; ++i) pat.v[i] = value;
  uint4* body = (uint4*)(p + head);
  for (int64_t i = threadIdx.x; i < vecs; i += blockDim.x) body[i] = pat.u;
  for (int64_t i = head + vecs * per + threadIdx.x; i < count; i += blockDim.x) p[i] = value;
}

template <typename V>
__global__ void __launch_bounds__(MAX_THREADS)
point_rate_kernel(const int64_t* __restrict__ ts, const V* __restrict__ val,
                  const uint8_t* __restrict__ mask, int64_t n, Opts o,
                  int64_t* __restrict__ out_ts, double* __restrict__ out_val,
                  uint8_t* __restrict__ out_mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red[4 * MAX_WARPS];
  const int nt = blockDim.x, tid = threadIdx.x;
  const int tile = nt * P;                       // points a tile
  const int words = nt * (P + 1);                // words of a stage's array
  const int64_t tiles = (n + tile - 1) / tile;
  const int stages = tiles > 1 ? 2 : 1;
  uint64_t* s_ts = (uint64_t*)smem;              // stage k: s_ts + k * words
  uint64_t* s_val = s_ts + stages * words;       // ts, then val, then the rate
  uint8_t* s_mask = (uint8_t*)(s_val + stages * words);  // stage k: + k * tile
  const int64_t row = blockIdx.x;
  const int64_t* tr = ts + row * n;
  const V* vr = val + row * n;
  const uint8_t* mr = mask + row * n;
  int64_t* ot = out_ts + row * n;
  double* ov = out_val + row * n;

  uint8_t mreg[P];
  auto issue = [&](int64_t k) {  // tile k's ts and val copies, its mask loads
    const int st = (int)(k % stages);
    const int64_t b = k * tile;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int e = tid + i * nt;
      const bool in = b + e < n;
      if (in) {
        copy8(s_ts + st * words + slot(e), tr + b + e);
        copy8(s_val + st * words + slot(e), vr + b + e);
      }
      mreg[i] = in ? mr[b + e] : 0;
    }
    copies_commit();
  };

  issue(0);
  bool carry = false;  // a valid point before this tile
  int64_t carry_ts = 0;
  V carry_val = 0;
  int64_t written = 0;
  for (int64_t k = 0; k < tiles; ++k) {
    const int st = (int)(k % stages);
    uint64_t* sts = s_ts + st * words;
    uint64_t* sval = s_val + st * words;
    uint8_t* smk = s_mask + st * tile;
#pragma unroll
    for (int i = 0; i < P; ++i) smk[tid + i * nt] = mreg[i];
    copies_wait();
    __syncthreads();  // the stage is whole; the other stage is free
    if (k + 1 < tiles) issue(k + 1);

    // this thread's run: points tid * P + j of the tile
    int64_t t[P];
    V v[P];
    unsigned valid = 0;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int e = tid * P + j;
      t[j] = (int64_t)sts[slot(e)];
      from_word(sval[slot(e)], v[j]);
      valid |= (unsigned)(smk[e] != 0) << j;
    }
    const int last_mine = valid ? tid * P + 31 - __clz(valid) : -1;
    int prev_at, valid_before, last_at, valid_all;
    scan_pair(last_mine, __popc(valid), red, prev_at, valid_before, last_at, valid_all);

    // the previous valid point of the run's first
    const bool had = carry;
    bool has = carry;
    int64_t pt = carry_ts;
    V pv = carry_val;
    if (prev_at >= 0) {
      has = true;
      pt = (int64_t)sts[slot(prev_at)];
      from_word(sval[slot(prev_at)], pv);
    }
    if (last_at >= 0) {
      carry = true;
      carry_ts = (int64_t)sts[slot(last_at)];
      from_word(sval[slot(last_at)], carry_val);
    }
    double r[P];
    unsigned keep = 0;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (!((valid >> j) & 1u)) continue;
      if (has && rate_of(t[j], v[j], pt, pv, o, r[j])) keep |= 1u << j;
      has = true;
      pt = t[j];
      pv = v[j];
    }
    int place, kept;
    if (o.counter && o.drop_resets) {
      int unused_a, unused_b;
      scan_pair(-1, __popc(keep), red + 2 * MAX_WARPS, unused_a, place, unused_b, kept);
    } else {
      // every valid point survives but the row's first, which is this
      // tile's first where no tile before held one
      place = valid_before - (!had && valid_before > 0 ? 1 : 0);
      kept = valid_all - (!had && valid_all > 0 ? 1 : 0);
    }
    __syncthreads();  // every read of the stage's inputs is done
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (!((keep >> j) & 1u)) continue;
      sts[slot(place)] = (uint64_t)t[j];
      sval[slot(place)] = word_of(r[j]);
      ++place;
    }
    __syncthreads();
    for (int e = tid; e < kept; e += nt) {
      ot[written + e] = (int64_t)sts[slot(e)];
      from_word(sval[slot(e)], ov[written + e]);
    }
    written += kept;
  }
  fill<int64_t>(ot + written, n - written, PAD_TS);
  fill<double>(ov + written, n - written, NAN);
  fill<uint8_t>(out_mask + row * n, written, (uint8_t)1);
  fill<uint8_t>(out_mask + row * n + written, n - written, (uint8_t)0);
}

}  // namespace

extern "C" int point_rate(const void* ts, const void* val, const void* mask,
                          long long s, long long n, int val_is_int, int counter,
                          int drop_resets, long long counter_max,
                          long long reset_value, void* out_ts, void* out_val,
                          void* out_mask, void* stream) {
  if (s <= 0 || n <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  // a row of at most MAX_THREADS * P points is one tile of whole warps
  int nt = LONG_THREADS;
  if (n <= (long long)MAX_THREADS * P) {
    const long long warps = (n + 32 * P - 1) / (32 * P);
    nt = (int)warps * 32;
  }
  const long long tiles = (n + (long long)nt * P - 1) / ((long long)nt * P);
  const int stages = tiles > 1 ? 2 : 1;
  const size_t smem = (size_t)stages * nt * ((P + 1) * 16 + P);
  const Opts o{counter, drop_resets, counter_max, reset_value};
  if (val_is_int) {
    point_rate_kernel<int64_t><<<(unsigned)s, nt, smem, st>>>(
        (const int64_t*)ts, (const int64_t*)val, (const uint8_t*)mask, n, o, (int64_t*)out_ts,
        (double*)out_val, (uint8_t*)out_mask);
  } else {
    point_rate_kernel<double><<<(unsigned)s, nt, smem, st>>>(
        (const int64_t*)ts, (const double*)val, (const uint8_t*)mask, n, o, (int64_t*)out_ts,
        (double*)out_val, (uint8_t*)out_mask);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* point_rate_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
