// The grouped fold that K3 (group_moments.cu) and T1 (tile_partials.cu)
// share: a group's rows of an [S, W] grid (contrib f64, participate u8,
// present u8) folded into its [G, W] moment cells.
//
// Row order is the contract.  Each (group, window) cell has one writer,
// a thread that adds the group's rows to its accumulators in row order,
// one row at a time, with no f64 atomic.  So T1's fold of every tile
// equals K3 over the whole grid bit for bit, stacked cells equal solo
// cells, a one-shard mesh equals one device, and a 1e15 group beside a
// 1.0 group keeps full precision (each group sums from its own zero).
// Squares and centred squares are formed in fold_row alone, each added
// by one explicit fused multiply-add (__fma_rn: one rounding, which the
// compiler can neither split nor fuse otherwise), so K3 and T1 cannot
// round them differently.
//
// Mapping: a block is one group and a tile of TW consecutive windows, and
// the first TW of its THREADS threads own one window each.  TW is 128,
// narrowed down to 16 while G x tiles is under MIN_BLOCKS (fold_tile), so
// a grid of few groups still spreads over the 132 SMs.  How the rows
// reach the owners is chosen by shape on the host (fold_staged), from the
// grid's mean group depth:
//   - direct (at most DIRECT_DEPTH rows a group on average: the headline
//     grid, a tile of the tiled fold, a shard): each owner reads its rows
//     from device memory, eight rows' loads in flight, and the kernel
//     takes no shared memory, so an SM holds as many blocks as it can;
//   - staged (deeper groups, such as fan-in: all rows one group): every
//     thread of the block copies chunks of CH rows into shared memory
//     with cp.async, two buffers deep, and the owners fold each chunk in
//     row order while the next is in flight.  contrib moves as one 8-byte
//     copy a cell; the flags as the 4-byte aligned words that hold a row's
//     cells, whatever W is, the fold reading a row at its offset in the
//     first word.
//
// Lanes are template bits: an instance carries only what its caller
// reads (K3's sum keeps no square, minimum or maximum; T1's centred mode
// reads no presence).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace group_fold {

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 4 * 132;   // blocks before the tile narrows
constexpr int DIRECT_DEPTH = 32;      // mean rows a group read unstaged

// The accumulators a fold keeps.
enum Lane : unsigned {
  L_CNT = 1,    // participating, non-NaN cells
  L_PRES = 2,   // present cells (read the present grid)
  L_SUM = 4,
  L_SQ = 8,     // x * x
  L_MIN = 16,
  L_MAX = 32,
  L_M2 = 64,    // (x - mean) ^ 2 around the cell's mean
};

// A cell's accumulators.  Count: the counters' type, int where they
// count one launch's rows (K3: a grid has fewer than 2^31), int64_t where
// they carry a lane's total across tiles (T1).
template <class Count>
struct Cell {
  Count cnt = 0, pres = 0;
  double sum = 0.0, sq = 0.0, mn = INFINITY, mx = -INFINITY, m2 = 0.0;
};

// One row of one cell.  A cell that takes no part adds nothing.
template <unsigned L, class C>
__device__ __forceinline__ void fold_row(C& c, double v, bool part,
                                         bool pres, double mean) {
  if (L & L_PRES) c.pres += pres ? 1 : 0;
  if (part && !isnan(v)) {
    if (L & L_CNT) c.cnt += 1;
    if (L & L_SUM) c.sum = __dadd_rn(c.sum, v);
    if (L & L_SQ) c.sq = __fma_rn(v, v, c.sq);
    if (L & L_MIN) c.mn = fmin(c.mn, v);
    if (L & L_MAX) c.mx = fmax(c.mx, v);
    if (L & L_M2) {
      const double d = __dsub_rn(v, mean);
      c.m2 = __fma_rn(d, d, c.m2);
    }
  }
}

// The staged chunk's layout in shared memory: CH contrib rows of TW
// doubles, then CH participate and, with PRESENT, CH present rows of FROW
// bytes (a row's aligned flag words).  A narrow tile stages more rows a
// chunk: it is chosen when the grid has few blocks, so shared memory is
// not what bounds its occupancy, and each chunk costs one load latency.
template <int TW, bool PRESENT>
struct Stage {
  static constexpr int CH = (TW <= 32 ? 2048 : 1024) / TW;
  static constexpr int FROW = TW + 4;
  static constexpr int VBYTES = CH * TW * 8;
  static constexpr int FBYTES = CH * FROW;
  static constexpr int BYTES =
      (VBYTES + FBYTES * (PRESENT ? 2 : 1) + 15) / 16 * 16;
};

// Both buffers of the widest layout a kernel of tile TW stages.
template <int TW>
constexpr int smem_bytes() {
  return 2 * Stage<TW, true>::BYTES;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int rows_in(int64_t n, int ch) {
  return n < ch ? (int)n : ch;
}

struct Grid {
  const double* contrib;
  const uint8_t* participate;
  const uint8_t* present;
  int w;
};

// The power of two at or above n.
__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// Issue the copies of rows [ra, ra + nr) x windows [c0, c0 + tw) into a
// stage buffer.  contrib: one 8-byte copy a cell, TW threads a row, so a
// thread steps its source by a fixed stride from row to row.  Flags: the
// 4-byte aligned words that hold a row's cells (the first may start up to
// 3 bytes before the row), FS slots a row.
template <int TW, bool PRESENT>
__device__ __forceinline__ void stage_rows(unsigned char* buf, const Grid& a,
                                           int64_t ra, int nr, int c0,
                                           int tw) {
  using S = Stage<TW, PRESENT>;
  constexpr int VR = THREADS / TW;                 // contrib rows a pass
  constexpr int FS = pow2_at_least(TW / 4 + 1);    // flag slots a row
  constexpr int FR = THREADS / FS;                 // flag rows a pass
  const int t = threadIdx.x % TW;
  if (t < tw) {
    const int i0 = threadIdx.x / TW;
    const double* src = a.contrib + (ra + i0) * a.w + c0 + t;
    double* dst = reinterpret_cast<double*>(buf) + i0 * TW + t;
    for (int i = i0; i < nr; i += VR, src += (int64_t)VR * a.w,
             dst += VR * TW)
      cp_async8(dst, src);
  }
  const int k = threadIdx.x % FS;
  if (k <= TW / 4) {
    const int i0 = threadIdx.x / FS;
    unsigned char* sp = buf + S::VBYTES + i0 * S::FROW + 4 * k;
    uintptr_t p = reinterpret_cast<uintptr_t>(a.participate +
                                              (ra + i0) * a.w + c0);
    uintptr_t q = reinterpret_cast<uintptr_t>(a.present +
                                              (ra + i0) * a.w + c0);
    const uintptr_t step = (uintptr_t)FR * a.w;
    for (int i = i0; i < nr; i += FR, p += step, q += step,
             sp += FR * S::FROW) {
      if (4 * k < (int)(p & 3) + tw)
        cp_async4(sp, reinterpret_cast<const void*>((p & ~uintptr_t(3)) +
                                                    4 * k));
      if (PRESENT && 4 * k < (int)(q & 3) + tw)
        cp_async4(sp + S::FBYTES,
                  reinterpret_cast<const void*>((q & ~uintptr_t(3)) + 4 * k));
    }
  }
}

// The calling thread's window (column c0 + threadIdx.x) of a staged
// chunk of nr rows starting at row ra, folded in row order.
template <int TW, bool PRESENT, unsigned L, class C>
__device__ __forceinline__ void fold_chunk(C& c, const unsigned char* buf,
                                           const Grid& a, int64_t ra, int nr,
                                           int c0, double mean) {
  using S = Stage<TW, PRESENT>;
  const double* sv = reinterpret_cast<const double*>(buf);
  const unsigned char* sp = buf + S::VBYTES;
  const int t = threadIdx.x;
  // a row's flags sit at the offset of its first cell in its first word
  uintptr_t p = reinterpret_cast<uintptr_t>(a.participate + ra * a.w + c0);
  uintptr_t q = reinterpret_cast<uintptr_t>(a.present + ra * a.w + c0);
#pragma unroll 8
  for (int i = 0; i < nr; ++i, p += a.w, q += a.w) {
    const double v = sv[i * TW + t];
    const bool part = sp[i * S::FROW + (int)(p & 3) + t] != 0;
    const bool pres =
        PRESENT && sp[S::FBYTES + i * S::FROW + (int)(q & 3) + t] != 0;
    fold_row<L>(c, v, part, pres, mean);
  }
}

// Rows [r0, r1) of the group read straight from device memory into the
// calling thread's cell, the loads of eight rows in flight at a time.
template <bool PRESENT, unsigned L, class C>
__device__ __forceinline__ void fold_direct(C& c, const Grid& a,
                                            int64_t r0, int64_t r1, int col,
                                            double mean) {
  int64_t e = r0 * a.w + col;
#pragma unroll 8
  for (int64_t r = r0; r < r1; ++r, e += a.w)
    fold_row<L>(c, __ldg(a.contrib + e), __ldg(a.participate + e) != 0,
                PRESENT && __ldg(a.present + e) != 0, mean);
}

// Rows [r0, r1) of the block's group folded into the calling thread's
// cell (threads at or past tw take no cell).  Every thread of the block
// calls it.  STAGED: the rows go through shared memory, chunk by chunk,
// every thread staging.  Else each cell's thread reads its rows itself.
template <int TW, bool PRESENT, unsigned L, bool STAGED, class C>
__device__ void fold_rows(C& c, unsigned char* smem, const Grid& a,
                          int64_t r0, int64_t r1, int c0, int tw,
                          double mean) {
  using S = Stage<TW, PRESENT>;
  const bool mine = (int)threadIdx.x < tw;
  if (!STAGED) {
    if (mine) fold_direct<PRESENT, L>(c, a, r0, r1, c0 + threadIdx.x, mean);
    return;
  }
  const int64_t chunks = (r1 - r0 + S::CH - 1) / S::CH;
  stage_rows<TW, PRESENT>(smem, a, r0, rows_in(r1 - r0, S::CH), c0, tw);
  cp_async_commit();
  for (int64_t k = 0; k < chunks; ++k) {
    const int64_t ra = r0 + k * S::CH;
    if (k + 1 < chunks) {
      const int64_t rb = ra + S::CH;
      stage_rows<TW, PRESENT>(smem + ((k + 1) & 1) * S::BYTES, a, rb,
                              rows_in(r1 - rb, S::CH), c0, tw);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (mine)
      fold_chunk<TW, PRESENT, L>(c, smem + (k & 1) * S::BYTES, a, ra,
                                 rows_in(r1 - ra, S::CH), c0, mean);
    __syncthreads();
  }
}

// Whether a launch stages its rows: when the grid's groups hold more
// than DIRECT_DEPTH rows on average.  Shallow groups read their few rows
// straight, and a kernel without shared memory keeps more blocks on an SM.
inline bool fold_staged(long long s, long long g) {
  return s > DIRECT_DEPTH * g;
}

// The window tile of a [G, W] fold: 128, halved down to 16 while the
// grid has fewer than MIN_BLOCKS blocks.
inline int fold_tile(long long g, int w) {
  int tw = 128;
  while (tw > 16 && g * (long long)((w + tw - 1) / tw) < MIN_BLOCKS) tw >>= 1;
  return tw;
}

}  // namespace group_fold
