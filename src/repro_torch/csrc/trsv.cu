// Triangular solves on lower-triangular L (n, n), with an optional leading
// batch axis.  Two C entries:
//
//   repro_tri_inverse  X = L^{-1}, i.e. L X = I, the refactor's and the lag
//                      refit's solve (every solve on the main path);
//   repro_trsv         L Q = B (trans = 0) or L^T Q = B (trans = 1) for a
//                      general B (n, r): the VJP and the posterior solve.
//
// Replaces: src/repro/kernels/trsv.py:_trsv_kernel (with _solve_diag_lower
// and _solve_diag_upper), reached through _trsv_pallas_raw / trsv_pallas;
// repro_tri_inverse is that kernel at B = I (ops.padded_tri_inverse).
//
// --- repro_tri_inverse ------------------------------------------------------
// What bounds it on the H100: the n^3 / 3 flops of L X = I (column c of X is
// zero above row c, so each column costs (n - c)^2 / 2 FMAs): 5.3 us at
// n = 1024 at the 67 TFLOP/s fp32 peak.  Two things stand in the way: the
// chain (row i of a column needs every row above it, and each row ends in
// an IEEE division), and the uneven panels (the panel at column c0 carries
// w (n - c0)^2 / 2 FMAs, so panel 0 carries three times the mean).
//
// Design: one CTA per 8-column panel of X (n = 1024 gives 128 CTAs).
//   * The zero half is skipped: the CTA writes zeros above row
//     s0 = 32 floor(c0 / 32) and walks from there, with the identity's 1
//     as the initial value of the diagonal element.
//   * Uneven panels: CTAs are issued heaviest first.  CTA i of the grid
//     takes panel i / batch of matrix i % batch (`kernels/trsv.launch_order`),
//     so panel 0 of every matrix starts in the first wave and the light
//     panels fill in behind (grouping the batch matrix by matrix, for L2
//     reuse, measured slower on the lag refit's 18: PERF.md, PR 15).
//   * Latency: rows are walked in chunks of 128 (four 32-row sub-blocks,
//     one per pair of warps).  L's 128-row slab streams through shared
//     memory as 128 x 32 tiles with cp.async, two stages deep, so the
//     next tile loads while this one is used: one barrier a tile.  The
//     CTA's solved panel of X stays in shared memory for the whole walk
//     (32 bytes a row, 32 KB at n = 1024), so X is never read back from
//     global memory.  That is 68 KB a CTA at n = 1024, so an SM holds
//     three CTAs, and one CTA's diagonal chain overlaps the others' tiles
//     (a third stage, at two CTAs an SM, was slower on the batch).
//   * The diagonal chain: each step's division is taken as a multiply by
//     a double reciprocal (below), which keeps the IEEE quotient and lets
//     the 4 columns' steps run side by side (the compiled division's
//     slow-path check had serialized them).  The chain of n dependent
//     steps is what remains of panel 0's time beside its tiles.
//   * Register reuse: a thread owns one row and 4 columns of the panel.
//     One float4 of L (4 values of k) feeds 16 FMAs, and X's rows are
//     read as float4 broadcasts.
//   * A tile left of the chunk (k < chunk start) is a plain update of all
//     128 rows.  A tile on the chunk's diagonal is solved by the two warps
//     of its sub-block (32 steps of shuffle, quotient and FMA, in
//     registers), then, after a barrier, applied to the sub-blocks below.
// The arithmetic of every element is the general kernel's: v = delta(row,
// col), then fmaf(-L[row,k], X[k,col], v) for k ascending, then one IEEE
// v / L[row,row] (no --use_fast_math, no tensor cores).  The skipped terms
// (k < col) are exact zeros, which change at most the sign of a zero, so
// on a finite factor X equals repro_trsv(L, I) bit for bit.  The panel of
// X lives in shared memory, so n is at most 6112 (227 KB a CTA).
//
// --- repro_trsv (general B) ---------------------------------------------------
// What bounds it on the H100.  For a narrow B (r = 1: the append's q =
// L^{-1} p, the posterior's z and alpha) the bytes are L's lower half once
// (2.1 MB at n = 1024, 0.63 us at 3.35 TB/s), but the solve is a chain: row
// i needs every row above it, and each row ends in a division.  The chain
// is n dependent steps (a shuffle, the quotient, an FMA: about 65 ns a row
// with the hand-offs, PERF.md) plus one hand-off per block of rows between
// CTAs.  For a wide B (the VJP's r = n, L X = I past the L X = I kernel's
// limit) it is the n^2 r flops.
//
// Design: one template, `trsv_kernel<kMR, kCC, kTrans>`, and two regimes
// that differ in how its 256 threads map onto Q (`kernels/trsv.launch_plan`
// computes each call's regime and geometry; the C entry checks them).  A CTA
// owns 8 columns of Q (a panel); a thread owns kMR rows x kCC columns of a
// block of rows, lanes on consecutive rows.  Both walk tiles of 32 columns
// of L (32 rows of L for L^T), staged with cp.async in a ring of shared
// memory with one barrier a tile, so the next tiles load while this one is
// used; only L's lower triangle is copied.
//   * Narrow (r <= 512, the width where it stops being the faster one at
//     n = 1024): one CTA per block of 32 / 64 / 128 rows (by n) and panel,
//     warp w owns column w, each lane 1 / 2 / 4 rows.  Blocks are spread over the
//     card as a wavefront: a CTA takes an atomic ticket (tickets go block by
//     block, matrix and panel fastest), so it only ever waits on blocks
//     whose CTAs were already running, which rules out deadlock under any
//     schedule.  L[block, :s] does not depend on Q, so the ring (8 tiles
//     deep) streams the CTA's slab of L before and while it waits; only the
//     solved values of Q are on the chain.  A CTA publishes each 32-row
//     sub-block as it is solved: Q stored, a barrier, a fence and a release
//     store of the number of solved sub-blocks in its (matrix, panel) word.
//     A consumer's thread 0 polls that word with acquire loads (a bounded
//     spin that traps instead of hanging) when a tile needs rows not yet
//     taken in, and the CTA reads every solved row of that k-block through
//     L2 (ld.global.cg, so never a stale L1 line).  So the next block takes
//     in all but the last sub-block while it is being solved, and only one
//     tile's update waits on each hand-off.  The diagonal block is solved
//     in registers by each column's warp, one shuffle a row.  The scratch
//     (ticket, count of finished CTAs, one progress word per matrix and
//     panel) is kept per device and stream by the wrapper; the last CTA to
//     finish sets it back to 0, so back-to-back calls need no memset.
//   * Wide (r > 512): one CTA per panel walks 128-row blocks (4 x 32-row
//     sub-blocks), the L X = I kernel's staging: a thread owns 1 row x 4
//     columns (float4 reads of Q), 128 x 32 tiles of L in a ring of 4
//     stages.  The CTA keeps a window of two blocks of its panel of Q in
//     shared memory: the block being solved, and the earlier block whose
//     rows the current tiles need, which streams back through L2 (written
//     by this CTA, read with ld.global.cg) a 128-row block at a time, so n
//     has no limit.  The whole panel is not kept in shared memory: that
//     measured no faster on the regime's caller below the limit it would
//     set, L X = I's VJP (L^T at r = n; PERF.md).  A diagonal tile is solved
//     by its sub-block's two warps in registers, then applied by the warps
//     below after a barrier.  The CTA first finds the first (last,
//     for L^T) row where its panel of B is not zero: Q is exactly zero above
//     it (below it), so those rows are written as zeros and never walked.
//     At B = I that skips the zero half, as the L X = I kernel does.
// Edges: rows past n (and, for L^T, above 0) act as identity rows and are
// never stored, so the caller pads neither n nor r.
//
// Bits.  L Q = B keeps the earlier kernel's operations in their order for
// every element: v = B[row, col], then fmaf(-L[row, k], Q[k, col], v) for k
// ascending, then one IEEE division by L[row, row] (taken, as in the L X = I
// kernel, as a product with the correctly rounded double reciprocal, which
// rounds the same way).  The wavefront delivers blocks in ascending k, so
// this costs nothing.  The wide regime's skipped rows (B's leading zero
// rows) contribute exact zeros in the earlier kernel when L is finite with
// a non-zero diagonal there, which changes at most the sign of a zero: on
// such a factor the bits are the earlier kernel's.  Where a skipped row of
// L has a zero pivot, or an inf or a NaN lies in the skipped part, the
// earlier kernel and the plain version carry NaN or inf into Q's later
// rows through those zeros, and this kernel does not: it writes the
// skipped rows as 0 and never reads that part of L.
// L^T Q = B cannot keep them: the earlier kernel summed the off-diagonal
// blocks in ascending k, and the first of those is the last one back
// substitution solves.  Here every element sums in the order the rows are
// solved, k descending (fmaf(-L[k, row], Q[k, col], v)), then divides: the
// transposed solve's bits changed, and are held to the plain version.
#include <stdint.h>

#include <cuda/atomic>

#include "common.cuh"

namespace {


// ---------------------------------------------------------------------------
// X = L^{-1}: one CTA per 8-column panel, heaviest panels first.
// ---------------------------------------------------------------------------
namespace inv {

constexpr int kW = 8;                  // columns of X per CTA
constexpr int kRows = 32;              // rows of a sub-block (diagonal solve)
constexpr int kSub = 4;                // sub-blocks per chunk
constexpr int kChunk = kRows * kSub;   // rows walked per chunk
constexpr int kTk = 32;                // columns of L per staged tile
constexpr int kLd = kTk + 4;           // row stride of a staged tile (floats)
constexpr int kStages = 2;             // cp.async ring depth
constexpr int kThreads = kSub * (kW / 4) * 32;   // 2 warps per sub-block
constexpr int kStageFloats = kChunk * kLd;
constexpr int kMaxShared = 232448;     // opt-in shared memory of one CTA

constexpr size_t shared_bytes(int n) {
  return sizeof(float) * (static_cast<size_t>(kStages) * kStageFloats +
                          static_cast<size_t>((n + kRows - 1) / kRows) * kRows * kW);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// v[q] -= L[row, k] X[k, col + q] for the tile's 32 values of k, ascending.
__device__ __forceinline__ void update(float (&v)[4], const float* lrow,
                                       const float* xcol) {
#pragma unroll
  for (int kk = 0; kk < kTk; kk += 4) {
    const float4 a = *reinterpret_cast<const float4*>(lrow + kk);
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 xk = *reinterpret_cast<const float4*>(xcol + (kk + e) * kW);
      v[0] = fmaf(-av[e], xk.x, v[0]);
      v[1] = fmaf(-av[e], xk.y, v[1]);
      v[2] = fmaf(-av[e], xk.z, v[2]);
      v[3] = fmaf(-av[e], xk.w, v[3]);
    }
  }
}

// kVec: n % 4 == 0 and 16-byte aligned L and X (16-byte copies and
// float4 stores); otherwise 4-byte copies and scalar stores.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
tri_inverse_kernel(const float* __restrict__ l, float* __restrict__ x,
                   int batch, int n) {
  extern __shared__ float4 smem4[];
  float* const stage = reinterpret_cast<float*>(smem4);
  float* const xs = stage + kStages * kStageFloats;   // X[s0:, panel]

  // Launch order (kernels/trsv.launch_order): panel p of every matrix
  // before panel p + 1 of any.
  const int mat = blockIdx.x % batch;
  const int c0 = (blockIdx.x / batch) * kW;
  l += static_cast<size_t>(mat) * n * n;
  x += static_cast<size_t>(mat) * n * n;

  const int s0 = (c0 / kRows) * kRows;   // first row the walk visits
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = warp >> 1;             // sub-block of this thread's row
  const int col = c0 + 4 * (warp & 1);   // first of its 4 columns

  // The zero half: rows above s0.
  for (int e = tid; e < s0 * kW; e += kThreads) {
    const int c = c0 + e % kW;
    if (c < n) x[static_cast<size_t>(e / kW) * n + c] = 0.f;
  }

  // Tile (s, k0): rows [s, s + 128) x columns [k0, k0 + 32) of L.  A tile
  // on the chunk's diagonal feeds only the rows from k0 down, and only
  // the lower triangle is copied; the rest is zero-filled.
  auto load_tile = [&](int slot, int s, int k0) {
    float* dst = stage + slot * kStageFloats;
    const int r_lo = max(0, k0 - s);
    if (kVec) {
      for (int e = r_lo * (kTk / 4) + tid; e < kChunk * (kTk / 4); e += kThreads) {
        const int r = e / (kTk / 4), q = 4 * (e % (kTk / 4));
        const int gr = s + r, gk = k0 + q;
        const int valid = gr < n ? min(4, max(0, gr - gk + 1)) : 0;
        cp_async16(dst + r * kLd + q,
                   valid ? l + static_cast<size_t>(gr) * n + gk : l, 4 * valid);
      }
    } else {
      for (int e = r_lo * kTk + tid; e < kChunk * kTk; e += kThreads) {
        const int r = e / kTk, q = e % kTk;
        const int gr = s + r, gk = k0 + q;
        const bool ok = gr < n && gk <= gr;
        cp_async4(dst + r * kLd + q,
                  ok ? l + static_cast<size_t>(gr) * n + gk : l, ok ? 4 : 0);
      }
    }
  };
  // Tiles in walk order: for each chunk s, k0 = s0, s0 + 32, ... up to the
  // end of the chunk's rows.  Every thread commits one group per call, so
  // the group count stays in step with the tile count.
  int ld_s = s0, ld_k = s0;
  auto load_next = [&](int slot) {
    if (ld_s < n) {
      load_tile(slot, ld_s, ld_k);
      ld_k += kTk;
      if (ld_k >= min(ld_s + kChunk, n)) {
        ld_s += kChunk;
        ld_k = s0;
      }
    }
    cp_async_commit();
  };
  for (int st = 0; st < kStages - 1; ++st) load_next(st);

  int t = 0;
  for (int s = s0; s < n; s += kChunk) {
    const int row_l = sub * kRows + lane;
    const int row = s + row_l;
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = row == col + q ? 1.f : 0.f;
    const int k_end = min(s + kChunk, n);
    for (int k0 = s0; k0 < k_end; k0 += kTk, ++t) {
      cp_async_wait<kStages - 2>();   // tile t has landed (this thread's part)
      __syncthreads();                // ... everyone's, and tile t - 1 is done
      load_next((t + kStages - 1) % kStages);
      const float* lt = stage + (t % kStages) * kStageFloats;
      const float* xcol = xs + (k0 - s0) * kW + (col - c0);
      if (k0 < s) {                   // left of the chunk: solved rows only
        update(v, lt + row_l * kLd, xcol);
        continue;
      }
      const int j = (k0 - s) / kRows;   // the chunk's diagonal, sub-block j
      if (sub == j) {
        // Lane i holds row s + 32 j + i.  Each step's quotient is the
        // double product with the correctly rounded double reciprocal of
        // the diagonal, rounded to float: that is the IEEE float quotient
        // (a float quotient is never within 2^-49 of a rounding boundary,
        // the double product is within 2^-52 of it).  The reciprocals do
        // not depend on v, so they come off the chain, and the 4 columns'
        // quotients no longer wait on each other's slow-path check.
        const float* lrow = lt + row_l * kLd;
        const double rdia = __drcp_rn(static_cast<double>(lrow[lane]));
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const double rd = __shfl_sync(repro::kFullMask, rdia, i);
          const float a = lrow[i];        // used by the lanes below row i
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float xi = __double2float_rn(__dmul_rn(
                static_cast<double>(__shfl_sync(repro::kFullMask, v[q], i)), rd));
            v[q] = lane == i ? xi : (lane > i ? fmaf(-a, xi, v[q]) : v[q]);
          }
        }
        if (row < n) {
          *reinterpret_cast<float4*>(xs + (row - s0) * kW + (col - c0)) =
              make_float4(v[0], v[1], v[2], v[3]);
          float* out = x + static_cast<size_t>(row) * n + col;
          if (kVec) {
            if (col < n) *reinterpret_cast<float4*>(out) =
                make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (col + q < n) out[q] = v[q];
          }
        }
      }
      __syncthreads();                // sub-block j's rows of X are out
      if (sub > j && s + sub * kRows < n) update(v, lt + row_l * kLd, xcol);
    }
  }
  cp_async_wait<0>();
}

}  // namespace inv

// ---------------------------------------------------------------------------
// L Q = B or L^T Q = B for a general B: one template, two regimes.
// ---------------------------------------------------------------------------
namespace gen {

using DeviceInt = cuda::atomic_ref<int, cuda::thread_scope_device>;

constexpr int kThreads = 256;
constexpr int kW = 8;                  // columns of Q a CTA owns (a panel)
constexpr int kTk = 32;                // k per staged tile of L
constexpr int kLd = kTk + 4;           // row stride of a tile of L (floats)
constexpr int kNarrowStages = 8;       // cp.async ring depth, narrow
constexpr int kWideStages = 4;         // ... and wide
constexpr int kWideRows = 128;
constexpr int kCtrlBytes = 16;         // ticket / flag words after the floats
constexpr int kMaxShared = 232448;     // opt-in shared memory of one CTA
constexpr unsigned kSpinLimit = 1u << 24;   // seconds of polls, then trap
constexpr int kScratchHead = 2;        // ticket, CTAs done; then progress
constexpr int kPublisher = kThreads - 32;   // narrow: the thread that publishes

enum { kNarrow = 0, kWide = 1 };

struct Args {
  const float* l;
  const float* b;
  float* q;
  int* scratch;      // narrow: ticket, done, a word per (matrix, panel)
  int batch, n, r, panels, nblk, vec;
};

template <int kMR, int kCC, bool kTrans>
struct Geo {
  static constexpr bool kChain = kCC == 1;          // the narrow regime
  static constexpr int kWGC = kW / kCC;             // warps across columns
  static constexpr int kWGR = kThreads / 32 / kWGC; // warps across rows
  static constexpr int kR = 32 * kWGR * kMR;        // rows of a block
  static constexpr int kQRows = 2 * kR;             // rows of Q's window
  static constexpr int kStages = kChain ? kNarrowStages : kWideStages;
  static constexpr int kLdT = kR + 4;               // row stride, L^T tile
  static constexpr int kStage = kR * kLd;           // >= kTk * kLdT
};

// One tile of op(L) into shared memory.  Forward: rows [s, s + kR) x
// columns [k0, k0 + 32) of L, row-major with stride kLd; rows above k0 of
// a diagonal tile are not needed (their k is past the row) and are not
// copied.  L^T: rows [k0, k0 + 32) x columns [s, s + kR) of L, i.e.
// op(L)[s + rr, k0 + kk] at [kk][rr], stride kLdT.  Entries above L's
// diagonal, past n or outside the block's valid rows [vlo, vhi) are zero.
template <int kR, bool kTrans>
__device__ __forceinline__ void load_tile(float* dst, const float* l, int n,
                                          int s, int k0, int vlo, int vhi,
                                          bool vec, int tid) {
  if (!kTrans) {
    const int r_lo = max(0, k0 - s);
    if (vec) {
      for (int e = r_lo * (kTk / 4) + tid; e < kR * (kTk / 4); e += kThreads) {
        const int rr = e / (kTk / 4), c4 = 4 * (e % (kTk / 4));
        const int gr = s + rr, gk = k0 + c4;
        const int valid = gr < vhi ? min(4, max(0, gr - gk + 1)) : 0;
        inv::cp_async16(dst + rr * kLd + c4,
                        valid ? l + static_cast<size_t>(gr) * n + gk : l, 4 * valid);
      }
    } else {
      for (int e = r_lo * kTk + tid; e < kR * kTk; e += kThreads) {
        const int rr = e / kTk, c = e % kTk;
        const int gr = s + rr, gk = k0 + c;
        const bool ok = gr < vhi && gk <= gr;
        inv::cp_async4(dst + rr * kLd + c,
                       ok ? l + static_cast<size_t>(gr) * n + gk : l, ok ? 4 : 0);
      }
    }
  } else {
    constexpr int kLdT = kR + 4;
    const int c_lo = vlo - s;            // a multiple of 32
    if (vec) {
      const int per = (kR - c_lo) / 4;
      for (int e = tid; e < kTk * per; e += kThreads) {
        const int kk = e / per, c4 = c_lo + 4 * (e % per);
        const int gk = k0 + kk, gr = s + c4;
        const int valid = gk < n ? min(4, max(0, gk - gr + 1)) : 0;
        inv::cp_async16(dst + kk * kLdT + c4,
                        valid ? l + static_cast<size_t>(gk) * n + gr : l, 4 * valid);
      }
    } else {
      const int per = kR - c_lo;
      for (int e = tid; e < kTk * per; e += kThreads) {
        const int kk = e / per, c = c_lo + e % per;
        const int gk = k0 + kk, gr = s + c;
        const bool ok = gk < n && gr <= gk;
        inv::cp_async4(dst + kk * kLdT + c,
                       ok ? l + static_cast<size_t>(gk) * n + gr : l, ok ? 4 : 0);
      }
    }
  }
}

template <int kCC>
__device__ __forceinline__ void load_q(float (&qv)[kCC], const float* p) {
  if (kCC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    qv[0] = x.x; qv[1] = x.y; qv[2] = x.z; qv[3] = x.w;
  } else {
#pragma unroll
    for (int c = 0; c < kCC; ++c) qv[c] = p[c];
  }
}

// v -= op(L)[row, k] Q[k, col] over the tile's 32 values of k, ascending
// (L) or descending (L^T).  `row0` is the lane's local row for m = 0 (its
// rows are row0 + 32 m), `col` its first column in the panel; `qt` is Q's
// rows k0 .. k0 + 31 in the window (8 floats a row).  Each row's sum is a
// chain of 32 FMAs, so every shared-memory read is issued ahead of the
// FMAs that use it: a column of Q whole (kCC = 1), the values of L one
// group of 4 (or 8, for L^T) k ahead; loaded as it was used, each k waited
// on a shared-memory load.
template <int kMR, int kCC, bool kTrans>
__device__ __forceinline__ void update(float (&v)[kMR][kCC], const float* lt,
                                       const float* qt, int row0, int col) {
  using G = Geo<kMR, kCC, kTrans>;
  constexpr int kG = kTrans ? 8 : 4;      // k per group of L's values
  constexpr int kQAll = kCC == 1;         // the whole column of Q up front
  float qall[kQAll ? kTk : 1];
  if (kQAll) {
#pragma unroll
    for (int kk = 0; kk < kTk; ++kk) qall[kQAll ? kk : 0] = qt[kk * kW + col];
  }
  // Group g holds k = 4 g .. 4 g + 3 (L, as one float4 a row) or, walking
  // down, k = 31 - 8 g .. 24 - 8 g (L^T, one float a row and k).
  auto load_group = [&](float (&av)[kMR][kG], int grp) {
#pragma unroll
    for (int m = 0; m < kMR; ++m) {
      if (!kTrans) {
        const float4 a4 = *reinterpret_cast<const float4*>(
            lt + (row0 + 32 * m) * kLd + kG * grp);
        av[m][0] = a4.x; av[m][1] = a4.y; av[m][2] = a4.z; av[m][3] = a4.w;
      } else {
#pragma unroll
        for (int e = 0; e < kG; ++e)
          av[m][e] = lt[(kTk - 1 - kG * grp - e) * G::kLdT + row0 + 32 * m];
      }
    }
  };
  float cur[kMR][kG], nxt[kMR][kG];
  load_group(cur, 0);
#pragma unroll
  for (int grp = 0; grp < kTk / kG; ++grp) {
    if (grp + 1 < kTk / kG) load_group(nxt, grp + 1);
#pragma unroll
    for (int e = 0; e < kG; ++e) {
      const int kk = kTrans ? kTk - 1 - kG * grp - e : kG * grp + e;
      float qv[kCC];
      if (kQAll) qv[0] = qall[kQAll ? kk : 0];
      else load_q<kCC>(qv, qt + kk * kW + col);
#pragma unroll
      for (int m = 0; m < kMR; ++m)
#pragma unroll
        for (int c = 0; c < kCC; ++c) v[m][c] = fmaf(-cur[m][e], qv[c], v[m][c]);
    }
    if (grp + 1 < kTk / kG) {
#pragma unroll
      for (int m = 0; m < kMR; ++m)
#pragma unroll
        for (int e = 0; e < kG; ++e) cur[m][e] = nxt[m][e];
    }
  }
}

// Sub-block kJ of the warp's rows on a diagonal tile: the 32 substitution
// steps.  Lane i's row is solved at step i (forward) or 31 - i (L^T), its
// quotient shuffled to the warp; the lanes after it (before it, for L^T)
// and the warp's rows of the later (earlier) sub-blocks take its FMA in the
// same step (measured faster than applying the tile to those rows after
// the chain).  Then the rows go out to Q (`qrow`, its first `qcols`
// columns; none for a row outside the matrix) and to the window (`wrow`,
// unless null).  `rdia` is the correctly rounded double reciprocal of the
// lane's own diagonal element (0 for a row outside the matrix, whose
// quotient is then 0).  Each quotient is the product with it, rounded once:
// the IEEE quotient, as the L X = I kernel takes it (a float reciprocal
// with two Markstein corrections gave the same bits on every shape of
// chip_smoke.py but ran slower, its out-of-range fallback a branch on the
// chain).  kJ is a template parameter so that the choice of row is
// resolved at compile time: a runtime index put branches on the chain.
template <int kMR, int kCC, bool kTrans, int kJ>
__device__ __forceinline__ void diag_block(float (&v)[kMR][kCC], const float* lt,
                                           int row0, int lane, double rdia, float* qrow,
                                           int qcols, float* wrow) {
  using G = Geo<kMR, kCC, kTrans>;
#pragma unroll
  for (int ii = 0; ii < kTk; ++ii) {
    const int i = kTrans ? kTk - 1 - ii : ii;
    const double rd = __shfl_sync(repro::kFullMask, rdia, i);
    float a[kMR];
#pragma unroll
    for (int m = 0; m < kMR; ++m)
      a[m] = kTrans ? lt[i * G::kLdT + row0 + 32 * m] : lt[(row0 + 32 * m) * kLd + i];
#pragma unroll
    for (int c = 0; c < kCC; ++c) {
      const float x = __double2float_rn(__dmul_rn(
          static_cast<double>(__shfl_sync(repro::kFullMask, v[kJ][c], i)), rd));
      v[kJ][c] = lane == i ? x
               : ((kTrans ? lane < i : lane > i) ? fmaf(-a[kJ], x, v[kJ][c]) : v[kJ][c]);
#pragma unroll
      for (int m = kTrans ? 0 : kJ + 1; m < (kTrans ? kJ : kMR); ++m)
        v[m][c] = fmaf(-a[m], x, v[m][c]);
    }
  }
#pragma unroll
  for (int c = 0; c < kCC; ++c)
    if (c < qcols) qrow[c] = v[kJ][c];
  if (wrow != nullptr) {
#pragma unroll
    for (int c = 0; c < kCC; ++c) wrow[c] = v[kJ][c];
  }
}

template <int kMR, int kCC, bool kTrans>
__device__ __forceinline__ void diag_block(float (&v)[kMR][kCC], const float* lt,
                                           int row0, int jm, int lane, double rdia,
                                           float* qrow, int qcols, float* wrow) {
  static_assert(kMR == 1 || kMR == 2 || kMR == 4, "rows a lane: 1, 2 or 4");
#define REPRO_DIAG_CASE(J)                                                \
    case J:                                                                \
      diag_block<kMR, kCC, kTrans, (kMR > J ? J : 0)>(                     \
          v, lt, row0, lane, rdia, qrow, qcols, wrow);                     \
      break;
  switch (jm) {
    REPRO_DIAG_CASE(0) REPRO_DIAG_CASE(1) REPRO_DIAG_CASE(2) REPRO_DIAG_CASE(3)
  }
#undef REPRO_DIAG_CASE
}

// Narrow: one CTA an SM (its ring is 155 KB at 128-row blocks), so the
// registers need not be shared; wide: two CTAs an SM (80 KB each).
template <int kMR, int kCC, bool kTrans>
__global__ void __launch_bounds__(kThreads, kCC == 1 ? 1 : 2) trsv_kernel(const Args a) {
  using G = Geo<kMR, kCC, kTrans>;
  constexpr int kR = G::kR;
  constexpr int kStages = G::kStages;
  extern __shared__ float4 smem4[];
  float* const stage = reinterpret_cast<float*>(smem4);
  float* const win = stage + kStages * G::kStage;   // Q's rows, 8 floats a row
  int* const ctrl = reinterpret_cast<int*>(win + G::kQRows * kW);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = warp / G::kWGC, h = warp % G::kWGC;
  const int n = a.n, r = a.r;
  const int k_top = (n + kTk - 1) / kTk * kTk;

  // This CTA's (matrix, panel) and its blocks: `nblocks` blocks of kR rows
  // starting at s_first, walked downward for L, upward for L^T.  Tiles of a
  // forward block start at k_lo; those of an L^T block end below k_hi.
  int mat, panel, step = 0, s_first, nblocks, k_lo = 0, k_hi = k_top, base = 0;
  if (G::kChain) {
    if (tid == 0) ctrl[0] = atomicAdd(a.scratch, 1);
    __syncthreads();
    const int per = a.batch * a.panels;
    step = ctrl[0] / per;
    mat = ctrl[0] % per % a.batch;
    panel = ctrl[0] % per / a.batch;
    s_first = (kTrans ? a.nblk - 1 - step : step) * kR;
    nblocks = 1;
  } else {
    mat = blockIdx.x % a.batch;
    panel = blockIdx.x / a.batch;
    if (kTrans) panel = a.panels - 1 - panel;
  }
  const int c0 = panel * kW;
  const float* l = a.l + static_cast<size_t>(mat) * n * n;
  const float* b = a.b + static_cast<size_t>(mat) * n * r;
  float* q = a.q + static_cast<size_t>(mat) * n * r;

  if (!G::kChain) {
    // First (L) or last (L^T) row where the panel of B is not zero, 256
    // rows a round from the end Q is walked from.
    if (tid == 0) ctrl[0] = kTrans ? -1 : n;
    __syncthreads();
    const int rounds = (n + 255) / 256;
    for (int rnd = 0; rnd < rounds; ++rnd) {
      int found = kTrans ? -1 : n;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int off = rnd * 256 + u * 32 + tid / kW;
        const int row = kTrans ? n - 1 - off : off;
        const int col = c0 + tid % kW;
        if (row >= 0 && row < n && col < r &&
            b[static_cast<size_t>(row) * r + col] != 0.f)
          found = kTrans ? max(found, row) : min(found, row);
      }
      const bool hit = kTrans ? found >= 0 : found < n;
      if (hit) {
        if (kTrans) atomicMax(ctrl, found);
        else atomicMin(ctrl, found);
      }
      if (__syncthreads_or(hit)) break;
    }
    const int edge = ctrl[0];
    int z_lo, z_hi;                      // rows of Q that are exactly zero
    if (!kTrans) {
      const int s0 = edge / kTk * kTk;
      s_first = s0;
      nblocks = (n - s0 + kR - 1) / kR;
      k_lo = s0;
      z_lo = 0;
      z_hi = s0;
    } else {
      const int e_top = min(k_top, (edge + kTk) / kTk * kTk);
      nblocks = (e_top + kR - 1) / kR;
      s_first = e_top - kR;
      k_hi = e_top;
      z_lo = min(e_top, n);
      z_hi = n;
    }
    base = kTrans ? k_hi - nblocks * kR : k_lo;
    for (int e = tid; e < (z_hi - z_lo) * kW; e += kThreads) {
      const int row = z_lo + e / kW, col = c0 + e % kW;
      if (col < r) q[static_cast<size_t>(row) * r + col] = 0.f;
    }
  }
  // Row k of Q sits at window row (k - base) % (2 kR): k-block j (counted
  // from base) in half j % 2.
  auto wrow = [&](int k) { return (k - base) % G::kQRows; };

  // The tiles in walk order, produced kStages - 1 ahead of their use.  Each
  // thread commits one group per call, so groups and tiles stay in step.
  int ld_i = 0, ld_k = kTrans ? k_hi - kTk : k_lo;
  auto load_next = [&](int slot) {
    if (ld_i < nblocks) {
      const int s = kTrans ? s_first - ld_i * kR : s_first + ld_i * kR;
      const int vlo = max(s, 0), vhi = min(s + kR, n);
      load_tile<kR, kTrans>(stage + slot * G::kStage, l, n, s, ld_k, vlo, vhi,
                            a.vec, tid);
      if (!kTrans) {
        ld_k += kTk;
        if (ld_k >= vhi) { ++ld_i; ld_k = k_lo; }
      } else {
        ld_k -= kTk;
        if (ld_k < vlo) { ++ld_i; ld_k = k_hi - kTk; }
      }
    }
    inv::cp_async_commit();
  };
  for (int st = 0; st < kStages - 1; ++st) load_next(st);

  const int row0 = 32 * g * kMR + lane;   // local row of v[0]
  const int colp = h * kCC;               // first column within the panel
  const bool active = c0 + colp < r;      // warp-uniform
  // Narrow: the progress word counts the 32-row sub-blocks of Q solved, in
  // solve order (rows [0, 32 p) for L, [k_top - 32 p, n) for L^T); a CTA
  // publishes each of its sub-blocks at the barrier after it is stored, so
  // the next CTA takes in a block while its last sub-block is still being
  // solved.  The publisher is lane 0 of the last warp, which owns a column
  // only when r = 8: its fences stay off column 0's chain.
  int* const progress = a.scratch + kScratchHead + mat + a.batch * panel;
  int t = 0, published = 0;
  for (int blk = 0; blk < nblocks; ++blk) {
    const int s = kTrans ? s_first - blk * kR : s_first + blk * kR;
    const int vlo = max(s, 0), vhi = min(s + kR, n);
    // Rows of Q in the window for this block: [q_lo, q_hi).
    int q_lo = 0, q_hi = 0;
    float v[kMR][kCC];
#pragma unroll
    for (int m = 0; m < kMR; ++m) {
      const int row = s + row0 + 32 * m;
#pragma unroll
      for (int c = 0; c < kCC; ++c) {
        const int col = c0 + colp + c;
        v[m][c] = row >= vlo && row < vhi && col < r
                      ? b[static_cast<size_t>(row) * r + col] : 0.f;
      }
    }
    for (int k0 = kTrans ? k_hi - kTk : k_lo; kTrans ? k0 >= vlo : k0 < vhi;
         k0 += kTrans ? -kTk : kTk, ++t) {
      inv::cp_async_wait<kStages - 2>();   // tile t has landed (this thread's part)
      __syncthreads();                     // ... everyone's; tile t - 1 is done
      if (G::kChain && tid == kPublisher && published > 0) {
        __threadfence();                   // the sub-block stored before the barrier
        DeviceInt(*progress).store(published, cuda::memory_order_release);
      }
      load_next((t + kStages - 1) % kStages);
      const float* lt = stage + (t % kStages) * G::kStage;
      const float* qt = win + wrow(k0) * kW;
      const bool diag = kTrans ? k0 < s + kR : k0 >= s;
      if (!diag) {
        if (k0 < q_lo || k0 + kTk > q_hi) {
          // This tile's rows of Q are not in the window: bring in every
          // solved row of its k-block from here on in walk order (wide: the
          // block's; narrow: those whose CTA has published them, waiting for
          // this tile's).  Thread 0 reads the progress word (acquire) and
          // the barrier hands what it saw to the CTA.
          const int kb_lo = base + (k0 - base) / kR * kR;
          int lo = kTrans ? kb_lo : k0, hi = kTrans ? k0 + kTk : kb_lo + kR;
          if (G::kChain) {
            if (tid == 0) {
              const int need = kTrans ? (k_top - k0) / kTk : (k0 + kTk) / kTk;
              DeviceInt w(*progress);
              unsigned spins = 0;
              int seen;
              while ((seen = w.load(cuda::memory_order_acquire)) < need)
                if (++spins == kSpinLimit) __trap();
              ctrl[2] = seen;
            }
            __syncthreads();
            if (kTrans) lo = max(lo, k_top - ctrl[2] * kTk);
            else hi = min(hi, ctrl[2] * kTk);
          }
          for (int e = tid; e < (hi - lo) * kW; e += kThreads) {
            const int row = lo + e / kW, c = e % kW, col = c0 + c;
            win[wrow(row) * kW + c] =
                row >= 0 && row < n && col < r
                    ? __ldcg(q + static_cast<size_t>(row) * r + col) : 0.f;
          }
          __syncthreads();
          q_lo = lo;
          q_hi = hi;
        }
        if (active) update<kMR, kCC, kTrans>(v, lt, qt, row0, colp);
        continue;
      }
      const int j = (k0 - s) / kTk;        // the block's sub-block on this tile
      const int jg = j / kMR, jm = j % kMR;
      if (G::kChain) published = kTrans ? (k_top - k0) / kTk : (k0 + kTk) / kTk;
      if (g == jg && active) {
        const int row_l = row0 + 32 * jm;
        const int row = s + row_l;
        const float dia = kTrans ? lt[lane * G::kLdT + row_l] : lt[row_l * kLd + lane];
        const double rdia = row >= vlo && row < vhi
                                ? __drcp_rn(static_cast<double>(dia)) : 0.0;
        // Wide: the warps below read these rows from the window.
        diag_block<kMR, kCC, kTrans>(
            v, lt, row0, jm, lane, rdia,
            q + static_cast<size_t>(row) * r + c0 + colp,
            row >= vlo && row < vhi ? min(kCC, r - c0 - colp) : 0,
            G::kChain ? nullptr : win + wrow(row) * kW + colp);
      }
      if (G::kWGR > 1) {
        __syncthreads();                   // sub-block j's rows of Q are in
        if ((kTrans ? g < jg : g > jg) && active)
          update<kMR, kCC, kTrans>(v, lt, qt, row0, colp);
      }
    }
    if (G::kChain) {
      // Publish the last sub-block; the last CTA to finish resets the
      // scratch.
      __syncthreads();
      if (tid == kPublisher) {
        __threadfence();
        DeviceInt(*progress).store(published, cuda::memory_order_release);
        ctrl[1] = DeviceInt(a.scratch[1]).fetch_add(1, cuda::memory_order_acq_rel)
                  == static_cast<int>(gridDim.x) - 1;
      }
      __syncthreads();
      if (ctrl[1]) {
        for (int e = tid; e < a.batch * a.panels; e += kThreads)
          a.scratch[kScratchHead + e] = 0;
        if (tid == 0) { a.scratch[0] = 0; a.scratch[1] = 0; }
      }
    }
  }
  inv::cp_async_wait<0>();
}

// The geometry of one call; kernels/trsv.launch_plan computes the same.
struct Plan {
  int rows;
  int stages;
  size_t smem;
  long long grid;
  long long scratch;
};

// Rows a narrow block holds (kernels/trsv.narrow_rows picks among them;
// 256-row blocks measured slower at n = 1024 and 4096: more rows a lane
// lengthen every step of the chain more than the saved hand-offs).
inline bool rows_ok(int regime, int rows) {
  return regime == kNarrow ? rows == 32 || rows == 64 || rows == 128
                           : rows == kWideRows;
}

inline Plan plan_for(int regime, int batch, int n, int r, int rows) {
  const long long panels = (r + kW - 1) / kW;
  Plan p{};
  p.rows = rows;
  if (regime == kNarrow) {
    p.stages = kNarrowStages;
    p.grid = batch * panels * ((n + p.rows - 1) / p.rows);
    p.scratch = kScratchHead + batch * panels;
  } else {
    p.stages = kWideStages;
    p.grid = batch * panels;
    p.scratch = 0;
  }
  // The ring, the window of two blocks of Q's rows, the control words.
  p.smem = sizeof(float) * (static_cast<size_t>(p.stages) * p.rows * kLd +
                            static_cast<size_t>(2 * p.rows) * kW) + kCtrlBytes;
  return p;
}

// Raise a kernel's dynamic shared-memory limit to `smem` once per kernel
// and device: the limit set so far is kept, so a call at a size already
// allowed skips the attribute call.
inline cudaError_t allow_shared(const void* kernel, int smem) {
  constexpr int kSlots = 64;
  static const void* kernels[kSlots];
  static int devices[kSlots], allowed[kSlots];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int slot = 0;
  while (slot < kSlots && kernels[slot] != nullptr &&
         (kernels[slot] != kernel || devices[slot] != dev))
    ++slot;
  if (slot < kSlots && kernels[slot] == kernel && allowed[slot] >= smem)
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess && slot < kSlots) {
    kernels[slot] = kernel;
    devices[slot] = dev;
    allowed[slot] = smem;
  }
  return err;
}

template <bool kTrans>
const void* pick(int regime, int rows) {
  if (regime == kWide) return reinterpret_cast<const void*>(trsv_kernel<1, 4, kTrans>);
  if (rows == 32) return reinterpret_cast<const void*>(trsv_kernel<1, 1, kTrans>);
  if (rows == 64) return reinterpret_cast<const void*>(trsv_kernel<2, 1, kTrans>);
  return reinterpret_cast<const void*>(trsv_kernel<4, 1, kTrans>);
}

}  // namespace gen

}  // namespace

// L Q = B (trans = 0) or L^T Q = B (trans = 1) for L (batch, n, n) and B, Q
// (batch, n, r).  `regime` (0 narrow, 1 wide), `rows` and `smem` come from
// kernels/trsv.launch_plan and must match the geometry computed here;
// `scratch` holds the plan's scratch ints (narrow), all 0.
REPRO_EXPORT int repro_trsv(const float* l, const float* b, float* q,
                            int* scratch, int batch, int n, int r, int trans,
                            int regime, int rows, int stages, int smem,
                            void* stream) {
  if (batch <= 0 || n <= 0 || r <= 0 || (regime != gen::kNarrow && regime != gen::kWide))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!gen::rows_ok(regime, rows)) return static_cast<int>(cudaErrorInvalidValue);
  const gen::Plan p = gen::plan_for(regime, batch, n, r, rows);
  if (p.stages != stages || p.smem != static_cast<size_t>(smem) ||
      p.smem > gen::kMaxShared || p.grid > 0x7fffffffLL ||
      p.scratch > 0x7fffffffLL || (p.scratch > 0 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int panels = (r + gen::kW - 1) / gen::kW;
  const gen::Args a{l, b, q, scratch, batch, n, r, panels, (n + rows - 1) / rows,
                    n % 4 == 0 && reinterpret_cast<uintptr_t>(l) % 16 == 0};
  const void* kernel = trans ? gen::pick<true>(regime, rows)
                             : gen::pick<false>(regime, rows);
  cudaError_t err = gen::allow_shared(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {const_cast<gen::Args*>(&a)};
  err = cudaLaunchKernel(kernel, dim3(static_cast<unsigned>(p.grid)),
                         dim3(gen::kThreads), args, p.smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// X = L^{-1} for L (batch, n, n), one CTA per 8-column panel.
REPRO_EXPORT int repro_tri_inverse(const float* l, float* x, int batch, int n,
                                   void* stream) {
  if (batch == 0 || n == 0) return 0;
  const size_t smem = inv::shared_bytes(n);
  const long long ctas =
      static_cast<long long>(batch) * ((n + inv::kW - 1) / inv::kW);
  if (batch < 0 || n < 0 || smem > inv::kMaxShared ||
      ctas > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = n % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(l) | reinterpret_cast<uintptr_t>(x)) % 16 == 0;
  const auto kernel = vec ? inv::tri_inverse_kernel<true>
                          : inv::tri_inverse_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(ctas), inv::kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(l, x, batch, n);
  return static_cast<int>(cudaGetLastError());
}
