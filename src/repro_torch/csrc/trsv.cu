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
// What bounds it: for a vector right-hand side the chain of n / 32
// dependent row blocks (latency); for a matrix B the n^2 r flops.
//
// Design: the TPU kernel walks 128-row panels on one core with the whole
// factor in VMEM.  Here the right-hand side is cut into panels of 8
// columns, one CTA each.  Each CTA walks 32-row blocks in order (forward
// for L, backward for L^T):
//   1. off-diagonal update: its 32 x 8 block of B minus L[block, solved] @
//      Q[solved, panel], with 32 x 32 tiles of L and 32 x 8 tiles of the
//      already solved rows staged in shared memory;
//   2. diagonal solve: warp w owns column w of the panel and lane i row i of
//      the block; the 32-step substitution runs in registers, the solved
//      value of each row broadcast with a warp shuffle.
// Solved rows go straight to Q and are read back by the same CTA in the
// next blocks.  The edge of n is handled here (rows past n act as identity
// rows and are never stored), so the caller pads neither n nor r, and only
// the lower triangle of L is ever read.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kRows = 32;     // rows per block of the substitution
constexpr int kCols = 8;      // right-hand-side columns per CTA
constexpr int kThreads = kRows * kCols;

template <bool kTrans>
__global__ void __launch_bounds__(kThreads)
trsv_kernel(const float* __restrict__ l, const float* __restrict__ b, float* q,
            int n, int r) {
  const size_t bz = blockIdx.z;
  l += bz * n * n;
  b += bz * n * r;
  q += bz * n * r;
  __shared__ float ls[kRows][kRows + 1];  // off-diagonal tile of L (or L^T)
  __shared__ float qs[kRows][kCols];      // solved rows of the panel
  __shared__ float ld[kRows][kRows + 1];  // diagonal block of L
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int col0 = blockIdx.x * kCols;
  const int col = col0 + w;
  const bool col_ok = col < r;
  const int nblk = (n + kRows - 1) / kRows;
  for (int step = 0; step < nblk; ++step) {
    const int s = (kTrans ? nblk - 1 - step : step) * kRows;
    const int row = s + lane;
    float v = (row < n && col_ok) ? b[(size_t)row * r + col] : 0.f;
    // 1. v -= sum over solved rows k of op(L)[row, k] * Q[k, col].
    const int k_lo = kTrans ? s + kRows : 0;
    const int k_hi = kTrans ? n : s;
    for (int k0 = k_lo; k0 < k_hi; k0 += kRows) {
      for (int e = tid; e < kRows * kRows; e += kThreads) {
        const int slow = e / kRows, fast = e % kRows;
        // Coalesced reads: along a row of L in both cases.
        const int rr = kTrans ? fast : slow;
        const int kk = kTrans ? slow : fast;
        const int gi = s + rr, gk = k0 + kk;
        float val = 0.f;
        if (gi < n && gk < k_hi)
          val = kTrans ? l[(size_t)gk * n + gi] : l[(size_t)gi * n + gk];
        ls[rr][kk] = val;
      }
      {
        const int kk = tid / kCols, c = tid % kCols;
        const int gk = k0 + kk, gc = col0 + c;
        qs[kk][c] = (gk < k_hi && gc < r) ? q[(size_t)gk * r + gc] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kRows; ++kk) v -= ls[lane][kk] * qs[kk][w];
      __syncthreads();
    }
    // 2. Diagonal block; rows past n are identity rows.
    for (int e = tid; e < kRows * kRows; e += kThreads) {
      const int a = e / kRows, c = e % kRows;
      const int ga = s + a, gc = s + c;
      ld[a][c] = (ga < n && gc < n) ? l[(size_t)ga * n + gc]
                                    : (a == c ? 1.f : 0.f);
    }
    __syncthreads();
    if (!kTrans) {
      for (int i = 0; i < kRows; ++i) {
        const float qi = __shfl_sync(repro::kFullMask, v, i) / ld[i][i];
        if (lane == i) v = qi;
        else if (lane > i) v -= ld[lane][i] * qi;
      }
    } else {
      for (int i = kRows - 1; i >= 0; --i) {
        const float qi = __shfl_sync(repro::kFullMask, v, i) / ld[i][i];
        if (lane == i) v = qi;
        else if (lane < i) v -= ld[i][lane] * qi;
      }
    }
    if (row < n && col_ok) q[(size_t)row * r + col] = v;
    __syncthreads();
  }
}


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

}  // namespace

REPRO_EXPORT int repro_trsv(const float* l, const float* b, float* q,
                            int batch, int n, int r, int trans, void* stream) {
  if (batch == 0 || n == 0 || r == 0) return 0;
  const dim3 grid((r + kCols - 1) / kCols, 1, batch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (trans)
    trsv_kernel<true><<<grid, kThreads, 0, st>>>(l, b, q, n, r);
  else
    trsv_kernel<false><<<grid, kThreads, 0, st>>>(l, b, q, n, r);
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
