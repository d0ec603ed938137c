// Blocked triangular solve  L Q = B  (trans = 0) or  L^T Q = B  (trans = 1),
// L (n, n) lower triangular, B and Q (n, r), with an optional leading batch
// axis on all three (blockIdx.z).
//
// Replaces: src/repro/kernels/trsv.py:_trsv_kernel (with _solve_diag_lower
// and _solve_diag_upper), reached through _trsv_pallas_raw / trsv_pallas.
//
// What bounds it on the H100: for the refactor's L X = I (n = r = 1024) the
// n^2 r flops of the substitution; for a vector right-hand side the chain of
// n / 32 dependent row blocks (latency).
//
// Design: the TPU kernel walks 128-row panels on one core with the whole
// factor in VMEM.  Here the right-hand side is cut into panels of 8
// columns, one CTA each, so the 1024-column identity gives 128 CTAs.  Each
// CTA walks 32-row blocks in order (forward for L, backward for L^T):
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
