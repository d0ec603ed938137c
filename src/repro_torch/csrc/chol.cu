// Blocked right-looking lower Cholesky factor of an (n, n) matrix, in place,
// with an optional leading batch axis, and the diagonal clamp
// l_jj = sqrt(max(a_jj - sum_k l_jk^2, 1e-12)) of the reference, so a matrix
// that is not positive definite still yields finite values.
//
// Replaces: src/repro/kernels/chol.py:_chol_kernel (with _chol_unblocked and
// _inv_lower), reached through cholesky_pallas.
//
// What bounds it on the H100: the n^3 / 3 flops of the factorization; at
// n = 1024 the chain of n / 32 dependent block columns and the launches
// that carry it weigh as much.
//
// Design: the TPU kernel loops over 128-wide block columns on one core with
// the whole matrix in VMEM.  Blocks of a Hopper grid run in parallel and in
// no order, so the loop over 32-wide block columns moves to the host side of
// the C entry, and each block column is three launches on the stream:
//   1. chol_diag_kernel, one warp per matrix: Crout factor of the 32 x 32
//      diagonal block in shared memory (lane = row), then its inverse by
//      row substitution (lane = column), as _chol_unblocked / _inv_lower;
//   2. chol_panel_kernel, one CTA per 32-row tile: the panel below the
//      diagonal block becomes A[:, kb] inv(L_kk)^T, a product instead of a
//      triangular solve, as on the TPU; tiles above it are zeroed;
//   3. chol_trailing_kernel, one CTA per 64 x 64 tile of the lower trailing
//      matrix: A -= P P^T with the panel P staged in shared memory.
// The matrix lives in device memory (L2 at n = 1024) between launches.  The
// C entry is one wrapper call; it issues 3 n / 32 launches.
#include "common.cuh"

namespace {

constexpr int kNb = 32;       // block-column width
constexpr int kTile = 64;     // trailing-update tile
constexpr int kThreads = 256;

__global__ void __launch_bounds__(32)
chol_diag_kernel(float* a, float* inv, int n, int kb) {
  a += (size_t)blockIdx.x * n * n;
  inv += (size_t)blockIdx.x * kNb * kNb;
  __shared__ float as[kNb][kNb + 1];
  __shared__ float ls[kNb][kNb + 1];
  __shared__ float xs[kNb][kNb + 1];
  const int lane = threadIdx.x;
  const int s = kb * kNb;
  const int nb = min(kNb, n - s);
  // Rows and columns past n are an identity block: factored and inverted
  // along with the rest, never stored.
  for (int r = 0; r < kNb; ++r) {
    as[r][lane] = (r < nb && lane < nb) ? a[(size_t)(s + r) * n + s + lane]
                                        : (r == lane ? 1.f : 0.f);
    ls[r][lane] = 0.f;
  }
  __syncwarp();
  // Crout column loop, lane = row.
  for (int j = 0; j < kNb; ++j) {
    float acc = 0.f;
    for (int k = 0; k < j; ++k) acc += ls[lane][k] * ls[j][k];
    const float ljj = sqrtf(fmaxf(as[j][j] - __shfl_sync(repro::kFullMask, acc, j), 1e-12f));
    if (lane == j) ls[j][j] = ljj;
    else if (lane > j) ls[lane][j] = (as[lane][j] - acc) / ljj;
    __syncwarp();
  }
  // Inverse by row substitution, lane = column.
  for (int i = 0; i < kNb; ++i) {
    float acc = 0.f;
    for (int k = 0; k < i; ++k) acc += ls[i][k] * xs[k][lane];
    xs[i][lane] = ((i == lane ? 1.f : 0.f) - acc) / ls[i][i];
  }
  __syncwarp();
  for (int r = 0; r < kNb; ++r) {
    if (r < nb && lane < nb) a[(size_t)(s + r) * n + s + lane] = ls[r][lane];
    inv[r * kNb + lane] = xs[r][lane];
  }
}

__global__ void __launch_bounds__(kThreads)
chol_panel_kernel(float* a, const float* __restrict__ inv, int n, int kb) {
  a += (size_t)blockIdx.z * n * n;
  inv += (size_t)blockIdx.z * kNb * kNb;
  const int t = blockIdx.x;
  if (t == kb) return;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int s = kb * kNb;
  const int r0 = t * kNb;
  const int j = s + lane;
  if (t < kb) {  // above the diagonal block: the factor is zero there
    for (int u = w; u < kNb; u += kThreads / 32)
      if (j < n) a[(size_t)(r0 + u) * n + j] = 0.f;
    return;
  }
  __shared__ float ps[kNb][kNb + 1];
  __shared__ float vs[kNb][kNb + 1];
  for (int u = w; u < kNb; u += kThreads / 32) {
    const int i = r0 + u;
    ps[u][lane] = (i < n && j < n) ? a[(size_t)i * n + j] : 0.f;
    vs[u][lane] = inv[u * kNb + lane];
  }
  __syncthreads();
  for (int u = w; u < kNb; u += kThreads / 32) {
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < kNb; ++k) acc += ps[u][k] * vs[lane][k];
    const int i = r0 + u;
    if (i < n && j < n) a[(size_t)i * n + j] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
chol_trailing_kernel(float* a, int n, int kb) {
  const int bi = blockIdx.y, bj = blockIdx.x;
  if (bj > bi) return;  // lower tiles only
  a += (size_t)blockIdx.z * n * n;
  const int s = kb * kNb;
  const int e = s + kNb;
  const int i0 = e + bi * kTile, j0 = e + bj * kTile;
  __shared__ float pi[kTile][kNb + 1];
  __shared__ float pj[kTile][kNb + 1];
  const int tid = threadIdx.x;
  for (int idx = tid; idx < kTile * kNb; idx += kThreads) {
    const int rr = idx / kNb, k = idx % kNb;
    pi[rr][k] = (i0 + rr < n) ? a[(size_t)(i0 + rr) * n + s + k] : 0.f;
    pj[rr][k] = (j0 + rr < n) ? a[(size_t)(j0 + rr) * n + s + k] : 0.f;
  }
  __syncthreads();
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
#pragma unroll 4
  for (int k = 0; k < kNb; ++k) {
    float xv[4], yv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      xv[u] = pi[ty + 16 * u][k];
      yv[u] = pj[tx + 16 * u][k];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] += xv[u] * yv[v];
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int gi = i0 + ty + 16 * u;
    if (gi >= n) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int gj = j0 + tx + 16 * v;
      if (gj < n) a[(size_t)gi * n + gj] = a[(size_t)gi * n + gj] - acc[u][v];
    }
  }
}

}  // namespace

// Factors the batch of (n, n) matrices in `a` in place (lower factor, upper
// triangle zeroed).  `inv` is scratch for batch * 32 * 32 floats.
REPRO_EXPORT int repro_cholesky(float* a, float* inv, int batch, int n,
                                void* stream) {
  if (batch == 0 || n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = (n + kNb - 1) / kNb;
  for (int kb = 0; kb < nblk; ++kb) {
    chol_diag_kernel<<<batch, 32, 0, st>>>(a, inv, n, kb);
    chol_panel_kernel<<<dim3(nblk, 1, batch), kThreads, 0, st>>>(a, inv, n, kb);
    const int rest = n - (kb + 1) * kNb;
    if (rest > 0) {
      const int nt = (rest + kTile - 1) / kTile;
      chol_trailing_kernel<<<dim3(nt, nt, batch), kThreads, 0, st>>>(a, n, kb);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
