// Matérn-2.5 gram  K[i, j] = sigma2 (1 + z + z^2 / 3) exp(-z),
// z = sqrt(5) |x_i - y_j| / rho, for x (n, d) and y (m, d).
//
// Replaces: src/repro/kernels/matern.py:_matern_tile_kernel (reached through
// _matern_pallas_raw / matern52_gram_pallas).
//
// What bounds it on the H100: the bytes of the (n, m) output.  The feature
// width d is tiny on the main path (5), so the work per output element is a
// few dozen flops and no tensor-core product pays; the per-append call
// (n_max x 1) is bound by the launch itself.
//
// Design: one thread per output element over 16 x 16 tiles.  The 16 x rows
// and 16 y rows of a tile are staged in shared memory in chunks of 32
// features, so any d works without padding, and the ragged edges in n, m
// and d are masked here instead of padded by the caller.  The distance is
// the same |x|^2 + |y|^2 - 2 x.y expansion, clamp at 0 and +1e-36 inside
// the square root as the reference, so kernel and plain version agree to
// rounding.  sigma2 and rho are read from device memory so a call never
// waits for the host.
#include "common.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kChunk = 32;

__global__ void __launch_bounds__(kTile * kTile)
matern52_gram_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const float* __restrict__ sigma2_p,
                     const float* __restrict__ rho_p, float* __restrict__ out,
                     int n, int m, int d) {
  __shared__ float xs[kTile][kChunk + 1];
  __shared__ float ys[kTile][kChunk + 1];
  const int tx = threadIdx.x;  // y row within the tile
  const int ty = threadIdx.y;  // x row within the tile
  const int tid = ty * kTile + tx;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  float xx = 0.f, yy = 0.f, cross = 0.f;
  for (int c0 = 0; c0 < d; c0 += kChunk) {
    for (int e = tid; e < kTile * kChunk; e += kTile * kTile) {
      const int r = e / kChunk, c = e % kChunk;
      const int gc = c0 + c;
      xs[r][c] = (i0 + r < n && gc < d) ? x[(size_t)(i0 + r) * d + gc] : 0.f;
      ys[r][c] = (j0 + r < m && gc < d) ? y[(size_t)(j0 + r) * d + gc] : 0.f;
    }
    __syncthreads();
    const int cmax = min(kChunk, d - c0);
    for (int c = 0; c < cmax; ++c) {
      const float a = xs[ty][c];
      const float b = ys[tx][c];
      xx += a * a;
      yy += b * b;
      cross += a * b;
    }
    __syncthreads();
  }
  const int i = i0 + ty, j = j0 + tx;
  if (i >= n || j >= m) return;
  const float sigma2 = *sigma2_p, rho = *rho_p;
  const float sq = fmaxf(xx + yy - 2.f * cross, 0.f);
  const float dist = sqrtf(sq + 1e-36f);
  const float z = repro::kSqrt5 * dist / rho;
  out[(size_t)i * m + j] = sigma2 * (1.f + z + z * z / 3.f) * expf(-z);
}

}  // namespace

REPRO_EXPORT int repro_matern52_gram(const float* x, const float* y,
                                     const float* sigma2, const float* rho,
                                     float* out, int n, int m, int d,
                                     void* stream) {
  if (n == 0 || m == 0) return 0;
  const dim3 block(kTile, kTile);
  const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  matern52_gram_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, sigma2, rho, out, n, m, d);
  return static_cast<int>(cudaGetLastError());
}
