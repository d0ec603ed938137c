// Mixed-space gram  K[i, j] = sigma2 (1 + z + z^2 / 3) exp(-z) cat,
//   z   = sqrt(5) |xc_i - yc_j| / rho,        xc = x * cont_mask
//   cat = exp(-0.5 |xk_i - yk_j|^2 / rho),    xk = x * cat_mask
// for x (n, d), y (m, d) and the two (d,) 0/1 type masks.  The categorical
// factor divides by rho, not rho^2: that is the reference's definition.
//
// Replaces: src/repro/kernels/mixed.py:_mixed_tile_kernel (reached through
// _mixed_pallas_raw / mixed_gram_pallas).
//
// What bounds it on the H100: the bytes of the (n, m) output, as for the
// Matérn gram; the per-append (n_max x 1) call is bound by the launch.
//
// Design: the tiling of matern.cu (one thread per output over 16 x 16
// tiles, features staged in chunks of 32, ragged n, m and d masked here).
// The reference's ops layer splits x and y into four masked operands
// before the Pallas call; here the split happens while the rows are
// loaded, so the wrapper launches nothing else.  Both squared distances
// use the |a|^2 + |b|^2 - 2 a.b expansion clamped at 0, as the reference
// does, so kernel and plain version agree to rounding.
#include "common.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kChunk = 32;

__global__ void __launch_bounds__(kTile * kTile)
mixed_gram_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  const float* __restrict__ cont_mask,
                  const float* __restrict__ cat_mask,
                  const float* __restrict__ sigma2_p,
                  const float* __restrict__ rho_p, float* __restrict__ out,
                  int n, int m, int d) {
  __shared__ float xs[kTile][kChunk + 1];
  __shared__ float ys[kTile][kChunk + 1];
  __shared__ float cms[kChunk], kms[kChunk];
  const int tx = threadIdx.x;  // y row within the tile
  const int ty = threadIdx.y;  // x row within the tile
  const int tid = ty * kTile + tx;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  float xx = 0.f, yy = 0.f, cross = 0.f;   // continuous block
  float kk = 0.f, ll = 0.f, crossk = 0.f;  // categorical block
  for (int c0 = 0; c0 < d; c0 += kChunk) {
    for (int e = tid; e < kTile * kChunk; e += kTile * kTile) {
      const int r = e / kChunk, c = e % kChunk;
      const int gc = c0 + c;
      xs[r][c] = (i0 + r < n && gc < d) ? x[(size_t)(i0 + r) * d + gc] : 0.f;
      ys[r][c] = (j0 + r < m && gc < d) ? y[(size_t)(j0 + r) * d + gc] : 0.f;
    }
    if (tid < kChunk) {
      cms[tid] = (c0 + tid < d) ? cont_mask[c0 + tid] : 0.f;
      kms[tid] = (c0 + tid < d) ? cat_mask[c0 + tid] : 0.f;
    }
    __syncthreads();
    const int cmax = min(kChunk, d - c0);
    for (int c = 0; c < cmax; ++c) {
      const float a = xs[ty][c] * cms[c];
      const float b = ys[tx][c] * cms[c];
      xx += a * a;
      yy += b * b;
      cross += a * b;
      const float ak = xs[ty][c] * kms[c];
      const float bk = ys[tx][c] * kms[c];
      kk += ak * ak;
      ll += bk * bk;
      crossk += ak * bk;
    }
    __syncthreads();
  }
  const int i = i0 + ty, j = j0 + tx;
  if (i >= n || j >= m) return;
  const float sigma2 = *sigma2_p, rho = *rho_p;
  const float sq = fmaxf(xx + yy - 2.f * cross, 0.f);
  const float dist = sqrtf(sq + 1e-36f);
  const float z = repro::kSqrt5 * dist / rho;
  const float sqk = fmaxf(kk + ll - 2.f * crossk, 0.f);
  const float cat = expf(-0.5f * sqk / rho);
  out[(size_t)i * m + j] = sigma2 * (1.f + z + z * z / 3.f) * expf(-z) * cat;
}

}  // namespace

REPRO_EXPORT int repro_mixed_gram(const float* x, const float* y,
                                  const float* cont_mask,
                                  const float* cat_mask, const float* sigma2,
                                  const float* rho, float* out, int n, int m,
                                  int d, void* stream) {
  if (n == 0 || m == 0) return 0;
  const dim3 block(kTile, kTile);
  const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  mixed_gram_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, cont_mask, cat_mask, sigma2, rho, out, n, m, d);
  return static_cast<int>(cudaGetLastError());
}
