// The gram kernels' shared design: matern.cu instantiates it as the
// Matérn-2.5 form, mixed.cu as the mixed (Matérn x categorical) form.
//
//   K_b[i, j] = sigma2_b (1 + z + z^2 / 3) exp(-z) [cat],
//   z = sqrt(5) |x_bi - y_bj| / rho_b,   b = 0 .. batch - 1,
//   cat = exp(-0.5 |xk_bi - yk_bj|^2 / rho_b)        (mixed form only)
//
// with |a - b|^2 = |a|^2 + |b|^2 - 2 a.b clamped at 0, and, in the masked
// form (the padded Gram of a lag event or a refactor), rows and columns at
// or past n_b replaced by the identity and noise2_b added on the active
// diagonal.  x is (batch, n, d) and y (batch, m, d), each with its own row
// and batch stride (batch stride 0: one buffer shared by the batch, as the
// lag refit's 18 candidates share x_buf); sigma2, rho, noise2 and n are
// read per matrix from device memory with a stride (0: one value for all),
// and so are the mixed form's (d,) type masks: a stride of 0 shares one
// pair of masks, a stride of d gives each matrix its own (a stacked
// engine whose studies have different type layouts).
//
// What bounds it on the H100: the bytes of the output.  A 1024^2 Gram is
// 4 MB (1.25 us at 3.35 TB/s); the lag refit's 18 padded Grams are 75.5 MB
// (22.5 us).  d is 5 (float path) or 6 (mixed), so the distance is a few
// dozen flops an element, tensor cores do not pay, and the epilogue's two
// IEEE divisions and one or two expf a matrix element are what the stores
// must hide.  The append column (n x 1) is bound by the launch.
//
// Design (the geometry comes from `kernels/matern.launch_plan`):
//   * Tile layout: a CTA of 256 threads owns a 64 x 64 tile; a thread owns
//     4 rows x 4 consecutive columns and writes each row's 4 outputs as one
//     16-byte store, so a warp stores two 256-byte row segments.  The 64 x
//     and 64 y rows are staged feature-major in shared memory, 32 features
//     a pass (one pass for d <= 32), and each row's squared norm is
//     computed once, by one thread, into shared memory.  Ragged n, m and d
//     are masked here.
//   * Symmetric builds (y is x: every padded Gram) compute the tile pairs
//     bi >= bj only.  An off-diagonal tile is stored, then transposed
//     through shared memory and stored again as its mirror (bj, bi), both
//     coalesced; a diagonal tile is computed whole and stored once.  K is
//     exactly symmetric in this arithmetic: fmaf is commutative in its two
//     factors and |x_i|^2 and |x_j|^2 are the same chains, so the mirror
//     keeps the bits of a full build.
//   * Shared x over the batch: when x, y (and the masks) have batch stride
//     0, a CTA
//     computes each element's distance (and the mixed form's categorical
//     squared distance) once and runs the epilogue and the stores for a
//     group of matrices, reusing the rho-only part of the epilogue while
//     rho repeats; the plan splits the batch into groups so that the grid
//     holds about eight CTAs an SM.  Distinct x per matrix: one matrix a
//     CTA.
//   * Column layout (m <= 8, the append's n x 1): one thread per row of x,
//     y read through the cache, no shared memory and no barrier.
//   * Masked form fused: identity outside the active block and
//     __fadd_rn(K_ii, noise2) on the active diagonal, which is what
//     K + noise2 * eye, then where(active, ., eye) gives.
// Each element keeps the arithmetic of the kernels this design replaces,
// in their order: the three chains over features in feature order
// (fmaf), the clamp, sqrtf(sq + 1e-36f), then the epilogue (`radial`,
// `covariance`).  Never built with fast math: expf, sqrtf and the
// divisions are IEEE.
#pragma once

#include "common.cuh"

namespace repro {
namespace gram {

constexpr int kTile = 64;          // rows and columns of a CTA's tile
constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 outputs each
constexpr int kChunk = 32;         // features staged per pass
constexpr int kColThreads = 128;   // column layout: rows of x per CTA
constexpr int kColMaxM = 8;        // widest y the column layout takes

enum Layout { kTileLayout = 0, kColumnLayout = 1 };

struct Args {
  const float* x;
  const float* y;
  const float* cont;       // mixed form: 0/1 type masks, (d,) per matrix
  const float* cat;        //   at a step of mask_step floats (0: shared)
  const float* sigma2;
  const float* rho;
  const float* noise2;     // null: the plain gram, no padding
  const int* n_active;     // null: n_fixed for every matrix
  float* out;              // (batch, n, m), contiguous
  long long x_row, x_batch, y_row, y_batch;
  int batch, n, m, d;
  int s2_step, rho_step, noise_step, n_step, n_fixed;
  int symmetric, per_group, tiles_m;
  int mask_step;           // 0 or d; d only with one matrix a CTA
};

// The epilogue, as the kernels this design replaces wrote it:
//   z = kSqrt5 * dist / rho,  K = sigma2 * (1 + z + z * z / 3) * expf(-z)
//   [* expf(-0.5 * sqk / rho)],
// evaluated left to right.  Everything but the two products with sigma2
// and the categorical factor depends on rho alone, so it is split in two:
// `radial` (per distance and rho) and `covariance` (per matrix).  A CTA
// whose next matrix has the same rho (the lag refit's 18 candidates are 6
// rho x 3 sigma2) reuses its radial terms; the operations, and so the
// bits, are those of one expression.
struct Radial {
  float poly, ez, cat;
};

template <bool kMixed>
__device__ __forceinline__ Radial radial(float dist, float sqk, float rho) {
  const float z = kSqrt5 * dist / rho;
  Radial r;
  r.poly = 1.f + z + z * z / 3.f;
  r.ez = expf(-z);
  r.cat = kMixed ? expf(-0.5f * sqk / rho) : 1.f;
  return r;
}

template <bool kMixed>
__device__ __forceinline__ float covariance(const Radial& r, float sigma2) {
  const float k = sigma2 * r.poly * r.ez;
  return kMixed ? k * r.cat : k;
}

// The masked form: K + noise2 on the active diagonal, K inside the active
// block, the identity outside it.
__device__ __forceinline__ float padded(float k, int i, int j, int nb,
                                        float noise, bool masked) {
  if (!masked) return k;
  if (i < nb && j < nb) return i == j ? __fadd_rn(k, noise) : k;
  return i == j ? 1.f : 0.f;
}

__device__ __forceinline__ float clamped_dist(float xx, float yy,
                                              float cross) {
  const float sq = fmaxf(xx + yy - 2.f * cross, 0.f);
  return sqrtf(sq + 1e-36f);
}

// One row segment of 4 outputs at (i, j..j+3): a 16-byte store where the
// row allows it, else the columns inside the matrix one by one.
__device__ __forceinline__ void store4(float* out, const Args& a, int i,
                                       int j, const float (&v)[4]) {
  if (i >= a.n) return;
  float* row = out + (size_t)i * a.m;
  if ((a.m & 3) == 0 && j + 3 < a.m) {
    *reinterpret_cast<float4*>(row + j) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (j + q < a.m) row[j + q] = v[q];
}

// Two CTAs an SM: the mixed form holds 80 floats of distances and radial
// terms a thread and would take 150 registers, one CTA an SM; capped at
// 128 it spills 40 bytes and runs the lag batch faster (PERF.md, section 6).
template <bool kMixed>
__global__ void __launch_bounds__(kThreads, 2) gram_tile_kernel(const Args a) {
  __shared__ __align__(16) float xs[kChunk][kTile];   // feature-major rows
  __shared__ __align__(16) float ys[kChunk][kTile];
  __shared__ float norm[2 * kTile];                   // |x_i|^2, then |y_j|^2
  __shared__ float normk[kMixed ? 2 * kTile : 1];     // categorical block
  __shared__ float cms[kChunk], kms[kChunk];
  __shared__ float tr[kTile][kTile + 1];              // the mirror tile

  // Tile pair of this CTA: row-major over the lower triangle when
  // symmetric, over the whole tile grid otherwise.
  const int p = blockIdx.x;
  int bi, bj;
  if (a.symmetric) {
    bi = static_cast<int>((sqrt(8.0 * p + 1.0) - 1.0) * 0.5);
    while (bi > 0 && (long long)bi * (bi + 1) / 2 > p) --bi;
    while ((long long)(bi + 1) * (bi + 2) / 2 <= p) ++bi;
    bj = p - static_cast<int>((long long)bi * (bi + 1) / 2);
  } else {
    bi = p / a.tiles_m;
    bj = p % a.tiles_m;
  }
  const int i0 = bi * kTile, j0 = bj * kTile;
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int b0 = blockIdx.y * a.per_group;
  const int b_end = min(b0 + a.per_group, a.batch);
  // per_group > 1 only where x, y and the masks have batch stride 0.
  const float* x = a.x + b0 * a.x_batch;
  const float* y = a.y + b0 * a.y_batch;
  const float* cont = kMixed ? a.cont + (size_t)b0 * a.mask_step : nullptr;
  const float* cat = kMixed ? a.cat + (size_t)b0 * a.mask_step : nullptr;

  float cross[4][4], crossk[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) cross[k][q] = crossk[k][q] = 0.f;
  float nrm = 0.f, nrmk = 0.f;    // threads < 128: one row's norm chain

  for (int c0 = 0; c0 < a.d; c0 += kChunk) {
    const int cw = min(kChunk, a.d - c0);
    for (int e = t; e < kTile * cw; e += kThreads) {
      const int r = e / cw, c = e % cw;
      xs[c][r] = (i0 + r < a.n) ? x[(i0 + r) * a.x_row + c0 + c] : 0.f;
      ys[c][r] = (j0 + r < a.m) ? y[(j0 + r) * a.y_row + c0 + c] : 0.f;
    }
    if (kMixed && t < cw) {
      cms[t] = cont[c0 + t];
      kms[t] = cat[c0 + t];
    }
    __syncthreads();
    if (t < 2 * kTile) {
      const float* src = t < kTile ? &xs[0][t] : &ys[0][t - kTile];
      for (int c = 0; c < cw; ++c) {
        const float v = src[c * kTile];
        if (kMixed) {
          const float vc = v * cms[c], vk = v * kms[c];
          nrm = fmaf(vc, vc, nrm);
          nrmk = fmaf(vk, vk, nrmk);
        } else {
          nrm = fmaf(v, v, nrm);
        }
      }
    }
    for (int c = 0; c < cw; ++c) {
      float xv[4], yv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) xv[k] = xs[c][ty + 16 * k];
      const float4 y4 = *reinterpret_cast<const float4*>(&ys[c][4 * tx]);
      yv[0] = y4.x; yv[1] = y4.y; yv[2] = y4.z; yv[3] = y4.w;
      if (kMixed) {
        const float cm = cms[c], km = kms[c];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            cross[k][q] = fmaf(xv[k] * cm, yv[q] * cm, cross[k][q]);
            crossk[k][q] = fmaf(xv[k] * km, yv[q] * km, crossk[k][q]);
          }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            cross[k][q] = fmaf(xv[k], yv[q], cross[k][q]);
      }
    }
    __syncthreads();
  }
  if (t < 2 * kTile) {
    norm[t] = nrm;
    if (kMixed) normk[t] = nrmk;
  }
  __syncthreads();

  // Distances, shared by every matrix of the group.
  float dist[4][4], sqk[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ii = ty + 16 * k, jj = 4 * tx + q;
      dist[k][q] = clamped_dist(norm[ii], norm[kTile + jj], cross[k][q]);
      sqk[k][q] = kMixed ? fmaxf(normk[ii] + normk[kTile + jj]
                                 - 2.f * crossk[k][q], 0.f)
                         : 0.f;
    }

  const bool masked = a.noise2 != nullptr;
  const bool mirror = a.symmetric && bi != bj;
  Radial rad[4][4];
  for (int b = b0; b < b_end; ++b) {
    const float s2 = a.sigma2[(size_t)b * a.s2_step];
    const float rh = a.rho[(size_t)b * a.rho_step];
    const float nz = masked ? a.noise2[(size_t)b * a.noise_step] : 0.f;
    const int nb = a.n_active ? a.n_active[(size_t)b * a.n_step] : a.n_fixed;
    float* out = a.out + (size_t)b * a.n * a.m;
    if (b == b0 || !(rh == a.rho[(size_t)(b - 1) * a.rho_step])) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          rad[k][q] = radial<kMixed>(dist[k][q], sqk[k][q], rh);
    }
    float v[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[k][q] = padded(covariance<kMixed>(rad[k][q], s2), i0 + ty + 16 * k,
                         j0 + 4 * tx + q, nb, nz, masked);
      store4(out, a, i0 + ty + 16 * k, j0 + 4 * tx, v[k]);
    }
    if (mirror) {
      __syncthreads();              // the last matrix's mirror is read
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int q = 0; q < 4; ++q) tr[4 * tx + q][ty + 16 * k] = v[k][q];
      __syncthreads();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = ty + 16 * k;
        const float w[4] = {tr[r][4 * tx], tr[r][4 * tx + 1],
                            tr[r][4 * tx + 2], tr[r][4 * tx + 3]};
        store4(out, a, j0 + r, i0 + 4 * tx, w);
      }
    }
  }
}

template <bool kMixed>
__global__ void __launch_bounds__(kColThreads)
gram_column_kernel(const Args a) {
  const int i = blockIdx.x * kColThreads + threadIdx.x;
  if (i >= a.n) return;
  const int b0 = blockIdx.y * a.per_group;
  const int b_end = min(b0 + a.per_group, a.batch);
  const float* x = a.x + b0 * a.x_batch + i * a.x_row;
  const float* y = a.y + b0 * a.y_batch;
  const float* cont = kMixed ? a.cont + (size_t)b0 * a.mask_step : nullptr;
  const float* cat = kMixed ? a.cat + (size_t)b0 * a.mask_step : nullptr;
  float xx = 0.f, kk = 0.f;
  float yy[kColMaxM], ll[kColMaxM], cross[kColMaxM], crossk[kColMaxM];
#pragma unroll
  for (int j = 0; j < kColMaxM; ++j) yy[j] = ll[j] = cross[j] = crossk[j] = 0.f;
  for (int c = 0; c < a.d; ++c) {
    const float xv = x[c];
    const float cm = kMixed ? cont[c] : 1.f, km = kMixed ? cat[c] : 0.f;
    const float xc = kMixed ? xv * cm : xv, xk = xv * km;
    xx = fmaf(xc, xc, xx);
    if (kMixed) kk = fmaf(xk, xk, kk);
#pragma unroll
    for (int j = 0; j < kColMaxM; ++j) {
      if (j < a.m) {
        const float yv = y[j * a.y_row + c];
        const float yc = kMixed ? yv * cm : yv;
        yy[j] = fmaf(yc, yc, yy[j]);
        cross[j] = fmaf(xc, yc, cross[j]);
        if (kMixed) {
          const float yk = yv * km;
          ll[j] = fmaf(yk, yk, ll[j]);
          crossk[j] = fmaf(xk, yk, crossk[j]);
        }
      }
    }
  }
  float dist[kColMaxM], sqk[kColMaxM];
#pragma unroll
  for (int j = 0; j < kColMaxM; ++j) {
    dist[j] = clamped_dist(xx, yy[j], cross[j]);
    sqk[j] = kMixed ? fmaxf(kk + ll[j] - 2.f * crossk[j], 0.f) : 0.f;
  }
  const bool masked = a.noise2 != nullptr;
  for (int b = b0; b < b_end; ++b) {
    const float s2 = a.sigma2[(size_t)b * a.s2_step];
    const float rh = a.rho[(size_t)b * a.rho_step];
    const float nz = masked ? a.noise2[(size_t)b * a.noise_step] : 0.f;
    const int nb = a.n_active ? a.n_active[(size_t)b * a.n_step] : a.n_fixed;
    float* row = a.out + ((size_t)b * a.n + i) * a.m;
#pragma unroll
    for (int j = 0; j < kColMaxM; ++j)
      if (j < a.m)
        row[j] = padded(covariance<kMixed>(radial<kMixed>(dist[j], sqk[j], rh),
                                           s2),
                        i, j, nb, nz, masked);
  }
}

// Checks the geometry the wrapper took from its launch plan and launches
// one kernel on `stream`; returns the CUDA status.
template <bool kMixed>
int launch(const Args& a, int layout, int grid_x, int grid_y, void* stream) {
  if (a.batch == 0 || a.n == 0 || a.m == 0) return 0;
  const long long tiles_n = (a.n + kTile - 1) / kTile;
  const long long tiles_m = (a.m + kTile - 1) / kTile;
  const long long want_x =
      layout == kColumnLayout ? (a.n + kColThreads - 1) / kColThreads
      : a.symmetric           ? tiles_n * (tiles_n + 1) / 2
                              : tiles_n * tiles_m;
  const bool shared = a.x_batch == 0 && a.y_batch == 0 && a.mask_step == 0;
  const bool ok =
      (layout == kTileLayout || (layout == kColumnLayout && a.m <= kColMaxM))
      && grid_x == want_x && a.tiles_m == tiles_m && a.per_group >= 1
      && (long long)grid_y * a.per_group >= a.batch
      && (long long)(grid_y - 1) * a.per_group < a.batch
      && (a.per_group == 1 || shared) && (!a.symmetric || a.n == a.m)
      && (a.mask_step == 0 || a.mask_step == a.d) && a.d >= 0
      && grid_y <= 65535;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(grid_x, grid_y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout == kTileLayout)
    gram_tile_kernel<kMixed><<<grid, kThreads, 0, s>>>(a);
  else
    gram_column_kernel<kMixed><<<grid, kColThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gram
}  // namespace repro
