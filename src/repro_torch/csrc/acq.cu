// Fused EI value and gradient for a batch of r candidates (one ascent step
// of the multi-start EI optimizer), with an optional leading batch axis, in
// two forms: the float form below and the mixed form (kMixed, further down).
// The float form:
//   K     = kern(X, x_buf) * amask                 (r, n)
//   gamma = K alpha + shift                        (r)
//   U     = K A,  A = li_buf^T li_buf (hoisted)    (r, n)
//   var   = max(sigma2 - rowsum(U o K), 1e-12)
//   EI    = gamma Phi(Z) + sigma phi(Z),  Z = gamma / sigma
//   grad  = rowsum(w) x - w x_buf,  w = (Phi alpha amask - 2 dvar U) s amask
// with dvar = phi / 2 sigma zeroed where the variance clamp binds.
//
// Replaces: src/repro/kernels/acq.py:_acq_tile_kernel (float form of
// fused_ei_grad_pallas; the math is _fused_ei_grad_math) and, as the kMixed
// instantiation, src/repro/kernels/acq.py:_acq_mixed_tile_kernel.
//
// The mixed form (search spaces with categorical coordinates) takes the two
// (d,) 0/1 type masks and splits each row while loading it: xc = x * cont,
// xk = x * cat.  K and the gradient's radial factor s carry
//   cat = exp(-0.5 |xk - xbk|^2 / rho)
// (divided by rho, the reference's definition), which is never
// differentiated, and the distance z and the gradient use the continuous
// block only, so the gradient is exactly 0 on categorical coordinates.
// Phase 3 recomputes cat beside z, as it recomputes z, which costs d flops
// per entry and no shared memory; the row split adds a (kRb, d) block for
// the candidates' categorical rows and 2 d floats for the masks.
//
// What bounds it on the H100: the 2 r n^2 flops of U = K A (r = 64,
// n = 1024 on the main path); A is 4 MB and is read from L2 by every CTA.
//
// Design: Pallas keeps A whole in VMEM; a Hopper block has 227 KB of shared
// memory, so here A streams from L2 while each CTA keeps the rows of its
// own candidates whole in shared memory.  The gradient weights U by dvar,
// and dvar needs the finished row sum of U o K, so the CTA works in phases:
//   1. K rows (masked) for all n into shared memory, gamma by block reduce;
//   2. U = K A, thread t owning columns t, t + 256, ...: each A row is read
//      once per CTA, coalesced, against K values broadcast from shared
//      memory; U goes to shared memory and rowsum(U o K) is reduced;
//   3. var, EI and dvar per row; w overwrites K in shared memory;
//   4. rowsum(w) and w x_buf, one warp per (row, feature) pair.
// A CTA holds kRb candidate rows, 2 kRb n floats of shared memory (64 KB at
// kRb = 8, n = 1024, opted in above 48 KB); the C entry picks the largest
// kRb in {8, 4, 2, 1} that fits (for the form asked), so any n up to
// about 29000 runs.  r = 64 gives 8 CTAs: slow on 132 SMs, but right.
// erfcf / expf / sqrtf are the accurate forms (no fast math), as the
// parity with the reference needs; Phi is 0.5 erfc(-Z / sqrt2), which
// keeps its lower tail where 1 + erf(Z / sqrt2) cancels to 0 and drops
// the gradient's mean term.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerPass = 4;  // U columns per thread per pass
constexpr float kVarFloor = 1e-12f;
constexpr float kSqrt2 = 1.4142135623730951f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

__device__ __forceinline__ float matern_z(const float* xi, float xxi,
                                          const float* xbj, float yy, int d,
                                          float rho) {
  float cross = 0.f;
  for (int c = 0; c < d; ++c) cross += xi[c] * xbj[c];
  const float sq = fmaxf(xxi + yy - 2.f * cross, 0.f);
  const float dist = sqrtf(sq + 1e-36f);
  return repro::kSqrt5 * dist / rho;
}

// Mixed form: z over the continuous block (xci is the candidate's masked
// row) and the categorical factor over the one-hot block, for the train
// row xbj split by the masks cm / km as it is read.
__device__ __forceinline__ float mixed_z(const float* xci, const float* xki,
                                         float xxi, float kki,
                                         const float* xbj, float yy, float ll,
                                         const float* cm, const float* km,
                                         int d, float rho, float* cat) {
  float cross = 0.f, crossk = 0.f;
  for (int c = 0; c < d; ++c) {
    cross += xci[c] * (xbj[c] * cm[c]);
    crossk += xki[c] * (xbj[c] * km[c]);
  }
  const float sq = fmaxf(xxi + yy - 2.f * cross, 0.f);
  const float dist = sqrtf(sq + 1e-36f);
  const float sqk = fmaxf(kki + ll - 2.f * crossk, 0.f);
  *cat = expf(-0.5f * sqk / rho);
  return repro::kSqrt5 * dist / rho;
}

// |xbc_j|^2 and |xbk_j|^2 of train row j (the mixed form's row norms).
__device__ __forceinline__ void mixed_norms(const float* xbj, const float* cm,
                                            const float* km, int d, float* yy,
                                            float* ll) {
  float a = 0.f, b = 0.f;
  for (int c = 0; c < d; ++c) {
    const float vc = xbj[c] * cm[c], vk = xbj[c] * km[c];
    a += vc * vc;
    b += vk * vk;
  }
  *yy = a;
  *ll = b;
}

template <int kRb, bool kMixed>
__global__ void __launch_bounds__(kThreads)
fused_ei_grad_kernel(const float* __restrict__ x, const float* __restrict__ xb,
                     const float* __restrict__ amask,
                     const float* __restrict__ alpha,
                     const float* __restrict__ abuf,
                     const float* __restrict__ cont_mask,
                     const float* __restrict__ cat_mask,
                     const float* __restrict__ sigma2_p,
                     const float* __restrict__ rho_p,
                     const float* __restrict__ shift_p,
                     float* __restrict__ ei_out, float* __restrict__ grad_out,
                     int r, int n, int d) {
  extern __shared__ float smem[];
  float* ks = smem;               // (kRb, n): K, later w
  float* us = ks + kRb * n;       // (kRb, n): U
  float* xs = us + kRb * n;       // (kRb, d): candidates (mixed: xc)
  float* gs = xs + kRb * d;       // (kRb, d + 1): w x_buf and rowsum(w)
  float* xks = gs + kRb * (d + 1);  // mixed only, (kRb, d): xk
  float* cms = xks + kRb * d;       // mixed only, (d,): cont_mask
  float* kms = cms + d;             // mixed only, (d,): cat_mask
  __shared__ float red[kWarps][kRb];
  __shared__ float xx_s[kRb], gam_s[kRb], cdf_s[kRb], dvar_s[kRb];
  __shared__ float kk_s[kRb];       // mixed only: |xk_i|^2

  const int b = blockIdx.y;
  x += (size_t)b * r * d;
  xb += (size_t)b * n * d;
  amask += (size_t)b * n;
  alpha += (size_t)b * n;
  abuf += (size_t)b * n * n;
  ei_out += (size_t)b * r;
  grad_out += (size_t)b * r * d;
  const float sigma2 = sigma2_p[b], rho = rho_p[b], shift = shift_p[b];

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int i0 = blockIdx.x * kRb;
  if constexpr (kMixed) {
    for (int c = tid; c < d; c += kThreads) {
      cms[c] = cont_mask[c];
      kms[c] = cat_mask[c];
    }
    __syncthreads();
    for (int e = tid; e < kRb * d; e += kThreads) {
      const float v = (i0 + e / d < r) ? x[(size_t)i0 * d + e] : 0.f;
      xs[e] = v * cms[e % d];
      xks[e] = v * kms[e % d];
    }
  } else {
    for (int e = tid; e < kRb * d; e += kThreads)
      xs[e] = (i0 + e / d < r) ? x[(size_t)i0 * d + e] : 0.f;
  }
  __syncthreads();
  if (tid < kRb) {
    float acc = 0.f;
    for (int c = 0; c < d; ++c) acc += xs[tid * d + c] * xs[tid * d + c];
    xx_s[tid] = acc;
    if constexpr (kMixed) {
      float acck = 0.f;
      for (int c = 0; c < d; ++c) acck += xks[tid * d + c] * xks[tid * d + c];
      kk_s[tid] = acck;
    }
  }
  __syncthreads();

  // 1. K rows and gamma.
  float part[kRb];
#pragma unroll
  for (int i = 0; i < kRb; ++i) part[i] = 0.f;
  for (int j = tid; j < n; j += kThreads) {
    const float* xbj = xb + (size_t)j * d;
    if constexpr (kMixed) {
      float yy, ll;
      mixed_norms(xbj, cms, kms, d, &yy, &ll);
      const float am = amask[j], al = alpha[j];
#pragma unroll
      for (int i = 0; i < kRb; ++i) {
        float cat;
        const float z = mixed_z(xs + i * d, xks + i * d, xx_s[i], kk_s[i],
                                xbj, yy, ll, cms, kms, d, rho, &cat);
        float k = sigma2 * (1.f + z + z * z / 3.f) * expf(-z);
        k = k * cat;
        const float km = k * am;
        ks[i * n + j] = km;
        part[i] += km * al;
      }
    } else {
      float yy = 0.f;
      for (int c = 0; c < d; ++c) yy += xbj[c] * xbj[c];
      const float am = amask[j], al = alpha[j];
#pragma unroll
      for (int i = 0; i < kRb; ++i) {
        const float z = matern_z(xs + i * d, xx_s[i], xbj, yy, d, rho);
        const float k = sigma2 * (1.f + z + z * z / 3.f) * expf(-z);
        const float km = k * am;
        ks[i * n + j] = km;
        part[i] += km * al;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRb; ++i) {
    const float v = repro::warp_sum(part[i]);
    if (lane == 0) red[w][i] = v;
  }
  __syncthreads();
  if (tid < kRb) {
    float g = 0.f;
    for (int q = 0; q < kWarps; ++q) g += red[q][tid];
    gam_s[tid] = g + shift;
  }
  __syncthreads();

  // 2. U = K A and rowsum(U o K).
#pragma unroll
  for (int i = 0; i < kRb; ++i) part[i] = 0.f;
  for (int jb = 0; jb < n; jb += kThreads * kColsPerPass) {
    float acc[kColsPerPass][kRb];
#pragma unroll
    for (int q = 0; q < kColsPerPass; ++q)
#pragma unroll
      for (int i = 0; i < kRb; ++i) acc[q][i] = 0.f;
    for (int k = 0; k < n; ++k) {
      const float* arow = abuf + (size_t)k * n + jb + tid;
      float av[kColsPerPass];
#pragma unroll
      for (int q = 0; q < kColsPerPass; ++q)
        av[q] = (jb + tid + q * kThreads < n) ? arow[q * kThreads] : 0.f;
#pragma unroll
      for (int i = 0; i < kRb; ++i) {
        const float kv = ks[i * n + k];
#pragma unroll
        for (int q = 0; q < kColsPerPass; ++q) acc[q][i] += kv * av[q];
      }
    }
#pragma unroll
    for (int q = 0; q < kColsPerPass; ++q) {
      const int j = jb + tid + q * kThreads;
      if (j < n) {
#pragma unroll
        for (int i = 0; i < kRb; ++i) {
          us[i * n + j] = acc[q][i];
          part[i] += acc[q][i] * ks[i * n + j];
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRb; ++i) {
    const float v = repro::warp_sum(part[i]);
    if (lane == 0) red[w][i] = v;
  }
  __syncthreads();

  // 3. var, EI, dvar per row.
  if (tid < kRb) {
    float quad = 0.f;
    for (int q = 0; q < kWarps; ++q) quad += red[q][tid];
    const float raw_var = sigma2 - quad;
    const float var = fmaxf(raw_var, kVarFloor);
    const float sig = sqrtf(var);
    const float gam = gam_s[tid];
    const float zs = gam / fmaxf(sig, 1e-12f);
    const float cdf = 0.5f * erfcf(-zs / kSqrt2);  // accurate lower tail
    const float pdf = expf(-0.5f * zs * zs) * kInvSqrt2Pi;
    if (i0 + tid < r) ei_out[i0 + tid] = fmaxf(gam * cdf + sig * pdf, 0.f);
    cdf_s[tid] = cdf;
    dvar_s[tid] = raw_var > kVarFloor ? pdf / (2.f * sig) : 0.f;
  }
  __syncthreads();

  // w = (cdf alpha amask - 2 dvar U) s amask, into the K rows.
  const float sfac = -sigma2 * (5.f / (3.f * rho * rho));
  for (int j = tid; j < n; j += kThreads) {
    const float* xbj = xb + (size_t)j * d;
    if constexpr (kMixed) {
      float yy, ll;
      mixed_norms(xbj, cms, kms, d, &yy, &ll);
      const float am = amask[j], al = alpha[j];
#pragma unroll
      for (int i = 0; i < kRb; ++i) {
        float cat;
        const float z = mixed_z(xs + i * d, xks + i * d, xx_s[i], kk_s[i],
                                xbj, yy, ll, cms, kms, d, rho, &cat);
        const float s = sfac * (1.f + z) * expf(-z) * cat;
        const float c = cdf_s[i] * (al * am) - 2.f * dvar_s[i] * us[i * n + j];
        ks[i * n + j] = c * s * am;
      }
    } else {
      float yy = 0.f;
      for (int c = 0; c < d; ++c) yy += xbj[c] * xbj[c];
      const float am = amask[j], al = alpha[j];
#pragma unroll
      for (int i = 0; i < kRb; ++i) {
        const float z = matern_z(xs + i * d, xx_s[i], xbj, yy, d, rho);
        const float s = sfac * (1.f + z) * expf(-z);
        const float c = cdf_s[i] * (al * am) - 2.f * dvar_s[i] * us[i * n + j];
        ks[i * n + j] = c * s * am;
      }
    }
  }
  __syncthreads();

  // 4. Gradient: pair p = (row i, feature c); c == d is rowsum(w).  The
  // mixed form takes w xbc (the train rows' continuous block) and xc, so
  // its gradient is 0 on the categorical coordinates.
  for (int p = w; p < kRb * (d + 1); p += kWarps) {
    const int i = p / (d + 1), c = p % (d + 1);
    float acc = 0.f;
    if constexpr (kMixed) {
      const float cmc = c < d ? cms[c] : 1.f;
      for (int j = lane; j < n; j += 32) {
        const float wv = ks[i * n + j];
        acc += (c < d) ? wv * (xb[(size_t)j * d + c] * cmc) : wv;
      }
    } else {
      for (int j = lane; j < n; j += 32) {
        const float wv = ks[i * n + j];
        acc += (c < d) ? wv * xb[(size_t)j * d + c] : wv;
      }
    }
    acc = repro::warp_sum(acc);
    if (lane == 0) gs[p] = acc;
  }
  __syncthreads();
  for (int e = tid; e < kRb * d; e += kThreads) {
    const int i = e / d, c = e % d;
    if (i0 + i < r)
      grad_out[(size_t)(i0 + i) * d + c] =
          gs[i * (d + 1) + d] * xs[e] - gs[i * (d + 1) + c];
  }
}

template <int kRb>
size_t smem_bytes(int n, int d, bool mixed) {
  return sizeof(float) * ((size_t)2 * kRb * n + (size_t)kRb * d +
                          (size_t)kRb * (d + 1) +
                          (mixed ? (size_t)kRb * d + 2 * (size_t)d : 0));
}

template <int kRb, bool kMixed>
int launch(const float* x, const float* xb, const float* amask,
           const float* alpha, const float* abuf, const float* cont_mask,
           const float* cat_mask, const float* sigma2, const float* rho,
           const float* shift, float* ei, float* grad, int batch, int r,
           int n, int d, cudaStream_t st) {
  const size_t bytes = smem_bytes<kRb>(n, d, kMixed);
  cudaError_t err = cudaFuncSetAttribute(
      fused_ei_grad_kernel<kRb, kMixed>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((r + kRb - 1) / kRb, batch);
  fused_ei_grad_kernel<kRb, kMixed><<<grid, kThreads, bytes, st>>>(
      x, xb, amask, alpha, abuf, cont_mask, cat_mask, sigma2, rho, shift, ei,
      grad, r, n, d);
  return static_cast<int>(cudaGetLastError());
}

template <bool kMixed>
int launch_rows(const float* x, const float* xb, const float* amask,
                const float* alpha, const float* abuf, const float* cont_mask,
                const float* cat_mask, const float* sigma2, const float* rho,
                const float* shift, float* ei, float* grad, int batch, int r,
                int n, int d, int rows, cudaStream_t st) {
  switch (rows) {
    case 8: return launch<8, kMixed>(x, xb, amask, alpha, abuf, cont_mask, cat_mask, sigma2, rho, shift, ei, grad, batch, r, n, d, st);
    case 4: return launch<4, kMixed>(x, xb, amask, alpha, abuf, cont_mask, cat_mask, sigma2, rho, shift, ei, grad, batch, r, n, d, st);
    case 2: return launch<2, kMixed>(x, xb, amask, alpha, abuf, cont_mask, cat_mask, sigma2, rho, shift, ei, grad, batch, r, n, d, st);
    case 1: return launch<1, kMixed>(x, xb, amask, alpha, abuf, cont_mask, cat_mask, sigma2, rho, shift, ei, grad, batch, r, n, d, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Candidate rows per CTA for (n, d) and the form (mixed != 0: the mixed
// form's larger shared memory): 8, 4, 2 or 1, or 0 if none fits.
REPRO_EXPORT int repro_fused_ei_rows(int n, int d, int mixed) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  const size_t limit = static_cast<size_t>(optin) - 1024;  // static smem
  const bool mx = mixed != 0;
  if (smem_bytes<8>(n, d, mx) <= limit) return 8;
  if (smem_bytes<4>(n, d, mx) <= limit) return 4;
  if (smem_bytes<2>(n, d, mx) <= limit) return 2;
  if (smem_bytes<1>(n, d, mx) <= limit) return 1;
  return 0;
}

REPRO_EXPORT int repro_fused_ei_grad(const float* x, const float* xb,
                                     const float* amask, const float* alpha,
                                     const float* abuf, const float* sigma2,
                                     const float* rho, const float* shift,
                                     float* ei, float* grad, int batch, int r,
                                     int n, int d, int rows, void* stream) {
  if (batch == 0 || r == 0) return 0;
  return launch_rows<false>(x, xb, amask, alpha, abuf, nullptr, nullptr,
                            sigma2, rho, shift, ei, grad, batch, r, n, d, rows,
                            static_cast<cudaStream_t>(stream));
}

// The mixed form: as repro_fused_ei_grad, plus the (d,) type masks shared
// by every study of the batch.
REPRO_EXPORT int repro_fused_ei_grad_mixed(
    const float* x, const float* xb, const float* cont_mask,
    const float* cat_mask, const float* amask, const float* alpha,
    const float* abuf, const float* sigma2, const float* rho,
    const float* shift, float* ei, float* grad, int batch, int r, int n,
    int d, int rows, void* stream) {
  if (batch == 0 || r == 0) return 0;
  return launch_rows<true>(x, xb, amask, alpha, abuf, cont_mask, cat_mask,
                           sigma2, rho, shift, ei, grad, batch, r, n, d, rows,
                           static_cast<cudaStream_t>(stream));
}
