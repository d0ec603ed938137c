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
// xk = x * cat.  The masks are one pair for the batch (mask_step = 0) or
// one pair a study (mask_step = d): the CTAs of study b stage theirs from
// cont + b * mask_step, so studies with different type layouts share one
// launch.  K and the gradient's radial factor s carry
//   cat = exp(-0.5 |xk - xbk|^2 / rho)
// (divided by rho, the reference's definition), which is never
// differentiated, and the distance z and the gradient use the continuous
// block only, so the gradient is exactly 0 on categorical coordinates.
//
// What bounds it on the H100: the 2 r n^2 flops of U = K A (2 us at r = 64,
// n = 1024 at the fp32 peak); A is 4 MB and stays in L2.  What stands in
// the way is latency and occupancy: U needs every row of A, and the
// gradient weights U by dvar, which needs the finished row sum of U o K.
// The earlier design (one CTA per 8 candidate rows: 8 CTAs on 132 SMs,
// each reading A row by row straight from L2) took 0.35 ms of device time.
//
// Design: one launch.  Each CTA owns a tile of R candidate rows x C columns
// of U (R C = 512, 128 threads, a thread 4 rows x 1 column) and one slice
// of k, for one study: grid (k-slices x n / C, r / R, batch).  The plan
// (`kernels/acq.launch_plan`) splits k until one study's grid has about
// 512 CTAs: R = 8, C = 64 and 4 slices of 256 rows at r = 64, n = 1024.
// The split depends on (r, n, d) only, never on the batch, and every sum
// runs in a fixed order (slices in slice order, then column blocks in
// `tree_sum` order), so a study's outputs carry the same bits in any
// batch.  The kernel is a template on R; three tiles are compiled, R = 4,
// 8 and 16 (C = 128, 64, 32), in both forms.  Which tile and k-split a
// launch takes is the wrapper's plan: a table raced off line on the card
// per (R of the unsharded launch, n, d, form), or the R = 8 rule above
// (`kernels/acq.acq_tile_config`).
//   * A streams, nothing n-long is held: a CTA walks its k-slice in tiles
//     of 32 rows; cp.async stages A[k-tile, its C columns], x_buf[k-tile]
//     and amask four stages deep (16-byte copies of A where n % 4 is 0).
//     From the staged x_buf rows the CTA computes K[its R rows, k-tile]
//     (masked; mixed: with cat) into shared memory, one warp per 4 rows
//     and one lane per k, and each thread adds the tile's 32 terms of its
//     U entries (FMAs, k ascending) to its registers.  Two barriers a
//     k-tile; no load waits on an unstaged L2 read.
//   * U is whole before any column sum.  A slice's partial U is a sum of
//     large terms that cancel (on an ill-conditioned state its entries run
//     to 40x those of U), so a column sum taken of it carries that size's
//     round-off into q, S2 and V2.  With more than one k-slice each CTA
//     writes its R x C tile of partial U to scratch (study, row block,
//     column block, slice), fences, and takes a ticket on the integer
//     counter of its (study, row block, column block).  The slice that
//     arrives last adds the tiles in slice order (the same bits on every
//     run), sets that counter back to 0 and goes on alone; the others
//     leave.  A one-slice plan keeps U in registers and skips this step.
//     Scratch rather than a thread-block cluster summing in distributed
//     shared memory: a cluster holds at most 8 CTAs (portable), where the
//     plans reach 32 slices at n = 4096, and the round trip (about 19 MB
//     at S = 16, r = 48, n = 1024, 6 slices, beside the 64 MB of A the
//     launch streams) stays in L2.
//   * Local sums: everything before dvar is linear in U, and the gradient
//     is linear in the per-entry weight w = cdf a1 - 2 dvar a2, with
//     a1 = alpha amask s amask and a2 = U s amask.  So over its C columns
//     the column block's one remaining CTA forms, per row, q = sum U K,
//     S1 = sum a1, S2 = sum a2, gamma = sum K alpha, V1 = sum a1 x_buf and
//     V2 = sum a2 x_buf (mixed: x_buf's continuous block): 2 d + 4 floats,
//     by warp shuffles in a fixed order, then across the row group's warps
//     in warp order.  K and s of the CTA's own columns are recomputed
//     there.
//   * Two-level sum without float atomics: that CTA writes its partials to
//     scratch, fences, and takes a ticket on the integer counter of its
//     (study, row block).  The CTA that arrives last sums the partials of
//     every column block in a fixed tree order (`tree_sum`), then computes
//     var, sigma, Z, EI, cdf and dvar, writes ei and grad = (cdf S1 - 2
//     dvar S2) x - (cdf V1 - 2 dvar V2), and sets the counter back to 0,
//     so the scratch is ready for the next call on the stream.  No
//     grid-wide barrier: any batch runs.
// Shared memory is 36-40 KB a CTA at R = 8 whatever n is (four stages of
// the tile and the reduction buffers; about 24 KB at R = 16 and 70 KB at
// R = 4, where the A stages are 128 columns wide), so any n that device
// memory holds runs.  The tile (R), the k-tiles per slice, the shared
// bytes and the scratch sizes come from the plan; the entry checks the
// bytes against `layout`.  A row's sums do not depend on its place in its
// row block (each row's U, K and partials are its own; the warps of a row
// group sum in warp order), so a restart shard that starts mid-block sums
// its rows as the unsharded launch does.  Rounding differs from the
// earlier designs (shorter sums: 32-term chains of U, trees across CTAs),
// not the math.
// erfcf / expf / sqrtf are the accurate forms (no fast math), as the
// parity with the reference needs; Phi is 0.5 erfc(-Z / sqrt2), which
// keeps its lower tail where 1 + erf(Z / sqrt2) cancels to 0 and drops
// the gradient's mean term.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileOutputs = 512;   // R x C outputs of U per CTA
constexpr int kTk = 32;             // rows of A per staged k-tile
constexpr int kStages = 4;          // cp.async ring depth
constexpr int kMaxDynamic = 232448 - 1024;   // opt-in limit less static smem
constexpr int kMaxDevices = 64;
constexpr float kVarFloor = 1e-12f;
constexpr float kSqrt2 = 1.4142135623730951f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

// Offsets (in floats) of the dynamic shared memory of one CTA; each block
// starts on a 16-byte boundary.  Mirrored by kernels/acq.shared_bytes.
struct Layout {
  int as, xbs, ams, ks, xs, xks, cms, kms, ws, tot, total;
};

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

__host__ __device__ inline Layout layout(int rows, int cols, int d,
                                         bool mixed) {
  const int p = 2 * d + 4;
  Layout l{};
  int o = 0;
  l.as = o;  o += kStages * kTk * cols;          // A tiles
  l.xbs = o; o += kStages * round4(kTk * d);     // x_buf tiles
  l.ams = o; o += kStages * kTk;                 // amask tiles
  l.ks = o;  o += rows * kTk;                    // K[R, k-tile]
  l.xs = o;  o += round4(rows * d);              // candidates (mixed: xc)
  l.xks = o; o += mixed ? round4(rows * d) : 0;  // mixed: xk
  l.cms = o; o += mixed ? round4(d) : 0;         // mixed: cont_mask
  l.kms = o; o += mixed ? round4(d) : 0;         // mixed: cat_mask
  l.ws = o;  o += kWarps * 4 * p;                // per-warp row sums
  l.tot = o; o += rows * p;                      // the CTA's partials / totals
  l.total = o;
  return l;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

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

// z (and, mixed, cat) of candidate row i against train row xbj.
template <bool kMixed>
__device__ __forceinline__ float entry_z(const float* xs, const float* xks,
                                         const float* xx_s, const float* kk_s,
                                         int i, const float* xbj, float yy,
                                         float ll, const float* cms,
                                         const float* kms, int d, float rho,
                                         float* cat) {
  if constexpr (kMixed) {
    return mixed_z(xs + i * d, xks + i * d, xx_s[i], kk_s[i], xbj, yy, ll,
                   cms, kms, d, rho, cat);
  } else {
    *cat = 1.f;
    return matern_z(xs + i * d, xx_s[i], xbj, yy, d, rho);
  }
}

template <bool kMixed>
__device__ __forceinline__ void row_norms(const float* xbj, const float* cms,
                                          const float* kms, int d, float* yy,
                                          float* ll) {
  if constexpr (kMixed) {
    mixed_norms(xbj, cms, kms, d, yy, ll);
  } else {
    float a = 0.f;
    for (int c = 0; c < d; ++c) a += xbj[c] * xbj[c];
    *yy = a;
    *ll = 0.f;
  }
}

// Sum of v[0], v[stride], ..., v[(m - 1) stride] as a balanced binary tree
// over runs of 4, in a fixed order (the same bits on every run; error
// growing with log m, not m).  Loads bypass L1: the values come from
// other CTAs of this launch.
__device__ float tree_sum(const float* v, int m, size_t stride) {
  float stack[32];
  int top = 0;
  for (int blk = 0; blk * 4 < m; ++blk) {
    const int e1 = min(m, blk * 4 + 4);
    float s = __ldcg(v + (size_t)blk * 4 * stride);
    for (int e = blk * 4 + 1; e < e1; ++e) s += __ldcg(v + (size_t)e * stride);
    for (int c = blk; c & 1; c >>= 1) s = stack[--top] + s;
    stack[top++] = s;
  }
  float s = stack[--top];
  while (top > 0) s = stack[--top] + s;
  return s;
}

template <int R, bool kMixed>
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
                     float* __restrict__ part, float* __restrict__ utile,
                     int* __restrict__ counters, int r, int n, int d, int tps,
                     int vec, int mask_step) {
  constexpr int C = kTileOutputs / R;
  constexpr int kGroupWarps = C / 32;      // warps sharing a row group
  static_assert(C % 32 == 0 && (R / 4) * C == kThreads, "tile");
  extern __shared__ __align__(16) float smem[];
  __shared__ float xx_s[R], kk_s[R];
  __shared__ int last_s;
  const Layout lay = layout(R, C, d, kMixed);
  float* as = smem + lay.as;
  float* xbs = smem + lay.xbs;
  float* ams = smem + lay.ams;
  float* ks = smem + lay.ks;
  float* xs = smem + lay.xs;
  float* xks = smem + lay.xks;
  float* cms = smem + lay.cms;
  float* kms = smem + lay.kms;
  float* ws = smem + lay.ws;
  float* tot = smem + lay.tot;
  const int xb_stride = round4(kTk * d);
  const int P = 2 * d + 4;   // q, S1, S2, gamma, V1[d], V2[d]

  // blockIdx.x = k-slice * column blocks + column block.
  const int ncb = (n + C - 1) / C, nk = (n + kTk - 1) / kTk;
  const int cb = blockIdx.x % ncb, ksl = blockIdx.x / ncb;
  const int rb = blockIdx.y, b = blockIdx.z;
  const int nrb = gridDim.y, nsl = gridDim.x / ncb;
  x += (size_t)b * r * d;
  xb += (size_t)b * n * d;
  amask += (size_t)b * n;
  alpha += (size_t)b * n;
  abuf += (size_t)b * n * n;
  ei_out += (size_t)b * r;
  grad_out += (size_t)b * r * d;
  const float sigma2 = sigma2_p[b], rho = rho_p[b], shift = shift_p[b];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = rb * R, j0 = cb * C;
  const int col = tid % C, rg = tid / C;   // U: rows 4 rg .. 4 rg + 3
  const int t0 = ksl * tps, t1 = min(nk, t0 + tps);

  // Candidate rows (mixed: split by the masks) and their norms.
  if constexpr (kMixed) {
    for (int c = tid; c < d; c += kThreads) {
      cms[c] = cont_mask[(size_t)b * mask_step + c];
      kms[c] = cat_mask[(size_t)b * mask_step + c];
    }
    __syncthreads();
  }
  for (int e = tid; e < R * d; e += kThreads) {
    const float v = (i0 + e / d < r) ? x[(size_t)i0 * d + e] : 0.f;
    if constexpr (kMixed) {
      xs[e] = v * cms[e % d];
      xks[e] = v * kms[e % d];
    } else {
      xs[e] = v;
    }
  }
  __syncthreads();
  if (tid < R) {
    float acc = 0.f;
    for (int c = 0; c < d; ++c) acc += xs[tid * d + c] * xs[tid * d + c];
    xx_s[tid] = acc;
    if constexpr (kMixed) {
      float acck = 0.f;
      for (int c = 0; c < d; ++c) acck += xks[tid * d + c] * xks[tid * d + c];
      kk_s[tid] = acck;
    }
  }

  // Stage k-tile t: A[k-tile, j0 .. j0 + C), x_buf and amask rows;
  // zero-filled past n.
  auto issue = [&](int t) {
    const int s = (t - t0) % kStages, k0 = t * kTk;
    float* at = as + s * kTk * C;
    if (vec) {
      for (int e = tid; e < kTk * C / 4; e += kThreads) {
        const int kk = e / (C / 4), c4 = (e % (C / 4)) * 4;
        const int k = k0 + kk, j = j0 + c4;
        const bool ok = k < n && j < n;
        cp_async16(at + kk * C + c4, ok ? abuf + (size_t)k * n + j : abuf,
                   ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kTk * C; e += kThreads) {
        const int k = k0 + e / C, j = j0 + e % C;
        const bool ok = k < n && j < n;
        cp_async4(at + e, ok ? abuf + (size_t)k * n + j : abuf, ok ? 4 : 0);
      }
    }
    float* xt = xbs + s * xb_stride;
    const size_t lim = (size_t)n * d;
    for (int e = tid; e < kTk * d; e += kThreads) {
      const size_t idx = (size_t)k0 * d + e;
      cp_async4(xt + e, idx < lim ? xb + idx : xb, idx < lim ? 4 : 0);
    }
    if (tid < kTk) {
      const int k = k0 + tid;
      cp_async4(ams + s * kTk + tid, k < n ? amask + k : amask, k < n ? 4 : 0);
    }
  };

  for (int t = t0; t < t0 + kStages - 1; ++t) {
    if (t < t1) issue(t);
    cp_async_commit();
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};   // this slice's U[4 rg + q, j0 + col]
  for (int t = t0; t < t1; ++t) {
    const int s = (t - t0) % kStages;
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile t landed; every thread is done with t - 1
    if (t + kStages - 1 < t1) issue(t + kStages - 1);
    cp_async_commit();
    {  // K[R, k-tile]: lane = k, warp w takes rows w, w + 4, ...
      const float* xbk = xbs + s * xb_stride + lane * d;
      const float am = ams[s * kTk + lane];
      float yy, ll;
      row_norms<kMixed>(xbk, cms, kms, d, &yy, &ll);
#pragma unroll
      for (int m = 0; m < R / 4; ++m) {
        const int i = warp + 4 * m;
        float cat;
        const float z = entry_z<kMixed>(xs, xks, xx_s, kk_s, i, xbk, yy, ll,
                                        cms, kms, d, rho, &cat);
        float k = sigma2 * (1.f + z + z * z / 3.f) * expf(-z);
        if constexpr (kMixed) k = k * cat;
        ks[i * kTk + lane] = k * am;
      }
    }
    __syncthreads();
    const float* at = as + s * kTk * C + col;
    const float* kr = ks + 4 * rg * kTk;
    float u[4] = {0.f, 0.f, 0.f, 0.f};   // this k-tile's terms
#pragma unroll
    for (int kk = 0; kk < kTk; kk += 4) {
      float a[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = at[(kk + e) * C];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 kv = *reinterpret_cast<const float4*>(kr + q * kTk + kk);
        u[q] = fmaf(kv.x, a[0], u[q]);
        u[q] = fmaf(kv.y, a[1], u[q]);
        u[q] = fmaf(kv.z, a[2], u[q]);
        u[q] = fmaf(kv.w, a[3], u[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] += u[q];
  }

  // With more than one k-slice: the column block's slices meet in
  // scratch and the last to arrive sums U in slice order.
  if (nsl > 1) {
    float* ut = utile + (((size_t)b * nrb + rb) * ncb + cb) * nsl * R * C;
    float* mine = ut + (size_t)ksl * R * C + 4 * rg * C + col;
#pragma unroll
    for (int q = 0; q < 4; ++q) mine[q * C] = acc[q];
    __threadfence();
    __syncthreads();
    int* ticket = counters + (size_t)gridDim.z * nrb
                  + ((size_t)b * nrb + rb) * ncb + cb;
    if (tid == 0) last_s = atomicAdd(ticket, 1) == nsl - 1;
    __syncthreads();
    if (!last_s) return;
    __threadfence();
    const float* u0 = ut + 4 * rg * C + col;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float s = __ldcg(u0 + q * C);
      for (int sl = 1; sl < nsl; ++sl)
        s += __ldcg(u0 + (size_t)sl * R * C + q * C);
      acc[q] = s;
    }
    if (tid == 0) *ticket = 0;
  }

  // Local sums over this CTA's columns from the whole U.  Column j's K
  // and s are recomputed from x_buf[j] (the same arithmetic as the
  // streamed K).
  const int j = j0 + col;
  const bool jv = j < n;
  const float amj = jv ? amask[j] : 0.f;
  const float alj = jv ? alpha[j] : 0.f;
  const float* xbj = xb + (size_t)(jv ? j : 0) * d;
  const float sfac = -sigma2 * (5.f / (3.f * rho * rho));
  float yy, ll;
  row_norms<kMixed>(xbj, cms, kms, d, &yy, &ll);
  float q[4], a1[4], a2[4], g[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float cat;
    const float z = entry_z<kMixed>(xs, xks, xx_s, kk_s, 4 * rg + e, xbj, yy,
                                    ll, cms, kms, d, rho, &cat);
    float k = sigma2 * (1.f + z + z * z / 3.f) * expf(-z);
    if constexpr (kMixed) k = k * cat;
    const float km = k * amj;
    const float s_am = sfac * (1.f + z) * expf(-z) * cat * amj;
    q[e] = acc[e] * km;
    a1[e] = (alj * amj) * s_am;
    a2[e] = acc[e] * s_am;
    g[e] = km * alj;
  }
  float* wrow = ws + warp * 4 * P;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float vq = repro::warp_sum(q[e]);
    const float v1 = repro::warp_sum(a1[e]);
    const float v2 = repro::warp_sum(a2[e]);
    const float vg = repro::warp_sum(g[e]);
    if (lane == 0) {
      wrow[e * P] = vq;
      wrow[e * P + 1] = v1;
      wrow[e * P + 2] = v2;
      wrow[e * P + 3] = vg;
    }
  }
  for (int c = 0; c < d; ++c) {
    float xv = xbj[c];
    if constexpr (kMixed) xv = xv * cms[c];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v1 = repro::warp_sum(a1[e] * xv);
      const float v2 = repro::warp_sum(a2[e] * xv);
      if (lane == 0) {
        wrow[e * P + 4 + c] = v1;
        wrow[e * P + 4 + d + c] = v2;
      }
    }
  }
  __syncthreads();
  // Partials in (study, row block, column block) order.
  float* prow = part + (size_t)(b * nrb + rb) * ncb * R * P;
  float* pcta = prow + (size_t)cb * R * P;
  for (int e = tid; e < R * P; e += kThreads) {
    const int i = e / P, p = e % P;
    const float* w0 = ws + ((i / 4) * kGroupWarps * 4 + i % 4) * P + p;
    float v = w0[0];
    for (int w2 = 1; w2 < kGroupWarps; ++w2) v += w0[w2 * 4 * P];
    pcta[e] = v;
  }

  // Ticket: the last CTA of the (study, row block) finishes its rows.
  __threadfence();
  __syncthreads();
  int* counter = counters + b * nrb + rb;
  if (tid == 0) last_s = atomicAdd(counter, 1) == ncb - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  for (int e = tid; e < R * P; e += kThreads)
    tot[e] = tree_sum(prow + e, ncb, (size_t)R * P);
  __syncthreads();
  if (tid < R && i0 + tid < r) {
    const float* tr = tot + tid * P;
    const float raw_var = sigma2 - tr[0];
    const float var = fmaxf(raw_var, kVarFloor);
    const float sig = sqrtf(var);
    const float gam = tr[3] + shift;
    const float zs = gam / fmaxf(sig, 1e-12f);
    const float cdf = 0.5f * erfcf(-zs / kSqrt2);  // accurate lower tail
    const float pdf = expf(-0.5f * zs * zs) * kInvSqrt2Pi;
    ei_out[i0 + tid] = fmaxf(gam * cdf + sig * pdf, 0.f);
    const float dvar = raw_var > kVarFloor ? pdf / (2.f * sig) : 0.f;
    const float rs = cdf * tr[1] - 2.f * dvar * tr[2];
    for (int c = 0; c < d; ++c)
      grad_out[(size_t)(i0 + tid) * d + c] =
          rs * xs[tid * d + c] - (cdf * tr[4 + c] - 2.f * dvar * tr[4 + d + c]);
  }
  if (tid == 0) *counter = 0;
}

struct Args {
  const float *x, *xb, *amask, *alpha, *abuf, *cont_mask, *cat_mask;
  const float *sigma2, *rho, *shift;
  float *ei, *grad, *part, *utile;
  int* counters;
  int batch, r, n, d, tps, shared, mask_step;
};

template <int R, bool kMixed>
int launch(const Args& a, cudaStream_t st) {
  // The opt-in shared memory limit, set once per device.
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(fused_ei_grad_kernel<R, kMixed>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxDynamic);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set[dev] = true;
  }
  constexpr int C = kTileOutputs / R;
  const int nk = (a.n + kTk - 1) / kTk;
  const dim3 grid((a.n + C - 1) / C * ((nk + a.tps - 1) / a.tps),
                  (a.r + R - 1) / R, a.batch);
  const int vec = a.n % 4 == 0 && reinterpret_cast<uintptr_t>(a.abuf) % 16 == 0;
  fused_ei_grad_kernel<R, kMixed><<<grid, kThreads, a.shared, st>>>(
      a.x, a.xb, a.amask, a.alpha, a.abuf, a.cont_mask, a.cat_mask, a.sigma2,
      a.rho, a.shift, a.ei, a.grad, a.part, a.utile, a.counters, a.r, a.n,
      a.d, a.tps, vec, a.mask_step);
  return static_cast<int>(cudaGetLastError());
}

// The compiled tiles: R = 4, 8 and 16 candidate rows; any other R is
// refused.
template <bool kMixed>
int launch_rows(const Args& a, int rows, cudaStream_t st) {
  if (a.batch == 0 || a.r == 0) return 0;
  if (rows != 4 && rows != 8 && rows != 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int want = static_cast<int>(
      sizeof(float) * layout(rows, kTileOutputs / rows, a.d, kMixed).total);
  if (a.n < 1 || a.d < 1 || a.tps < 1 || a.batch > 65535 ||
      (a.r + rows - 1) / rows > 65535 || a.shared != want ||
      a.shared > kMaxDynamic || (a.mask_step != 0 && a.mask_step != a.d))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (rows) {
    case 4: return launch<4, kMixed>(a, st);
    case 8: return launch<8, kMixed>(a, st);
    default: return launch<16, kMixed>(a, st);
  }
}

}  // namespace

// The float form.  `rows` is the tile's candidate rows (4, 8 or 16; the
// tile has 512 / rows columns), `tps` the k-tiles a CTA walks
// and `shared` its dynamic shared bytes, all from kernels/acq.launch_plan;
// `part`, `utile` and `counters` are the call's scratch (the column sums
// of every (study, row block, column block); the partial U tile of every
// CTA when k is split, else unused; one int per (study, row block), then,
// when k is split, one per (study, row block, column block), 0 on entry
// and left 0).
REPRO_EXPORT int repro_fused_ei_grad(
    const float* x, const float* xb, const float* amask, const float* alpha,
    const float* abuf, const float* sigma2, const float* rho,
    const float* shift, float* ei, float* grad, float* part, float* utile,
    int* counters, int batch, int r, int n, int d, int rows, int tps,
    int shared, void* stream) {
  const Args a{x, xb, amask, alpha, abuf, nullptr, nullptr, sigma2, rho,
               shift, ei, grad, part, utile, counters, batch, r, n, d, tps,
               shared, 0};
  return launch_rows<false>(a, rows, static_cast<cudaStream_t>(stream));
}

// The mixed form: as repro_fused_ei_grad, plus the type masks, (d,) for
// every study of the batch (mask_step = 0) or one (d,) pair a study at a
// step of d floats (mask_step = d).
REPRO_EXPORT int repro_fused_ei_grad_mixed(
    const float* x, const float* xb, const float* cont_mask,
    const float* cat_mask, const float* amask, const float* alpha,
    const float* abuf, const float* sigma2, const float* rho,
    const float* shift, float* ei, float* grad, float* part, float* utile,
    int* counters, int batch, int r, int n, int d, int rows, int tps,
    int shared, int mask_step, void* stream) {
  const Args a{x, xb, amask, alpha, abuf, cont_mask, cat_mask, sigma2, rho,
               shift, ei, grad, part, utile, counters, batch, r, n, d, tps,
               shared, mask_step};
  return launch_rows<true>(a, rows, static_cast<cudaStream_t>(stream));
}
