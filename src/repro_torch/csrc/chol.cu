// Blocked right-looking lower Cholesky factor of an (n, n) matrix, in place,
// with an optional leading batch axis, and the diagonal clamp
// l_jj = sqrt(max(a_jj - sum_k l_jk^2, 1e-12)) of the reference, so a matrix
// that is not positive definite still yields finite values.
//
// Replaces: src/repro/kernels/chol.py:_chol_kernel (with _chol_unblocked and
// _inv_lower), reached through cholesky_pallas.
//
// What bounds it on the H100: not the flops.  At n = 1024 the n^3 / 3 flops
// take 5 us at the fp32 peak; the factor is a chain of n / 32 dependent
// block columns, each a 32 x 32 diagonal factor and inverse that nothing can
// overlap, then a panel and a trailing update that wait for it.  The earlier
// design ran each link as three launches from a host loop (96 launches at
// n = 1024), with the diagonal step on one warp reading shared memory
// serially: 54% of a call was that warp and 23% the gaps between launches.
//
// Design: one persistent cooperative launch per call.  The grid (as many
// CTAs as the card holds at once, cudaOccupancyMaxActiveBlocksPerMultiprocessor
// x SMs) is split into groups of `ctas` CTAs; group g factors matrices
// g, g + groups, ...  A group synchronizes on its own barrier counter and
// flag in the scratch (release / acquire at device scope, a bounded spin
// that traps instead of hanging), so the matrices of a batch never wait on
// each other.  Per 32-wide block column, one barrier:
//   * CTA 0 carries the chain alone: it updates the next 32 x 32 diagonal
//     block by the block column just finished, factors and inverts it on one
//     warp in registers (lane = row, each row fully unrolled, each running
//     sum gathered as soon as its term is known, divisions as multiplies by
//     a double reciprocal that round the same way), publishes the inverse by
//     raising the flag, and stores the factor;
//   * meanwhile CTAs 1 .. ctas-1 take the live 64 x 64 lower tiles of the
//     trailing matrix round-robin (A_IJ -= P_I P_J^T, fp32 FMA from
//     shared-memory tiles into 4 x 4 registers a thread), then the owner of
//     tile (c, 0) waits for the flag and turns the 64 rows of chunk c of the
//     next panel into P = A inv(L_kk)^T: a product, as on the TPU.
// The strict upper triangle is zeroed once, at the start, by the group.
// Each output entry's arithmetic (tile origin, summation order, where the
// clamp applies) depends on n alone, never on the CTA or the group size, so
// a batched call equals single calls bit for bit; it is also, operation for
// operation, that of the earlier three-kernel version (the reference's
// Crout loop, row substitution and blocked products), so the factor did not
// change with the schedule.  fp32 throughout, no tensor cores, like the
// reference.
#include <cuda/atomic>

#include "common.cuh"

namespace {

constexpr int kNb = 32;            // block-column width
constexpr int kTile = 64;          // trailing-update tile and panel chunk
constexpr int kThreads = 256;
constexpr int kSyncInts = 64;      // per group: barrier counter, diag flag
constexpr int kFlag = 32;          // the flag's own 128-byte line
constexpr unsigned kSpinLimit = 1u << 22;   // seconds of polls, then trap

struct __align__(16) Smem {
  float pt[2][kNb][kTile + 4];  // P_I^T, P_J^T (k-major) of a trailing tile
  float raw[kTile][kNb + 4];    // panel rows before the product
  float inv[kNb][kNb + 1];      // inv(L_kk)
  float dg[kNb][kNb + 1];       // the next diagonal block, then its factor
};

using DeviceInt = cuda::atomic_ref<int, cuda::thread_scope_device>;

// Thread 0 polls `word` until it reaches `value` (acquire), then the CTA
// goes on; a poll count far beyond any real wait traps instead of hanging.
__device__ __forceinline__ void wait_for(int* word, int value) {
  if (threadIdx.x == 0) {
    DeviceInt w(*word);
    unsigned spins = 0;
    while (w.load(cuda::memory_order_acquire) < value) {
      __nanosleep(32);
      if (++spins == kSpinLimit) __trap();
    }
  }
  __syncthreads();
}

// Every CTA of the group waits here until all `ctas` have arrived.  Writes
// before it are visible to every CTA of the group after it.
__device__ __forceinline__ void group_barrier(int* sync, int ctas, int& target) {
  __syncthreads();
  if (ctas == 1) return;
  target += ctas;
  if (threadIdx.x == 0) DeviceInt(*sync).fetch_add(1, cuda::memory_order_release);
  wait_for(sync, target);
}

// x / y correctly rounded, as IEEE division gives it, without the per-lane
// branch to its slow path: x times the correctly rounded double reciprocal
// of y, rounded once to float.  The double product is within 2^-52 of x / y,
// and a quotient of two floats is never closer than about 2^-49 (relative)
// to a rounding boundary of float, so the float rounding is the same.
__device__ __forceinline__ float div_rn(float x, double rcp_y) {
  return static_cast<float>(static_cast<double>(x) * rcp_y);
}

// Warp 0: factor the diagonal block at (s, s) held in sm.dg (lower part
// valid for rows and columns < nb; the rest is an identity block, factored
// along and never stored), publish its inverse in `inv` by raising the
// group's flag to `factored`, then write the factor into `a`.
//
// The arithmetic is the reference's Crout loop (_chol_unblocked) and row
// substitution (_inv_lower) in their own order: l_ij = (a_ij - sum_k<j
// l_ik l_jk) / l_jj with the sum in ascending k, x_i = (e_i - sum_k<i l_ik
// x_k) / l_ii.  Only the schedule differs from a serial loop: each lane
// (a row) keeps its running sums in registers and adds the term of column k
// as soon as column k is known, so the chain from one pivot to the next is
// a shuffle, the clamp, the square root, one reciprocal and one multiply.
__device__ void factor_diag(Smem& sm, float* a, int n, int s, float* inv,
                            int* flag, int factored) {
  const int lane = threadIdx.x;
  const int nb = min(kNb, n - s);
  // a0: the row as given; acc[c]: sum_k l_lane,k l_c,k so far.
  float a0[kNb], acc[kNb], dg[kNb];
#pragma unroll
  for (int c = 0; c < kNb; ++c) {
    a0[c] = (lane < nb && c < nb) ? (c <= lane ? sm.dg[lane][c] : 0.f)
                                  : (lane == c ? 1.f : 0.f);
    dg[c] = c < nb ? sm.dg[c][c] : 1.f;
    acc[c] = 0.f;
  }
  __syncwarp();
  double rcp[kNb];   // 1 / l_jj
#pragma unroll
  for (int j = 0; j < kNb; ++j) {
    const float ljj = sqrtf(fmaxf(dg[j] - __shfl_sync(repro::kFullMask, acc[j], j), 1e-12f));
    rcp[j] = __drcp_rn(static_cast<double>(ljj));
    const float q = div_rn(a0[j] - acc[j], rcp[j]);
    const float l = lane > j ? q : (lane == j ? ljj : 0.f);
    sm.dg[lane][j] = l;
#pragma unroll
    for (int c = j + 1; c < kNb; ++c)
      acc[c] = fmaf(l, __shfl_sync(repro::kFullMask, l, c), acc[c]);
  }
  __syncwarp();
  // Inverse, lane = column: x_i = (e_i - acc_i) / l_ii, the sum acc_i
  // gathered term by term as the rows k < i become known.
  float x[kNb];
#pragma unroll
  for (int i = 0; i < kNb; ++i) x[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kNb; ++i) {
    x[i] = div_rn((i == lane ? 1.f : 0.f) - x[i], rcp[i]);
#pragma unroll
    for (int k = i + 1; k < kNb; ++k) x[k] = fmaf(sm.dg[k][i], x[i], x[k]);
  }
#pragma unroll
  for (int i = 0; i < kNb; ++i) inv[i * kNb + lane] = x[i];
  __syncwarp();
  if (lane == 0) DeviceInt(*flag).store(factored, cuda::memory_order_release);
  for (int rr = 0; rr < nb; ++rr)
    if (lane < nb) a[(size_t)(s + rr) * n + s + lane] = lane <= rr ? sm.dg[rr][lane] : 0.f;
  __syncwarp();
}

// Rows [r0, r1) (at most 64) of the panel in columns col .. col + 31 into
// sm.raw: the rows before the product.
__device__ void load_raw(const float* a, int n, int r0, int r1, int col, Smem& sm) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int q = 0; q < kTile * kNb / kThreads; ++q) {
    const int idx = tid + q * kThreads, rr = idx / kNb, k = idx % kNb;
    sm.raw[rr][k] = r0 + rr < r1 ? __ldcg(&a[(size_t)(r0 + rr) * n + col + k]) : 0.f;
  }
}

// The rows in sm.raw become A inv^T in `a`, the product the reference uses
// in place of a triangular solve.
__device__ void panel_chunk(float* a, int n, int r0, int r1, int col,
                            const float* inv, Smem& sm) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int q = 0; q < kNb * kNb / kThreads; ++q) {
    const int idx = tid + q * kThreads;
    sm.inv[idx / kNb][idx % kNb] = __ldcg(&inv[idx]);
  }
  __syncthreads();
  const int c = tid & 31, w = tid >> 5;   // lane = column, warp w: rows w + 8q
  float ic[kNb];
#pragma unroll
  for (int k = 0; k < kNb; ++k) ic[k] = sm.inv[c][k];
#pragma unroll
  for (int q = 0; q < kTile / 8; ++q) {
    const int rr = w + 8 * q;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kNb; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(&sm.raw[rr][k]);
      acc = fmaf(v.x, ic[k], acc);
      acc = fmaf(v.y, ic[k + 1], acc);
      acc = fmaf(v.z, ic[k + 2], acc);
      acc = fmaf(v.w, ic[k + 3], acc);
    }
    if (r0 + rr < r1) a[(size_t)(r0 + rr) * n + col + c] = acc;
  }
  __syncthreads();
}

// The lower 32 x 32 diagonal block at (e, e) after the update by the block
// column e - 32, into sm.dg: what CTA 0 factors next.  Tile (0, 0), which
// holds the block, skips these entries, so the factor written there stays.
__device__ void diag_update(const float* a, int n, int e, Smem& sm) {
  const int tid = threadIdx.x;
  const int nb = min(kNb, n - e);
#pragma unroll
  for (int q = 0; q < kNb * kNb / kThreads; ++q) {
    const int idx = tid + q * kThreads, rr = idx / kNb, k = idx % kNb;
    sm.raw[rr][k] = rr < nb ? __ldcg(&a[(size_t)(e + rr) * n + e - kNb + k]) : 0.f;
    sm.dg[rr][k] = (rr < nb && k <= rr) ? __ldcg(&a[(size_t)(e + rr) * n + e + k]) : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kNb * kNb / kThreads; ++q) {
    const int idx = tid + q * kThreads, rr = idx / kNb, cc = idx % kNb;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kNb; k += 4) {
      const float4 x = *reinterpret_cast<const float4*>(&sm.raw[rr][k]);
      const float4 y = *reinterpret_cast<const float4*>(&sm.raw[cc][k]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
      acc = fmaf(x.z, y.z, acc);
      acc = fmaf(x.w, y.w, acc);
    }
    if (cc <= rr) sm.dg[rr][cc] -= acc;
  }
  __syncthreads();
}

// One 64 x 64 lower tile (I, J) of the trailing matrix at (e, e):
// A_IJ -= P_I P_J^T with P = A[:, e-32:e], final already.  Thread (ty, tx)
// owns rows 4 ty .. 4 ty + 3 and columns 4 tx .. 4 tx + 3 of the tile, read
// and written as float4 where the rows allow it.  Tile (0, 0) leaves the
// diagonal block at (e, e) to diag_update and the factor.
__device__ void trailing_tile(float* a, int n, int e, int I, int J, Smem& sm) {
  const int tid = threadIdx.x;
  const int s = e - kNb;
  const int i0 = e + I * kTile, j0 = e + J * kTile;
  const bool diag = I == J, vec = (n & 3) == 0;
  const int tx = tid % 16, ty = tid / 16;
  const int gj0 = j0 + 4 * tx;
  const bool skip = I == 0 && J == 0 && gj0 < e + kNb;   // the diagonal block
  float cur[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int gi = i0 + 4 * ty + u;
    if (skip && gi < e + kNb) {
#pragma unroll
      for (int v = 0; v < 4; ++v) cur[u][v] = 0.f;
    } else if (vec && gi < n && gj0 + 3 <= gi) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(&a[(size_t)gi * n + gj0]));
      cur[u][0] = v.x; cur[u][1] = v.y; cur[u][2] = v.z; cur[u][3] = v.w;
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v)
        cur[u][v] = (gi < n && gj0 + v <= gi) ? __ldcg(&a[(size_t)gi * n + gj0 + v]) : 0.f;
    }
  }
#pragma unroll
  for (int q = 0; q < kTile * kNb / kThreads; ++q) {
    const int idx = tid + q * kThreads, rr = idx / kNb, k = idx % kNb;
    sm.pt[0][k][rr] = i0 + rr < n ? __ldcg(&a[(size_t)(i0 + rr) * n + s + k]) : 0.f;
    if (!diag)
      sm.pt[1][k][rr] = j0 + rr < n ? __ldcg(&a[(size_t)(j0 + rr) * n + s + k]) : 0.f;
  }
  __syncthreads();
  const float (*pj)[kTile + 4] = sm.pt[diag ? 0 : 1];
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
#pragma unroll 8
  for (int k = 0; k < kNb; ++k) {
    const float4 x4 = *reinterpret_cast<const float4*>(&sm.pt[0][k][4 * ty]);
    const float4 y4 = *reinterpret_cast<const float4*>(&pj[k][4 * tx]);
    const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
    const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(xv[u], yv[v], acc[u][v]);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int gi = i0 + 4 * ty + u;
    if (gi >= n || (skip && gi < e + kNb)) continue;
    if (vec && gj0 + 3 <= gi) {
      const float4 v = make_float4(cur[u][0] - acc[u][0], cur[u][1] - acc[u][1],
                                   cur[u][2] - acc[u][2], cur[u][3] - acc[u][3]);
      *reinterpret_cast<float4*>(&a[(size_t)gi * n + gj0]) = v;
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (gj0 + v <= gi) a[(size_t)gi * n + gj0 + v] = cur[u][v] - acc[u][v];
    }
  }
  __syncthreads();
}

// The panel of the block column at `e` (rows e + 32 .. n, in 64-row chunks
// c aligned with the trailing tiles at origin e): chunk c goes to the CTA
// that updated its rows, the owner of tile (c, 0), once the group's flag
// says the diagonal block's inverse is ready.
__device__ void panel(float* a, int n, int e, int rank, int ctas,
                      const float* inv, int* flag, int factored, Smem& sm) {
  bool waited = rank == 0;   // CTA 0 wrote the inverse itself
  // Tile t goes to CTA 1 + t mod (ctas - 1) (all to CTA 0 if it is alone),
  // so CTA 0 carries the diagonal chain alone; `owner` follows the tile
  // t = c (c + 1) / 2 of chunk c.
  for (int c = 0, owner = ctas > 1 ? 1 : 0; e + kTile * c < n; ++c) {
    if (ctas > 1) {
      owner += c;
      while (owner >= ctas) owner -= ctas - 1;
    }
    if (owner != rank) continue;
    const int r0 = max(e + kTile * c, e + kNb), r1 = min(e + kTile * (c + 1), n);
    if (r0 >= r1) continue;
    load_raw(a, n, r0, r1, e, sm);   // the CTA's own rows: final already
    if (!waited) {
      wait_for(flag, factored);
      waited = true;
    }
    panel_chunk(a, n, r0, r1, e, inv, sm);
  }
}

__global__ void __launch_bounds__(kThreads)
chol_kernel(float* a, float* scratch, int batch, int n, int ctas) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int groups = gridDim.x / ctas;
  const int g = blockIdx.x / ctas, rank = blockIdx.x % ctas;
  int* sync = reinterpret_cast<int*>(scratch) + g * kSyncInts;
  int* flag = sync + kFlag;
  float* inv = scratch + groups * kSyncInts + g * kNb * kNb;
  int target = 0, factored = 0;
  for (int m = g; m < batch; m += groups) {
    float* am = a + (size_t)m * n * n;
    if (m != g) group_barrier(sync, ctas, target);   // the scratch is reused
    ++factored;
    if (rank == 0) {
      const int nb = min(kNb, n);
      for (int idx = tid; idx < kNb * kNb; idx += kThreads) {
        const int r = idx / kNb, c = idx % kNb;
        sm.dg[r][c] = (r < nb && c <= r) ? __ldcg(&am[(size_t)r * n + c]) : 0.f;
      }
      __syncthreads();
      if (tid < 32) factor_diag(sm, am, n, 0, inv, flag, factored);
      __syncthreads();
    }
    for (int i = rank; i < n; i += ctas)
      for (int j = i + 1 + tid; j < n; j += kThreads) am[(size_t)i * n + j] = 0.f;
    panel(am, n, 0, rank, ctas, inv, flag, factored, sm);
    group_barrier(sync, ctas, target);

    for (int e = kNb; e < n; e += kNb) {   // block column e - 32 is final
      const int mt = (n - e + kTile - 1) / kTile;
      const int ntiles = mt * (mt + 1) / 2;
      ++factored;
      if (rank == 0) {   // lookahead: the next diagonal block first
        diag_update(am, n, e, sm);
        if (tid < 32) factor_diag(sm, am, n, e, inv, flag, factored);
        __syncthreads();
      }
      const int first = ctas > 1 ? rank - 1 : 0, stride = ctas > 1 ? ctas - 1 : 1;
      for (int t = rank == 0 && ctas > 1 ? ntiles : first; t < ntiles; t += stride) {
        // Tile t = I (I + 1) / 2 + J of the lower triangle, row by row.
        int I = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
        while (I * (I + 1) / 2 > t) --I;
        while ((I + 1) * (I + 2) / 2 <= t) ++I;
        trailing_tile(am, n, e, I, t - I * (I + 1) / 2, sm);
      }
      panel(am, n, e, rank, ctas, inv, flag, factored, sm);
      if (e + kNb < n) group_barrier(sync, ctas, target);
    }
  }
}

}  // namespace

// CTAs of the factor kernel the current device holds at once (occupancy at
// kThreads threads and the kernel's static shared memory, times the SMs).
REPRO_EXPORT int repro_cholesky_resident(int* ctas) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chol_kernel, kThreads, 0);
  *ctas = per_sm * sms;
  return static_cast<int>(err);
}

// Factors the batch of (n, n) matrices in `a` in place (lower factor, upper
// triangle zeroed) with one cooperative launch of groups x ctas CTAs.
// `scratch` holds 64 ints per group (barrier counter and flag, zeroed here),
// then 32 x 32 floats per group (the current diagonal block's inverse).
REPRO_EXPORT int repro_cholesky(float* a, float* scratch, int batch, int n,
                                int groups, int ctas, void* stream) {
  if (batch == 0 || n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(int) * kSyncInts * groups, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&a, &scratch, &batch, &n, &ctas};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(chol_kernel),
                                    dim3(groups * ctas), dim3(kThreads), args, 0, st);
  return static_cast<int>(err);
}
