// Mixed-space gram  K[i, j] = sigma2 (1 + z + z^2 / 3) exp(-z) cat,
//   z   = sqrt(5) |xc_i - yc_j| / rho,        xc = x * cont_mask
//   cat = exp(-0.5 |xk_i - yk_j|^2 / rho),    xk = x * cat_mask
// for x (n, d), y (m, d) and the two (d,) 0/1 type masks, over a batch of
// matrices with per-matrix sigma2 and rho (and per-matrix masks at a step
// of d floats, mask_step = d, or one pair for the batch, mask_step = 0),
// and in the masked form the identity-padded K + noise2 I.  The categorical factor divides by rho,
// not rho^2: that is the reference's definition.
//
// Replaces: src/repro/kernels/mixed.py:_mixed_tile_kernel (reached through
// _mixed_pallas_raw / mixed_gram_pallas, batched over a study axis by
// pallas_call's batching rule under ops.masked_gram's vmap).
//
// What bounds it on the H100: the bytes of the output, as for the Matérn
// gram; the append column is bound by the launch.  The design is
// gram.cuh's, instantiated with kMixed: the masks are staged in shared
// memory once a feature pass and split each row as it is read (the
// reference splits x and y into four operands before its call), and the
// categorical squared distance is kept beside the distance, shared by
// every matrix of a batch that shares x and the masks.  One launch a call; the bits of
// the earlier 16 x 16 kernel.
#include "gram.cuh"

REPRO_EXPORT int repro_mixed_gram(
    const float* x, const float* y, const float* cont_mask,
    const float* cat_mask, int mask_step, const float* sigma2,
    const float* rho, const float* noise2, const int* n_active, float* out, int batch, int n,
    int m, int d, long long x_row, long long x_batch, long long y_row,
    long long y_batch, int s2_step, int rho_step, int noise_step, int n_step,
    int n_fixed, int symmetric, int layout, int per_group, int tiles_m,
    int grid_x, int grid_y, void* stream) {
  const repro::gram::Args a{x, y, cont_mask, cat_mask, sigma2, rho, noise2,
                            n_active, out, x_row, x_batch, y_row, y_batch,
                            batch, n, m, d, s2_step, rho_step, noise_step,
                            n_step, n_fixed, symmetric, per_group, tiles_m,
                            mask_step};
  return repro::gram::launch<true>(a, layout, grid_x, grid_y, stream);
}
