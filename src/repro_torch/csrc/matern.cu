// Matérn-2.5 gram  K[i, j] = sigma2 (1 + z + z^2 / 3) exp(-z),
// z = sqrt(5) |x_i - y_j| / rho, for x (n, d) and y (m, d), over a batch of
// matrices with per-matrix sigma2 and rho, and in the masked form the
// identity-padded K + noise2 I of a lag event or a refactor.
//
// Replaces: src/repro/kernels/matern.py:_matern_tile_kernel (reached through
// _matern_pallas_raw / matern52_gram_pallas, batched over a study axis by
// pallas_call's batching rule under ops.masked_gram's vmap).
//
// What bounds it on the H100: the bytes of the output (4 MB a 1024^2 Gram,
// 75.5 MB for the lag refit's 18); the append column (n x 1) is bound by
// the launch.  The design (gram.cuh): 64 x 64 tiles with 16-byte stores,
// norms once per row, the lower tile pairs only when y is x (the mirror
// through shared memory), one distance for every matrix of a batch that
// shares x, the masked form fused, and a one-thread-per-row layout for
// the column.  One launch a call; the bits of the earlier 16 x 16 kernel.
#include "gram.cuh"

REPRO_EXPORT int repro_matern52_gram(
    const float* x, const float* y, const float* sigma2, const float* rho,
    const float* noise2, const int* n_active, float* out, int batch, int n,
    int m, int d, long long x_row, long long x_batch, long long y_row,
    long long y_batch, int s2_step, int rho_step, int noise_step, int n_step,
    int n_fixed, int symmetric, int layout, int per_group, int tiles_m,
    int grid_x, int grid_y, void* stream) {
  const repro::gram::Args a{x, y, nullptr, nullptr, sigma2, rho, noise2,
                            n_active, out, x_row, x_batch, y_row, y_batch,
                            batch, n, m, d, s2_step, rho_step, noise_step,
                            n_step, n_fixed, symmetric, per_group, tiles_m,
                            0};
  return repro::gram::launch<false>(a, layout, grid_x, grid_y, stream);
}
