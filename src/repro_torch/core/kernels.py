"""Covariance kernel functions for the lazy Gaussian process.

Counterpart of `repro/core/kernels.py`.  Matérn-1.5/2.5, squared-exponential
and the mixed-space Matérn x categorical kernel, each a pairwise-distance
computation |x|^2 + |y|^2 - 2 x.y^T over torch tensors.
All kernels take `KernelParams(sigma2, rho, noise2)` so that the lag
policy can refit them as a unit.  Each also takes a leading study axis,
as the reference vmaps them over a stacked engine: (S, n, d) x (S, m, d)
points with (S,) params (and, for the mixed kernel, (S, d) masks, one
type layout a study) give (S, n, m).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.kernels.ref import per_matrix, per_row

Tensor = torch.Tensor

SQRT5 = 2.23606797749979
SQRT3 = 1.7320508075688772


@dataclasses.dataclass(frozen=True)
class KernelParams:
    """Kernel hyper-parameters (frozen between lag events): 0-d tensors on
    the state's device, or floats where a caller passes constants."""

    sigma2: Tensor | float   # signal variance sigma^2
    rho: Tensor | float      # length scale
    noise2: Tensor | float   # observation noise sigma_n^2 (jitter)

    @staticmethod
    def default() -> "KernelParams":
        return KernelParams(sigma2=1.0, rho=1.0, noise2=1e-6)

    def to(self, device, dtype=torch.float32) -> "KernelParams":
        return KernelParams(*(torch.as_tensor(v, dtype=dtype, device=device)
                              for v in (self.sigma2, self.rho, self.noise2)))


def pairwise_sqdist(x: Tensor, y: Tensor) -> Tensor:
    """Squared Euclidean distances between rows of x (.., n, d) and
    y (.., m, d), by the expansion |x - y|^2 = |x|^2 + |y|^2 - 2 x.y^T."""
    xx = torch.sum(x * x, dim=-1)[..., :, None]
    yy = torch.sum(y * y, dim=-1)[..., None, :]
    return torch.clamp(xx + yy - 2.0 * (x @ y.transpose(-1, -2)), min=0.0)


def matern52(x: Tensor, y: Tensor, params: KernelParams) -> Tensor:
    """Matérn-2.5 kernel matrix (paper Eq. 3, with the exponent sign fixed)."""
    d = torch.sqrt(pairwise_sqdist(x, y) + 1e-36)
    z = SQRT5 * d / per_matrix(params.rho)
    return per_matrix(params.sigma2) * (1.0 + z + z * z / 3.0) * torch.exp(-z)


def matern32(x: Tensor, y: Tensor, params: KernelParams) -> Tensor:
    d = torch.sqrt(pairwise_sqdist(x, y) + 1e-36)
    z = SQRT3 * d / per_matrix(params.rho)
    return per_matrix(params.sigma2) * (1.0 + z) * torch.exp(-z)


def rbf(x: Tensor, y: Tensor, params: KernelParams) -> Tensor:
    sq = pairwise_sqdist(x, y)
    rho = per_matrix(params.rho)
    return per_matrix(params.sigma2) * torch.exp(-0.5 * sq / (rho * rho))


KernelFn = Callable[[Tensor, Tensor, KernelParams], Tensor]

# Gram-routing tag: a kernel with a hand-written gram kernel advertises it
# here, and `repro_torch.kernels.ops.kernel_gram` dispatches on the
# attribute.  The reference names the same tag `pallas_gram`
# (repro/core/kernels.py:75); nothing in the port is Pallas.
matern52.gram_kernel = "matern52"

KERNELS: dict[str, KernelFn] = {
    "matern52": matern52,
    "matern32": matern32,
    "rbf": rbf,
}


# --- mixed (continuous x categorical) spaces, DESIGN.md §10 ----------------

def mixed_matern52(x: Tensor, y: Tensor, params: KernelParams,
                   cont_mask: Tensor, cat_mask: Tensor) -> Tensor:
    """Mixed-space kernel: Matérn-2.5 over the continuous (float + int)
    coordinates times `exp(-d2_cat / 2 rho)` over the one-hot block (on
    feasible one-hot encodings the Hamming kernel exp(-h / rho)).  The
    categorical factor carries no gradient (`detach`, the reference's
    stop_gradient): the ascent moves one-hot coordinates by round-and-repair
    projection, never by gradient steps.  The masks are (d,), or (S, d)
    against (S, n, d) points, one type layout a study."""
    cont_mask, cat_mask = per_row(cont_mask), per_row(cat_mask)
    rho = per_matrix(params.rho)
    xc, yc = x * cont_mask, y * cont_mask
    d = torch.sqrt(pairwise_sqdist(xc, yc) + 1e-36)
    z = SQRT5 * d / rho
    sqk = pairwise_sqdist(x * cat_mask, y * cat_mask)
    cat = torch.exp(-0.5 * sqk / rho).detach()
    return per_matrix(params.sigma2) * (1.0 + z + z * z / 3.0) \
        * torch.exp(-z) * cat


def make_mixed_kernel(cont_mask: Tensor, cat_mask: Tensor) -> KernelFn:
    """Close a `KernelFn` over a space's type masks (from its
    `TypeDescriptor`, on the device of the points).  The tag
    `gram_kernel = "mixed"` routes gram builds to the mixed kernel, and the
    closure carries the masks for it and for the fused EI ascent.  Stacked
    (S, d) masks (a stacked descriptor's) give one closure over S studies
    with different type layouts, the reference's per-study closure under
    its vmap: its gram builds and fused-EI steps take all S in one
    launch."""
    def mixed(x: Tensor, y: Tensor, params: KernelParams) -> Tensor:
        return mixed_matern52(x, y, params, cont_mask, cat_mask)

    mixed.gram_kernel = "mixed"
    mixed.cont_mask = cont_mask
    mixed.cat_mask = cat_mask
    return mixed


def gram(kernel: KernelFn, x: Tensor, params: KernelParams) -> Tensor:
    """K_y = k(X, X) + noise2 * I (paper's K + sigma^2 I)."""
    k = kernel(x, x, params)
    return k + params.noise2 * torch.eye(x.shape[0], dtype=k.dtype,
                                         device=k.device)
