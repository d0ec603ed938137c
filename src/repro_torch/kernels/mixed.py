"""Mixed-space (continuous x categorical) covariance build: `csrc/mixed.cu`.

Counterpart of `repro/kernels/mixed.py`.  `mixed_gram` is an
`autograd.Function`: its forward launches the CUDA kernel for a CUDA tensor
and runs the plain version (`ref.mixed_gram`) for a CPU tensor; its
backward is the reference's analytic `_mixed_bwd` in plain torch:

    k = sigma2 g(z) e^{-z} cat,  z = sqrt5 |xc - yc| / rho,
    cat = exp(-|xk - yk|^2 / 2 rho)

differentiated on the continuous block only: the categorical factor
scales the Matérn gradient but has no gradient of its own (dxk = dyk = 0,
and drho leaves out the factor's rho), because the ascent moves one-hot
coordinates by round-and-repair projection, never by gradient steps.
Shapes, the batch axis and `masked_gram` as in `matern.py`, whose
`launch` both wrappers share.  The masks are (d,), shared by the batch,
or (B, d), one pair a matrix: a stacked engine whose studies have
different type layouts builds all their grams in one launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.matern import (_GEOMETRY, launch, reduce_to,
                                        scalar_on, wants_grad)

Tensor = torch.Tensor

SOURCE = "mixed"
LAUNCHES = 0      # kernel launches since the caller last set it to 0
_SIGNATURES = {"repro_mixed_gram": (_build.ptr,) * 4 + (_build.cint,)
               + (_build.ptr,) * 5 + _GEOMETRY}


def mixed_gram_cuda(x: Tensor, y: Tensor, sigma2, rho, cont_mask: Tensor,
                    cat_mask: Tensor) -> Tensor:
    """Launch the kernel: x (n, d) or (B, n, d), y (m, d) or (B, m, d),
    masks (d,) or (B, d), float32 CUDA, sigma2 / rho scalars or (B,) ->
    (n, m) or (B, n, m)."""
    global LAUNCHES
    out, launched = launch(SOURCE, _SIGNATURES, "repro_mixed_gram", x, y,
                           sigma2, rho, (cont_mask, cat_mask))
    LAUNCHES += launched
    return out


def masked_gram_cuda(x_buf: Tensor, n, sigma2, rho, noise2, cont_mask: Tensor,
                     cat_mask: Tensor) -> Tensor:
    """Launch the masked form on x_buf (n_max, d) or (B, n_max, d): the
    identity-padded K + noise2 I with n an int or a (B,) int tensor,
    sigma2 / rho / noise2 scalars or (B,) and masks (d,) or (B, d)."""
    global LAUNCHES
    out, launched = launch(SOURCE, _SIGNATURES, "repro_mixed_gram", x_buf,
                           x_buf, sigma2, rho, (cont_mask, cat_mask),
                           noise2=noise2, n_active=n)
    LAUNCHES += launched
    return out


def _gram(x, y, sigma2, rho, cont_mask, cat_mask) -> Tensor:
    if x.device.type == "cuda":
        return mixed_gram_cuda(x, y, sigma2, rho, cont_mask, cat_mask)
    if x.device.type == "cpu":
        return ref.mixed_gram(x, y, sigma2, rho, cont_mask, cat_mask)
    raise ValueError(f"no mixed gram for device {x.device}")


def _sqdist(a: Tensor, b: Tensor) -> Tensor:
    aa = torch.sum(a * a, dim=-1)[..., :, None]
    bb = torch.sum(b * b, dim=-1)[..., None, :]
    return torch.clamp(aa + bb - 2.0 * (a @ b.transpose(-1, -2)), min=0.0)


class _MixedGram(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, y, sigma2, rho, cont_mask, cat_mask):
        ctx.save_for_backward(x, y, sigma2, rho, cont_mask, cat_mask)
        return _gram(x, y, sigma2, rho, cont_mask, cat_mask)

    @staticmethod
    def backward(ctx, g):
        x, y, sigma2, rho, cont_mask, cat_mask = ctx.saved_tensors
        cm, km = ref.per_row(cont_mask.float()), ref.per_row(cat_mask.float())
        xc, yc = x.float() * cm, y.float() * cm
        xk, yk = x.float() * km, y.float() * km
        g32 = g.float()
        sig, rho32 = ref.per_matrix(sigma2.float()), ref.per_matrix(rho.float())
        dist = torch.sqrt(_sqdist(xc, yc) + 1e-36)
        z = ref.SQRT5 * dist / rho32
        ez = torch.exp(-z)
        cat = torch.exp(-0.5 * _sqdist(xk, yk) / rho32)
        poly = 1.0 + z + z * z / 3.0
        dsigma2 = torch.sum(g32 * poly * ez * cat, dim=(-2, -1))
        # Continuous-only rho gradient: dk/dz = -sig e^{-z} z (1 + z) / 3,
        # the categorical factor's rho held fixed.
        drho = torch.sum(g32 * sig * cat * ez * z * z * (1.0 + z)
                         / (3.0 * rho32), dim=(-2, -1))
        # Matérn gradient on the continuous block, scaled by the factor;
        # chained through xc = x * cont_mask (the categorical block's
        # cotangent is zero).
        s = -g32 * sig * cat * ez * (1.0 + z) * (5.0 / (3.0 * rho32 * rho32))
        dx = (torch.sum(s, dim=-1)[..., None] * xc - s @ yc) * cm
        dy = (torch.sum(s, dim=-2)[..., None] * yc
              - s.transpose(-1, -2) @ xc) * cm
        return (reduce_to(dx, x), reduce_to(dy, y), reduce_to(dsigma2, sigma2),
                reduce_to(drho, rho), None, None)


def mixed_gram(x: Tensor, y: Tensor, sigma2, rho, cont_mask: Tensor,
               cat_mask: Tensor) -> Tensor:
    """(.., n, d) x (.., m, d) mixed covariance under the (d,) or (B, d)
    type masks and scalar or (B,) sigma2 / rho; differentiable in x, y,
    sigma2 and rho on the continuous block."""
    return _MixedGram.apply(x, y, scalar_on(sigma2, x), scalar_on(rho, x),
                            cont_mask.to(x.dtype), cat_mask.to(x.dtype))


def masked_gram(x_buf: Tensor, n, sigma2, rho, noise2, cont_mask: Tensor,
                cat_mask: Tensor) -> Tensor:
    """Identity-padded K + noise2 I of the mixed kernel over x_buf (n_max, d)
    or (B, n_max, d) under (d,) or (B, d) masks, as `matern.masked_gram`:
    one launch on the card; on
    the CPU, or where a gradient is asked for, the gram above padded by
    `ref.pad_identity`."""
    cm, km = cont_mask.to(x_buf.dtype), cat_mask.to(x_buf.dtype)
    if x_buf.device.type == "cuda" and not wants_grad(x_buf, sigma2, rho,
                                                      noise2):
        return masked_gram_cuda(x_buf, n, sigma2, rho, noise2, cm, km)
    return ref.pad_identity(mixed_gram(x_buf, x_buf, sigma2, rho, cm, km), n,
                            noise2)
