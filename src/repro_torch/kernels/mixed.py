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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.matern import scalar_on

Tensor = torch.Tensor

SOURCE = "mixed"
LAUNCHES = 0      # kernel launches since the caller last set it to 0
_SIGNATURES = {"repro_mixed_gram": (_build.ptr,) * 7 + (_build.cint,) * 3
               + (_build.ptr,)}
_MAX_ROWS = 16 * 65535          # grid.y limit at 16 rows per CTA


def mixed_gram_cuda(x: Tensor, y: Tensor, sigma2, rho, cont_mask: Tensor,
                    cat_mask: Tensor) -> Tensor:
    """Launch the kernel: x (n, d), y (m, d), masks (d,), float32 CUDA ->
    (n, m)."""
    global LAUNCHES
    ops_ = (x, y, cont_mask, cat_mask)
    if x.device.type != "cuda" or any(t.device != x.device for t in ops_):
        raise ValueError(f"mixed kernel needs CUDA tensors on one device, got "
                         f"{[str(t.device) for t in ops_]}")
    if any(t.dtype != torch.float32 for t in ops_):
        raise TypeError(f"mixed kernel takes float32, got "
                        f"{[t.dtype for t in ops_]}")
    if (x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]
            or cont_mask.shape != (x.shape[1],)
            or cat_mask.shape != (x.shape[1],)):
        raise ValueError(f"mixed kernel takes (n, d) x (m, d) with (d,) masks, "
                         f"got {[tuple(t.shape) for t in ops_]}")
    if x.shape[0] > _MAX_ROWS:
        raise ValueError(f"mixed kernel takes at most {_MAX_ROWS} rows of x")
    x, y, cm, km = (t.contiguous() for t in ops_)
    n, d = x.shape
    m = y.shape[0]
    s2, rh = scalar_on(sigma2, x), scalar_on(rho, x)
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    lib = _build.load(SOURCE, _SIGNATURES)
    status = lib.repro_mixed_gram(
        x.data_ptr(), y.data_ptr(), cm.data_ptr(), km.data_ptr(),
        s2.data_ptr(), rh.data_ptr(), out.data_ptr(), n, m, d,
        torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES += 1
    _build.check(lib, status, "mixed_gram")
    return out


def _gram(x, y, sigma2, rho, cont_mask, cat_mask) -> Tensor:
    if x.device.type == "cuda":
        return mixed_gram_cuda(x, y, sigma2, rho, cont_mask, cat_mask)
    if x.device.type == "cpu":
        return ref.mixed_gram(x, y, sigma2, rho, cont_mask, cat_mask)
    raise ValueError(f"no mixed gram for device {x.device}")


def _sqdist(a: Tensor, b: Tensor) -> Tensor:
    aa = torch.sum(a * a, dim=-1)[:, None]
    bb = torch.sum(b * b, dim=-1)[None, :]
    return torch.clamp(aa + bb - 2.0 * (a @ b.T), min=0.0)


class _MixedGram(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, y, sigma2, rho, cont_mask, cat_mask):
        ctx.save_for_backward(x, y, sigma2, rho, cont_mask, cat_mask)
        return _gram(x, y, sigma2, rho, cont_mask, cat_mask)

    @staticmethod
    def backward(ctx, g):
        x, y, sigma2, rho, cont_mask, cat_mask = ctx.saved_tensors
        cm, km = cont_mask.float(), cat_mask.float()
        xc, yc = x.float() * cm, y.float() * cm
        xk, yk = x.float() * km, y.float() * km
        g32, sig, rho32 = g.float(), sigma2.float(), rho.float()
        dist = torch.sqrt(_sqdist(xc, yc) + 1e-36)
        z = ref.SQRT5 * dist / rho32
        ez = torch.exp(-z)
        cat = torch.exp(-0.5 * _sqdist(xk, yk) / rho32)
        poly = 1.0 + z + z * z / 3.0
        dsigma2 = torch.sum(g32 * poly * ez * cat)
        # Continuous-only rho gradient: dk/dz = -sig e^{-z} z (1 + z) / 3,
        # the categorical factor's rho held fixed.
        drho = torch.sum(g32 * sig * cat * ez * z * z * (1.0 + z)
                         / (3.0 * rho32))
        # Matérn gradient on the continuous block, scaled by the factor;
        # chained through xc = x * cont_mask (the categorical block's
        # cotangent is zero).
        s = -g32 * sig * cat * ez * (1.0 + z) * (5.0 / (3.0 * rho32 * rho32))
        dx = (torch.sum(s, dim=1)[:, None] * xc - s @ yc) * cm
        dy = (torch.sum(s, dim=0)[:, None] * yc - s.T @ xc) * cm
        return (dx.to(x.dtype), dy.to(y.dtype),
                dsigma2.reshape(sigma2.shape).to(sigma2.dtype),
                drho.reshape(rho.shape).to(rho.dtype), None, None)


def mixed_gram(x: Tensor, y: Tensor, sigma2, rho, cont_mask: Tensor,
               cat_mask: Tensor) -> Tensor:
    """(n, d) x (m, d) mixed covariance under the (d,) type masks;
    differentiable in x, y, sigma2 and rho on the continuous block."""
    return _MixedGram.apply(x, y, scalar_on(sigma2, x), scalar_on(rho, x),
                            cont_mask.to(x.dtype), cat_mask.to(x.dtype))
