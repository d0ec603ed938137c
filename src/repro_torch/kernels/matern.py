"""Matérn-2.5 covariance build: `csrc/matern.cu` on the card.

Counterpart of `repro/kernels/matern.py`.  `matern52_gram` is an
`autograd.Function`: its forward launches the CUDA kernel for a CUDA tensor
and runs the plain version (`ref.matern52_gram`) for a CPU tensor; its
backward is the analytic Matérn-2.5 gradient in plain torch, as the
reference's `_matern_bwd` is plain jnp:

    k = sigma2 g(z) e^{-z},  z = sqrt5 |x - y| / rho,  g = 1 + z + z^2/3
    dk/dx_i = -sigma2 (5 / 3 rho^2) e^{-z} (1 + z) (x_i - y_j)

(the apparent 1/|x - y| singularity cancels analytically).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

Tensor = torch.Tensor

SOURCE = "matern"
LAUNCHES = 0      # kernel launches since the caller last set it to 0
_SIGNATURES = {"repro_matern52_gram": (_build.ptr,) * 5 + (_build.cint,) * 3
               + (_build.ptr,)}
_MAX_ROWS = 16 * 65535          # grid.y limit at 16 rows per CTA


def scalar_on(v, like: Tensor) -> Tensor:
    """`v` as a contiguous tensor of `like`'s dtype and device (the same
    tensor, with no copy, when it already is one)."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device).contiguous()


def matern52_gram_cuda(x: Tensor, y: Tensor, sigma2, rho) -> Tensor:
    """Launch the kernel: x (n, d), y (m, d) float32 CUDA -> (n, m)."""
    global LAUNCHES
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"matern52 kernel needs CUDA tensors on one device, "
                         f"got {x.device} and {y.device}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"matern52 kernel takes float32, got {x.dtype}, {y.dtype}")
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"matern52 kernel takes (n, d) x (m, d), got "
                         f"{tuple(x.shape)} x {tuple(y.shape)}")
    if x.shape[0] > _MAX_ROWS:
        raise ValueError(f"matern52 kernel takes at most {_MAX_ROWS} rows of x")
    x, y = x.contiguous(), y.contiguous()
    n, d = x.shape
    m = y.shape[0]
    s2, rh = scalar_on(sigma2, x), scalar_on(rho, x)
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    lib = _build.load(SOURCE, _SIGNATURES)
    status = lib.repro_matern52_gram(
        x.data_ptr(), y.data_ptr(), s2.data_ptr(), rh.data_ptr(),
        out.data_ptr(), n, m, d, torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES += 1
    _build.check(lib, status, "matern52_gram")
    return out


def _gram(x: Tensor, y: Tensor, sigma2: Tensor, rho: Tensor) -> Tensor:
    if x.device.type == "cuda":
        return matern52_gram_cuda(x, y, sigma2, rho)
    if x.device.type == "cpu":
        return ref.matern52_gram(x, y, sigma2, rho)
    raise ValueError(f"no matern52 gram for device {x.device}")


class _Matern52Gram(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, y, sigma2, rho):
        ctx.save_for_backward(x, y, sigma2, rho)
        return _gram(x, y, sigma2, rho)

    @staticmethod
    def backward(ctx, g):
        x, y, sigma2, rho = ctx.saved_tensors
        x32, y32, g32 = x.float(), y.float(), g.float()
        sig, rho32 = sigma2.float(), rho.float()
        xx = torch.sum(x32 * x32, dim=-1)[:, None]
        yy = torch.sum(y32 * y32, dim=-1)[None, :]
        sq = torch.clamp(xx + yy - 2.0 * (x32 @ y32.T), min=0.0)
        dist = torch.sqrt(sq + 1e-36)
        z = ref.SQRT5 * dist / rho32
        ez = torch.exp(-z)
        poly = 1.0 + z + z * z / 3.0
        dsigma2 = torch.sum(g32 * poly * ez)
        # dk/dz = -sigma2 e^{-z} z (1 + z) / 3 ;  dz/drho = -z / rho
        drho = torch.sum(g32 * sig * ez * z * z * (1.0 + z) / (3.0 * rho32))
        # s_ij = g_ij dk_ij/d(x_i - y_j) / (x_i - y_j): the d-cancelled factor
        s = -g32 * sig * ez * (1.0 + z) * (5.0 / (3.0 * rho32 * rho32))
        dx = torch.sum(s, dim=1)[:, None] * x32 - s @ y32
        dy = torch.sum(s, dim=0)[:, None] * y32 - s.T @ x32
        return (dx.to(x.dtype), dy.to(y.dtype),
                dsigma2.reshape(sigma2.shape).to(sigma2.dtype),
                drho.reshape(rho.shape).to(rho.dtype))


def matern52_gram(x: Tensor, y: Tensor, sigma2, rho) -> Tensor:
    """(n, d) x (m, d) Matérn-2.5 covariance; differentiable in x, y,
    sigma2 and rho through the analytic backward above."""
    return _Matern52Gram.apply(x, y, scalar_on(sigma2, x), scalar_on(rho, x))
