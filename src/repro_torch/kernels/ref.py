"""Plain PyTorch versions of the port's kernels.

Counterpart of `repro/kernels/ref.py`.  A wrapper in this package runs the
function here when its tensor lies on the CPU; on a CUDA tensor it launches
the hand-written kernel instead, and `chip_smoke.py` holds each kernel
against the function here on the card.

The triangular solve and the Cholesky factor are blocked loops in torch,
vectorised over rows and columns, not `torch.linalg` calls: the Cholesky
keeps the reference kernel's diagonal clamp `sqrt(max(., 1e-12))`
(`repro/kernels/chol.py:41`), so it never raises on a matrix that is not
positive definite, where `torch.linalg.cholesky` would.  Every function
takes optional leading batch dimensions.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

SQRT5 = 2.23606797749979
BLOCK = 32        # block width of the solve and the factorization
DIAG_CLAMP = 1e-12
CLAMP_EPS = 1e-10


def per_matrix(v):
    """A per-matrix scalar against (..., n, m) matrices: a (B,) tensor as
    (B, 1, 1); a scalar or 0-d tensor as it is."""
    if isinstance(v, Tensor) and v.ndim:
        return v[..., None, None]
    return v


def per_row(mask: Tensor) -> Tensor:
    """A type mask against (..., n, d) rows: a (B, d) stack as (B, 1, d),
    one mask a matrix; a (d,) mask as it is."""
    return mask[..., None, :] if mask.ndim > 1 else mask


def matern52_gram(x: Tensor, y: Tensor, sigma2, rho) -> Tensor:
    """Pairwise Matérn-2.5 covariance, (.., n, d) x (.., m, d) -> (.., n, m),
    sigma2 / rho scalars or (B,)."""
    xx = torch.sum(x * x, dim=-1)[..., :, None]
    yy = torch.sum(y * y, dim=-1)[..., None, :]
    sq = torch.clamp(xx + yy - 2.0 * (x @ y.transpose(-1, -2)), min=0.0)
    d = torch.sqrt(sq + 1e-36)
    z = SQRT5 * d / per_matrix(rho)
    return per_matrix(sigma2) * (1.0 + z + z * z / 3.0) * torch.exp(-z)


def pad_identity(k: Tensor, n, noise2) -> Tensor:
    """The identity-padded Gram of a gram build k (..., n_max, n_max):
    k + noise2 I inside the active block (rows and columns below n),
    the identity outside it.  n is an int or a (B,) int tensor, noise2 a
    scalar or (B,)."""
    n_max = k.shape[-1]
    eye = torch.eye(n_max, dtype=k.dtype, device=k.device)
    idx = torch.arange(n_max, device=k.device)
    nn = per_matrix(n)
    active = (idx[:, None] < nn) & (idx[None, :] < nn)
    return torch.where(active, k + per_matrix(noise2) * eye, eye)


def _solve_diag(ld: Tensor, rhs: Tensor, trans: bool) -> Tensor:
    """Substitution on one (B, B) lower diagonal block, rhs (..., B, r)."""
    b = ld.shape[-1]
    rows: list[Tensor] = [rhs[..., 0, :]] * b
    for i in (range(b - 1, -1, -1) if trans else range(b)):
        if trans:   # row i of L^T is column i of L, solved rows are > i
            coef, done = ld[..., i + 1:, i], rows[i + 1:]
        else:
            coef, done = ld[..., i, :i], rows[:i]
        done = torch.stack(done, dim=-2) if done else rhs[..., :0, :]
        acc = torch.sum(coef[..., :, None] * done, dim=-2)
        rows[i] = (rhs[..., i, :] - acc) / ld[..., i, i, None]
    return torch.stack(rows, dim=-2)


def trsv(l: Tensor, b: Tensor, *, trans: bool = False) -> Tensor:
    """Lower-triangular solve L q = b (or L^T q = b), b (..., n, r).
    Built without in-place writes, so autograd can run through it."""
    n = l.shape[-1]
    starts = list(range(0, n, BLOCK))
    blocks: dict[int, Tensor] = {}
    for s in (reversed(starts) if trans else starts):
        e = min(s + BLOCK, n)
        if trans:
            done = [blocks[t] for t in starts if t >= e]
            part = l[..., e:, s:e].transpose(-1, -2) @ (
                torch.cat(done, dim=-2) if done else b[..., :0, :])
        else:
            done = [blocks[t] for t in starts if t < s]
            part = l[..., s:e, :s] @ (
                torch.cat(done, dim=-2) if done else b[..., :0, :])
        blocks[s] = _solve_diag(l[..., s:e, s:e], b[..., s:e, :] - part, trans)
    if not blocks:
        return torch.zeros_like(b)
    return torch.cat([blocks[s] for s in starts], dim=-2)


def tri_inverse(l: Tensor) -> Tensor:
    """L^{-1} of a lower-triangular L (..., n, n), as `trsv(l, I)`."""
    eye = torch.eye(l.shape[-1], dtype=l.dtype, device=l.device)
    return trsv(l, eye.expand_as(l))


def _chol_unblocked(a: Tensor) -> Tensor:
    """Crout column loop on a (B, B) block with the diagonal clamp."""
    b = a.shape[-1]
    l = torch.zeros_like(a)
    for j in range(b):
        lj = l[..., j, :j]
        s = torch.sum(l[..., j:, :j] * lj[..., None, :], dim=-1)   # rows >= j
        ljj = torch.sqrt(torch.clamp(a[..., j, j] - s[..., 0], min=DIAG_CLAMP))
        l[..., j, j] = ljj
        l[..., j + 1:, j] = (a[..., j + 1:, j] - s[..., 1:]) / ljj[..., None]
    return l


def _inv_lower(l: Tensor) -> Tensor:
    """Inverse of a (B, B) lower-triangular block by row substitution."""
    b = l.shape[-1]
    x = torch.zeros_like(l)
    eye = torch.eye(b, dtype=l.dtype, device=l.device)
    for i in range(b):
        acc = torch.sum(l[..., i, :i, None] * x[..., :i, :], dim=-2)
        x[..., i, :] = (eye[i] - acc) / l[..., i, i, None]
    return x


def cholesky(k: Tensor) -> Tensor:
    """Blocked right-looking lower Cholesky with the diagonal clamp."""
    a = k.clone()
    n = a.shape[-1]
    for s in range(0, n, BLOCK):
        e = min(s + BLOCK, n)
        ld = _chol_unblocked(a[..., s:e, s:e])
        panel = a[..., e:, s:e] @ _inv_lower(ld).transpose(-1, -2)
        a[..., s:e, s:e] = ld
        a[..., e:, s:e] = panel
        a[..., e:, e:] -= panel @ panel.transpose(-1, -2)
    return torch.tril(a)


def chol_append(l: Tensor, p: Tensor, c) -> tuple[Tensor, Tensor]:
    """Incremental append on the active factor: q = L^{-1} p, d."""
    q = trsv(l, p[:, None])[:, 0]
    d = torch.sqrt(torch.clamp(c - q @ q, min=CLAMP_EPS))
    return q, d


def gp_posterior_solve(l: Tensor, resid: Tensor, k_star: Tensor,
                       k_ss_diag: Tensor) -> tuple[Tensor, Tensor]:
    """Posterior solve: mean = k*^T K^{-1} resid, var = k** - |v|^2."""
    z = trsv(l, resid[:, None])
    alpha = trsv(l, z, trans=True)[:, 0]
    v = trsv(l, k_star)
    mean = k_star.T @ alpha
    var = torch.clamp(k_ss_diag - torch.sum(v * v, dim=0), min=1e-12)
    return mean, var


def mixed_gram(x: Tensor, y: Tensor, sigma2, rho, cont_mask: Tensor,
               cat_mask: Tensor) -> Tensor:
    """Mixed-space covariance: Matérn-2.5 over the continuous (float + int)
    coordinates times the factor `exp(-d2_cat / 2 rho)` over the one-hot
    coordinates (divided by rho, not rho^2, as the reference defines it).
    On feasible one-hot blocks d2_cat is twice the number of differing
    groups, so the factor is the Hamming kernel exp(-h / rho).  The factor
    carries no gradient (`detach`, the reference's stop_gradient).  Shapes
    as `matern52_gram`; the masks are (d,), or (B, d) with one pair a
    matrix."""
    rho = per_matrix(rho)
    cont_mask, cat_mask = per_row(cont_mask), per_row(cat_mask)
    xc, yc = x * cont_mask, y * cont_mask
    xx = torch.sum(xc * xc, dim=-1)[..., :, None]
    yy = torch.sum(yc * yc, dim=-1)[..., None, :]
    sq = torch.clamp(xx + yy - 2.0 * (xc @ yc.transpose(-1, -2)), min=0.0)
    d = torch.sqrt(sq + 1e-36)
    z = SQRT5 * d / rho
    xk, yk = x * cat_mask, y * cat_mask
    kk = torch.sum(xk * xk, dim=-1)[..., :, None]
    ll = torch.sum(yk * yk, dim=-1)[..., None, :]
    sqk = torch.clamp(kk + ll - 2.0 * (xk @ yk.transpose(-1, -2)), min=0.0)
    cat = torch.exp(-0.5 * sqk / rho).detach()
    return per_matrix(sigma2) * (1.0 + z + z * z / 3.0) * torch.exp(-z) * cat
