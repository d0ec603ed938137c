"""Padded-state policy layer over the linalg substrate.

Counterpart of `repro/core/cholesky.py`: Alg. 2 (the full O(n^3/3)
factorization) against Alg. 3 (the O(n^2) row append that reuses the
previous factor), on fixed (n_max, n_max) buffers whose active top-left
(n, n) block is the true factor and whose remainder is the identity.  All
linear algebra goes through `repro_torch.kernels.ops`; the one exception is
`cholesky_naive`, the literal scalar loop of the paper's Alg. 2 kept as a
baseline.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

Tensor = torch.Tensor


def cholesky_naive(k: Tensor) -> Tensor:
    """Row-by-row Cholesky–Banachiewicz factorization, O(n^3/3): the paper's
    Alg. 2 as written, a baseline only."""
    n = k.shape[0]
    l = torch.zeros_like(k)
    for i in range(n):
        for j in range(i):
            l[i, j] = (k[i, j] - torch.sum(l[i, :j] * l[j, :j])) / l[j, j]
        l[i, i] = torch.sqrt(k[i, i] - torch.sum(l[i, :i] * l[i, :i]))
    return l


def cholesky_full(k: Tensor) -> Tensor:
    """Full factorization through the substrate (the reference's
    `cholesky_xla`): the production 'naive' path."""
    return ops.cholesky(k)


def identity_pad_factor(l_active: Tensor, n_max: int) -> Tensor:
    """Embed an (n, n) factor into an identity-padded (n_max, n_max) buffer."""
    n = l_active.shape[0]
    buf = torch.eye(n_max, dtype=l_active.dtype, device=l_active.device)
    buf[:n, :n] = l_active
    return buf


def padded_trsv(l_buf: Tensor, b: Tensor, *, lower: bool = True,
                trans: bool = False) -> Tensor:
    """Triangular solve on the identity-padded buffer; exact for right-hand
    sides that are zero beyond the active block."""
    if not lower:
        raise ValueError("the padded GP state stores lower factors only")
    return ops.padded_trsv(l_buf, b, trans=trans)


def lazy_append_row(l_buf: Tensor, p_pad: Tensor, c, n: int, *,
                    n_max: int) -> tuple[Tensor, Tensor]:
    """Paper Alg. 3 inner step by triangular solve: extend the factor by one
    row at index n, O(n_max^2).  Returns (new l_buf, d).

    The literal solve-based Alg. 3, kept as a baseline; the GP state
    appends through `ops.padded_append_row` / `ops.lazy_append`, which get
    the same q as a matvec against the maintained inverse factor.
    """
    if n_max != l_buf.shape[0]:
        raise ValueError(f"n_max={n_max} but l_buf is {tuple(l_buf.shape)}")
    q = ops.padded_trsv(l_buf, p_pad)
    d = torch.sqrt(torch.clamp(c - q @ q, min=ops.CLAMP_EPS))
    return ops.write_append_row(l_buf, q, d, n), d


def lazy_append_block(l_buf: Tensor, p_block: Tensor, c_block: Tensor,
                      n: int, *, n_max: int) -> Tensor:
    """Absorb t new points (paper Sec. 3.4) as t row appends; p_block[i]
    covers the first n + i rows, c_block (t,) the self-covariances."""
    for i in range(p_block.shape[0]):
        l_buf, _ = lazy_append_row(l_buf, p_block[i], c_block[i], n + i,
                                   n_max=n_max)
    return l_buf


def lazy_full_refactor(k_active_pad: Tensor, n: int, *, n_max: int) -> Tensor:
    """Lag-event full refactorization of the identity-padded Gram buffer."""
    del n, n_max
    return ops.padded_cholesky(k_active_pad)


def pad_gram(k_active: Tensor, n_max: int) -> Tensor:
    """Embed an (n, n) Gram matrix with identity padding."""
    n = k_active.shape[0]
    buf = torch.eye(n_max, dtype=k_active.dtype, device=k_active.device)
    buf[:n, :n] = k_active
    return buf
