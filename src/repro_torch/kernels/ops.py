"""The linalg substrate: the one dispatch surface for every GP operation.

Counterpart of `repro/kernels/ops.py`.  The reference picks a substrate
with an `implementation` knob (auto | pallas | xla | ref); the port has no
knob: the tensor's device decides.  A CUDA tensor goes to the hand-written
kernel (a failed build or launch raises, nothing falls back), a CPU tensor
to the plain PyTorch version in `ref.py` / `acq.ei_grad_torch`.  There are
no size envelopes: a kernel takes any n, or its wrapper raises.

  op                 | shape contract    | CUDA kernel       | batched
  -------------------|-------------------|-------------------|--------
  matern52_gram      | (..,n,d)x(..,m,d) | csrc/matern.cu    | yes
  mixed_gram         | (..,n,d)x(..,m,d) | csrc/mixed.cu     | yes
  trsv               | (n,n),(n[,r])     | csrc/trsv.cu      | yes
  cholesky           | (n,n)             | csrc/chol.cu      | yes
  chol_append        | active factor     | trsv              | no
  gp_posterior_solve | active factor     | trsv              | no
  kernel_gram        | any kernel fn     | gram if tagged    | if tagged
  masked_gram        | padded buffers    | masked gram if    | yes
                     |                   |  tagged           |
  padded_trsv        | padded buffers    | csrc/trsv.cu      | yes
  padded_cholesky    | padded buffers    | csrc/chol.cu      | yes
  tri_inverse        | (n,n)             | csrc/trsv.cu      | yes
  padded_tri_inverse | padded buffers    | csrc/trsv.cu      | yes
  padded_append_row  | padded buffers    | ‡                 | no
  lazy_append        | padded buffers    | ‡                 | no
  lazy_append_rows   | padded buffers    | ‡                 | no
  lazy_append_rows_  | padded buffers    | ‡ (in place)      | no
  fused_ei_grad      | (r,d) + padded    | csrc/acq.cu       | yes
                     |  + (d,)/(..,d)    | (mixed form)      | yes
                     |  masks            |                   |

  ‡  matmul-only against the maintained inverse factor (`torch.matmul`,
     as the reference leaves them to XLA): no kernel below the entry point.

The padded-state ops work on the identity-padded (n_max, n_max) buffers of
DESIGN.md §3: the active top-left (n, n) block is real data, the rest is
the identity, and right-hand sides are zero beyond the active block.  They
take `n` as a Python int, the host-side counter the GP state keeps
(`masked_gram` also an (S,) int tensor).  The masked Gram, the factor, the
inverse and the solve take a leading batch axis, which the lag refit uses
to score its grid of candidate hyper-parameters with one launch of each.

The appends are matmuls against the maintained inverse `li_buf = L^{-1}`:
the row solve is `q = L^{-1} p` and the inverse grows by the closed-form
bordered row `[-(1/d) q^T L^{-1}, 1/d]`.  The single-study appends return
new buffers: the input buffers belong to the caller (the lag refit scores
18 candidate states off one base state), so a row is written in place only
into this call's own copy; `lazy_append_rows_` writes into the buffers it
is given (the engine's fantasy rows, and the stacked engine's appends,
one study's views at a time: `gp.append_stacked`), so a round copies no
(S, n_max, n_max) buffer.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import acq as acq_kernels
from repro_torch.kernels import ref
# The active-shape entry points are the kernel modules' own functions:
# matern52_gram (.., n, d) x (.., m, d) with scalar or (B,) params,
# trsv (..., n, n) with b (..., n[, r]), tri_inverse (..., n, n),
# cholesky (..., n, n) with the reference's diagonal clamp, and
# mixed_gram as matern52_gram under the (d,) type masks of a mixed space.
from repro_torch.kernels import matern as matern_kernels
from repro_torch.kernels import mixed as mixed_kernels
from repro_torch.kernels.chol import cholesky
from repro_torch.kernels.matern import matern52_gram
from repro_torch.kernels.mixed import mixed_gram
from repro_torch.kernels.trsv import tri_inverse, trsv

Tensor = torch.Tensor

# Floor for the squared new-diagonal d^2 = c - q.q in the incremental append.
# Exact arithmetic guarantees d^2 > 0; hitting the floor means float32
# ill-conditioning, which the padded ops report to callers.
CLAMP_EPS = ref.CLAMP_EPS

__all__ = ["CLAMP_EPS", "chol_append", "cholesky", "fused_ei_grad",
           "fused_supported", "gp_posterior_solve", "kernel_gram",
           "lazy_append", "lazy_append_rows", "lazy_append_rows_",
           "masked_gram", "matern52_gram",
           "mixed_gram",
           "padded_append_row", "padded_cholesky", "padded_tri_inverse",
           "padded_trsv", "tri_inverse", "trsv", "write_append_row"]


def chol_append(l: Tensor, p: Tensor, c) -> tuple[Tensor, Tensor]:
    """Incremental append on the active factor: q = L^{-1} p, d."""
    q = trsv(l, p)
    d = torch.sqrt(torch.clamp(c - q @ q, min=CLAMP_EPS))
    return q, d


def gp_posterior_solve(l: Tensor, resid: Tensor, k_star: Tensor,
                       k_ss_diag: Tensor) -> tuple[Tensor, Tensor]:
    """GP posterior solves (mean, var) on one active factor."""
    z = trsv(l, resid)
    alpha = trsv(l, z, trans=True)
    v = trsv(l, k_star)
    mean = k_star.T @ alpha
    var = torch.clamp(k_ss_diag - torch.sum(v * v, dim=0), min=1e-12)
    return mean, var


# ---------------------------------------------------------------------------
# Padded-state ops: the identity-padded (n_max, n_max) buffers of DESIGN.md §3.
# ---------------------------------------------------------------------------

def padded_trsv(l_buf: Tensor, b: Tensor, *, trans: bool = False) -> Tensor:
    """Triangular solve on the identity-padded factor buffer.

    Exact for right-hand sides that are zero beyond the active block.
    Batched form: `l_buf (G, n_max, n_max)` with `b (G, n_max)` or
    `(G, n_max, r)` solves G systems in one launch.
    """
    return trsv(l_buf, b, trans=trans)


def padded_cholesky(k_pad: Tensor) -> Tensor:
    """Cholesky of an identity-padded Gram buffer: the factor of
    [[K, 0], [0, I]] is [[L, 0], [0, I]], the identity-padded factor the
    lazy state stores.  Batched form: (G, n_max, n_max) in one launch."""
    return cholesky(k_pad)


def kernel_gram(kernel_fn, x: Tensor, y: Tensor, params) -> Tensor:
    """Covariance build through the substrate.

    A kernel function opts into a gram kernel by carrying the tag
    `gram_kernel` (set in `repro_torch.core.kernels`; the reference calls
    the same tag `pallas_gram`): "matern52" for the Matérn-2.5 kernel,
    "mixed" for the mixed kernel, whose closure also carries its
    `cont_mask` / `cat_mask`, (d,) or (B, d).  Anything else uses the
    kernel's own torch formulation.  `params` needs `.sigma2` and `.rho`;
    a tagged kernel also takes (B,) params and (B, n, d) / (B, m, d)
    operands.
    """
    tag = getattr(kernel_fn, "gram_kernel", None)
    if tag == "matern52":
        return matern52_gram(x, y, params.sigma2, params.rho)
    if tag == "mixed":
        return mixed_gram(x, y, params.sigma2, params.rho, kernel_fn.cont_mask,
                          kernel_fn.cat_mask)
    return kernel_fn(x, y, params)


def masked_gram(x_buf: Tensor, n, kernel_fn, params) -> Tensor:
    """Identity-padded Gram K + noise2 I over the padded point buffer:
    rows/cols >= n are the identity, so `padded_cholesky` of it is the
    identity-padded factor.

    Batched form (the reference's vmap): `x_buf (S, n_max, d)`, `n` an int
    or an (S,) int tensor and `params` with scalar or (S,) leaves give
    (S, n_max, n_max).  `x_buf` may be one buffer expanded over the batch
    (batch stride 0), as the lag refit scores 18 candidates on one state.
    A tagged kernel is one launch of its gram's masked form on the card;
    any other kernel is its torch formulation padded by `ref.pad_identity`,
    one study at a time.
    """
    tag = getattr(kernel_fn, "gram_kernel", None)
    if tag == "matern52":
        return matern_kernels.masked_gram(x_buf, n, params.sigma2, params.rho,
                                          params.noise2)
    if tag == "mixed":
        return mixed_kernels.masked_gram(x_buf, n, params.sigma2, params.rho,
                                         params.noise2, kernel_fn.cont_mask,
                                         kernel_fn.cat_mask)
    if x_buf.ndim == 3:
        def study(v, s):
            return v[s] if isinstance(v, Tensor) and v.ndim else v
        return torch.stack([masked_gram(
            x_buf[s], study(n, s), kernel_fn,
            type(params)(*(study(v, s) for v in (params.sigma2, params.rho,
                                                 params.noise2))))
            for s in range(x_buf.shape[0])])
    return ref.pad_identity(kernel_fn(x_buf, x_buf, params), n, params.noise2)


def _put_append_row(buf: Tensor, q: Tensor, d, n: int) -> None:
    """Replace row n of the padded triangular buffer by [q^T, d, 0, ...],
    in place."""
    idx = torch.arange(buf.shape[-1], device=buf.device)
    row = torch.where(idx < n, q, 0.0)
    row[n] = d
    buf[n] = row


def write_append_row(buf: Tensor, q: Tensor, d, n: int) -> Tensor:
    """A copy of the padded triangular buffer with row n replaced by
    [q^T, d, 0, ...]."""
    out = buf.clone()      # this call's own buffer: written in place below
    _put_append_row(out, q, d, n)
    return out


def padded_tri_inverse(l_buf: Tensor) -> Tensor:
    """Identity-padded inverse `L^{-1}` of the identity-padded factor, by
    solving `L X = I` (the identity block is self-inverse).  Runs only at
    refactor events.  Batched form: (G, n_max, n_max)."""
    return tri_inverse(l_buf)


def padded_append_row(l_buf: Tensor, li_buf: Tensor, p_pad: Tensor, c,
                      n: int) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Paper Alg. 3 row append on the padded factor + inverse, O(n_max^2).

    Args:
      l_buf: (n_max, n_max) identity-padded factor of K_n + noise I.
      li_buf: (n_max, n_max) identity-padded inverse factor L^{-1}.
      p_pad: (n_max,) new covariance column k(X, x_new), zero beyond n.
      c: k(x_new, x_new) + noise.
      n: active count; the new row lands at index n.

    Returns (l_new, li_new, d, clamped) where `clamped` is 1 (int32) iff
    d^2 hit the CLAMP_EPS conditioning floor.
    """
    q, r, d, clamped = _bordered_row(li_buf, p_pad, c)
    return (write_append_row(l_buf, q, d, n),
            write_append_row(li_buf, r, 1.0 / d, n), d, clamped)


def _bordered_row(li_buf: Tensor, p_pad: Tensor, c
                  ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The new rows of one Alg. 3 append: (q, r, d, clamped) with row n of
    L' = [q^T, d] and row n of L'^{-1} = [r^T, 1/d]."""
    # Rows >= n of li are identity and p is zero there, so q is exact and
    # already zero beyond the active block.
    q = li_buf @ p_pad
    d2 = c - q @ q
    clamped = (d2 < CLAMP_EPS).to(torch.int32)
    d = torch.sqrt(torch.clamp(d2, min=CLAMP_EPS))
    # Bordered inverse: row n of L'^{-1} is [-(1/d) q^T L^{-1}, 1/d].
    r = -(q @ li_buf) / d
    return q, r, d, clamped


def _refresh_alpha(li_new: Tensor, resid: Tensor, active: Tensor) -> Tensor:
    """alpha = L'^{-T} (L'^{-1} r) as two matvecs, zero past the active rows."""
    z = li_new @ resid
    alpha = z @ li_new                                     # == li_new.T @ z
    return torch.where(active, alpha, 0.0)


def lazy_append(l_buf: Tensor, li_buf: Tensor, p_pad: Tensor, c,
                resid: Tensor, n: int
                ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Fused Alg. 3 append: row + inverse update + alpha refresh, O(n_max^2).

    `resid` (n_max,) is y - mean *including* the new observation at row n,
    zero beyond it.  Returns (l_new, li_new, alpha, d, clamped).
    """
    idx = torch.arange(l_buf.shape[-1], device=l_buf.device)
    l_new, li_new, d, clamped = padded_append_row(l_buf, li_buf, p_pad, c, n)
    return (l_new, li_new, _refresh_alpha(li_new, resid, idx <= n), d,
            clamped)


def lazy_append_rows(l_buf: Tensor, li_buf: Tensor, p_pads: Tensor, cs: Tensor,
                     resid: Tensor, n: int
                     ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Append q bordered rows, then one alpha refresh.

    Row i lands at index n + i; `p_pads (q, n_max)` row i covers the first
    n + i rows of the final point buffer, `cs (q,)` the self-covariances,
    `resid` includes all q new rows.  Returns (l_new, li_new, alpha,
    ds (q,), clamped count).
    """
    l_new, li_new = l_buf.clone(), li_buf.clone()
    alpha = torch.empty_like(resid)
    ds, clamped = lazy_append_rows_(l_new, li_new, alpha, p_pads, cs, resid, n)
    return l_new, li_new, alpha, ds, clamped


def lazy_append_rows_(l_buf: Tensor, li_buf: Tensor, alpha: Tensor,
                      p_pads: Tensor, cs: Tensor, resid: Tensor, n: int
                      ) -> tuple[Tensor, Tensor]:
    """`lazy_append_rows` in place: rows n .. n + q - 1 of `l_buf` and
    `li_buf` and all of `alpha` are written into the given buffers (one
    study's rows of a stacked state, as the engine's fantasies write them),
    so no (n_max, n_max) buffer is copied.  Returns (ds (q,), clamped
    count)."""
    ds, clamped = [], 0
    for i in range(p_pads.shape[0]):
        q, r, d, cl = _bordered_row(li_buf, p_pads[i], cs[i])
        _put_append_row(l_buf, q, d, n + i)
        _put_append_row(li_buf, r, 1.0 / d, n + i)
        ds.append(d)
        clamped = clamped + cl
    idx = torch.arange(l_buf.shape[-1], device=l_buf.device)
    alpha.copy_(_refresh_alpha(li_buf, resid, idx < n + p_pads.shape[0]))
    return torch.stack(ds), clamped


# ---------------------------------------------------------------------------
# Fused EI value + gradient (DESIGN.md §11).
# ---------------------------------------------------------------------------

def fused_supported(kernel_fn, acq_name: str) -> bool:
    """True iff the fused kernel covers this (kernel, acquisition) pair: EI
    over the Matérn-2.5 or the mixed kernel.  Anything else takes the
    autodiff ascent."""
    return acq_name == "ei" and \
        getattr(kernel_fn, "gram_kernel", None) in ("matern52", "mixed")


def fused_ei_grad(x: Tensor, x_buf: Tensor, amask: Tensor, alpha: Tensor,
                  a_buf: Tensor, sigma2, rho, shift, *,
                  cont_mask: Tensor | None = None,
                  cat_mask: Tensor | None = None,
                  plan_rows: int | None = None) -> tuple[Tensor, Tensor]:
    """Fused EI value + gradient for a whole (r, d) candidate batch.

    Args:
      x: (r, d) candidate batch (the restart set).
      x_buf: (n_max, d) padded train buffer.
      amask: (n_max,) 0/1 active-row mask.
      alpha: (n_max,) padded weights, zero beyond the active block.
      a_buf: (n_max, n_max) hoisted A = li_buf^T li_buf.
      sigma2, rho: kernel hyper-parameters; shift = ymean - f_best - xi.
      cont_mask/cat_mask: (d,) type masks of a mixed space (None = float).
      plan_rows: a restart shard's unsharded R (`acq.launch_plan`): its r
        rows are summed as in the launch on all R.

    Returns (ei (r,), grad (r, d)).  For a mixed space the rows split by
    the masks (in the kernel's loads on the card, in `acq.split_rows` on
    the CPU) and the gradient is taken on the continuous block, so it is
    zero on the categorical coordinates by construction.  Batched: a
    leading axis on every tensor and (G,) scalars, one launch; the masks
    are (d,), shared by the batch, or (G, d), one type layout a study.
    """
    return acq_kernels.fused_ei_grad(x, x_buf, amask.to(x.dtype), alpha,
                                     a_buf, sigma2, rho, shift,
                                     cont_mask=cont_mask, cat_mask=cat_mask,
                                     plan_rows=plan_rows)
