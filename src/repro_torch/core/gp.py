"""Lazy Gaussian process regression (the paper's surrogate model).

Counterpart of `repro/core/gp.py`.  Fixed-shape padded buffers hold the
observed points, the observations, the identity-padded Cholesky factor and
its maintained inverse; `append` is the paper's O(n^2) Alg. 3 step;
`refactor` / `refit_params` are the lag-event refactorization with kernel
hyper-parameter re-estimation by log marginal likelihood; `fantasize` /
`truncate` are the fantasy rows of the q-suggestion protocol and their
rollback.

The active count `n` and the lag counter `since_refit` of one study are
Python ints in the state: the BO loop is driven from the host, and a
device counter would make every capacity or lag check wait for the card.
`clamp_count` stays a 0-d int32 tensor on the device.  Transitions return
new states and never write a buffer of their input state, except where a
caller asks for `in_place` (the engine's fantasy rows and rollback).

Stacked studies (DESIGN.md §7): `init_pool_state` / `stack_states` build a
state whose leaves carry a leading study axis S, with `n`, `since_refit`
and `clamp_count` (S,) int32 tensors on the device and (S,) params; the
stacked engine (`repro_torch.hpo.engine`) keeps host mirrors of the
counters and advances the state in place (`append_stacked`: one column
gram for all studies, then each study's rows by `append`'s calls, so a
lane stays bit for bit the single-study state), as the reference's engine
donates its buffers.  `unstack_state` gives one study
as a single-study state that every function here takes.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import cholesky as chol
from repro_torch.core import descriptor as desc_mod
from repro_torch.core.kernels import (KERNELS, KernelFn, KernelParams,
                                      make_mixed_kernel)
from repro_torch.kernels import ops

Tensor = torch.Tensor


class GPCapacityError(RuntimeError):
    """Base of the capacity-rejection taxonomy; `retryable` says whether
    retrying the same call can ever succeed."""

    retryable = False


class StudySaturatedError(GPCapacityError):
    """Terminal: an append can never fit the study's fixed (n_max, ...)
    buffers.  Without this guard the row write at n == n_max would fail or
    corrupt the last row of the factor."""

    retryable = False


class BackpressureError(GPCapacityError):
    """Transient admission rejection: the same call can succeed later."""

    retryable = True


def ensure_capacity(n: int, n_max: int, incoming: int = 1) -> None:
    """Host-side capacity guard: fail loudly *before* the buffer overflows."""
    if n + incoming > n_max:
        raise StudySaturatedError(
            f"GP buffer full: n={n} + {incoming} incoming observation(s) "
            f"exceeds n_max={n_max}; raise n_max (GPConfig/BOConfig) or stop "
            f"absorbing")


def reference_precision() -> None:
    """fp32 like the reference, process-wide: no TF32 in matmuls or cuDNN
    convolutions, and bfloat16 GEMMs reduced in float32 (PyTorch's default
    lets cuBLAS reduce them in bfloat16)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point was asked for; a CUDA request without a
    usable card raises instead of carrying on on the CPU.  Resolving a card
    sets `reference_precision`, so every entry point that runs on one
    computes as the reference does."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not "
                f"available; pass device='cpu' to run the plain PyTorch "
                f"versions")
        reference_precision()
    return dev


@dataclasses.dataclass(frozen=True)
class LazyGPState:
    """Padded, fixed-shape GP state (DESIGN.md §4)."""

    x_buf: Tensor        # (n_max, d) observed points
    y_buf: Tensor        # (n_max,) observations
    l_buf: Tensor        # (n_max, n_max) identity-padded factor of K + noise I
    li_buf: Tensor       # (n_max, n_max) identity-padded inverse factor L^{-1}
    alpha: Tensor        # (n_max,) (K + noise I)^{-1} (y - mean), zero-padded
    n: int | Tensor      # active count (host; stacked: (S,) int32, device)
    since_refit: int | Tensor  # appends since the last full refactor (the
    # same)
    clamp_count: Tensor  # () int32 appends whose d^2 hit the floor (device)
    params: KernelParams

    @property
    def is_batched(self) -> bool:
        """A stacked state: every leaf has a leading study axis."""
        return self.x_buf.ndim == 3

    @property
    def n_studies(self) -> int:
        return self.x_buf.shape[0] if self.is_batched else 1

    @property
    def n_max(self) -> int:
        return self.x_buf.shape[-2]

    @property
    def dim(self) -> int:
        return self.x_buf.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.x_buf.device


@dataclasses.dataclass(frozen=True)
class GPConfig:
    n_max: int = 1024
    dim: int = 5
    kernel: str = "matern52"
    lag: int = 0           # 0 = never refit (the fully lazy GP of the paper)
    noise2: float = 1e-6
    rho0: float = 0.25     # initial length scale on the unit box (the paper
    # fixes rho = 1; paper-repro benchmarks pass rho0 = 1.0 explicitly)
    desc: desc_mod.TypeDescriptor | None = None  # mixed-space type
    # descriptor (DESIGN.md §10): when it has discrete coordinates,
    # `kernel_fn` is the mixed Matérn x categorical kernel over the encoded
    # unit cube, closed over the descriptor's masks (on their device)
    dtype: torch.dtype = torch.float32
    device: str = "cuda"

    def __post_init__(self):
        if self.kernel not in KERNELS:
            raise ValueError(f"unknown kernel {self.kernel!r}; expected one "
                             f"of {tuple(KERNELS)}")
        if self.desc is not None and self.desc.has_discrete \
                and self.kernel != "matern52":
            raise ValueError(
                f"mixed spaces require kernel='matern52' (the mixed kernel "
                f"is its Matérn x categorical product), got {self.kernel!r}")

    @property
    def kernel_fn(self) -> KernelFn:
        if self.desc is not None and self.desc.has_discrete:
            return make_mixed_kernel(self.desc.cont_mask, self.desc.cat_mask)
        return KERNELS[self.kernel]


def init_state(cfg: GPConfig, params: KernelParams | None = None) -> LazyGPState:
    dev = resolve_device(cfg.device)
    params = params or KernelParams(sigma2=1.0, rho=cfg.rho0, noise2=cfg.noise2)
    return LazyGPState(
        x_buf=torch.zeros((cfg.n_max, cfg.dim), dtype=cfg.dtype, device=dev),
        y_buf=torch.zeros((cfg.n_max,), dtype=cfg.dtype, device=dev),
        l_buf=torch.eye(cfg.n_max, dtype=cfg.dtype, device=dev),
        li_buf=torch.eye(cfg.n_max, dtype=cfg.dtype, device=dev),
        alpha=torch.zeros((cfg.n_max,), dtype=cfg.dtype, device=dev),
        n=0, since_refit=0,
        clamp_count=torch.zeros((), dtype=torch.int32, device=dev),
        params=params.to(dev, cfg.dtype),
    )


# ---------------------------------------------------------------------------
# Stacked study axis (DESIGN.md §7): constructors, views and writes.
# ---------------------------------------------------------------------------

def _leaves(state: LazyGPState) -> tuple:
    return (state.x_buf, state.y_buf, state.l_buf, state.li_buf, state.alpha,
            state.clamp_count, state.params.sigma2, state.params.rho,
            state.params.noise2)


def _with_leaves(state: LazyGPState, leaves, n, since_refit) -> LazyGPState:
    x_buf, y_buf, l_buf, li_buf, alpha, clamp, sigma2, rho, noise2 = leaves
    return LazyGPState(x_buf=x_buf, y_buf=y_buf, l_buf=l_buf, li_buf=li_buf,
                       alpha=alpha, n=n, since_refit=since_refit,
                       clamp_count=clamp,
                       params=KernelParams(sigma2, rho, noise2))


def stack_states(states: "list[LazyGPState]") -> LazyGPState:
    """Stack single-study states (one n_max and width, one device) into one
    state with a leading study axis."""
    dev = states[0].device
    leaves = [torch.stack([torch.as_tensor(v, device=dev) for v in vs])
              for vs in zip(*(_leaves(st) for st in states))]

    def counter(name):
        return torch.tensor([int(getattr(st, name)) for st in states],
                            dtype=torch.int32, device=dev)

    return _with_leaves(states[0], leaves, counter("n"),
                        counter("since_refit"))


def init_pool_state(cfg: GPConfig, n_studies: int,
                    params: KernelParams | None = None) -> LazyGPState:
    """Stacked state for `n_studies` empty studies with the same kernel
    params; per-study params diverge at lag events."""
    if n_studies < 1:
        raise ValueError(f"n_studies must be >= 1, got {n_studies}")
    return stack_states([init_state(cfg, params)] * n_studies)


def unstack_state(state: LazyGPState, study: int, *, n: int | None = None,
                  since_refit: int | None = None,
                  copy: bool = False) -> LazyGPState:
    """Study `study` of a stacked state as a single-study state: views of
    its rows (its own buffers with `copy`).  `n` / `since_refit` are the
    host counts where the caller keeps them (the engine's mirrors); else
    they are read from the device."""
    leaves = [leaf[study].clone() if copy else leaf[study]
              for leaf in _leaves(state)]
    return _with_leaves(
        state, leaves, int(state.n[study]) if n is None else n,
        int(state.since_refit[study]) if since_refit is None else since_refit)


def lanes(state: LazyGPState, sl: slice) -> LazyGPState:
    """A slice of the study axis as a stacked state of views: in-place
    transitions on it (`append_stacked`) write the full stack."""
    return _with_leaves(state, [leaf[sl] for leaf in _leaves(state)],
                        state.n[sl], state.since_refit[sl])


def place(state: LazyGPState, device: torch.device) -> LazyGPState:
    """A stacked state copied onto `device`, over buffers of its own."""
    return _with_leaves(state, [leaf.to(device, copy=True)
                                for leaf in _leaves(state)],
                        state.n.to(device, copy=True),
                        state.since_refit.to(device, copy=True))


def concat_states(states: "list[LazyGPState]",
                  device: torch.device) -> LazyGPState:
    """Stacked states joined along the study axis, on `device`."""
    def cat(vs):
        return torch.cat([v.to(device) for v in vs])
    return _with_leaves(states[0], [cat(vs) for vs in
                                    zip(*(_leaves(st) for st in states))],
                        cat([st.n for st in states]),
                        cat([st.since_refit for st in states]))


def copy_lanes(dst: LazyGPState, src: LazyGPState, idx) -> None:
    """Studies `idx` of stacked state `src` written into `dst`, in place
    and bit for bit (the two may sit on different devices)."""
    for d, v in zip((*_leaves(dst), dst.n, dst.since_refit),
                    (*_leaves(src), src.n, src.since_refit)):
        d[idx] = v[idx].to(d.device)


def write_study(state: LazyGPState, study: int, sub: LazyGPState) -> None:
    """Copy single-study state `sub` into study `study` of a stacked
    state, in place and bit for bit."""
    for leaf, v in zip(_leaves(state), _leaves(sub)):
        leaf[study] = v
    state.n[study] = int(sub.n)
    state.since_refit[study] = int(sub.since_refit)


def _active_mask(state: LazyGPState, n: int | Tensor | None = None) -> Tensor:
    """Rows below n: (n_max,), or (S, n_max) for a stacked state."""
    n = state.n if n is None else n
    if isinstance(n, Tensor):
        n = n[..., None]
    return torch.arange(state.n_max, device=state.device) < n


def _ymean(state: LazyGPState) -> Tensor:
    """Mean of the active observations (GP prior mean = running mean);
    (S,) for a stacked state."""
    return _masked_mean(torch.where(_active_mask(state), state.y_buf, 0.0),
                        state.n)


def _masked_mean(masked_y: Tensor, n: int | Tensor) -> Tensor:
    """Sum over the last axis of zero-padded observations, over n: a host
    int for one study (the single-study mean, which a stacked caller
    computes lane by lane to keep its bits), or an (S,) tensor."""
    total = torch.sum(masked_y, dim=-1)
    if isinstance(n, Tensor):
        return total / torch.clamp(n, min=1)
    return total / max(n, 1)


def _recompute_alpha(state: LazyGPState) -> Tensor:
    """alpha = L^{-T} (L^{-1} r) as two matvecs against the maintained
    inverse (padding-exact: rows >= n of `li_buf` are identity against a
    zero-padded residual)."""
    m = _active_mask(state)
    resid = torch.where(m, state.y_buf - _ymean(state), 0.0)
    z = state.li_buf @ resid
    return torch.where(m, z @ state.li_buf, 0.0)


def _cov_column(state: LazyGPState, kernel: KernelFn,
                x_new: Tensor) -> tuple[Tensor, Tensor]:
    """(p_pad, c): covariances of x_new against actives (padded) and itself."""
    p = ops.kernel_gram(kernel, state.x_buf, x_new[None, :], state.params)[:, 0]
    p_pad = torch.where(_active_mask(state), p, 0.0)
    c = kernel(x_new[None, :], x_new[None, :], state.params)[0, 0] \
        + state.params.noise2
    return p_pad, c


def _write_point(state: LazyGPState, x_new: Tensor, y_new) -> tuple[Tensor, Tensor]:
    """Copies of x_buf / y_buf with the new point at row n (own buffers,
    written in place)."""
    x_buf, y_buf = state.x_buf.clone(), state.y_buf.clone()
    x_buf[state.n] = x_new
    y_buf[state.n] = y_new
    return x_buf, y_buf


def _append_row_only(state: LazyGPState, kernel: KernelFn, x_new: Tensor,
                     y_new) -> LazyGPState:
    """Row append with a *stale* alpha (the deferred-alpha batch path);
    `append_batch` refreshes alpha once per batch."""
    p_pad, c = _cov_column(state, kernel, x_new)
    l_buf, li_buf, _, clamped = ops.padded_append_row(
        state.l_buf, state.li_buf, p_pad, c, state.n)
    x_buf, y_buf = _write_point(state, x_new, y_new)
    return dataclasses.replace(
        state, x_buf=x_buf, y_buf=y_buf, l_buf=l_buf, li_buf=li_buf,
        n=state.n + 1, since_refit=state.since_refit + 1,
        clamp_count=state.clamp_count + clamped)


def append(state: LazyGPState, kernel: KernelFn, x_new: Tensor,
           y_new) -> LazyGPState:
    """Absorb one observation in O(n_max^2) (paper Alg. 3): the fused row
    append, inverse update and alpha refresh of `ops.lazy_append`."""
    ensure_capacity(state.n, state.n_max)
    p_pad, c = _cov_column(state, kernel, x_new)
    x_buf, y_buf = _write_point(state, x_new, y_new)
    n_new = state.n + 1
    mask_new = _active_mask(state, n_new)
    ymean = torch.sum(torch.where(mask_new, y_buf, 0.0)) / n_new
    resid = torch.where(mask_new, y_buf - ymean, 0.0)
    l_buf, li_buf, alpha, _, clamped = ops.lazy_append(
        state.l_buf, state.li_buf, p_pad, c, resid, state.n)
    return dataclasses.replace(
        state, x_buf=x_buf, y_buf=y_buf, l_buf=l_buf, li_buf=li_buf,
        alpha=alpha, n=n_new, since_refit=state.since_refit + 1,
        clamp_count=state.clamp_count + clamped)


def append_stacked(state: LazyGPState, kernel: KernelFn, xs: Tensor,
                   ys: Tensor, flags: Tensor, lanes_, counts) -> None:
    """Absorb one observation into each flagged study of a stacked state,
    in place (the reference's masked `append` under vmap): `xs (S, d)`,
    `ys (S,)` and `flags (S,)` bool on the state's device; `lanes_` are
    the flagged studies and `counts` the host counts (the engine's
    mirrors).  One gram launch builds every study's covariance column (a
    lane of the batched gram is bit for bit its single-study launch); the
    rest runs lane by lane with `append`'s calls on the lane's views,
    written in place (`_append_lane`), so a lane's points, factor,
    inverse and alpha are bit for bit what `append` gives on it.  The
    other studies keep every bit.  Capacity is the caller's check
    (`ensure_capacity` on its host counts): nothing here reads the device
    back."""
    xs = xs.contiguous()
    p = ops.kernel_gram(kernel, state.x_buf, xs[:, None, :],
                        state.params)[..., 0]
    for s in lanes_:
        _append_lane(unstack_state(state, s, n=int(counts[s]), since_refit=0),
                     study_kernel(kernel, s), xs[s], ys[s], p[s])
    step = flags.to(torch.int32)
    state.n.add_(step)
    state.since_refit.add_(step)


def _append_lane(lane: LazyGPState, kernel: KernelFn, x_new: Tensor, y_new,
                 p: Tensor) -> None:
    """`append` on one study's views of a stacked state, in place, with its
    covariance column `p` given: the same calls, the rows written into the
    stack (`ops.lazy_append_rows_`) instead of new buffers."""
    n = lane.n
    p_pad = torch.where(_active_mask(lane), p, 0.0)
    c = kernel(x_new[None, :], x_new[None, :], lane.params)[0, 0] \
        + lane.params.noise2
    lane.x_buf[n] = x_new
    lane.y_buf[n] = y_new
    mask_new = _active_mask(lane, n + 1)
    ymean = torch.sum(torch.where(mask_new, lane.y_buf, 0.0)) / (n + 1)
    resid = torch.where(mask_new, lane.y_buf - ymean, 0.0)
    _, clamped = ops.lazy_append_rows_(lane.l_buf, lane.li_buf, lane.alpha,
                                       p_pad[None], c[None], resid, n)
    lane.clamp_count.add_(clamped)


def append_batch(state: LazyGPState, kernel: KernelFn, xs: Tensor,
                 ys: Tensor) -> LazyGPState:
    """Absorb t observations as t sequential row appends (paper Sec. 3.4),
    with the alpha refresh deferred to once per batch."""
    ensure_capacity(state.n, state.n_max, xs.shape[0])
    for i in range(xs.shape[0]):
        state = _append_row_only(state, kernel, xs[i], ys[i])
    return dataclasses.replace(state, alpha=_recompute_alpha(state))


# ---------------------------------------------------------------------------
# Fantasy rows: the q-suggestion protocol (DESIGN.md §12).
# ---------------------------------------------------------------------------

FANTASY_LIARS = ("mean", "pessimistic")


@dataclasses.dataclass(frozen=True)
class FantasyConfig:
    """Liar policy for pending-trial fantasies (Snoek et al. 2012).

    * "mean"        — kriging believer: the liar value is the posterior mean
                      at the fantasy point, so the mean surface is (nearly)
                      unchanged and only the variance collapses there.
    * "pessimistic" — constant liar: the worst (max) active observation, so
                      the fantasized point actively repels later suggestions.
    """

    liar: str = "mean"

    def __post_init__(self):
        if self.liar not in FANTASY_LIARS:
            raise ValueError(
                f"unknown fantasy liar {self.liar!r}; "
                f"expected one of {FANTASY_LIARS}")


def _copy(state: LazyGPState) -> LazyGPState:
    """The state over its own buffers (counters too where they are
    tensors)."""
    def own(v):
        return v.clone() if isinstance(v, Tensor) else v
    return _with_leaves(state, [leaf.clone() for leaf in _leaves(state)],
                        own(state.n), own(state.since_refit))


def study_kernel(kernel: KernelFn, study: int) -> KernelFn:
    """Study `study`'s kernel out of one that covers a stack: the mixed
    closure over (S, d) masks gives the closure over row `study`'s."""
    if getattr(kernel, "gram_kernel", None) == "mixed" \
            and kernel.cont_mask.ndim > 1:
        return make_mixed_kernel(kernel.cont_mask[study],
                                 kernel.cat_mask[study])
    return kernel


def fantasy_values(state: LazyGPState, kernel: KernelFn, xs: Tensor,
                   liar: str = "mean") -> Tensor:
    """Liar observations for fantasy points `xs (q, d)` against one study's
    state, all computed against the *input* state (exact for q = 1, the
    per-step path of the q-suggest loop)."""
    if liar not in FANTASY_LIARS:
        raise ValueError(f"unknown fantasy liar {liar!r}; "
                         f"expected one of {FANTASY_LIARS}")
    if liar == "pessimistic":
        worst = torch.amax(torch.where(_active_mask(state), state.y_buf,
                                       -math.inf))
        if state.n == 0:
            worst = torch.zeros_like(worst)
        return worst.expand(xs.shape[0]).clone()
    mean, _ = posterior(state, kernel, xs)
    return mean


def fantasize(state: LazyGPState, kernel: KernelFn, xs: Tensor,
              liar: str = "mean", *, in_place: bool = False) -> LazyGPState:
    """Append q fantasy rows `xs (q, d)`: full bordered appends (the factor,
    the inverse and alpha all see them, so an ascent on the fantasized
    state is the ordinary ascent), but `since_refit` and `clamp_count` stay
    as they are: fantasies are scratch state that must never trigger a lag
    refit, and their rollback (`truncate`) has no telemetry to un-count.

    The liar values are taken against the input state; x and y land at
    rows n .. n + q - 1; one gram build covers the whole point buffer
    against `xs`, column i masked to the rows below n + i; then the rows
    and one alpha refresh (`ops.lazy_append_rows_`).  `in_place` writes
    them into the state's own buffers (the engine's views of one study's
    rows) and returns a state over those buffers; otherwise the input is
    left as it is.  Stacked: `xs (S, q, d)` appends q rows to each study
    (one study after another, reading each study's n from the device).
    """
    if state.is_batched:
        counts = state.n.tolist()
        for count in counts:
            ensure_capacity(count, state.n_max, xs.shape[1])
        out = state if in_place else _copy(state)
        for s, count in enumerate(counts):
            fantasize(unstack_state(out, s, n=count), study_kernel(kernel, s),
                      xs[s], liar, in_place=True)
        out.n.add_(xs.shape[1])
        return out
    q, n, n_max = xs.shape[0], state.n, state.n_max
    ensure_capacity(n, n_max, q)
    ys = fantasy_values(state, kernel, xs, liar)
    st = state if in_place else _copy(state)
    st.x_buf[n:n + q] = xs
    st.y_buf[n:n + q] = ys
    idx = torch.arange(n_max, device=st.device)
    p_all = ops.kernel_gram(kernel, st.x_buf, xs, st.params)   # (n_max, q)
    cols = torch.where(idx[:, None] < n + torch.arange(q, device=st.device),
                       p_all, 0.0)
    cs = kernel(xs[:, None, :], xs[:, None, :], st.params)[:, 0, 0] \
        + st.params.noise2
    mask_new = idx < n + q
    ymean = torch.sum(torch.where(mask_new, st.y_buf, 0.0)) / (n + q)
    resid = torch.where(mask_new, st.y_buf - ymean, 0.0)
    ops.lazy_append_rows_(st.l_buf, st.li_buf, st.alpha, cols.T, cs, resid, n)
    return dataclasses.replace(st, n=n + q)


def truncate(state: LazyGPState, n_real, *, in_place: bool = False,
             alpha: Tensor | None = None) -> LazyGPState:
    """Roll back every row >= n_real to the identity-padded empty state.

    Appends write only row n of `l_buf` / `li_buf` / `x_buf` / `y_buf`, and
    before the rolled-back rows were appended they were exactly identity
    (factor, inverse) and exactly zero (points, observations); re-padding
    therefore restores those four buffers bit for bit.  Alpha is
    recomputed against the restored inverse, or set to `alpha` where the
    caller kept the pre-fantasy vector (the engine does): the recompute is
    another float32 evaluation than the fused append's, so it may differ
    from the pre-fantasy alpha in the last bit.  `since_refit` and
    `clamp_count` are untouched, since `fantasize` never advanced them.
    `in_place` re-pads the state's own buffers.  Stacked: `n_real (S,)`.
    """
    if state.is_batched:
        out = state if in_place else _copy(state)
        counts = [int(v) for v in n_real]
        for s, count in enumerate(counts):
            truncate(unstack_state(out, s, n=count), count, in_place=True,
                     alpha=None if alpha is None else alpha[s])
        out.n.copy_(torch.tensor(counts, dtype=torch.int32))
        return out
    n_real = int(n_real)
    st = dataclasses.replace(state if in_place else _copy(state), n=n_real)
    st.x_buf[n_real:].zero_()
    st.y_buf[n_real:].zero_()
    for buf in (st.l_buf, st.li_buf):
        buf[n_real:].zero_()
        torch.diagonal(buf)[n_real:].fill_(1.0)
    st.alpha.copy_(_recompute_alpha(st) if alpha is None else alpha)
    return st


def posterior(state: LazyGPState, kernel: KernelFn, x_star: Tensor,
              *, ymean: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Posterior mean and variance at query points x_star (m, d):
    mean = k_*^T alpha + ymean, var = k_** - v^T v with v = L^{-1} k_*
    (paper Alg. 1 lines 3-6), on padded buffers.  `ymean` may be hoisted
    by a caller that queries one frozen state many times."""
    if ymean is None:
        ymean = _ymean(state)
    k_star = ops.kernel_gram(kernel, state.x_buf, x_star, state.params)
    k_star = torch.where(_active_mask(state)[:, None], k_star, 0.0)
    mean = k_star.T @ state.alpha + ymean
    v = state.li_buf @ k_star                                  # (n_max, m)
    k_ss = kernel(x_star, x_star, state.params)
    var = torch.clamp(torch.diagonal(k_ss) - torch.sum(v * v, dim=0),
                      min=1e-12)
    return mean, var


def log_marginal_likelihood(state: LazyGPState) -> Tensor:
    """log p(y | X) = -1/2 y^T alpha - sum log L_ii - n/2 log 2pi (Alg. 1 l.7);
    the identity padding contributes log(1) = 0."""
    m = _active_mask(state)
    resid = torch.where(m, state.y_buf - _ymean(state), 0.0)
    quad = resid @ state.alpha
    logdet = torch.sum(torch.where(m, torch.log(torch.diagonal(state.l_buf)),
                                   0.0))
    return -0.5 * quad - logdet - 0.5 * state.n * math.log(2.0 * math.pi)


# ---------------------------------------------------------------------------
# Lag-event refit (paper Sec. 4.1, the lagging factor l).
# ---------------------------------------------------------------------------

def refactor(state: LazyGPState, kernel: KernelFn,
             params: KernelParams | None = None) -> LazyGPState:
    """Full O(n^3) refactorization (optionally under new kernel params):
    masked Gram, blocked Cholesky, then the inverse factor by one
    triangular solve (the one place a solve runs)."""
    params = params or state.params
    st = dataclasses.replace(state, params=params)
    k_pad = ops.masked_gram(st.x_buf, st.n, kernel, params)
    l_buf = chol.lazy_full_refactor(k_pad, st.n, n_max=st.n_max)
    li_buf = ops.padded_tri_inverse(l_buf)
    st = dataclasses.replace(st, l_buf=l_buf, li_buf=li_buf, since_refit=0)
    return dataclasses.replace(st, alpha=_recompute_alpha(st))


def _lml_grid(state: LazyGPState, kernel: KernelFn, cand: Tensor) -> Tensor:
    """LML of `state` under each candidate `[sigma2, rho]` row of `cand`
    (G, 2): the `refactor` + `log_marginal_likelihood` of every candidate,
    with the G padded Grams built, factored and inverted as one batch (one
    gram, one Cholesky and one solve launch on the card; the Grams share
    `x_buf`, expanded, never copied).  `state` stays untouched."""
    params = KernelParams(sigma2=cand[:, 0], rho=cand[:, 1],
                          noise2=state.params.noise2)
    x_bufs = state.x_buf.expand(cand.shape[0], *state.x_buf.shape)
    k_pads = ops.masked_gram(x_bufs, state.n, kernel, params)
    l_bufs = chol.lazy_full_refactor(k_pads, state.n, n_max=state.n_max)
    li_bufs = ops.padded_tri_inverse(l_bufs)                 # (G, n, n)
    m = _active_mask(state)
    resid = torch.where(m, state.y_buf - _ymean(state), 0.0)
    z = li_bufs @ resid                                      # (G, n)
    alpha = torch.where(m, (z[:, None, :] @ li_bufs)[:, 0, :], 0.0)
    quad = alpha @ resid
    diag = torch.diagonal(l_bufs, dim1=-2, dim2=-1)
    logdet = torch.sum(torch.where(m, torch.log(diag), 0.0), dim=-1)
    return -0.5 * quad - logdet - 0.5 * state.n * math.log(2.0 * math.pi)


def refit_params(state: LazyGPState, kernel: KernelFn,
                 rho_grid: Tensor | None = None,
                 sigma2_grid: Tensor | None = None) -> KernelParams:
    """Grid LML maximization over (sigma2, rho): the 6 x 3 grid of the
    reference, each candidate scored by a full refactor of `state` (which
    stays untouched), all 18 in one batch.  The argmax stays on the
    device and skips candidates whose LML is NaN."""
    dev, dt = state.device, state.x_buf.dtype
    if rho_grid is None:
        # Unit-box length scales (inputs are normalized by the BO driver).
        rho_grid = torch.tensor([0.05, 0.1, 0.2, 0.4, 0.8, 1.6], dtype=dt,
                                device=dev)
    if sigma2_grid is None:
        sigma2_grid = torch.tensor([0.25, 1.0, 4.0], dtype=dt, device=dev)
    rr, ss = torch.meshgrid(rho_grid, sigma2_grid, indexing="ij")
    cand = torch.stack([ss.ravel(), rr.ravel()], dim=-1)  # (G, 2) [sigma2, rho]
    lmls = _lml_grid(state, kernel, cand)
    # A candidate whose float32 factor broke down (a Gram the diagonal
    # clamp could not factor, so its LML is NaN) never wins.  The
    # reference's jnp.argmax returns the first NaN instead, which hands
    # the lag refit a non-finite factor (ROADMAP queue 3).
    best = torch.argmax(torch.where(torch.isnan(lmls), -torch.inf, lmls))
    return KernelParams(sigma2=cand[best, 0], rho=cand[best, 1],
                        noise2=state.params.noise2)


def maybe_refit(state: LazyGPState, kernel: KernelFn, lag: int) -> LazyGPState:
    """The lag policy: every `lag` appends, refit params + refactor.  lag <= 0
    means never (the fully lazy GP); lag == 1 is the per-iteration refit."""
    if lag <= 0 or state.since_refit < lag:
        return state
    return refactor(state, kernel, refit_params(state, kernel))


# ---------------------------------------------------------------------------
# Reference (non-lazy) GP for parity tests and the naive baseline.
# ---------------------------------------------------------------------------

def dense_posterior(x: Tensor, y: Tensor, x_star: Tensor, kernel: KernelFn,
                    params: KernelParams) -> tuple[Tensor, Tensor]:
    """Textbook GP posterior with a fresh full factorization (paper Alg. 1)."""
    n = x.shape[0]
    k = kernel(x, x, params) + params.noise2 * torch.eye(
        n, dtype=x.dtype, device=x.device)
    l = ops.cholesky(k)
    ymean = torch.mean(y)
    resid = y - ymean
    k_star = kernel(x, x_star, params)
    k_ss_diag = torch.diagonal(kernel(x_star, x_star, params))
    mean, var = ops.gp_posterior_solve(l, resid, k_star, k_ss_diag)
    return mean + ymean, var
