"""DNGO-style neural-basis surrogate: the saturation escalation tier.

Counterpart of `repro/core/neural_basis.py` (DESIGN.md §15).  A study whose
lazy-GP buffers fill to n_max escalates to this model: a small MLP feature
map phi(x) trained on the study's whole ledger, with an exact Bayesian
linear-regression head on top,

    A      = Phi^T Phi + sigma^2 I          (m+1, m+1), cached Cholesky
    mean   = y_mean + phi(x)^T w,   w = A^{-1} Phi^T (y - y_mean)
    var    = s^2 * phi(x)^T A^{-1} phi(x)

so a suggestion costs O(m^2) a candidate, flat in n.  An append is a
rank-1 update of the head's Gram and one (m+1)^2 re-Cholesky; the MLP
refits every `NeuralConfig.refit_every` appends (the tier's `lag`): a few
hundred Adam steps of full-ledger regression through a throwaway linear
output layer, after which the head is rebuilt exactly from the new
features.  A second head on the same features learns log cost, for the
acquisition's EI-per-unit-cost mode (`acquisition.cost_scaled`).

The model is MLP products of width 32 and 16 and a 17 x 17 head, which
the reference computes outside any Pallas kernel; here it is plain
PyTorch on either device, the head through `torch.linalg.cholesky_ex`
(the reference's Cholesky without the error check, which would wait for
the card) and `torch.cholesky_solve`.  Where the reference maps a scalar
function over rows (`vmap(value_and_grad)` over restarts) the port takes
one autograd pass over the (r, d) batch: the rows are independent.

Random draws are passed in, never regenerated: the MLP's initial params
(`params`, or a `torch.Generator` for the scaled normals) and the ascent's
restart seeds (`seeds`, or a generator).  A state is a dataclass of
tensors on one device with the reference's 21 fields (`n` and
`since_refit` 0-d int32), which `nb_to_json` / `nb_from_json` carry in
the reference's own format, bit for bit.  Every function returns a new
state and leaves its input as it was, so a snapshot is a reference to the
old state (the engine's fantasy rollback).  The ledger rows beyond `n` are
zero padding; `nb_grow` doubles the capacity when it is full.
"""
from __future__ import annotations

import base64
import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import acquisition as acq_mod
from repro_torch.core import descriptor as desc_mod
from repro_torch.core.gp import FANTASY_LIARS, resolve_device

Tensor = torch.Tensor

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class NeuralConfig:
    """Shape and training knobs of the neural-basis tier."""

    hidden: int = 32        # MLP hidden width
    features: int = 16      # m: basis features (head dims m+1 with bias)
    refit_every: int = 32   # appends between MLP refits (the tier's `lag`)
    refit_steps: int = 200  # Adam steps per refit
    refit_lr: float = 3e-3
    noise2: float = 1e-4    # ridge sigma^2 of the Bayes head
    cap0: int = 64          # minimum initial ledger capacity


@dataclasses.dataclass(frozen=True)
class NeuralBasisState:
    """Padded ledger, MLP params and the head's cached factors.

    Rows of `x_buf` / `y_buf` / `c_buf` beyond `n` are zero padding,
    masked out of every reduction; `c_buf` holds LOG cost.  The cache
    (`ptp` / `pty` / `ptc` / `pt1`, `chol`, `w_y` / `w_c`) always matches
    the ledger prefix and the current params: appends update it, refits
    rebuild it.
    """

    x_buf: Tensor        # (cap, d) observed points (unit space)
    y_buf: Tensor        # (cap,) observations
    c_buf: Tensor        # (cap,) log cost per observation
    n: Tensor            # () int32 active count
    since_refit: Tensor  # () int32 appends since the last MLP refit
    w1: Tensor           # (d, h) MLP layer 1
    b1: Tensor           # (h,)
    w2: Tensor           # (h, m) MLP layer 2 (its tanh output is the basis)
    b2: Tensor           # (m,)
    w3: Tensor           # (m,) throwaway linear output head (refit only)
    b3: Tensor           # ()
    ptp: Tensor          # (m+1, m+1) Phi^T Phi (bias feature appended)
    pty: Tensor          # (m+1,) Phi^T y
    ptc: Tensor          # (m+1,) Phi^T log-cost
    pt1: Tensor          # (m+1,) Phi^T 1 (for centering)
    chol: Tensor         # (m+1, m+1) lower Cholesky of ptp + noise2 I
    w_y: Tensor          # (m+1,) head weights on centered y
    w_c: Tensor          # (m+1,) log-cost head weights on centered c
    y_mean: Tensor       # () ledger mean of y at the last refit
    c_mean: Tensor       # () ledger mean of log cost at the last refit
    s2: Tensor           # () residual variance scale of the posterior

    @property
    def cap(self) -> int:
        return self.x_buf.shape[0]

    @property
    def dim(self) -> int:
        return self.x_buf.shape[1]

    @property
    def device(self) -> torch.device:
        return self.x_buf.device


FIELDS = tuple(f.name for f in dataclasses.fields(NeuralBasisState))
PARAMS = ("w1", "b1", "w2", "b2", "w3", "b3")
JITTER_STEPS = 6   # the head's fallback factors: noise2 x 10, 100, .., 10^6
COUNTERS = ("n", "since_refit")


def _replace(state: NeuralBasisState, **kw) -> NeuralBasisState:
    return dataclasses.replace(state, **kw)


# -- features + posterior -----------------------------------------------------
def _tanh(x: Tensor) -> Tensor:
    """tanh of a float32 tensor evaluated in float64 and rounded, so that
    it is within 0.5 ulp on every device; its gradient is taken in float64
    too and rounded.  The card's `torch.tanh` (CUDA's tanhf) is 1.8 ulp
    off, where the CPU's is 0.56, and over a refit's 400 steps the card's
    head then drifted further from float64 than the CPU float32 replays
    (PERF.md).  One path on every device; a float64 tensor takes
    `torch.tanh`."""
    if x.dtype == torch.float32:
        return torch.tanh(x.double()).float()
    return torch.tanh(x)


def _features(state: NeuralBasisState, x: Tensor) -> Tensor:
    """phi(x): (..., m+1), two tanh layers and a constant bias feature."""
    h = _tanh(x @ state.w1 + state.b1)
    f = _tanh(h @ state.w2 + state.b2)
    return torch.cat([f, torch.ones_like(f[..., :1])], dim=-1)


def nb_posterior(state: NeuralBasisState, x: Tensor
                 ) -> tuple[Tensor, Tensor]:
    """Posterior mean and variance at `x (r, d)`: two GEMMs and one solve
    against the cached factor, O(m^2) a point."""
    phi = _features(state, x)                                  # (r, m+1)
    mean = state.y_mean + phi @ state.w_y
    sol = torch.cholesky_solve(phi.transpose(0, 1), state.chol)  # (m+1, r)
    var = state.s2 * torch.sum(phi * sol.transpose(0, 1), dim=-1)
    return mean, torch.clamp(var, min=1e-10)


def nb_log_cost(state: NeuralBasisState, x: Tensor) -> Tensor:
    """Predicted log cost at `x (..., d)` (the cost head)."""
    return state.c_mean + _features(state, x) @ state.w_c


def _active_mask(state: NeuralBasisState) -> Tensor:
    return torch.arange(state.cap, device=state.device) < state.n


def _f_best(state: NeuralBasisState) -> Tensor:
    return torch.amax(torch.where(_active_mask(state), state.y_buf,
                                  -torch.inf))


# -- head solve (shared by append + refit) ------------------------------------
def _solve_heads(ncfg: NeuralConfig, ptp: Tensor, pty: Tensor, ptc: Tensor,
                 pt1: Tensor, y_mean: Tensor, c_mean: Tensor
                 ) -> tuple[Tensor, Tensor, Tensor]:
    """The factor of ptp + noise2 I and the two heads' weights (one solve
    with two right-hand sides).

    Float32 round-off in ptp can leave ptp + noise2 I indefinite where the
    head's condition number nears 1 / eps (one-hot features of a mixed
    ledger: 1e7-1e8); the reference's factor is then NaN, and so is every
    later suggestion of the study.  So the factors of ptp + 10^k noise2 I
    (k = 1 .. JITTER_STEPS) are taken beside it in one batched call, and
    the first that exists stands in where the plain one does not.  Where
    the plain factor exists it is used, bit for bit; nothing is read back
    from the device."""
    eye = torch.eye(ptp.shape[0], dtype=ptp.dtype, device=ptp.device)
    a = ptp + ncfg.noise2 * eye
    chol, info = torch.linalg.cholesky_ex(a)
    jitter = ncfg.noise2 * 10.0 ** torch.arange(
        1, JITTER_STEPS + 1, dtype=ptp.dtype, device=ptp.device)
    ladder, infos = torch.linalg.cholesky_ex(a + jitter[:, None, None] * eye)
    first = torch.argmax((infos == 0).to(torch.int32))
    chol = torch.where(info == 0, chol, ladder[first])
    rhs = torch.stack([pty - y_mean * pt1, ptc - c_mean * pt1], dim=-1)
    w = torch.cholesky_solve(rhs, chol)
    return chol, w[:, 0], w[:, 1]


def _rebuild_cache(state: NeuralBasisState, ncfg: NeuralConfig
                   ) -> NeuralBasisState:
    """Exact rebuild of the head from the whole (masked) ledger."""
    mask = _active_mask(state)
    nf = torch.clamp(state.n.to(state.y_buf.dtype), min=1.0)
    phi = _features(state, state.x_buf) * mask[:, None]       # (cap, m+1)
    y = torch.where(mask, state.y_buf, 0.0)
    c = torch.where(mask, state.c_buf, 0.0)
    y_mean, c_mean = torch.sum(y) / nf, torch.sum(c) / nf
    pt = phi.transpose(0, 1)
    ptp, pty, ptc = pt @ phi, pt @ y, pt @ c
    pt1 = torch.sum(phi, dim=0)
    chol, w_y, w_c = _solve_heads(ncfg, ptp, pty, ptc, pt1, y_mean, c_mean)
    # Residual variance of the new head on the ledger, the posterior's
    # scale; floored at noise2 so an interpolated ledger still explores.
    pred = y_mean + phi @ w_y
    resid = torch.where(mask, state.y_buf - pred, 0.0)
    s2 = torch.clamp(torch.sum(resid * resid) / nf, min=ncfg.noise2)
    return _replace(state, ptp=ptp, pty=pty, ptc=ptc, pt1=pt1, chol=chol,
                    w_y=w_y, w_c=w_c, y_mean=y_mean, c_mean=c_mean, s2=s2,
                    since_refit=torch.zeros_like(state.since_refit))


# -- append (rank 1) ----------------------------------------------------------
def nb_append(state: NeuralBasisState, x: Tensor, y, logc,
              ncfg: NeuralConfig) -> NeuralBasisState:
    """One observation `x (d,)`, `y`, log cost `logc` (tensors on the
    state's device, or numbers): the ledger row at `n`, the rank-1 update
    of the head's Gram and its re-Cholesky.  Flat in n.  Reads nothing
    back from the device; the row must fit (`cap > n`, see `nb_grow`)."""
    dt, dev = state.y_buf.dtype, state.device
    x = torch.as_tensor(x, dtype=dt, device=dev)
    y = torch.as_tensor(y, dtype=dt, device=dev)
    logc = torch.as_tensor(logc, dtype=dt, device=dev)
    phi = _features(state, x)                                  # (m+1,)
    ptp = state.ptp + torch.outer(phi, phi)
    pty = state.pty + phi * y
    ptc = state.ptc + phi * logc
    pt1 = state.pt1 + phi
    chol, w_y, w_c = _solve_heads(ncfg, ptp, pty, ptc, pt1, state.y_mean,
                                  state.c_mean)
    row = state.n.to(torch.int64).reshape(1)
    return _replace(
        state,
        x_buf=state.x_buf.index_copy(0, row, x[None]),
        y_buf=state.y_buf.index_copy(0, row, y.reshape(1)),
        c_buf=state.c_buf.index_copy(0, row, logc.reshape(1)),
        n=state.n + 1, since_refit=state.since_refit + 1,
        ptp=ptp, pty=pty, ptc=ptc, pt1=pt1, chol=chol, w_y=w_y, w_c=w_c)


# -- refit (MLP training + exact cache rebuild) -------------------------------
def _refit_grad(x_buf: Tensor, mask: Tensor, targets: Tensor, nf: Tensor,
                params: Sequence[Tensor]) -> tuple[Tensor, ...]:
    """Gradient of the masked MSE over all `cap` ledger rows / nf through
    the throwaway linear head.  The padding rows take part in the forward
    pass; their error is 0 by `where`, so they add exactly 0."""
    with torch.enable_grad():
        ps = [p.detach().requires_grad_(True) for p in params]
        w1, b1, w2, b2, w3, b3 = ps
        h = _tanh(x_buf @ w1 + b1)
        f = _tanh(h @ w2 + b2)
        pred = f @ w3 + b3
        err = torch.where(mask, pred - targets, 0.0)
        loss = torch.sum(err * err) / nf
        return torch.autograd.grad(loss, ps)


def _adam_step(params, m, v, g, t: int, lr: float, dtype: torch.dtype):
    """Adam step t (from 0) in the reference's order: m, v, then
    p - lr (m / (1 - b1^t')) / (sqrt(v / (1 - b2^t')) + eps), t' = t + 1,
    the bias corrections taken in the params' precision on the host."""
    f = np.float32 if dtype == torch.float32 else np.float64
    tf = f(t) + f(1.0)
    c1 = float(f(1.0) - f(ADAM_B1) ** tf)
    c2 = float(f(1.0) - f(ADAM_B2) ** tf)
    m = torch._foreach_add(torch._foreach_mul(m, ADAM_B1),
                           torch._foreach_mul(g, 1 - ADAM_B1))
    v = torch._foreach_add(torch._foreach_mul(v, ADAM_B2),
                           torch._foreach_mul(torch._foreach_mul(g, g),
                                              1 - ADAM_B2))
    num = torch._foreach_mul(torch._foreach_div(m, c1), lr)
    den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(v, c2)),
                             ADAM_EPS)
    return torch._foreach_sub(params, torch._foreach_div(num, den)), m, v


def nb_refit(state: NeuralBasisState, ncfg: NeuralConfig
             ) -> NeuralBasisState:
    """Retrain the feature map on the whole ledger (DNGO: full-batch Adam,
    `refit_steps` steps, on the MSE of the throwaway linear head), then
    rebuild the head exactly."""
    mask = _active_mask(state)
    nf = torch.clamp(state.n.to(state.y_buf.dtype), min=1.0)
    y_mean = torch.sum(torch.where(mask, state.y_buf, 0.0)) / nf
    targets = torch.where(mask, state.y_buf - y_mean, 0.0)
    params = [getattr(state, k) for k in PARAMS]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    for t in range(ncfg.refit_steps):
        g = _refit_grad(state.x_buf, mask, targets, nf, params)
        params, m, v = _adam_step(params, m, v, g, t, ncfg.refit_lr,
                                  state.y_buf.dtype)
    return _rebuild_cache(_replace(state, **dict(zip(PARAMS, params))), ncfg)


# -- init / promotion ---------------------------------------------------------
def nb_init(d: int, cap: int, ncfg: NeuralConfig, *,
            params: Mapping[str, object] | None = None,
            generator: torch.Generator | None = None,
            device: str | torch.device = "cuda") -> NeuralBasisState:
    """Empty float32 state of capacity `cap` on `device`.  The MLP params
    are `params` (arrays or tensors by name: w1, b1, w2, b2, w3, b3, e.g.
    the reference's `nb_init` leaves), else the reference's scaled normals
    drawn from `generator` (w1 / sqrt(d), w2 / sqrt(h), w3 / sqrt(m), zero
    biases)."""
    dev = resolve_device(device)
    h, m = ncfg.hidden, ncfg.features
    f32 = torch.float32

    def z(*shape):
        return torch.zeros(shape, dtype=f32, device=dev)

    if params is not None:
        w = [torch.as_tensor(p if isinstance(p, Tensor) else np.asarray(
            p, np.float32), dtype=f32, device=dev)
             for p in (params[k] for k in PARAMS)]
        shapes = [(d, h), (h,), (h, m), (m,), (m,), ()]
        if [tuple(p.shape) for p in w] != shapes:
            raise ValueError(f"params shapes {[tuple(p.shape) for p in w]}, "
                             f"expected {shapes}")
    elif generator is not None:
        def normal(*shape):     # drawn on the generator's device
            return torch.randn(shape, generator=generator, dtype=f32,
                               device=generator.device).to(dev)
        w = [normal(d, h) / np.sqrt(d), z(h), normal(h, m) / np.sqrt(h),
             z(m), normal(m) / np.sqrt(m), z()]
    else:
        raise ValueError("nb_init needs the MLP's params or a generator")
    m1 = m + 1
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return NeuralBasisState(
        x_buf=z(cap, d), y_buf=z(cap), c_buf=z(cap), n=zero,
        since_refit=zero.clone(), **dict(zip(PARAMS, w)),
        ptp=z(m1, m1), pty=z(m1), ptc=z(m1), pt1=z(m1),
        chol=torch.eye(m1, dtype=f32, device=dev) * np.sqrt(ncfg.noise2),
        w_y=z(m1), w_c=z(m1), y_mean=z(), c_mean=z(),
        s2=torch.ones((), dtype=f32, device=dev))


def nb_capacity(n0: int, ncfg: NeuralConfig) -> int:
    """Initial ledger capacity for a promotion at n0 rows: the next power
    of two with at least n0 rows of headroom (>= cap0)."""
    cap = max(int(ncfg.cap0), 1)
    while cap < 2 * n0:
        cap *= 2
    return cap


def nb_from_data(xs, ys, logcs, ncfg: NeuralConfig, cap: int | None = None,
                 *, params=None, generator: torch.Generator | None = None,
                 device: str | torch.device = "cuda") -> NeuralBasisState:
    """Promotion entry point: train the tier on a study's whole ledger.

    `xs (n0, d)` / `ys (n0,)` are the saturated GP's active rows and
    `logcs (n0,)` the log of their tell costs (numpy arrays, or tensors
    already on `device`, which are not copied through the host).  The
    ledger is padded to `cap` (default `nb_capacity`), the MLP starts from
    `params` or `generator` (`nb_init`) and trains at once (one
    `nb_refit`), so the first escalated suggestion sees a fitted basis."""
    dev = resolve_device(device)
    xs, ys, logcs = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                     for a in (xs, ys, logcs))
    n0, d = xs.shape
    cap = int(cap) if cap is not None else nb_capacity(n0, ncfg)
    if cap < n0:
        raise ValueError(f"nb_from_data: cap={cap} < n0={n0}")
    state = nb_init(d, cap, ncfg, params=params, generator=generator,
                    device=dev)
    pad = cap - n0
    state = _replace(
        state,
        x_buf=torch.cat([xs, xs.new_zeros((pad, d))]),
        y_buf=torch.cat([ys, ys.new_zeros(pad)]),
        c_buf=torch.cat([logcs, logcs.new_zeros(pad)]),
        n=torch.tensor(n0, dtype=torch.int32, device=dev))
    return nb_refit(state, ncfg)


def nb_grow(state: NeuralBasisState, ncfg: NeuralConfig | None = None
            ) -> NeuralBasisState:
    """Double the ledger's capacity: zero rows appended on the device, every
    other leaf the same tensor.  Called when n reaches cap, so a study's
    life sees O(log n) of them."""
    del ncfg
    cap = state.cap
    return _replace(state,
                    x_buf=torch.cat([state.x_buf,
                                     state.x_buf.new_zeros(state.x_buf.shape)]),
                    y_buf=torch.cat([state.y_buf, state.y_buf.new_zeros(cap)]),
                    c_buf=torch.cat([state.c_buf, state.c_buf.new_zeros(cap)]))


# -- suggest / fantasize ------------------------------------------------------
def _make_eval_batch(state: NeuralBasisState, acq: acq_mod.AcqConfig,
                     f_best: Tensor):
    """`eval(X (r, d)) -> (vals (r,), grads (r, d))` against the head's
    posterior, by one autograd pass over the batch (each value depends on
    its own row only), cost-scaled for "ei_per_cost"."""
    fn = acq_mod.ACQUISITIONS[acq.name]

    def eval_batch(x):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            mean, var = nb_posterior(state, xg)
            val = fn(mean, var, f_best, acq.xi)
            if acq.name == "ei_per_cost":
                val = acq_mod.cost_scaled(val, nb_log_cost(state, xg))
            (grad,) = torch.autograd.grad(val.sum(), xg)
        return val.detach(), grad

    return eval_batch


def nb_suggest(state: NeuralBasisState, desc=None, *,
               acq: acq_mod.AcqConfig, top_t: int = 1,
               seeds: Tensor | None = None, jitter: Tensor | None = None,
               generator: torch.Generator | None = None
               ) -> tuple[Tensor, Tensor]:
    """Multi-start acquisition ascent against the neural-basis posterior
    over the unit box: the GP tier's ascent and tie-break
    (`acquisition.ascend_acquisition`), so selection is as stable.  Draws:
    `seeds (R, d)` / `jitter (top_t, d)` when given, else `generator`;
    `desc` (a mixed space's descriptor) projects onto its lattice.
    Returns ((top_t, d), (top_t,))."""
    d, dt, dev = state.dim, state.x_buf.dtype, state.device
    lo = torch.zeros((d,), dtype=dt, device=dev)
    hi = torch.ones((d,), dtype=dt, device=dev)
    project = ((lambda u: desc_mod.project_units(u, desc))
               if desc is not None else None)
    return acq_mod.ascend_acquisition(
        _make_eval_batch(state, acq, _f_best(state)), lo, hi, acq, top_t,
        generator=generator, seeds=seeds, jitter=jitter, project=project)


def nb_fantasy_value(state: NeuralBasisState, x: Tensor, liar: str) -> Tensor:
    """Liar observation for a fantasy row at `x (d,)`, as
    `gp.fantasy_values`: the best observation ("pessimistic", 0 on an
    empty ledger) or the posterior mean ("mean")."""
    if liar not in FANTASY_LIARS:
        raise ValueError(f"unknown fantasy liar {liar!r}; "
                         f"expected one of {FANTASY_LIARS}")
    if liar == "pessimistic":
        return torch.where(state.n > 0, _f_best(state), 0.0)
    mean, _ = nb_posterior(state, x[None, :])
    return mean[0]


def nb_fantasize(state: NeuralBasisState, xs: Tensor, ncfg: NeuralConfig,
                 liar: str = "mean") -> NeuralBasisState:
    """Append `xs (q, d)` as fantasy rows: each a rank-1 append of its liar
    value and predicted log cost, taken against the state before it.
    Rollback is not a truncation (the factor updates do not reverse bit
    for bit) but the restore of a snapshot, which the engine keeps."""
    for x in xs:
        y = nb_fantasy_value(state, x, liar)
        state = nb_append(state, x, y, nb_log_cost(state, x[None, :])[0],
                          ncfg)
    return state


def nb_ask_q(state: NeuralBasisState, ncfg: NeuralConfig, desc=None, *,
             acq: acq_mod.AcqConfig, q: int, liar: str = "mean",
             seeds: Tensor | None = None, jitter: Tensor | None = None,
             generator: torch.Generator | None = None
             ) -> tuple[Tensor, Tensor, NeuralBasisState]:
    """Sequential-fantasy q-suggestion on the tier (the qEI recursion of
    `acquisition.suggest_q` against the O(m^2) posterior): q rounds of
    `nb_suggest` then `nb_fantasize`.  Step i draws `seeds[i] (R, d)` /
    `jitter[i] (1, d)` when given (the reference splits its key into q),
    else from `generator`.  Returns (xs (q, d), vals (q,), fantasized
    state); the ledger must hold q more rows."""
    if q < 1:
        raise ValueError(f"q must be >= 1, got {q}")
    xs, vals = [], []
    for i in range(q):
        x, v = nb_suggest(state, desc, acq=acq, top_t=1,
                          seeds=None if seeds is None else seeds[i],
                          jitter=None if jitter is None else jitter[i],
                          generator=generator)
        state = nb_fantasize(state, x, ncfg, liar)
        xs.append(x[0])
        vals.append(v[0])
    return torch.stack(xs), torch.stack(vals), state


# -- bitwise serialization ----------------------------------------------------
def nb_to_json(state: NeuralBasisState) -> dict:
    """JSON-safe dict in the reference's format: every leaf as base64 of
    its raw little-endian buffer, its `dtype.str` and shape (0-d leaves
    stay 0-d).  The round trip keeps every bit."""
    out = {}
    for name in FIELDS:
        a = getattr(state, name).detach().cpu().numpy()
        raw = np.ascontiguousarray(a)
        out[name] = {"b64": base64.b64encode(raw.tobytes()).decode("ascii"),
                     "dtype": a.dtype.str, "shape": list(a.shape)}
    return out


def nb_from_json(d: dict, device: str | torch.device = "cuda"
                 ) -> NeuralBasisState:
    """The state `nb_to_json` wrote (by this package or the reference), on
    `device`."""
    dev = resolve_device(device)
    kw = {}
    for name in FIELDS:
        spec = d[name]
        a = np.frombuffer(base64.b64decode(spec["b64"]),
                          np.dtype(spec["dtype"])).reshape(spec["shape"])
        kw[name] = torch.from_numpy(a.copy()).to(dev)
    return NeuralBasisState(**kw)
