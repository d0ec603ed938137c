"""Acquisition functions and their multi-start optimizer.

Counterpart of `repro/core/acquisition.py`.
Expected Improvement (paper Sec. 3.2.1) and a multi-start
projected-gradient ascent that returns the argmax (sequential BO) or the
top-t distinct local maxima (paper Sec. 3.4), for one study or for a
stacked state of S studies (the reference's vmap): there each ascent step
is one fused-EI launch for all S studies, with (S, d) type masks where
their layouts differ.  `suggest_q` is the q-suggestion of the fantasy
protocol: q ascents, each followed by a fantasy row.  "ei_per_cost" is EI
per unit of predicted cost (`cost_scaled`, with a log-cost head the caller
gives), the neural-basis tier's cost-aware mode.

Each ascent step is one `ops.fused_ei_grad` call for the whole restart
batch (the fused kernel on the card), with the loop invariants — f_best,
the active mean, `A = li_buf^T li_buf` and the active mask — hoisted once
per suggest call (`hoist`); a stacked state's are hoisted lane by lane
with the single-study calls, so a lane's operands are bit for bit those
of a single-study suggest on it.  `AcqConfig.fused = "off"` (or a kernel
/ acquisition the fused kernel does not cover) takes the autodiff ascent
through the gram's `autograd.Function` instead.

Random draws are explicit: the restart seeds come from a `torch.Generator`
or are passed in as a tensor (the tests pass the JAX package's own seeds),
and so does the jitter of the top-t backfill; `draw_seeds` /
`draw_jitter` are those draws, for callers that keep a stream per study
(the pool).  Restart selection
quantizes the values (low-mantissa clearing) before the argmax / sort, so
round-off never flips which restart wins a numerical tie.  On a mixed
search space (`desc`) every iterate is projected back onto the feasible
lattice (`descriptor.project_units`) after its gradient step, the seeds and
the top-t backfill too.

Restart sharding (the mesh's restart axis, `repro_torch.hpo.mesh`): with
`restart_states` a study shard's R seeds, drawn once at full R, are cut
into contiguous slices, each ascended on its restart shard's device
against the state there (the shard's own copy, or a replica on another
card); the finals and values are concatenated in shard order before the
tie-break and the dedup, which therefore see the unsharded restart set.
On the card a shard's step is one fused-EI launch on its rows, planned as
the unsharded launch (`plan_rows=R`), so each row is summed as there.  On
the CPU the plain version's GEMMs sum a row in an order set by the call's
row count and the row's place in it, so a shard evaluates its rows at
their place in an R-row call (`_at_place`): the same bits as the
unsharded step, for k times the work.  Only the fused ascent splits its
restarts; the autodiff ascent runs them unsplit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.core import descriptor as desc_mod
from repro_torch.core import gp as gp_mod
from repro_torch.core.kernels import KernelFn, make_mixed_kernel
from repro_torch.kernels import ops

Tensor = torch.Tensor

_SQRT2 = 1.4142135623730951


def _norm_pdf(z: Tensor) -> Tensor:
    return torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


def _norm_cdf(z: Tensor) -> Tensor:
    # erfc form: exact in the lower tail, where 1 + erf cancels to 0.
    return 0.5 * torch.erfc(-z / _SQRT2)


def expected_improvement(mean: Tensor, var: Tensor, f_best: Tensor,
                         xi: float = 0.01) -> Tensor:
    """EI(x) = gamma Phi(Z) + sigma phi(Z)  (paper Eq. 11, maximization form),
    gamma = mu(x) - f_best - xi, Z = gamma / sigma."""
    sigma = torch.sqrt(var)
    gamma = mean - f_best - xi
    pos = sigma > 0
    z = torch.where(pos, gamma / torch.clamp(sigma, min=1e-12), 0.0)
    ei = gamma * _norm_cdf(z) + sigma * _norm_pdf(z)
    return torch.where(pos, torch.clamp(ei, min=0.0), 0.0)


def upper_confidence_bound(mean: Tensor, var: Tensor, f_best: Tensor,
                           beta: float = 2.0) -> Tensor:
    del f_best
    return mean + beta * torch.sqrt(var)


ACQUISITIONS: dict[str, Callable[..., Tensor]] = {
    "ei": expected_improvement,
    # EI per unit of cost (FABOLAS-style): the posterior term is plain EI;
    # `_acq_value` divides by the predicted cost when the caller gives a
    # `log_cost_fn` (the neural-basis tier's log-cost head).  Without one
    # it is plain EI, so a cost-aware study still serves on the GP tier.
    "ei_per_cost": expected_improvement,
    "ucb": upper_confidence_bound,
}

# Predicted log cost is clipped before exponentiation, so a wild early cost
# head can neither zero out nor blow up the acquisition surface.
_LOG_COST_CLIP = 20.0


def cost_scaled(value: Tensor, log_cost: Tensor) -> Tensor:
    """acq / exp(log_cost): EI per unit of predicted cost (FABOLAS)."""
    return value * torch.exp(-torch.clamp(log_cost, -_LOG_COST_CLIP,
                                          _LOG_COST_CLIP))

FUSED_MODES = ("auto", "on", "off")


@dataclasses.dataclass(frozen=True)
class AcqConfig:
    name: str = "ei"
    xi: float = 0.01
    restarts: int = 64          # R multi-start seeds
    ascent_steps: int = 25      # S projected-gradient steps per seed
    lr: float = 0.05            # in units of the box width
    dedup_radius: float = 0.08  # basin-merge radius, units of box width
    fused: str = "auto"         # "auto" / "on" = the fused EI kernel where
    # it covers the (kernel, acquisition) pair; "off" = autodiff ascent


def _acq_value(state: gp_mod.LazyGPState, kernel: KernelFn, x: Tensor,
               f_best: Tensor, cfg: AcqConfig, ymean: Tensor,
               log_cost_fn: Callable[[Tensor], Tensor] | None = None
               ) -> Tensor:
    """Acquisition values of a candidate batch x (r, d) -> (r,).  Each value
    depends on its own row only, so the gradient of their sum is the batch
    of per-candidate gradients.  `log_cost_fn (r, d) -> (r,)` scales
    "ei_per_cost" by the predicted cost."""
    mean, var = gp_mod.posterior(state, kernel, x, ymean=ymean)
    val = ACQUISITIONS[cfg.name](mean, var, f_best, cfg.xi)
    if cfg.name == "ei_per_cost" and log_cost_fn is not None:
        val = cost_scaled(val, log_cost_fn(x))
    return val


def _f_best(state: gp_mod.LazyGPState) -> Tensor:
    """Best active observation; (S,) for a stacked state."""
    return torch.amax(torch.where(gp_mod._active_mask(state), state.y_buf,
                                  -math.inf), dim=-1)


# Mantissa bits cleared by the selection tie-break: values within ~2^-11
# relative distance collapse to one bucket.
_TIEBREAK_MANTISSA_BITS = 12


def _quantize_for_tiebreak(vals: Tensor) -> Tensor:
    """Float32 quantization used ONLY for restart selection: clearing low
    mantissa bits is monotone, so the argmax / stable sort pick the same
    (first) restart even when two substrates differ by ulps."""
    bits = vals.to(torch.float32).view(torch.int32)
    return (bits & -(1 << _TIEBREAK_MANTISSA_BITS)).view(torch.float32)


def _use_fused(cfg: AcqConfig, kernel: KernelFn) -> bool:
    if cfg.fused not in FUSED_MODES:
        raise ValueError(f"unknown AcqConfig.fused {cfg.fused!r}; "
                         f"expected one of {FUSED_MODES}")
    return cfg.fused != "off" and ops.fused_supported(kernel, cfg.name)


def hoist(state: gp_mod.LazyGPState, cfg: AcqConfig, counts=None
          ) -> tuple[Tensor, Tensor, Tensor]:
    """The fused ascent's loop invariants: (the active mask as floats,
    `A = li_buf^T li_buf`, the shift `ymean - f_best - xi`).

    A stacked state's A and mean are computed lane by lane, each with the
    single-study calls on the lane's rows and its host count (`counts`,
    the engine's mirrors; read from the device when not given): one
    (n_max, n_max) GEMM and one (n_max,) sum over n a lane, where a
    batched call would sum in another order.  The mask, f_best (a max)
    and the shift's subtractions are exact in any shape.  So every lane's
    operands are bit for bit those of a single-study suggest on it."""
    amask = gp_mod._active_mask(state)
    f_best = _f_best(state)
    if state.is_batched:
        counts = state.n.tolist() if counts is None else counts
        masked_y = torch.where(amask, state.y_buf, 0.0)
        li = state.li_buf
        ymean = torch.stack([gp_mod._masked_mean(masked_y[s], int(counts[s]))
                             for s in range(state.n_studies)])
        a_buf = torch.stack([li[s].transpose(-1, -2) @ li[s]
                             for s in range(state.n_studies)])
    else:
        ymean = gp_mod._ymean(state)
        a_buf = state.li_buf.transpose(-1, -2) @ state.li_buf
    return amask.to(state.x_buf.dtype), a_buf, ymean - f_best - cfg.xi


def _make_eval_batch(state: gp_mod.LazyGPState, kernel: KernelFn,
                     cfg: AcqConfig, fused: bool,
                     log_cost_fn: Callable[[Tensor], Tensor] | None = None,
                     counts=None, plan_rows: int | None = None):
    """Build `eval(X (r, d)) -> (vals (r,), grads (r, d))` for the ascent.

    Fused: the loop invariants come from `hoist` (`counts` as there); each
    step is then one `ops.fused_ei_grad` call, in its mixed form when the
    kernel is the mixed closure (its type masks), planned for `plan_rows`
    candidates (a restart shard's full R).  A stacked state gives
    `eval(X (S, r, d))`, one call for all S studies.  Unfused (one study):
    autodiff through the posterior, with f_best / ymean still hoisted
    (and the cost scaling of "ei_per_cost", `log_cost_fn`).
    """
    if fused:
        amask, a_buf, shift = hoist(state, cfg, counts)
        cont_mask = getattr(kernel, "cont_mask", None)
        cat_mask = getattr(kernel, "cat_mask", None)

        def eval_batch(x):
            return ops.fused_ei_grad(x, state.x_buf, amask, state.alpha, a_buf,
                                     state.params.sigma2, state.params.rho,
                                     shift, cont_mask=cont_mask,
                                     cat_mask=cat_mask, plan_rows=plan_rows)

        return eval_batch

    f_best, ymean = _f_best(state), gp_mod._ymean(state)

    def eval_autodiff(x):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            vals = _acq_value(state, kernel, xg, f_best, cfg, ymean,
                              log_cost_fn)
            (grad,) = torch.autograd.grad(vals.sum(), xg)
        return vals.detach(), grad

    return eval_autodiff


def ei_value_and_grad(state: gp_mod.LazyGPState, kernel: KernelFn, x: Tensor,
                      cfg: AcqConfig | None = None, *,
                      fused: bool = True) -> tuple[Tensor, Tensor]:
    """Acquisition value + gradient for a whole (r, d) candidate batch:
    one ascent iteration, fused (`fused=True`) or by autodiff."""
    return _make_eval_batch(state, kernel, cfg or AcqConfig(), fused)(x)


def _draw_device(lo: Tensor, generator: torch.Generator | None):
    return lo.device if generator is None else generator.device


def draw_seeds(lo: Tensor, hi: Tensor, restarts: int,
               generator: torch.Generator | None,
               batch: tuple[int, ...] = ()) -> Tensor:
    """Restart seeds `lo + (hi - lo) * U[0, 1)`, (*batch, R, d), on lo's
    device (drawn on the generator's)."""
    u = torch.rand((*batch, restarts, lo.shape[-1]), generator=generator,
                   dtype=lo.dtype, device=_draw_device(lo, generator))
    return lo + (hi - lo) * u.to(lo.device)


def draw_jitter(lo: Tensor, top_t: int, generator: torch.Generator | None,
                batch: tuple[int, ...] = ()) -> Tensor:
    """The top-t backfill's standard normals, (*batch, top_t, d), on lo's
    device (drawn on the generator's)."""
    return torch.randn((*batch, top_t, lo.shape[-1]), generator=generator,
                       dtype=lo.dtype,
                       device=_draw_device(lo, generator)).to(lo.device)


def draw_stacked(lo: Tensor, hi: Tensor, cfg: AcqConfig, kernel: KernelFn,
                 top_t: int, generator: torch.Generator | None,
                 n_studies: int, seeds: Tensor | None = None,
                 jitter: Tensor | None = None) -> tuple[Tensor, Tensor | None]:
    """The draws a stacked `optimize_acquisition` on `kernel` takes from
    `generator` where `seeds (S, R, d)` / `jitter (S, top_t, d)` are not
    given, drawn ahead in its order: fused, the (S, R, d) seeds then the
    (S, top_t, d) jitter (top_t > 1); unfused, study by study.  Returns
    (seeds, jitter), jitter None at top_t = 1 unless given."""
    need_j = top_t > 1 and jitter is None
    if _use_fused(cfg, kernel):
        if seeds is None:
            seeds = draw_seeds(lo, hi, cfg.restarts, generator, (n_studies,))
        if need_j:
            jitter = draw_jitter(lo, top_t, generator, (n_studies,))
        return seeds, jitter
    s_rows, j_rows = [], []
    for s in range(n_studies):
        s_rows.append(draw_seeds(lo, hi, cfg.restarts, generator)
                      if seeds is None else seeds[s])
        if need_j:
            j_rows.append(draw_jitter(lo, top_t, generator))
    return torch.stack(s_rows), torch.stack(j_rows) if need_j else jitter


@dataclasses.dataclass(frozen=True)
class RestartShard:
    """One restart shard's ascent: its oracle and box on its device, and
    its lattice projection (None: the identity)."""
    eval_batch: Callable
    lo: Tensor
    hi: Tensor
    project: Callable[[Tensor], Tensor] | None = None


def _gather(parts: list[Tensor], dim: int, device) -> Tensor:
    """Restart shards' outputs concatenated in shard order on `device`."""
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(device) for p in parts], dim=dim)


def ascend_acquisition(eval_batch, lo: Tensor, hi: Tensor, cfg: AcqConfig,
                       top_t: int = 1, *,
                       generator: torch.Generator | None = None,
                       seeds: Tensor | None = None,
                       jitter: Tensor | None = None,
                       project: Callable[[Tensor], Tensor] | None = None,
                       batch: tuple[int, ...] = (),
                       shards: "list[RestartShard] | None" = None,
                       ) -> tuple[Tensor, Tensor]:
    """Multi-start ascent + tie-break-stable selection, model-free.

    `eval_batch(X (*batch, r, d)) -> (vals (*batch, r), grads (*batch, r,
    d))` is the acquisition oracle; `batch` is () for one study and (S,)
    for a stacked state, whose studies ascend side by side and select each
    on its own restarts.  The restart seeds are `seeds (*batch, R, d)`
    when given, else `lo + (hi - lo) * U[0, 1)` drawn from `generator`;
    the top-t backfill jitter is `jitter (*batch, top_t, d)` standard
    normals when given, else drawn from `generator`.  `project` (optional)
    repairs rows (..., d) onto a feasible lattice: the seeds, every
    iterate after its gradient step and the backfill (mixed spaces).
    `shards` (optional) splits the restarts: shard j ascends the
    contiguous slice j of the seeds with its own oracle, box and
    projection (`eval_batch` and `project` are then unused), step by step
    beside the others, and the finals come back to lo's device in shard
    order before the selection.
    Returns (points (*batch, top_t, d), values (*batch, top_t)).
    """
    width = hi - lo
    project = project or (lambda u: u)
    shards = shards or [RestartShard(eval_batch, lo, hi, project)]
    if cfg.restarts % len(shards):
        raise ValueError(f"restart shards ({len(shards)}) must divide "
                         f"cfg.restarts ({cfg.restarts})")
    if seeds is None:
        seeds = draw_seeds(lo, hi, cfg.restarts, generator, batch)
    r_loc = cfg.restarts // len(shards)
    projects = [sh.project or (lambda u: u) for sh in shards]
    xs = [proj(seeds[..., j * r_loc:(j + 1) * r_loc, :]
               .to(device=sh.lo.device, dtype=sh.lo.dtype))
          for j, (sh, proj) in enumerate(zip(shards, projects))]
    for _ in range(cfg.ascent_steps):
        for j, (sh, proj) in enumerate(zip(shards, projects)):
            _, g = sh.eval_batch(xs[j])
            gn = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
            g = torch.where(gn > 0, g / torch.clamp(gn, min=1e-12), 0.0)
            xs[j] = proj(torch.clamp(xs[j] + cfg.lr * (sh.hi - sh.lo) * g,
                                     sh.lo, sh.hi))
    vals = _gather([sh.eval_batch(x)[0] for sh, x in zip(shards, xs)], -1,
                   lo.device)
    x = _gather(xs, -2, lo.device)

    def rows(a, i):         # rows i (*batch, k) of a (*batch, R, ...)
        if a.ndim > i.ndim:
            return torch.take_along_dim(a, i[..., None], dim=-2)
        return torch.take_along_dim(a, i, dim=-1)

    # Selection runs on quantized values; the returned values are exact.
    qvals = _quantize_for_tiebreak(vals)
    if top_t == 1:
        best = torch.argmax(qvals, dim=-1, keepdim=True)   # first max wins
        return rows(x, best), rows(vals, best)

    # Spatial dedup: greedy pick best, suppress all restarts within radius
    # (each study on its own restarts).
    order = torch.argsort(-qvals, dim=-1, stable=True)
    finals, svals = rows(x, order), rows(vals, order)
    radius = cfg.dedup_radius * torch.linalg.vector_norm(width)
    dist = torch.linalg.vector_norm(finals[..., :, None, :]
                                    - finals[..., None, :, :], dim=-1)
    close = (dist < radius).cpu()        # one host copy for the greedy loop
    picks = []
    for close_s in close.reshape(-1, *close.shape[-2:]):
        chosen = []
        suppressed = torch.zeros(close_s.shape[0], dtype=torch.bool)
        for i in range(close_s.shape[0]):
            if len(chosen) == top_t:
                break
            if not suppressed[i]:
                chosen.append(i)
                suppressed |= close_s[i]
        picks.append(chosen)
    # Fewer than top_t distinct basins: back-fill with jittered copies of
    # the best point so the batch shape stays fixed.
    if jitter is None:
        jitter = draw_jitter(lo, top_t, generator, batch)
    jitter = jitter.to(device=lo.device, dtype=lo.dtype)
    idx = torch.tensor([c + [c[0]] * (top_t - len(c)) for c in picks],
                       device=lo.device).reshape(*batch, top_t)
    filled = torch.tensor([[k < len(c) for k in range(top_t)] for c in picks],
                          device=lo.device).reshape(*batch, top_t)
    points, pvals = rows(finals, idx), rows(svals, idx)
    fallback = project(torch.clamp(rows(finals, idx[..., :1])
                                   + 0.01 * width * jitter, lo, hi))
    points = torch.where(filled[..., None], points, fallback)
    return points, pvals


def optimize_acquisition(state: gp_mod.LazyGPState, kernel: KernelFn,
                         lo: Tensor, hi: Tensor, cfg: AcqConfig,
                         top_t: int = 1, *,
                         generator: torch.Generator | None = None,
                         seeds: Tensor | None = None,
                         jitter: Tensor | None = None,
                         desc: desc_mod.TypeDescriptor | None = None,
                         log_cost_fn: Callable[[Tensor], Tensor] | None = None,
                         counts=None, restart_states=None
                         ) -> tuple[Tensor, Tensor]:
    """Return (points (top_t, d), acquisition values (top_t,)), best first:
    top_t = 1 is sequential BO, top_t = t the paper's t best distinct
    local maxima.  Draws as `ascend_acquisition`.  `desc` (a mixed space's
    descriptor, on the state's device) projects the ascent onto its
    feasible lattice.  `log_cost_fn (r, d) -> (r,)` is the predicted log
    cost that "ei_per_cost" divides by (the fused kernel covers plain EI
    only, so that acquisition takes the autodiff ascent).

    Stacked (the reference's vmap over studies): a stacked state gives
    ((S, top_t, d), (S, top_t)), with seeds (S, R, d) and jitter
    (S, top_t, d) when given; `kernel` covers all S studies (the mixed
    closure over (S, d) masks where their layouts differ) and `desc` is
    the stacked (S, d) descriptor.  Each ascent step is one fused-EI call
    for all S; selection is per study, with the same tie-break.  An
    acquisition the fused kernel does not cover runs study by study.
    `counts` are the studies' host counts (the engine's mirrors), read
    from the device when not given.  The fused EI sums each study in the
    same order whatever the batch (`acq.launch_plan`) and the hoisted
    operands are computed lane by lane (`hoist`), so on the same state a
    lane's ascent starts from the single-study path's operands, bit for
    bit.

    `restart_states` (optional, one per restart shard) splits the fused
    ascent's restarts: shard j ascends its slice of the seeds against
    `restart_states[j]`, which is `state` itself or its replica on
    another card (`ascend_acquisition`'s `shards`); the oracle of each
    distinct state is built once.  The autodiff ascent runs its restarts
    unsplit."""
    fused = _use_fused(cfg, kernel)
    if state.is_batched and not fused:
        return _optimize_each(state, kernel, lo, hi, cfg, top_t,
                              generator=generator, seeds=seeds,
                              jitter=jitter, desc=desc,
                              log_cost_fn=log_cost_fn, counts=counts)
    batch = state.x_buf.shape[:-2]
    if not fused or restart_states is None or len(restart_states) == 1:
        eval_batch = _make_eval_batch(state, kernel, cfg, fused, log_cost_fn,
                                      counts)
        return ascend_acquisition(eval_batch, lo, hi, cfg, top_t,
                                  generator=generator, seeds=seeds,
                                  jitter=jitter, project=_projector(desc),
                                  batch=batch)
    r_loc = cfg.restarts // len(restart_states)
    evals: dict[int, Callable] = {}     # one oracle a distinct state
    shards = []
    for j, st in enumerate(restart_states):
        dev = st.device
        if id(st) not in evals:
            evals[id(st)] = _make_eval_batch(
                st, _kernel_on(kernel, dev), cfg, True, None, counts,
                plan_rows=cfg.restarts)
        ev = evals[id(st)]
        if dev.type != "cuda":
            ev = _at_place(ev, cfg.restarts, j * r_loc)
        dsc = desc if desc is None or dev == lo.device else desc.to(dev)
        shards.append(RestartShard(ev, lo.to(dev), hi.to(dev),
                                   _projector(dsc)))
    return ascend_acquisition(None, lo, hi, cfg, top_t, generator=generator,
                              seeds=seeds, jitter=jitter,
                              project=_projector(desc), batch=batch,
                              shards=shards)


def _at_place(eval_batch, rows: int, row0: int):
    """`eval_batch` of a restart shard's r rows evaluated at rows
    [row0, row0 + r) of an R-row call (the other rows are zeros, whose
    outputs are dropped)."""
    def ev(x):
        r = x.shape[-2]
        full = x.new_zeros((*x.shape[:-2], rows, x.shape[-1]))
        full[..., row0:row0 + r, :] = x
        vals, grads = eval_batch(full)
        return vals[..., row0:row0 + r], grads[..., row0:row0 + r, :]
    return ev


def _projector(desc: desc_mod.TypeDescriptor | None):
    """The lattice projection of a mixed space's descriptor (None: none)."""
    if desc is None:
        return None
    return lambda u: desc_mod.project_units(u, desc)


def _kernel_on(kernel: KernelFn, dev: torch.device) -> KernelFn:
    """`kernel` with its type masks on `dev` (a replica's card)."""
    if getattr(kernel, "gram_kernel", None) != "mixed" \
            or kernel.cont_mask.device == dev:
        return kernel
    return make_mixed_kernel(kernel.cont_mask.to(dev),
                             kernel.cat_mask.to(dev))


def _optimize_each(state, kernel, lo, hi, cfg, top_t, *, generator, seeds,
                   jitter, desc, log_cost_fn, counts):
    """The stacked suggest one study at a time (the autodiff ascent has no
    study axis); each study's n from `counts`, else from the device."""
    counts = state.n.tolist() if counts is None else counts
    outs = []
    for s in range(state.n_studies):
        outs.append(optimize_acquisition(
            gp_mod.unstack_state(state, s, n=int(counts[s]), since_refit=0),
            gp_mod.study_kernel(kernel, s),
            lo, hi, cfg, top_t,
            generator=generator,
            seeds=None if seeds is None else seeds[s],
            jitter=None if jitter is None else jitter[s],
            desc=(desc_mod.index_descriptor(desc, s)
                  if desc is not None and desc.is_batched else desc),
            log_cost_fn=log_cost_fn))
    return tuple(torch.stack(v) for v in zip(*outs))


def suggest_q(state: gp_mod.LazyGPState, kernel: KernelFn, lo: Tensor,
              hi: Tensor, cfg: AcqConfig, q: int, *, liar: str = "mean",
              generator: torch.Generator | None = None,
              seeds: Tensor | None = None, jitter: Tensor | None = None,
              desc: desc_mod.TypeDescriptor | None = None,
              in_place: bool = False
              ) -> tuple[Tensor, Tensor, gp_mod.LazyGPState]:
    """Sequential-fantasy q-suggestion (qEI, DESIGN.md §12) for one study.

    q steps, each the ascent of `optimize_acquisition(top_t=1)` against the
    current (fantasized) posterior, then its pick appended as a fantasy row
    (`gp.fantasize` with the `liar` value taken against that state), so
    step i + 1 suggests where the variance has collapsed at the first i
    picks.  Step i draws `seeds[i] (R, d)` / `jitter[i] (1, d)` when given
    (the reference splits its key into q keys, one a step), else from
    `generator`; `desc` projects every step onto a mixed space's lattice.
    The picks stay on the device: no step reads anything back.

    Returns `(xs (q, d), vals (q,), fantasized state)`; the input state is
    left as it is unless `in_place`, which writes the fantasy rows into
    its buffers (the engine's views of one study).
    """
    if q < 1:
        raise ValueError(f"q must be >= 1, got {q}")
    gp_mod.ensure_capacity(state.n, state.n_max, q)
    st = state if in_place else gp_mod._copy(state)
    xs, vals = [], []
    for i in range(q):
        x, v = optimize_acquisition(
            st, kernel, lo, hi, cfg, 1, generator=generator,
            seeds=None if seeds is None else seeds[i],
            jitter=None if jitter is None else jitter[i], desc=desc)
        st = gp_mod.fantasize(st, kernel, x, liar, in_place=True)
        xs.append(x[0])
        vals.append(v[0])
    return torch.stack(xs), torch.stack(vals), st
