"""Bayesian optimization driver (paper Alg. 1 + Sec. 3.3/3.4).

Counterpart of `repro/core/bayesopt.py`.  Two factorization policies:
  * ``mode="naive"`` — the paper's baseline: every iteration refits the
    kernel params and runs a full O(n^3) refactorization;
  * ``mode="lazy"``  — the paper's contribution: frozen kernel params,
    O(n^2) incremental row appends, optional lag-l full refits.
and two suggestion policies: ``batch_size=1`` (argmax EI) or ``batch_size=t``
(the t best EI local maxima, paper Sec. 3.4).

The driver is a Python loop around the GP and acquisition steps, so the
objective can be any black box.  It runs on `BOConfig.device`, the card
unless the caller asks for the CPU; asking for CUDA without a card raises.
Randomness comes from one `torch.Generator` seeded with `cfg.seed`: the seed
points first, then each round's restart seeds.  Phase times are host
clocks around work that ends in `torch.cuda.synchronize()` on the card.
A mixed search space runs on its encoded unit cube:
`desc=space.descriptor()` with `lo = 0`, `hi = 1`; the seed points, the
ascent and every suggestion then lie on the space's feasible lattice
(`SearchSpace.to_hparams` decodes them).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import acquisition as acq_mod
from repro_torch.core import descriptor as desc_mod
from repro_torch.core import gp as gp_mod

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class BOConfig:
    dim: int
    n_max: int = 1024
    kernel: str = "matern52"
    mode: str = "lazy"            # "lazy" | "naive"
    lag: int = 0                  # lazy mode: full refit every `lag` appends
    inv_refresh: int = 128        # fully-lazy mode (lag=0): rebuild factor +
    # maintained inverse from the Gram every `inv_refresh` appends under the
    # current params (0 = never; lag > 0 supersedes it; DESIGN.md §4)
    batch_size: int = 1           # t parallel suggestions (paper Sec. 3.4)
    noise2: float = 1e-6
    rho0: float = 0.25            # initial length scale (unit box); paper: 1.0
    desc: desc_mod.TypeDescriptor | None = None  # mixed-space descriptor
    # (over the encoded unit cube: run with lo = 0, hi = 1)
    acq: acq_mod.AcqConfig = dataclasses.field(default_factory=acq_mod.AcqConfig)
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self):
        if self.mode not in ("lazy", "naive"):
            raise ValueError(f"unknown mode {self.mode!r}; expected 'lazy' or "
                             f"'naive'")


@dataclasses.dataclass
class BOHistory:
    xs: list = dataclasses.field(default_factory=list)
    ys: list = dataclasses.field(default_factory=list)
    best_y: list = dataclasses.field(default_factory=list)
    gp_seconds: list = dataclasses.field(default_factory=list)   # factor+append
    acq_seconds: list = dataclasses.field(default_factory=list)  # suggestion
    obj_seconds: list = dataclasses.field(default_factory=list)  # evaluations
    acq_values: list = dataclasses.field(default_factory=list)   # EI of each
    # suggestion; 0 means the ascent found no restart with any signal
    clamp_counts: list = dataclasses.field(default_factory=list)  # cumulative
    # d^2 conditioning-floor hits after each round (ill-conditioning telemetry)

    def best(self) -> tuple[np.ndarray, float]:
        i = int(np.argmax(self.ys))
        return np.asarray(self.xs[i]), float(self.ys[i])

    def iterations_to(self, target: float) -> int | None:
        """First iteration whose running best reaches `target` (maximization)."""
        for i, b in enumerate(self.best_y):
            if b >= target:
                return i
        return None

    def record(self, xs: np.ndarray, ys: np.ndarray) -> None:
        for x, y in zip(xs, ys):
            self.xs.append(x)
            self.ys.append(float(y))
            self.best_y.append(max(self.ys))


class BayesOpt:
    """Stateful driver.  Inputs are normalized to the unit box internally;
    suggestions are denormalized before they reach the objective."""

    def __init__(self, cfg: BOConfig, lo, hi):
        self.cfg = cfg
        self.device = gp_mod.resolve_device(cfg.device)
        self.lo = torch.as_tensor(lo, dtype=torch.float32, device=self.device)
        self.hi = torch.as_tensor(hi, dtype=torch.float32, device=self.device)
        self._unit_lo = torch.zeros_like(self.lo)
        self._unit_hi = torch.ones_like(self.hi)
        # The descriptor on this driver's device (a SearchSpace builds it on
        # the CPU).
        self.desc = cfg.desc.to(self.device) if cfg.desc is not None else None
        self.gp_cfg = gp_mod.GPConfig(
            n_max=cfg.n_max, dim=cfg.dim, kernel=cfg.kernel, lag=cfg.lag,
            noise2=cfg.noise2, rho0=cfg.rho0, desc=self.desc,
            device=cfg.device)
        self.kernel = self.gp_cfg.kernel_fn  # mixed closure if desc is discrete
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)

    def _to_unit(self, x: Tensor) -> Tensor:
        return (x - self.lo) / (self.hi - self.lo)

    def _from_unit(self, u: Tensor) -> Tensor:
        return self.lo + u * (self.hi - self.lo)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _refit(self, state: gp_mod.LazyGPState) -> gp_mod.LazyGPState:
        params = gp_mod.refit_params(state, self.kernel)
        return gp_mod.refactor(state, self.kernel, params)

    def init(self, x0, y0) -> gp_mod.LazyGPState:
        """Seed the GP with initial observations (one full factorization:
        the paper's 'first iteration computes a complete decomposition').
        x0 is in *objective* coordinates; stored normalized."""
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=self.device)
        y0 = torch.as_tensor(y0, dtype=torch.float32, device=self.device)
        n0 = x0.shape[0]
        gp_mod.ensure_capacity(0, self.cfg.n_max, n0)
        state = gp_mod.init_state(self.gp_cfg)
        # init_state's buffers are fresh: filled in place.
        state.x_buf[:n0] = self._to_unit(x0)
        state.y_buf[:n0] = y0.reshape(-1)
        state = dataclasses.replace(state, n=n0)
        if self.cfg.mode == "naive":
            return self._refit(state)
        return gp_mod.refactor(state, self.kernel)

    def step(self, state: gp_mod.LazyGPState,
             objective: Callable[[np.ndarray], np.ndarray],
             history: BOHistory, *, seeds: Tensor | None = None,
             jitter: Tensor | None = None) -> gp_mod.LazyGPState:
        """One BO round: suggest (t points) -> evaluate -> absorb -> lag.
        `seeds` / `jitter` replace the generator's draws for this round
        (unit-box restart seeds (R, d), backfill normals (t, d))."""
        # Guard before the (possibly hours-long) objective evaluations.
        gp_mod.ensure_capacity(state.n, self.cfg.n_max, self.cfg.batch_size)
        t0 = time.perf_counter()
        us, vals = acq_mod.optimize_acquisition(
            state, self.kernel, self._unit_lo, self._unit_hi, self.cfg.acq,
            self.cfg.batch_size, generator=self.generator, seeds=seeds,
            jitter=jitter, desc=self.desc)
        xs = self._from_unit(us).cpu().numpy()
        vals = vals.cpu().numpy()
        t1 = time.perf_counter()

        ys = np.asarray(objective(xs), dtype=np.float32).reshape(-1)
        t2 = time.perf_counter()

        state = gp_mod.append_batch(
            state, self.kernel, us, torch.as_tensor(ys, device=self.device))
        if self.cfg.mode == "naive":
            state = self._refit(state)
        elif self.cfg.lag > 0:
            if state.since_refit >= self.cfg.lag:
                state = self._refit(state)
        elif self.cfg.inv_refresh > 0 and \
                state.since_refit >= self.cfg.inv_refresh:
            # Fully-lazy drift guard: re-anchor L and L^{-1} from the Gram
            # without touching the kernel params.
            state = gp_mod.refactor(state, self.kernel)
        self._sync()
        t3 = time.perf_counter()

        history.record(xs, ys)
        history.acq_values.extend(float(v) for v in vals)
        history.acq_seconds.append(t1 - t0)
        history.obj_seconds.append(t2 - t1)
        history.gp_seconds.append(t3 - t2)
        history.clamp_counts.append(int(state.clamp_count))
        return state

    def run(self, objective: Callable[[np.ndarray], np.ndarray],
            iterations: int, n_seed: int = 1, x0=None, y0=None,
            ) -> tuple[gp_mod.LazyGPState, BOHistory]:
        """Full BO loop (paper Sec. 4 protocol: n_seed random seed points,
        then `iterations` suggestion rounds)."""
        if x0 is None:
            u0 = torch.rand((n_seed, self.cfg.dim), generator=self.generator,
                            dtype=torch.float32, device=self.device)
            x0 = self._from_unit(u0)
            if self.desc is not None:
                # Mixed spaces: seed on the feasible lattice, like every
                # later suggestion.
                x0 = self._from_unit(desc_mod.project_units(
                    self._to_unit(x0), self.desc))
            x0 = x0.cpu().numpy()
            y0 = np.asarray(objective(x0), dtype=np.float32).reshape(-1)
        state = self.init(x0, y0)
        history = BOHistory()
        history.record(np.asarray(x0), np.asarray(y0))
        for _ in range(iterations):
            state = self.step(state, objective, history)
        return state, history


def run_bo(objective: Callable[[np.ndarray], np.ndarray], lo, hi,
           iterations: int, *, dim: int, mode: str = "lazy", lag: int = 0,
           batch_size: int = 1, n_seed: int = 1, n_max: int = 1024,
           seed: int = 0, kernel: str = "matern52", rho0: float = 0.25,
           desc: desc_mod.TypeDescriptor | None = None,
           acq: acq_mod.AcqConfig | None = None, device: str = "cuda",
           ) -> tuple[gp_mod.LazyGPState, BOHistory]:
    """One-call functional API (used by examples, benchmarks, chip_smoke).
    A mixed space: `desc=space.descriptor()`, `lo=0`, `hi=1`."""
    cfg = BOConfig(dim=dim, n_max=n_max, kernel=kernel, mode=mode, lag=lag,
                   batch_size=batch_size, seed=seed, rho0=rho0, desc=desc,
                   acq=acq or acq_mod.AcqConfig(), device=device)
    return BayesOpt(cfg, lo, hi).run(objective, iterations, n_seed=n_seed)
