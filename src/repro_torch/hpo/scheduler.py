"""HPO trial scheduler: the single-study objective execution loop
(counterpart of `repro/hpo/scheduler.py`).

The paper's Sec. 3.4 insight: with O(n^2) GP updates, synchronization stops
being the bottleneck, so you can (a) suggest the top-t EI local maxima and
train t models concurrently, and (b) absorb results as *row appends* that
commute under the frozen kernel.

`TrialScheduler` is the S = 1 case of `repro_torch.hpo.pool.StudyPool`
(DESIGN.md §7): suggest, absorb, fault policy, lag policy and
checkpointing all delegate to a one-study pool, so the scheduler and the
multi-tenant pool share one suggest/absorb code path (the `StudyEngine`'s
routed calls).  What lives here is only the objective execution loop
wrapped around that pool:

  * **async absorption** — `run` feeds completed futures to the pool in
    *completion* order; a straggler never blocks the GP or the next
    suggestion round.
  * **fault handling** — a failed trial (exception, non-finite loss) is
    routed to the pool's retry/penalty policy; scheduler-side errors
    (capacity, checkpoint IO) propagate instead of masquerading as trial
    faults.
  * **elasticity** — the parallel width t is re-read every round, so the
    suggestion batch tracks however many workers are currently healthy.
  * **resume** — a scheduler restored from a pool checkpoint goes straight
    to EI suggestions; it never re-runs its random seed trials.
"""
from __future__ import annotations

import time
import traceback
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from typing import Callable

import numpy as np

import torch

from repro_torch.core import gp as gp_mod
from repro_torch.hpo.pool import SchedulerConfig, StudyPool, Trial

__all__ = ["SchedulerConfig", "Trial", "TrialScheduler"]


class TrialScheduler:
    """Drives `objective(hparams) -> float (maximize)` through the lazy GP,
    on the card unless `device` says otherwise; `devices` are the logical
    devices of `cfg.mesh` (one study: restart shards only)."""

    def __init__(self, space, cfg: SchedulerConfig, *,
                 device: str | torch.device = "cuda", devices=None):
        self.space = space
        self.cfg = cfg
        self.pool = StudyPool([space], cfg, names=["study0"], device=device,
                              devices=devices)

    # -- delegation to the shared one-study pool ----------------------------
    @property
    def state(self) -> gp_mod.LazyGPState:
        return self.pool.state(0)

    @property
    def trials(self) -> list[Trial]:
        return self.pool.studies[0].trials

    def seed_trials(self, n: int) -> list[Trial]:
        return self.pool.seed_trials(0, n)

    def suggest(self, t: int | None = None) -> list[Trial]:
        """Top-t distinct EI local maxima from the current posterior."""
        return self.pool.suggest(0, t)

    def _make_trial(self, unit: np.ndarray) -> Trial:
        return self.pool._make_trial(0, unit)

    def absorb(self, trial: Trial, value: float) -> None:
        """O(n^2) row append (order-independent under the frozen kernel)."""
        self.pool.absorb(0, trial, value)

    def record_failure(self, trial: Trial, error: str) -> Trial | None:
        """Failed trial: retry (fresh suggestion) or penalize the region."""
        return self.pool.record_failure(0, trial, error)

    def best(self) -> Trial | None:
        return self.pool.best(0)

    def history(self) -> list[dict]:
        return self.pool.history(0)

    def restore(self) -> bool:
        return self.pool.restore()

    # -- objective execution loop -------------------------------------------
    def run(self, objective: Callable[[dict], float], budget: int,
            n_seed: int = 1, executor: ThreadPoolExecutor | None = None,
            parallel: Callable[[], int] | None = None) -> Trial | None:
        """Run until `budget` observations have been absorbed.

        `parallel` is an optional callable re-read each round — the elastic
        width (e.g. the number of currently-healthy pod slices).

        `budget` counts observations absorbed in THIS call (seed trials
        included), in both sequential and parallel modes: a resumed run
        absorbs `budget` *more* on top of the restored posterior.

        A scheduler resumed from a checkpoint (`restore()`, state.n > 0)
        does NOT run its random seed trials again: the restored posterior
        already contains them, so seeding would absorb duplicate points and
        skew the ledger.  Resumed runs go straight to EI suggestions.
        """
        own_pool = executor is None and self.cfg.parallel > 1
        pool = executor or (ThreadPoolExecutor(self.cfg.parallel)
                            if own_pool else None)
        width_fn = parallel or (lambda: self.cfg.parallel)
        resumed = self.pool.engine.n(0) > 0 or \
            any(t.status == "done" for t in self.trials)

        try:
            if pool is None:
                # Sequential mode (t = 1).
                done0 = sum(t.status == "done" for t in self.trials)
                if not resumed:
                    # Seeds count toward the per-call budget, so never seed
                    # past it.
                    for tr in self.seed_trials(min(n_seed, budget)):
                        self._run_one(objective, tr)
                while sum(t.status == "done"
                          for t in self.trials) - done0 < budget:
                    tr = self.suggest(1)[0]
                    self._run_one(objective, tr)
                return self.best()

            inflight: dict[Future, Trial] = {}

            def launch(trial: Trial) -> None:
                trial.status = "running"
                trial.started = time.time()
                inflight[pool.submit(objective, trial.hparams)] = trial

            if not resumed:
                for tr in self.seed_trials(min(max(n_seed, 1), budget)):
                    launch(tr)
            absorbed = 0
            while absorbed < budget:
                width = max(1, width_fn())
                while len(inflight) < width and \
                        absorbed + len(inflight) < budget:
                    for tr in self.suggest(1):
                        launch(tr)
                if not inflight:
                    break
                done, _ = wait(inflight, return_when=FIRST_COMPLETED)
                for fut in done:       # async absorption, completion order
                    tr = inflight.pop(fut)
                    try:
                        val = float(fut.result())
                        if not np.isfinite(val):
                            raise FloatingPointError(
                                f"objective returned {val}")
                    except Exception as e:  # noqa: BLE001 — trial fault
                        retry = self.record_failure(
                            tr, f"{type(e).__name__}: {e}")
                        if retry is not None:
                            launch(retry)
                    else:
                        # Scheduler-side errors (capacity, checkpoint IO)
                        # propagate: they are not trial faults to retry.
                        self.absorb(tr, val)
                        absorbed += 1
            return self.best()
        finally:
            if own_pool and pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)

    def _run_one(self, objective, trial: Trial):
        trial.status = "running"
        trial.started = time.time()
        try:
            val = float(objective(trial.hparams))
            if not np.isfinite(val):
                raise FloatingPointError(f"objective returned {val}")
        except Exception as e:  # noqa: BLE001 — trial fault only
            retry = self.record_failure(trial, traceback.format_exc()[-500:]
                                        if not isinstance(e, FloatingPointError)
                                        else str(e))
            if retry is not None:
                self._run_one(objective, retry)
        else:
            # Absorb outside the trial-fault net: a scheduler-side error
            # (GP capacity, checkpoint IO) must propagate, not masquerade as
            # a failed trial and spin the retry loop.
            self.absorb(trial, val)
