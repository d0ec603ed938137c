"""The port's Levy-4d regrets beside the reference's, each package on its
own random streams, under the protocol of `tests/test_accuracy.py` (see
`tests/test_torch_accuracy.py`, which holds the port to the bounds).

Seeds 0-2 by default.  `REPRO_ACCURACY_SEEDS=24` widens the comparison to
the 24 seeds the port's bounds are read over (about two minutes on one
core):

    REPRO_ACCURACY_SEEDS=24 PYTHONPATH=src python -m pytest -s -q \\
        tests/test_torch_accuracy_reference.py
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
from test_torch_accuracy import (DIM, ITERATIONS, MODES, N_SEED, OPTIMUM,
                                 PER_SEED_MARGIN, objective, port_regret,
                                 random_search_regret)

from repro.core import gp as jgp
from repro.core import levy_bounds, run_bo
from repro.core.acquisition import AcqConfig

SEEDS = tuple(range(int(os.environ.get("REPRO_ACCURACY_SEEDS", "3"))))


def counting_nan_picks(monkeypatch) -> list[bool]:
    """Wrap the reference's `refit_params` so that each refit records
    whether its grid argmax picked a NaN log marginal likelihood (its
    unclamped CPU Cholesky; ROADMAP.md queue 3).  The pick's LML is
    recomputed, which leaves the run's values as they were."""
    picks: list[bool] = []
    refit = jgp.refit_params

    def counted(state, kernel, *args, **kwargs):
        params = refit(state, kernel, *args, **kwargs)
        lml = jgp._lml_for(state, kernel, params,
                           kwargs.get("implementation", "auto"))
        jax.debug.callback(lambda bad: picks.append(bool(bad)),
                           jnp.isnan(lml))
        return params

    monkeypatch.setattr(jgp, "refit_params", counted)
    return picks


def reference_regret(mode: str, seed: int) -> float:
    lo, hi = levy_bounds(DIM)
    _, hist = run_bo(objective, lo, hi, iterations=ITERATIONS, dim=DIM,
                     mode=mode, n_max=ITERATIONS + N_SEED + 2, n_seed=N_SEED,
                     seed=seed, acq=AcqConfig(restarts=24, ascent_steps=12))
    return OPTIMUM - hist.best_y[-1]


def test_regrets_beside_reference(monkeypatch):
    """Print both packages' regrets per seed and their paired statistics,
    and beside the reference's the number of its refits that picked a NaN
    LML per seed; every regret must be finite and non-negative."""
    picks = counting_nan_picks(monkeypatch)
    random = np.array([random_search_regret(s) for s in SEEDS])
    print(f"\nseeds 0-{len(SEEDS) - 1}, random search mean "
          f"{random.mean():.3f}")
    for name, fn in (("port", port_regret), ("reference", reference_regret)):
        got, nan_picks = {}, {}
        for mode in MODES:
            regrets, counts = [], []
            for s in SEEDS:
                picks.clear()
                regrets.append(fn(mode, s))
                jax.effects_barrier()
                counts.append(f"{sum(picks)}/{len(picks)}")
            got[mode], nan_picks[mode] = np.array(regrets), counts
        diff = got["lazy"] - got["naive"]
        for mode in MODES:
            line = f"{name} {mode}: {got[mode].round(3).tolist()}"
            if name == "reference":
                line += f"; NaN picks / refits by seed: {nan_picks[mode]}"
            print(line)
            assert np.all(np.isfinite(got[mode]))
            assert np.all(got[mode] >= OPTIMUM - 1e-6)
        print(f"{name}: mean lazy {got['lazy'].mean():.3f}, mean naive "
              f"{got['naive'].mean():.3f}, lazy <= naive + {PER_SEED_MARGIN} "
              f"on {int(np.sum(diff <= PER_SEED_MARGIN))} of {len(SEEDS)}, "
              f"median lazy - naive {float(np.median(diff)):.3f}")
