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

import numpy as np
from test_torch_accuracy import (DIM, ITERATIONS, MODES, N_SEED, OPTIMUM,
                                 PER_SEED_MARGIN, objective, port_regret,
                                 random_search_regret)

from repro.core import levy_bounds, run_bo
from repro.core.acquisition import AcqConfig

SEEDS = tuple(range(int(os.environ.get("REPRO_ACCURACY_SEEDS", "3"))))


def reference_regret(mode: str, seed: int) -> float:
    lo, hi = levy_bounds(DIM)
    _, hist = run_bo(objective, lo, hi, iterations=ITERATIONS, dim=DIM,
                     mode=mode, n_max=ITERATIONS + N_SEED + 2, n_seed=N_SEED,
                     seed=seed, acq=AcqConfig(restarts=24, ascent_steps=12))
    return OPTIMUM - hist.best_y[-1]


def test_regrets_beside_reference():
    """Print both packages' regrets per seed and their paired statistics;
    every regret must be finite and non-negative."""
    random = np.array([random_search_regret(s) for s in SEEDS])
    print(f"\nseeds 0-{len(SEEDS) - 1}, random search mean "
          f"{random.mean():.3f}")
    for name, fn in (("port", port_regret), ("reference", reference_regret)):
        got = {mode: np.array([fn(mode, s) for s in SEEDS]) for mode in MODES}
        diff = got["lazy"] - got["naive"]
        for mode in MODES:
            print(f"{name} {mode}: {got[mode].round(3).tolist()}")
            assert np.all(np.isfinite(got[mode]))
            assert np.all(got[mode] >= OPTIMUM - 1e-6)
        print(f"{name}: mean lazy {got['lazy'].mean():.3f}, mean naive "
              f"{got['naive'].mean():.3f}, lazy <= naive + {PER_SEED_MARGIN} "
              f"on {int(np.sum(diff <= PER_SEED_MARGIN))} of {len(SEEDS)}, "
              f"median lazy - naive {float(np.median(diff)):.3f}")
