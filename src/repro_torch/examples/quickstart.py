"""Quickstart: lazy-GP Bayesian optimization of the 5-D Levy function.

Counterpart of `examples/quickstart.py`, the paper's core loop:

    PYTHONPATH=src python -m repro_torch.examples.quickstart \
        [--iterations 120] [--mode lazy|naive] [--lag L] [--device cuda|cpu]

The lazy GP (paper Alg. 3) does one O(n^2) incremental Cholesky append per
iteration; `--mode naive` refits the kernel and refactorizes fully (O(n^3))
every iteration, which is the baseline the paper beats.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import levy_bounds, neg_levy, run_bo


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iterations", type=int, default=120)
    ap.add_argument("--mode", default="lazy", choices=["lazy", "naive"])
    ap.add_argument("--lag", type=int, default=0,
                    help="lazy mode: full kernel refit every LAG steps")
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="the card by default; cpu runs the plain versions")
    args = ap.parse_args(argv)

    def objective(x: np.ndarray) -> np.ndarray:
        return neg_levy(torch.as_tensor(x)).numpy()

    lo, hi = levy_bounds(5)
    state, hist = run_bo(objective, lo, hi, args.iterations, dim=5,
                     mode=args.mode, lag=args.lag, n_seed=args.seeds,
                     n_max=args.iterations + args.seeds + 8, seed=0,
                     device=args.device)

    print(f"\nmode={args.mode} lag={args.lag}")
    trajectory = {}
    for frac in (0.25, 0.5, 0.75, 1.0):
        i = max(0, int(len(hist.best_y) * frac) - 1)
        trajectory[i + 1] = float(hist.best_y[i])
        print(f"  after {i + 1:4d} evals: best = {hist.best_y[i]:9.4f}")
    x, y = hist.best()
    print(f"  optimum found: f = {y:.4f} at x = {np.round(x, 3)}"
          f"   (true optimum: 0 at [1 1 1 1 1])")
    gp_ms = 1e3 * float(np.mean(hist.gp_seconds))
    acq_ms = 1e3 * float(np.mean(hist.acq_seconds))
    print(f"  mean GP update: {gp_ms:.2f} ms; "
          f"mean suggestion: {acq_ms:.2f} ms")
    return {"mode": args.mode, "lag": args.lag, "evals": len(hist.best_y),
            "best_after": trajectory, "best": y,
            "best_x": np.asarray(x).tolist(), "mean_gp_ms": gp_ms,
            "mean_suggest_ms": acq_ms, "device": str(state.x_buf.device)}


if __name__ == "__main__":
    main()
