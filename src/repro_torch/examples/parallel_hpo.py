"""Parallel HPO of a real trainer with fault injection (paper Sec. 3.4/4.4).

Counterpart of `examples/parallel_hpo.py`:

    PYTHONPATH=src python -m repro_torch.examples.parallel_hpo \
        [--budget 16] [--parallel 4] [--faults] [--ckpt-dir DIR] \
        [--device cuda|cpu]

t worker lanes train the tiny LM (`nn_objective`) with different (lr, wd,
momentum); the lazy GP suggests the top-t EI local maxima and absorbs
results in completion order (stragglers never block).  With --faults,
every 5th trial crashes to demonstrate the retry + penalized-region path,
and the GP checkpoint in --ckpt-dir lets a second invocation resume the
exact posterior.
"""
from __future__ import annotations

import argparse
import threading

from repro_torch.examples.nn_objective import make_objective
from repro_torch.hpo.scheduler import SchedulerConfig, TrialScheduler
from repro_torch.hpo.space import RESNET_SPACE


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--budget", type=int, default=16)
    ap.add_argument("--parallel", type=int, default=4)
    ap.add_argument("--train-steps", type=int, default=20)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the card by default; cpu runs the plain versions")
    args = ap.parse_args(argv)

    base = make_objective(steps=args.train_steps, device=args.device)
    counter = {"n": 0, "injected": 0}
    lock = threading.Lock()

    def objective(hp: dict) -> float:
        with lock:
            counter["n"] += 1
            n = counter["n"]
            fault = args.faults and n % 5 == 0
            counter["injected"] += fault
        if fault:
            raise RuntimeError(f"injected fault in trial call #{n}")
        return float(base(RESNET_SPACE.to_unit(hp))[0])

    sched = TrialScheduler(
        RESNET_SPACE,
        SchedulerConfig(n_max=max(64, args.budget + 16),
                        parallel=args.parallel, seed=0, max_retries=2,
                        ckpt_dir=args.ckpt_dir),
        device=args.device)
    resumed = None
    if args.ckpt_dir and sched.restore():
        resumed = int(sched.state.n)
        print(f"resumed GP with n={resumed} observations")

    best = sched.run(objective, budget=args.budget, n_seed=4)
    n_fail = sum(t.status == "failed" for t in sched.trials)
    absorbed = int(sched.state.n)
    print(f"\nabsorbed {absorbed} observations "
          f"({n_fail} injected failures recovered)")
    print(f"best accuracy {best.value:.3f} with:")
    for k, v in best.hparams.items():
        print(f"  {k:14s} = {v:.5g}")
    return {"absorbed": absorbed, "failed": n_fail,
            "injected": counter["injected"], "calls": counter["n"],
            "resumed": resumed, "best": best.value,
            "best_hparams": dict(best.hparams),
            "device": str(sched.pool.engine.device)}


if __name__ == "__main__":
    main()
