"""Multi-tenant HPO service: a request-driven suggest/report loop over a
StudyPool (the ROADMAP's "serve heavy traffic" shape, in miniature).

Counterpart of `examples/hpo_service.py`:

    PYTHONPATH=src python -m repro_torch.examples.hpo_service \
        [--studies 8] [--budget 12] [--workers 8] [--mesh auto] \
        [--categorical-tenant] [--ckpt-dir DIR] [--device cuda|cpu]

S tenants run concurrent HPO studies against one batched lazy-GP engine:
each service round issues ONE `advance_round`, the absorb of every drained
completion and the batched suggest for every tenant with an open request.
Suggestions go to worker threads (the "trainers"); results are absorbed in
completion order, so a slow tenant never blocks a fast one.  With --mesh
the suggest path shards over the pool's logical devices (`hpo/mesh.py`);
with --ckpt-dir the whole pool rides one atomic checkpoint and a second
invocation resumes every tenant's posterior.

Each tenant optimizes its own synthetic objective (a shifted smooth bowl on
the unit cube, distinct optimum per tenant).  With --categorical-tenant
the last tenant runs a MIXED space (a 3-way categorical choice, the same
encoded width as the float tenants' ResNet space) through the very same
batched rounds.
"""
from __future__ import annotations

import argparse
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

import numpy as np

from repro_torch.hpo.pool import SchedulerConfig, StudyPool
from repro_torch.hpo.space import Categorical, RESNET_SPACE, SearchSpace

# Same encoded width (3) as RESNET_SPACE, so both layouts stack in one
# rectangular pool; the engine's per-study type descriptor keeps the
# categorical tenant's suggestions on its one-hot lattice.
CATEGORICAL_SPACE = SearchSpace((
    Categorical("optimizer", ("sgd", "adam", "rmsprop")),
))
CATEGORICAL_SCORE = {"sgd": -0.3, "adam": 0.0, "rmsprop": -0.6}


def make_objective(sid: int, latency: float, space=None):
    """Tenant sid's trainer: smooth bowl with a per-tenant optimum (float
    tenants) or a per-choice score table (the categorical tenant)."""
    center = 0.15 + 0.7 * ((sid * 0.37) % 1.0)

    def objective(unit: np.ndarray) -> float:
        time.sleep(latency * (1.0 + 0.5 * ((sid + 1) % 3)))  # uneven tenants
        if space is not None and space.has_discrete:
            return CATEGORICAL_SCORE[
                space.to_hparams(np.asarray(unit))["optimizer"]]
        return float(-np.sum((np.asarray(unit) - center) ** 2))

    return objective


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--studies", type=int, default=8)
    ap.add_argument("--budget", type=int, default=12,
                    help="observations to absorb per study")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--latency", type=float, default=0.02,
                    help="simulated per-trial train time (s)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--mesh", default="none",
                    help="study x restart mesh of the batched suggest path: "
                         "none | auto | SxR over the pool's logical devices")
    ap.add_argument("--categorical-tenant", action="store_true",
                    help="give the last tenant a mixed (categorical) "
                         "search space")
    ap.add_argument("--device", default="cuda",
                    help="the card by default; cpu runs the plain versions")
    args = ap.parse_args(argv)

    spaces = [RESNET_SPACE] * args.studies
    if args.categorical_tenant:
        spaces[-1] = CATEGORICAL_SPACE
    cfg = SchedulerConfig(n_max=args.budget + 8, seed=0, mesh=args.mesh,
                          ckpt_dir=args.ckpt_dir)
    pool = StudyPool(spaces, cfg,
                     names=[f"tenant{i}" for i in range(args.studies)],
                     device=args.device)
    resumed = None
    if args.ckpt_dir and pool.restore():
        resumed = {h.name: pool.engine.n(h.study_id) for h in pool.studies}
        print("resumed pool: " + ", ".join(
            f"{name} n={n}" for name, n in resumed.items()))

    objectives = [make_objective(s, args.latency, spaces[s])
                  for s in range(args.studies)]
    t0 = time.perf_counter()
    suggested = failures = 0
    with ThreadPoolExecutor(args.workers) as workers:
        inflight = {}   # Future -> (study_id, Trial)
        events = []     # drained completions awaiting absorption

        def open_requests():
            """Tenants below budget with no trial in flight this round
            (counting completions about to be absorbed)."""
            busy = {sid for sid, _ in inflight.values()}
            incoming: dict[int, int] = {}
            for sid, _, _ in events:
                incoming[sid] = incoming.get(sid, 0) + 1
            return [s for s in range(args.studies)
                    if s not in busy
                    and pool.engine.n(s) + incoming.get(s, 0) < args.budget]

        while True:
            ready = open_requests()
            if events or ready:
                # ONE round absorbs every drained completion and serves
                # every open suggest request (tenants at budget absorb
                # without drawing a new trial).
                suggestions = pool.advance_round(events, studies=ready)
                events = []
                for sid, trs in suggestions.items():
                    tr = trs[0]
                    tr.status = "running"
                    tr.started = time.time()
                    fut = workers.submit(objectives[sid], tr.unit)
                    inflight[fut] = (sid, tr)
                    suggested += 1
            if not inflight:
                break
            done, _ = wait(inflight, return_when=FIRST_COMPLETED)
            for fut in done:            # completion order, any tenant mix
                sid, tr = inflight.pop(fut)
                try:
                    events.append((sid, tr, float(fut.result())))
                except Exception as e:  # noqa: BLE001 — a tenant's fault
                    failures += 1
                    retry = pool.record_failure(sid, tr,
                                                f"{type(e).__name__}: {e}")
                    if retry is not None:
                        fut2 = workers.submit(objectives[sid], retry.unit)
                        inflight[fut2] = (sid, retry)

    elapsed = time.perf_counter() - t0
    total = sum(pool.engine.n(s) for s in range(args.studies))
    print(f"\nserved {suggested} suggestions / absorbed {total} results "
          f"for {args.studies} tenants in {elapsed:.2f}s "
          f"({total / elapsed:.1f} results/s)")
    tenants = {}
    for h in pool.studies:
        best = pool.best(h.study_id)
        extra, choice = "", None
        if h.space.has_discrete and best is not None:
            choice = h.space.to_hparams(best.unit)
            extra = " " + " ".join(f"{k}={v}" for k, v in choice.items())
        n = pool.engine.n(h.study_id)
        clamps = pool.engine.clamp_count(h.study_id)
        tenants[h.name] = {"n": n, "best": best.value, "clamps": clamps,
                           "choice": choice}
        print(f"  {h.name}: n={n} best={best.value:+.4f} "
              f"clamps={clamps}{extra}")
    return {"suggested": suggested, "absorbed": total, "failures": failures,
            "seconds": elapsed, "resumed": resumed, "tenants": tenants,
            "device": str(pool.engine.device)}


if __name__ == "__main__":
    main()
