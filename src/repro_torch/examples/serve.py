"""Async ask–tell HPO serving: many clients, one coalesced gateway.

Counterpart of `examples/serve.py`:

    PYTHONPATH=src python -m repro_torch.examples.serve \
        [--studies 12] [--slots 4] [--budget 8] [--q 4] [--coalesce-ms 2] \
        [--ckpt-dir DIR] [--device cuda|cpu]

N asynchronous clients each run their own HPO study through the gateway's
`ask`/`tell` API.  Concurrent asks coalesce into ONE batched round per
tick; with `--slots` below `--studies` the pool serves more logical
studies than resident GP slots, evicting idle studies to per-study
checkpoints and restoring them on their next ask.  With --ckpt-dir
pointing at a persistent directory a second invocation restores the whole
gateway and every tenant resumes exactly where it stopped.

Each client optimizes its own synthetic objective (a shifted smooth bowl on
the unit cube, distinct optimum per tenant) with a touch of simulated
training latency.  With `--q N` (N > 1) every client asks for a BATCH of N
suggestions per round, one fantasy ask each, and evaluates them
concurrently before telling all N back.
"""
from __future__ import annotations

import argparse
import asyncio
import tempfile
import time

import numpy as np

from repro_torch.core import GPCapacityError
from repro_torch.core.acquisition import AcqConfig
from repro_torch.hpo.gateway import GatewayConfig, StudyGateway
from repro_torch.hpo.pool import SchedulerConfig
from repro_torch.hpo.space import RESNET_SPACE


def make_objective(sid: int, latency: float):
    center = 0.15 + 0.7 * ((sid * 0.37) % 1.0)

    async def objective(unit: np.ndarray) -> float:
        await asyncio.sleep(latency * (1.0 + 0.5 * ((sid + 1) % 3)))
        return float(-np.sum((np.asarray(unit) - center) ** 2))

    return objective


async def client(gw: StudyGateway, sid: int, budget: int, latency: float,
                 q: int = 1) -> int:
    """One tenant's loop; returns the observations it told."""
    objective = make_objective(sid, latency)
    done = 0
    while done < budget:
        width = min(q, budget - done)
        try:
            got = await gw.ask(sid, q=width) if width > 1 \
                else await gw.ask(sid)
        except GPCapacityError as e:
            # a resumed study can hit its n_max (the buffers are sized at
            # construction and shape-checked on restore): report it
            # instead of crashing the whole serving loop
            print(f"  {gw.study_info(sid)['name']}: full ({e})")
            break
        trials = got if isinstance(got, list) else [got]
        # the q suggestions are a worker farm: evaluate concurrently,
        # tell each result back as it lands
        values = await asyncio.gather(*(objective(t.unit) for t in trials))
        for trial, value in zip(trials, values):
            gw.tell(sid, trial, value)
        done += len(trials)
    await gw.drain()
    return done


async def serve(args, ckpt_dir: str) -> dict:
    cfg = SchedulerConfig(n_max=args.budget + 8, seed=0,
                          ckpt_dir=ckpt_dir, ckpt_every=10 ** 9,
                          acq=AcqConfig(restarts=16, ascent_steps=8))
    gw = StudyGateway(RESNET_SPACE, cfg,
                      GatewayConfig(slots=args.slots,
                                    coalesce_ms=args.coalesce_ms,
                                    max_inflight=max(4, args.q)),
                      device=args.device)
    # A fresh directory returns False; an INCOMPATIBLE checkpoint (e.g. a
    # --slots or --budget change reshaping the pool) raises ValueError:
    # let it surface rather than start fresh over the old tenants.
    resumed = None
    if gw.restore():
        sids = gw.study_ids()
        resumed = {gw.study_info(s)["name"]: gw.study_info(s)["n_obs"]
                   for s in sids}
        print("resumed gateway: " + ", ".join(
            "{name} n={n_obs}".format(**gw.study_info(s)) for s in sids))
    else:
        sids = [gw.create_study(name=f"tenant{i}")
                for i in range(args.studies)]

    served_before = gw.summary()["asks_served"]   # lifetime totals ride
    # the checkpoint registry: report only THIS invocation's traffic
    t0 = time.perf_counter()
    told = await asyncio.gather(*(client(gw, s, args.budget, args.latency,
                                         args.q) for s in sids))
    elapsed = time.perf_counter() - t0
    summary = gw.summary()
    served = summary["asks_served"] - served_before
    gw.checkpoint()
    await gw.aclose()

    infos = [gw.study_info(s) for s in sids]
    total = sum(info["n_obs"] for info in infos)
    print(f"\nserved {served} suggestions "
          f"({total} absorbed total) for {len(sids)} tenants on "
          f"{args.slots} slots in {elapsed:.2f}s "
          f"({served / max(elapsed, 1e-9):.1f} suggestions/s)")
    print(f"ticks={summary['ticks']} "
          f"mean_coalesce_width={summary['mean_coalesce_width']:.1f} "
          f"p50_tick={summary['p50_tick_ms']:.1f}ms "
          f"p95_tick={summary['p95_tick_ms']:.1f}ms "
          f"evictions={summary['evictions']} "
          f"restores={summary['restores']}")
    if args.q > 1:
        print(f"q-widths={summary['q_width_hist']} "
              f"fantasy_rollbacks={summary['fantasy_rollbacks']} "
              f"fantasy_active={summary['fantasy_active']}")
    tenants = {}
    for info in infos:
        slot = "evicted" if not info["resident"] else f"slot {info['slot']}"
        line = f"  {info['name']}: n={info['n_obs']} ({slot}"
        if info["evictions"]:
            line += f", {info['evictions']} evictions"
        line += ")"
        if info["best_value"] is not None:
            line += f" best={info['best_value']:+.4f}"
        print(line)
        tenants[info["name"]] = {"n": info["n_obs"],
                                 "best": info["best_value"],
                                 "resident": info["resident"],
                                 "evictions": info["evictions"]}
    keys = ("ticks", "mean_coalesce_width", "p50_tick_ms", "p95_tick_ms",
            "evictions", "restores", "fantasy_rollbacks", "fantasy_active",
            "q_width_hist")
    return {"served": served, "told": sum(told), "absorbed": total,
            "device": str(gw.pool.engine.device),
            "seconds": elapsed, "resumed": resumed, "tenants": tenants,
            **{k: summary[k] for k in keys if k in summary}}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--studies", type=int, default=12,
                    help="concurrent logical studies (clients)")
    ap.add_argument("--slots", type=int, default=4,
                    help="resident GP slots (< studies exercises eviction)")
    ap.add_argument("--budget", type=int, default=8,
                    help="observations per study")
    ap.add_argument("--q", type=int, default=1,
                    help="suggestions per ask: q>1 serves each ask with "
                         "one fantasy ask")
    ap.add_argument("--latency", type=float, default=0.01,
                    help="simulated per-trial train time (s)")
    ap.add_argument("--coalesce-ms", type=float, default=0.0,
                    help="tick gathering window")
    ap.add_argument("--ckpt-dir", default=None,
                    help="persistent dir: a 2nd run resumes every tenant")
    ap.add_argument("--device", default="cuda",
                    help="the card by default; cpu runs the plain versions")
    args = ap.parse_args(argv)

    if args.ckpt_dir:
        return asyncio.run(serve(args, args.ckpt_dir))
    with tempfile.TemporaryDirectory() as d:
        return asyncio.run(serve(args, d))


if __name__ == "__main__":
    main()
