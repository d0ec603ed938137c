"""Cross-process HPO serving: shard workers behind the socket front end.

Counterpart of `examples/serve_cluster.py`:

    PYTHONPATH=src python -m repro_torch.examples.serve_cluster \
        [--studies 8] [--shards 2] [--budget 6] [--latency 0.01] [--kill] \
        [--ckpt-dir DIR] [--device cuda|cpu]

A `TransportFederation` front end spawns one `repro_torch.hpo.shard_worker`
process per shard (one per host in a real cluster; `TransportConfig.connect`
adopts operator-started workers), and every `ask`/`tell` crosses a socket
as length-prefixed JSON frames.  Each worker serves on `--device`.

With `--kill` the supervisor SIGKILLs shard 0 mid-serve: parked asks on
that shard fail with `ShardConnectionError`, the health sweep marks it
dead, and `revive_shard` hands the shard to the front end's warm standby
worker, which restores from the shard's latest committed epoch; clients
resume and only the uncommitted round is lost (re-derived from the
persisted per-study generator streams).

With `--ckpt-dir` pointing at a persistent directory a second invocation
restores the whole federation (registry epoch first, then every shard
from its own store) and each tenant resumes exactly where it stopped.
"""
from __future__ import annotations

import argparse
import asyncio
import tempfile
import time

import numpy as np

from repro_torch.core.acquisition import AcqConfig
from repro_torch.core.gp import resolve_device
from repro_torch.hpo.federation import FederationConfig
from repro_torch.hpo.gateway import GatewayConfig
from repro_torch.hpo.pool import SchedulerConfig
from repro_torch.hpo.space import RESNET_SPACE
from repro_torch.hpo.transport import (ShardConnectionError, TransportConfig,
                                       TransportFederation)


# Retries of 0.2 s a client waits for its shard's revive: the JAX
# example's 50.  The revive starts no interpreter (the federation's warm
# standby worker takes the shard), so it costs the gateway, the restore,
# the bind and the reconcile (`worker_starts`, `revive_s`).
MAX_RETRIES = 50


def make_objective(sid: int, latency: float):
    center = 0.15 + 0.7 * ((sid * 0.37) % 1.0)

    async def objective(unit: np.ndarray) -> float:
        await asyncio.sleep(latency * (1.0 + 0.5 * ((sid + 1) % 3)))
        return float(-np.sum((np.asarray(unit) - center) ** 2))

    return objective


async def client(tf: TransportFederation, sid: int, budget: int,
                 latency: float) -> int:
    """One tenant's serving loop; survives its shard dying mid-ask by
    waiting for the supervisor to revive it.  Returns its retries."""
    objective = make_objective(sid, latency)
    done = retried = 0
    while done < budget:
        try:
            trial = await tf.ask(sid)
            await tf.tell(sid, trial, await objective(trial.unit))
        except (ShardConnectionError, asyncio.CancelledError,
                RuntimeError):
            # the shard died under us (parked asks cancel with kill_shard
            # semantics; calls routed to a down shard fail loudly): back
            # off and retry once the supervisor revives it
            retried += 1
            if retried > MAX_RETRIES:
                raise
            await asyncio.sleep(0.2)
            continue
        done += 1
    return retried


async def supervisor(tf: TransportFederation, kill_after: float) -> dict:
    """Checkpoint, SIGKILL shard 0, observe the health sweep declare it
    dead, respawn it from its committed epoch.  `revive_s` runs from the
    kill to the shard respawned and reconciled."""
    await asyncio.sleep(kill_after)
    epoch = await tf.checkpoint()
    t0 = time.perf_counter()
    tf.kill_shard(0)
    print(f"  [supervisor] shard 0 SIGKILLed after epoch {epoch}")
    dead = await tf.check_health()
    if dead:     # the kill already marked it dead: the sweep finds no more
        raise RuntimeError(f"health sweep found shards {dead} newly dead")
    await tf.revive_shard(0)
    revive_s = time.perf_counter() - t0
    print("  [supervisor] shard 0 respawned + reconciled")
    print(f"  [supervisor] revive_s={revive_s:.3f}")
    return {"killed_after_epoch": epoch, "revived": True,
            "revive_s": revive_s}


async def serve(args, root: str) -> dict:
    cfg = SchedulerConfig(n_max=args.budget + 8, seed=0,
                          ckpt_dir=root, ckpt_every=10 ** 9,
                          acq=AcqConfig(restarts=16, ascent_steps=8))
    tf = TransportFederation(
        RESNET_SPACE, cfg,
        GatewayConfig(slots=max(2, args.studies // args.shards)),
        FederationConfig(n_shards=args.shards),
        TransportConfig(heartbeat_s=0.0), device=args.device)
    restored = await tf.start()
    try:
        if restored:
            sids = tf.study_ids()
            print(f"resumed federation: {len(sids)} tenants across "
                  f"{args.shards} worker processes")
        else:
            sids = [await tf.create_study(name=f"tenant{i}")
                    for i in range(args.studies)]

        tasks = [client(tf, s, args.budget, args.latency) for s in sids]
        if args.kill:
            tasks.append(supervisor(tf, kill_after=args.kill_after))
        t0 = time.perf_counter()
        results = await asyncio.gather(*tasks)
        await tf.drain()
        elapsed = time.perf_counter() - t0

        summary = await tf.summary()
        client_retries = dict(zip(sids, results))
        retries = sum(client_retries.values())
        served = args.budget * len(sids)
        await tf.checkpoint()
        if args.kill:
            print(f"  [supervisor] retries by study {client_retries}")
        print(f"\nserved {served} suggestions for {len(sids)} tenants on "
              f"{args.shards} worker processes in {elapsed:.2f}s "
              f"({served / max(elapsed, 1e-9):.1f} suggestions/s, "
              f"{retries} failover retries)")
        worst_p95 = max((s["p95_tick_ms"]
                         for s in summary["per_shard"].values()), default=0.0)
        print(f"ticks={summary['ticks']} "
              f"evictions={summary['evictions']} "
              f"worst_shard_p95_tick={worst_p95:.1f}ms")
        tenants = {}
        for s in sids:
            info = await tf.study_info(s)
            line = (f"  {info['name']}: shard {info['shard']} "
                    f"n={info['n_obs']}")
            if info["best_value"] is not None:
                line += f" best={info['best_value']:+.4f}"
            print(line)
            tenants[info["name"]] = {"shard": info["shard"],
                                     "n": info["n_obs"],
                                     "best": info["best_value"]}
    finally:
        await tf.aclose()
    kill = next((r for r in results if isinstance(r, dict)), None)
    return {"served": served, "retries": retries, "seconds": elapsed,
            "resumed": bool(restored), "ticks": summary["ticks"],
            "evictions": summary["evictions"], "worst_p95_tick_ms": worst_p95,
            "kill": kill, "tenants": tenants,
            "client_retries": client_retries,
            "worker_starts": tf.worker_starts}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--studies", type=int, default=8,
                    help="concurrent logical studies (clients)")
    ap.add_argument("--shards", type=int, default=2,
                    help="worker processes (one per host in production)")
    ap.add_argument("--budget", type=int, default=6,
                    help="observations per study")
    ap.add_argument("--latency", type=float, default=0.01,
                    help="simulated per-trial train time (s)")
    ap.add_argument("--kill", action="store_true",
                    help="SIGKILL + revive shard 0 mid-serve")
    ap.add_argument("--kill-after", type=float, default=1.0,
                    help="seconds before the supervisor kills shard 0")
    ap.add_argument("--ckpt-dir", default=None,
                    help="persistent shared store root: a 2nd run "
                         "resumes every tenant")
    ap.add_argument("--device", default="cuda",
                    help="the workers' device: the card by default, cpu "
                         "runs the plain versions")
    args = ap.parse_args(argv)
    resolve_device(args.device)     # a card asked for where there is none
    # raises here, before a worker is spawned

    if args.ckpt_dir:
        return asyncio.run(serve(args, args.ckpt_dir))
    with tempfile.TemporaryDirectory() as d:
        return asyncio.run(serve(args, d))


if __name__ == "__main__":
    main()
