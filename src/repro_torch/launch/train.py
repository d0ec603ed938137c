"""Training launcher: `python -m repro_torch.launch.train --arch tiny-lm ...`
(counterpart of `repro/launch/train.py`).

Runs the fault-tolerant loop on the card (`--device cpu` for the CPU):
  * restores the latest committed checkpoint if one exists (the data
    iterator's step rides in the checkpoint's metadata), under the
    reference's tree `{"params": ..., "opt": OptState._asdict()}`, so
    either package resumes the other's run;
  * checkpoints every --ckpt-every steps through the atomic store;
  * on SIGTERM, checkpoints after the current step and exits with code 3.

`--mesh-shape DxM` trains sharded on a (data, model) mesh of D*M ranks,
one process a rank:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --arch tiny-lm --reduced --mesh-shape 2x2

  * each rank joins the process group (`--dist-init`, env:// by default,
    with RANK / WORLD_SIZE / LOCAL_RANK as torch.distributed.run sets
    them) and builds the mesh; the mesh's size must be the world's.  The
    backend follows from the topology: gloo for CPU ranks, NCCL when each
    rank of the host has a card of its own, gloo when ranks share a card.
  * the parameters are DTensors placed by `sharding.rules_for(arch,
    mesh)`; every rank makes the same global batch from (seed, step), and
    the batch is sharded over the data axes.
  * rank 0 writes the checkpoint's full tensors through the store while
    the other ranks wait at a barrier, so any mesh, and either package,
    resumes the run; every rank restores and redistributes.
  * the ranks agree on SIGTERM (a max over the group after each step), so
    all of them checkpoint the same step and exit 3.
`--mesh-shape 1x1` without a distributed environment (no WORLD_SIZE) is
the one-device loop.
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import time

import torch

from repro_torch import checkpoint as ckpt_mod
from repro_torch.configs import get_config
from repro_torch.core.gp import resolve_device
from repro_torch.data import DataConfig, DataIterator
from repro_torch.launch import sharding
from repro_torch.models import init_params
from repro_torch.models.common import tree_map
from repro_torch.optim import OptimizerConfig, OptState, init_opt_state
from repro_torch.training import TrainConfig, make_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--weight-decay", type=float, default=0.01)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "sgdm"])
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--mesh-shape", default="1x1",
                    help="DxM (data x model) mesh, one process a rank")
    ap.add_argument("--dist-init", default="env://",
                    help="the process group's init_method (a sharded run)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the card by default; cpu runs the same loop there")
    return ap.parse_args(argv)


class _OneDevice:
    """The one-device loop's placement: everything stays as it is."""
    rank = 0

    def __init__(self, dev):
        self.dev = dev

    def place(self, tree, specs):
        return tree

    def place_batch(self, batch):
        return batch

    def step(self, fn):
        return fn

    def host(self, x) -> float:
        return float(x)

    def restored(self, tree, like):
        return tree_map(lambda x: x.to(self.dev), tree)

    def full(self, tree):
        return tree

    def barrier(self):
        pass

    def stop(self, flag: bool) -> bool:
        return flag

    def close(self):
        pass


class _Sharded:
    """Rank `rank` of a (data, model) mesh over the process group."""

    def __init__(self, arch: str, shape: tuple[int, int], dev, init: str):
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_mesh, shared_card_collectives
        self.dist = dist
        self.rank = int(os.environ.get("RANK", "0"))
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if shape[0] * shape[1] != world:
            raise ValueError(f"mesh {shape[0]}x{shape[1]} has "
                             f"{shape[0] * shape[1]} positions, WORLD_SIZE "
                             f"is {world}")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
            backend = "nccl" if torch.cuda.device_count() >= local \
                else "gloo"
        else:
            backend = "gloo"
        self.backend = backend
        dist.init_process_group(backend, init_method=init, rank=self.rank,
                                world_size=world)
        if backend == "gloo" and dev.type == "cuda":
            shared_card_collectives()
        self.mesh = make_mesh(shape, ("data", "model"), device_type=dev.type)
        self.rules = sharding.rules_for(arch, self.mesh)
        self.dev = dev

    def place(self, tree, specs):
        return sharding.distribute(tree, specs, self.mesh, self.rules)

    def place_batch(self, batch):
        from torch.distributed.tensor import distribute_tensor
        spec = sharding.logical_to_spec(("batch",), self.rules)
        return {k: distribute_tensor(
            v, self.mesh,
            sharding.placements(spec + (None,) * (v.ndim - 1), self.mesh,
                                v.shape), src_data_rank=None)
            for k, v in batch.items()}

    def step(self, fn):
        from torch.distributed.tensor.experimental import implicit_replication

        def step_fn(params, opt_state, batch):
            with sharding.use_rules(self.mesh, self.rules), \
                    implicit_replication():
                return fn(params, opt_state, batch)
        return step_fn

    def host(self, x) -> float:
        return float(x.full_tensor() if sharding.is_dtensor(x) else x)

    def restored(self, tree, like):
        from torch.distributed.tensor import distribute_tensor

        def put(x, ref):
            x = x.to(self.dev)
            if not sharding.is_dtensor(ref):
                return x
            return distribute_tensor(x, self.mesh, ref.placements,
                                     src_data_rank=None)
        return tree_map(put, tree, like)

    def full(self, tree):
        return sharding.full(tree)

    def barrier(self):
        self.dist.barrier()

    def stop(self, flag: bool) -> bool:
        t = torch.tensor([int(flag)], device=self.dev)
        self.dist.all_reduce(t, op=self.dist.ReduceOp.MAX)
        return bool(t.item())

    def close(self):
        self.dist.destroy_process_group()


def run(args) -> dict:
    """Train; returns the logged steps, their losses and their host times
    (seconds since the loop started, read after the loss reached the
    host)."""
    cfg = get_config(args.arch, reduced=args.reduced)
    shape = tuple(int(x) for x in args.mesh_shape.split("x"))
    if len(shape) != 2:
        raise ValueError(f"--mesh-shape {args.mesh_shape!r}: want DxM")
    dev = resolve_device(args.device)   # on a card: fp32 like the reference
    if shape == (1, 1) and "WORLD_SIZE" not in os.environ:
        where = _OneDevice(dev)
    else:
        if dev.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", "0"))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        where = _Sharded(args.arch, shape, dev, args.dist_init)
    try:
        return _loop(args, cfg, dev, where)
    finally:
        where.close()


def _loop(args, cfg, dev, where) -> dict:
    opt_cfg = OptimizerConfig(
        name=args.optimizer, lr=args.lr, weight_decay=args.weight_decay,
        momentum=args.momentum, warmup_steps=args.warmup,
        total_steps=args.steps, compress_grads=args.compress_grads)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                          global_batch=args.global_batch, seed=args.seed,
                          frontend=cfg.frontend, d_model=cfg.d_model)

    params, specs = init_params(cfg, args.seed, device=dev)
    params = where.place(params, specs)
    opt_state = init_opt_state(opt_cfg, params)
    step_fn = where.step(make_train_step(
        cfg, opt_cfg, TrainConfig(microbatches=args.microbatches)))
    log = where.rank == 0

    it = DataIterator(data_cfg, device=dev)
    start = 0
    if args.ckpt_dir:
        like = {"params": params, "opt": opt_state._asdict()}
        restored = ckpt_mod.restore_latest(args.ckpt_dir, like)
        if restored is not None:
            start, tree, meta = restored
            tree = where.restored(tree, like)
            params = tree["params"]
            opt_state = OptState(**tree["opt"])
            it.load_state_dict(meta["data_iter"])
            if log:
                print(f"[train] resumed from step {start}", flush=True)

    def save(step):
        """Every rank gathers the full tensors, rank 0 writes them, and the
        others wait for the commit."""
        if not args.ckpt_dir:
            return
        tree = where.full({"params": params, "opt": opt_state._asdict()})
        if where.rank == 0:
            ckpt_mod.save(args.ckpt_dir, step, tree,
                          metadata={"data_iter": it.state_dict(),
                                    "arch": args.arch})
        where.barrier()

    stop_requested = {"flag": False}

    def on_sigterm(signum, frame):
        stop_requested["flag"] = True

    previous = signal.signal(signal.SIGTERM, on_sigterm)
    steps, losses, times, t0 = [], [], [], time.perf_counter()
    try:
        for step in range(start, args.steps):
            batch = where.place_batch(next(it))
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if step % args.log_every == 0 or step == args.steps - 1:
                loss = where.host(metrics["loss"])
                steps.append(step)
                losses.append(loss)
                times.append(time.perf_counter() - t0)
                if log:
                    print(f"[train] step={step} loss={loss:.4f} "
                          f"lr={where.host(metrics['lr']):.2e} "
                          f"gnorm={where.host(metrics['grad_norm']):.2f} "
                          f"({times[-1]:.1f}s)", flush=True)
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                save(step + 1)
            if where.stop(stop_requested["flag"]):
                save(step + 1)
                print(f"[train] SIGTERM: checkpointed step {step + 1} and "
                      f"exiting", flush=True)
                sys.exit(3)
    finally:
        signal.signal(signal.SIGTERM, previous)
    save(args.steps)
    return {"final_loss": losses[-1] if losses else None, "losses": losses,
            "steps": steps, "seconds": times, "start": start}


def main():
    out = run(parse_args())
    if int(os.environ.get("RANK", "0")) == 0:
        print(f"[train] done: final_loss={out['final_loss']}")


if __name__ == "__main__":
    main()
