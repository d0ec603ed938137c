"""Training launcher: `python -m repro_torch.launch.train --arch tiny-lm ...`
(counterpart of `repro/launch/train.py`, on one device).

Runs the fault-tolerant loop on the card (`--device cpu` for the CPU):
  * restores the latest committed checkpoint if one exists (the data
    iterator's step rides in the checkpoint's metadata), under the
    reference's tree `{"params": ..., "opt": OptState._asdict()}`, so
    either package resumes the other's run;
  * checkpoints every --ckpt-every steps through the atomic store;
  * on SIGTERM, checkpoints after the current step and exits with code 3.

`--mesh-shape` takes only 1x1: the port trains on one device.
"""
from __future__ import annotations

import argparse
import signal
import sys
import time

import torch

from repro_torch import checkpoint as ckpt_mod
from repro_torch.configs import get_config
from repro_torch.core.gp import resolve_device
from repro_torch.data import DataConfig, DataIterator
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
                    help="DxM device mesh; the port takes only 1x1")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the card by default; cpu runs the same loop there")
    return ap.parse_args(argv)


def run(args) -> dict:
    """Train; returns the logged steps, their losses and their host times
    (seconds since the loop started, read after the loss reached the
    host)."""
    cfg = get_config(args.arch, reduced=args.reduced)
    if tuple(int(x) for x in args.mesh_shape.split("x")) != (1, 1):
        raise NotImplementedError(
            f"mesh {args.mesh_shape!r}: the port trains on one device "
            f"(--mesh-shape 1x1); a training mesh waits for the launch "
            f"layer (ROADMAP.md, \"the launch layer\")")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # fp32 like the reference: no TF32 in matmuls or convolutions, and
        # bfloat16 products accumulated in float32 throughout.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False

    opt_cfg = OptimizerConfig(
        name=args.optimizer, lr=args.lr, weight_decay=args.weight_decay,
        momentum=args.momentum, warmup_steps=args.warmup,
        total_steps=args.steps, compress_grads=args.compress_grads)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                          global_batch=args.global_batch, seed=args.seed,
                          frontend=cfg.frontend, d_model=cfg.d_model)

    params, _ = init_params(cfg, args.seed, device=dev)
    opt_state = init_opt_state(opt_cfg, params)
    step_fn = make_train_step(cfg, opt_cfg,
                              TrainConfig(microbatches=args.microbatches))

    it = DataIterator(data_cfg, device=dev)
    start = 0
    if args.ckpt_dir:
        restored = ckpt_mod.restore_latest(
            args.ckpt_dir, {"params": params, "opt": opt_state._asdict()})
        if restored is not None:
            start, tree, meta = restored
            tree = tree_map(lambda x: x.to(dev), tree)
            params = tree["params"]
            opt_state = OptState(**tree["opt"])
            it.load_state_dict(meta["data_iter"])
            print(f"[train] resumed from step {start}", flush=True)

    def save(step):
        if not args.ckpt_dir:
            return
        ckpt_mod.save(args.ckpt_dir, step,
                      {"params": params, "opt": opt_state._asdict()},
                      metadata={"data_iter": it.state_dict(),
                                "arch": args.arch})

    stop_requested = {"flag": False}

    def on_sigterm(signum, frame):
        stop_requested["flag"] = True

    previous = signal.signal(signal.SIGTERM, on_sigterm)
    steps, losses, times, t0 = [], [], [], time.perf_counter()
    try:
        for step in range(start, args.steps):
            batch = next(it)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if step % args.log_every == 0 or step == args.steps - 1:
                loss = float(metrics["loss"])
                steps.append(step)
                losses.append(loss)
                times.append(time.perf_counter() - t0)
                print(f"[train] step={step} loss={loss:.4f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"gnorm={float(metrics['grad_norm']):.2f} "
                      f"({times[-1]:.1f}s)", flush=True)
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                save(step + 1)
            if stop_requested["flag"]:
                save(step + 1)
                print("[train] SIGTERM: checkpointed and exiting", flush=True)
                sys.exit(3)
    finally:
        signal.signal(signal.SIGTERM, previous)
    save(args.steps)
    return {"final_loss": losses[-1] if losses else None, "losses": losses,
            "steps": steps, "seconds": times, "start": start}


def main():
    out = run(parse_args())
    print(f"[train] done: final_loss={out['final_loss']}")


if __name__ == "__main__":
    main()
