"""End-to-end training driver: train a small LM for a few hundred steps.

Counterpart of `examples/train_e2e.py`:

    PYTHONPATH=src python -m repro_torch.examples.train_e2e    # ~15M params
    PYTHONPATH=src python -m repro_torch.examples.train_e2e --preset 100m
    PYTHONPATH=src python -m repro_torch.examples.train_e2e \
        --arch granite-3-2b --reduced [--device cuda|cpu]

The full substrate: synthetic data pipeline -> train step -> checkpointing
-> restart, through `repro_torch.launch.train`.  Kill it mid-run and run
it again with the same --ckpt-dir: it resumes from the last committed step
with an identical data stream.  A preset is tiny-lm's config with the
preset's widths, in place for the run and put back when `main` returns.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.launch import train as train_mod

PRESETS = {
    "15m": dict(num_layers=4, d_model=384, num_heads=8, num_kv_heads=4,
                d_ff=1536, vocab_size=8192),
    "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
                 d_ff=3072, vocab_size=16384),
}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="15m", choices=list(PRESETS))
    ap.add_argument("--arch", default=None,
                    help="use an assigned arch config instead of a preset")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_e2e_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="the card by default; cpu runs the same loop there")
    args = ap.parse_args(argv)

    import repro_torch.configs.tiny_lm as tiny
    config = tiny.CONFIG
    if args.arch:
        launch = ["--arch", args.arch] + (["--reduced"] if args.reduced
                                          else [])
    else:
        # the preset as a patched tiny-lm, for this run only
        tiny.CONFIG = dataclasses.replace(get_config("tiny-lm"),
                                          **PRESETS[args.preset])
        launch = ["--arch", "tiny-lm"]
    launch += ["--steps", str(args.steps), "--seq-len", str(args.seq_len),
               "--global-batch", str(args.global_batch), "--lr",
               str(args.lr), "--ckpt-dir", args.ckpt_dir, "--ckpt-every",
               "50", "--log-every", "10", "--device", args.device]
    try:
        out = train_mod.run(train_mod.parse_args(launch))
    finally:
        tiny.CONFIG = config
    print(f"final loss: {out['final_loss']:.4f} "
          f"(started near ln(vocab) ~ {out['losses'][0]:.2f})")
    return out


if __name__ == "__main__":
    main()
