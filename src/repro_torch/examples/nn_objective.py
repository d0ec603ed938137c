"""The NN-HPO trial objective: train reduced tiny-lm with SGD-momentum at
a trial's (lr, weight decay, momentum) and return its eval accuracy.

Counterpart of `benchmarks/bench_nn_hpo.py:make_objective` (the JAX
package's benchmark), kept here because `parallel_hpo` trains through it.
Every trial starts from one seeded init and trains on the same batches;
the three knobs enter as 0-d tensors, so every trial runs one code path.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.gp import resolve_device
from repro_torch.data import DataConfig, DataIterator
from repro_torch.hpo.space import RESNET_SPACE
from repro_torch.models import init_params, lm_loss
from repro_torch.models.common import tree_map
from repro_torch.optim import clip_by_global_norm
from repro_torch.training import make_eval_step, value_and_grad

EVAL_STEP = 10_000   # the data step of the held-out eval batch
KNOBS = ("lr", "weight_decay", "momentum")


def train_trial(cfg, params0, batches, eval_batch, knobs) -> dict:
    """One trial: SGD-momentum from `params0` over `batches` (gradients
    clipped to global norm 1 in float32, momentum without dampening,
    decoupled weight decay inside the step), then the eval metrics on
    `eval_batch` as floats.  `knobs`: 0-d tensors (lr, weight decay,
    momentum) on the params' device."""
    lr, wd, mom = knobs

    def loss_fn(p, batch):
        return lm_loss(p, cfg, batch)

    params, mu = params0, tree_map(torch.zeros_like, params0)
    for batch in batches:
        _, grads = value_and_grad(loss_fn, params, batch)
        with torch.no_grad():
            grads, _ = clip_by_global_norm(
                tree_map(lambda g: g.float(), grads), 1.0)
            mu = tree_map(lambda a, g: mom * a + g, mu, grads)
            params = tree_map(
                lambda p, a: (p.float() - lr * (a + wd * p.float())
                              ).to(p.dtype), params, mu)
    metrics = make_eval_step(cfg)(params, eval_batch)
    return {k: float(v) for k, v in metrics.items()}


def make_objective(steps: int = 25, seq_len: int = 64, batch: int = 8,
                   device: str | torch.device = "cuda"):
    """`objective(units (k, 3) or (3,)) -> (k,)` eval accuracies on
    RESNET_SPACE's unit cube, on `device`."""
    dev = resolve_device(device)
    cfg = get_config("tiny-lm", reduced=True)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      global_batch=batch, seed=7)
    params0, _ = init_params(cfg, 1, device=dev)
    it = DataIterator(dcfg, device=dev)
    batches = [next(it) for _ in range(steps)]
    eval_batch = next(DataIterator(dcfg, start_step=EVAL_STEP, device=dev))

    def objective(units: np.ndarray) -> np.ndarray:
        outs = []
        for u in np.atleast_2d(units):
            hp = RESNET_SPACE.to_hparams(u)
            knobs = [torch.tensor(hp[k], dtype=torch.float32, device=dev)
                     for k in KNOBS]
            outs.append(train_trial(cfg, params0, batches, eval_batch,
                                    knobs)["accuracy"])
        return np.asarray(outs)

    return objective
