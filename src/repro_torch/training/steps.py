"""Train, eval and serving step builders (counterpart of
`repro/training/steps.py`).

`make_train_step` closes over (ModelConfig, OptimizerConfig) and returns

    train_step(params, opt_state, batch) -> (params, opt_state, metrics)

a pure function of its arguments: the gradient is taken with respect to
detached copies of the parameter leaves, and the update returns new
tensors.  Microbatching (gradient accumulation) loops over slices of the
batch and sums the gradients in float32, as the reference's scan does.

The same step runs sharded on DTensor parameters and batches under a rule
context (`launch/sharding.use_rules`, with DTensor's implicit replication
of the plain tensors the model makes): `value_and_grad` returns each
gradient placed as its parameter is (DTensor's backward leaves partial
sums), and the optimizer's updates are elementwise on like placements.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.launch.sharding import is_dtensor
from repro_torch.models import decode_step, init_params, lm_loss, prefill
from repro_torch.models.common import tree_map
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import (OptimizerConfig, OptState,
                                          apply_updates, init_opt_state)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1     # gradient-accumulation steps per update
    bf16_grads: bool = False  # differentiate with respect to a bf16 copy of
    # the params: the gradients become bf16, the float32 master update is
    # unchanged


def make_loss_fn(cfg: ModelConfig) -> Callable:
    def loss_fn(params, batch):
        return lm_loss(params, cfg, batch)
    return loss_fn


def value_and_grad(loss_fn: Callable, params, batch,
                   dtype: torch.dtype | None = None):
    """((loss, metrics), grads) of `loss_fn(params, batch)` with respect to
    every leaf of `params` (cast to `dtype` first where given); the grads
    keep the params' tree, and nothing returned holds a graph."""
    watched = []

    def watch(x):
        x = x.detach()
        if dtype is not None and x.is_floating_point():
            x = x.to(dtype)
        watched.append(x.requires_grad_(True))
        return watched[-1]

    with torch.enable_grad():
        loss, metrics = loss_fn(tree_map(watch, params), batch)
        grads = iter(torch.autograd.grad(loss, watched))
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree_map(lambda p: _placed_as(p, next(grads)), params))


def _placed_as(p, g):
    """g redistributed to p's placements where p is a DTensor (a partial
    sum reduces to p's shards); g itself otherwise."""
    if is_dtensor(p) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    train_cfg: TrainConfig | None = None) -> Callable:
    train_cfg = train_cfg or TrainConfig()
    loss_fn = make_loss_fn(cfg)

    def single_step(params, opt_state: OptState, batch):
        dtype = torch.bfloat16 if train_cfg.bf16_grads else None
        (loss, metrics), grads = value_and_grad(loss_fn, params, batch, dtype)
        params, opt_state, opt_metrics = apply_updates(
            opt_cfg, params, grads, opt_state)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return params, opt_state, metrics

    if train_cfg.microbatches <= 1:
        return single_step

    m = train_cfg.microbatches

    def accum_step(params, opt_state: OptState, batch):
        gsum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)
        some = next(iter(batch.values()))
        lsum = torch.zeros((), dtype=torch.float32, device=some.device)
        mb = some.shape[0] // m
        for i in range(m):
            micro = {k: x[i * mb:(i + 1) * mb] for k, x in batch.items()}
            (loss, _), grads = value_and_grad(loss_fn, params, micro)
            gsum = tree_map(torch.add, gsum, grads)
            lsum = lsum + loss
        grads = tree_map(lambda g: g / m, gsum)
        params, opt_state, opt_metrics = apply_updates(
            opt_cfg, params, grads, opt_state)
        metrics = dict(loss=lsum / m, **opt_metrics)
        return params, opt_state, metrics

    return accum_step


def make_eval_step(cfg: ModelConfig) -> Callable:
    loss_fn = make_loss_fn(cfg)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = loss_fn(params, batch)
        return dict(metrics, loss=loss)

    return eval_step


def make_prefill_step(cfg: ModelConfig, max_len: int) -> Callable:
    """prefill_step(params, tokens) -> (last logits, cache), no graph."""

    @torch.no_grad()
    def prefill_step(params, tokens):
        return prefill(params, cfg, tokens, max_len)

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """serve_step(params, cache, token) -> (logits, cache), no graph; the
    cache is updated in place (`models.decode_step`)."""

    @torch.no_grad()
    def serve_step(params, cache, token):
        return decode_step(params, cfg, cache, token)

    return serve_step


def init_train_state(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                     seed: int | torch.Generator, *,
                     device: str | torch.device = "cuda"):
    params, specs = init_params(cfg, seed, device=device)
    return params, init_opt_state(opt_cfg, params), specs
