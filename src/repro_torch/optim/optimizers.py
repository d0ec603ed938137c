"""Optimizers, schedules, clipping and gradient compression (counterpart of
`repro/optim/optimizers.py`).

AdamW and SGD-momentum (the paper tunes lr / weight decay / momentum for
its LeNet / ResNet targets; these are the knobs the HPO layer exposes), a
warmup-cosine schedule, global-norm clipping, and error-feedback int8
gradient compression (the residual buffer keeps the update unbiased over
time).  Parameter, moment and gradient trees are the model's nested dicts;
the step counter is a 0-d int32 tensor and the bias corrections are
float32, as in the reference.  Updates are pure: `apply_updates` returns
new tensors and leaves its inputs as they were.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.common import tree_leaves, tree_map

Tensor = torch.Tensor
Params = Any


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # "adamw" | "sgdm"
    lr: float = 3e-4
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    momentum: float = 0.9          # sgdm
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    compress_grads: bool = False   # error-feedback int8 DP compression


class OptState(NamedTuple):
    step: Tensor
    mu: Params          # first moment / momentum
    nu: Params | None   # second moment (adamw)
    ef_residual: Params | None  # error-feedback buffer


def schedule(cfg: OptimizerConfig, step: Tensor) -> Tensor:
    """Linear warmup, then cosine down to `min_lr_frac`; `step` is the int32
    counter (divided before it is clipped, as the reference does)."""
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_opt_state(cfg: OptimizerConfig, params: Params) -> OptState:
    some = tree_leaves(params)[0]
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=some.device),
        mu=tree_map(torch.zeros_like, params),
        nu=tree_map(torch.zeros_like, params) if cfg.name == "adamw"
        else None,
        ef_residual=(tree_map(torch.zeros_like, params)
                     if cfg.compress_grads else None),
    )


def global_norm(tree: Params) -> Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> tuple[Params, Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return tree_map(lambda g: g * scale, grads), norm


# ---------------------------------------------------------------------------
# Error-feedback int8 compression (for the DP all-reduce payload)
# ---------------------------------------------------------------------------

def _compress_int8(x: Tensor) -> tuple[Tensor, Tensor]:
    """Symmetric int8 with one scale; `torch.round` rounds half to even, as
    `jnp.round` does."""
    absmax = torch.clamp_min(torch.max(torch.abs(x)), 1e-12)
    scale = absmax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _decompress_int8(q: Tensor, scale: Tensor) -> Tensor:
    return q.float() * scale


def ef_compress_grads(grads: Params, residual: Params
                      ) -> tuple[Params, Params]:
    """Error-feedback int8: g' = Q(g + r); r' = (g + r) - g'."""
    def sent(g, r):
        corrected = g.float() + r
        return _decompress_int8(*_compress_int8(corrected)), corrected

    both = tree_map(sent, grads, residual)
    return (tree_map(lambda g, s: s[0].to(g.dtype), grads, both),
            tree_map(lambda g, s: s[1] - s[0], grads, both))


# ---------------------------------------------------------------------------
# Updates
# ---------------------------------------------------------------------------

@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params: Params, grads: Params,
                  state: OptState) -> tuple[Params, OptState, dict]:
    grads = tree_map(lambda g: g.float(), grads)
    if cfg.compress_grads and state.ef_residual is not None:
        grads, new_residual = ef_compress_grads(grads, state.ef_residual)
    else:
        new_residual = state.ef_residual
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    lr = schedule(cfg, state.step)
    step = state.step + 1

    if cfg.name == "adamw":
        mu = tree_map(lambda m, g: cfg.b1 * m + (1 - cfg.b1) * g,
                      state.mu, grads)
        nu = tree_map(lambda v, g: cfg.b2 * v + (1 - cfg.b2) * g * g,
                      state.nu, grads)
        bc1 = 1 - cfg.b1 ** step.float()
        bc2 = 1 - cfg.b2 ** step.float()

        def upd(p, m, v):
            p32 = p.float()
            return (p32 - lr * ((m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
                                + cfg.weight_decay * p32)).to(p.dtype)

        new_params = tree_map(upd, params, mu, nu)
        new_state = OptState(step, mu, nu, new_residual)
    elif cfg.name == "sgdm":
        mu = tree_map(lambda m, g: cfg.momentum * m + g, state.mu, grads)

        def upd(p, m):
            p32 = p.float()
            return (p32 - lr * (m + cfg.weight_decay * p32)).to(p.dtype)

        new_params = tree_map(upd, params, mu)
        new_state = OptState(step, mu, None, new_residual)
    else:
        raise ValueError(cfg.name)
    return new_params, new_state, {"lr": lr, "grad_norm": gnorm}
