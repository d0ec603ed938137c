"""Input stand-ins and sharding specs per (arch x shape) cell (counterpart
of `repro/launch/specs.py`).

`token_specs` gives the shape and dtype of every input of a cell's step
(`SDS`, the counterpart of `jax.ShapeDtypeStruct`) with its spec tuple;
`cache_shardings` the spec of every decode-cache leaf.  The abstract
trees (`abstract_params`, `abstract_opt_state`, `abstract_cache`) are made
under the caller's `FakeTensorMode`: fake tensors with shapes, dtypes and
devices but no storage, the parameters and the optimizer state as
DTensors placed by the rules.  This is what the dry run
(`launch/dryrun.py`) steps.

Assigned LM shape grid:
    train_4k     seq=4096    global_batch=256   (train_step)
    prefill_32k  seq=32768   global_batch=32    (prefill_step)
    decode_32k   seq=32768   global_batch=128   (decode_step, 1 new token)
    long_500k    seq=524288  global_batch=1     (decode_step; sub-quadratic
                                                 archs only)
Token ids are int64, the port's index type (the reference's are int32).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.launch import sharding
from repro_torch.models.config import ModelConfig


class SDS(NamedTuple):
    shape: tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str       # "train" | "prefill" | "decode"
    seq: int
    batch: int


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def cell_applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped): encoders have no decode step, and only
    sub-quadratic archs decode at 500k."""
    cell = SHAPES[shape_name]
    if cell.kind == "decode" and not cfg.supports_decode:
        return False, "encoder-only arch has no decode step"
    if cell.name == "long_500k" and not cfg.supports_long_context:
        return False, "pure full-attention arch; 500k decode skipped"
    return True, ""


def _data_axes(mesh):
    axes = tuple(a for a in ("pod", "data") if a in sharding.axis_names(mesh))
    return axes if len(axes) > 1 else axes[0]


def batch_spec(mesh) -> tuple:
    return (_data_axes(mesh),)


def token_specs(cfg: ModelConfig, batch: int, seq: int,
                mesh) -> tuple[dict, dict]:
    bspec = batch_spec(mesh)
    if cfg.frontend == "frames":
        inputs = SDS((batch, seq, cfg.d_model), torch.bfloat16)
        ispec = (*bspec, None, None)
    else:
        inputs = SDS((batch, seq), torch.int64)
        ispec = (*bspec, None)
    batch_tree = {
        "inputs": inputs,
        "targets": SDS((batch, seq), torch.int64),
        "mask": SDS((batch, seq), torch.float32),
    }
    spec_tree = {"inputs": ispec, "targets": (*bspec, None),
                 "mask": (*bspec, None)}
    return batch_tree, spec_tree


# ---------------------------------------------------------------------------
# Decode-cache specs
# ---------------------------------------------------------------------------

def cache_shardings(cfg: ModelConfig, cache_shapes: Any, mesh,
                    batch: int) -> Any:
    """Spec tree matching `init_cache`'s structure (`pos`, a Python int,
    gets ()).

    batch > 1: cache batch over the data axes, heads (or the cache
    sequence) over model.  batch == 1 (long_500k): batch replicated, the
    cache *sequence* over all axes (sequence-parallel KV) so a 500k cache
    fits per device."""
    dp = _data_axes(mesh)
    seq_shard = batch == 1
    every = (*(dp if isinstance(dp, tuple) else (dp,)), "model")

    def spec_for(path: str, ndim: int) -> tuple:
        if path == "pos":
            return ()
        if path in ("k", "v", "shared_k", "shared_v"):
            # (L, B, S, KV, dh): batch over the data axes, the cache
            # sequence over "model".
            if seq_shard:
                return (None, None, every, None, None)
            return (None, dp, "model", None, None)
        if path in ("c_kv", "k_rope"):
            # (L, B, S, r): latent rank whole (small), seq over "model".
            if seq_shard:
                return (None, None, every, None)
            return (None, dp, "model", None)
        b = None if seq_shard else dp
        if path.endswith("conv"):
            return (None, b, None, "model")          # (L, B, W, conv_dim)
        if path.endswith("ssm"):
            return (None, b, "model", None, None)    # (L, B, H, P, N)
        if path.endswith("c"):
            return (None, b, None, None, None)       # mLSTM C (L,B,H,dh,dh)
        if path.endswith("n"):
            return (None, b, None, None)
        if path.endswith("m"):
            return (None, b, None)
        return (None,) * ndim

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return spec_for(prefix, len(getattr(tree, "shape", ())))

    return walk(cache_shapes)


# ---------------------------------------------------------------------------
# Abstract trees (under the caller's FakeTensorMode)
# ---------------------------------------------------------------------------

def abstract_params(cfg: ModelConfig, mesh, rules, mode) -> Any:
    """The parameters as DTensors of fake tensors under `mode`, placed by
    `rules` (each non-divisible dim replicated)."""
    from repro_torch.models import init_params
    with mode:
        params, specs = init_params(cfg, 0, device=mesh.device_type)
        return sharding.distribute(params, specs, mesh, rules)


def abstract_opt_state(opt_cfg, params, mode):
    """The optimizer state of `params` under `mode`: moments and the
    error-feedback residual placed as their parameters are, the step
    counter a plain (replicated) scalar."""
    from repro_torch.optim import init_opt_state
    with mode:
        return init_opt_state(opt_cfg, params)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int, params,
                   mode) -> Any:
    """`init_cache`'s tree of fake (unsharded) tensors under `mode`, built
    from the parameters' global shapes."""
    from repro_torch.models import init_cache
    from repro_torch.models.common import tree_map
    with mode:
        plain = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                               device=p.device), params)
        return init_cache(plain, cfg, batch, max_len)
