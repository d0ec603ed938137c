"""Logical-axis sharding rules and activation constraints on DTensor
(counterpart of `repro/launch/sharding.py`).

Parameters and activations carry *logical* axis names ("embed", "heads",
"mlp", "expert", "vocab", "batch", "seq", ...); a rule table maps each name
to mesh axes for a mesh topology, and per-arch overrides handle degenerate
head counts (gemma3 8 heads, xlstm 4) and granite-moe's 40 experts, as the
reference's tables do, entry for entry.

A spec here is a plain tuple with one entry per tensor dim: None, a mesh
axis name, or a tuple of names, equal to the reference's `PartitionSpec`
entry by entry.  `placements` turns it into DTensor placements on a
`DeviceMesh`: a dim mapped to mesh axes is `Shard(dim)` on each of those
mesh dims, in mesh-dim order, so a dim on ("pod", "data") is split pod-major
as JAX's `P(("pod", "data"))` splits it; every dim whose size its mesh-axis
product does not divide is replicated (`param_shardings`' rule, and
`constrain`'s, in the reference).

`constrain(x, axes)` is the in-model activation hook: the identity unless a
rule context is active (`use_rules`) and `x` is a DTensor, so the model
runs unchanged on one device.  Under a context it redistributes `x` to its
rule's placements: a DTensor's layout is what it is, not a hint, so the
hook moves data where GSPMD would only have been told a preference.

Sites where DTensor has no sharding rule for an op (or one that fails),
and the input is redistributed at the call site to a placement it takes:
  * `models/model.py` `lm_loss`: the gold logits are gathered from logits
    replicated over vocab (`replicate_except`): the gather from a
    vocab-sharded dim fails in DTensor's masked partial reduce.
  * `models/model.py` attention (GQA, MLA): the `_Flash` autograd function
    and the banded slices run on each rank's (batch, heads) block of q, k
    and v as local tensors (`heads_local`); attention is independent
    across both, so each block's output and gradients are those of the
    whole.  Heads stay whole where the q and kv head counts do not both
    divide the model axis.
  * `models/model.py` `forward`: the embedding gather runs on local
    tensors, the token ids' own shard from a table replicated over every
    axis (`gather_local`): PyTorch 2.11's DTensor fails on the gather's
    backward (`index_put` with a partial gradient).
  * `models/moe.py`: routing's sort, scatter_add_ and one_hot, the
    `_ScatterRows` / `_GatherRows` autograd functions and the combine run
    on local tensors: each data shard's rows replicated over the other
    axes (the constrained path), or the reference's `shard_map` layout
    (the expert-parallel path).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Mapping, Sequence

import torch

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# Rule tables
# ---------------------------------------------------------------------------

# logical axis -> mesh axis (or tuple of mesh axes, or None)
# "fsdp" rules shard the parameter stationary dim over the data axes too
# (ZeRO-3 style) so optimizer state fits at 33B scale.
BASE_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),        # activations' batch dim
    "seq": None,                     # sequence (sharded only under SP)
    "embed": ("pod", "data"),        # params: FSDP over data axes
    "heads": "model",                # TP over attention heads dim
    "kv_heads": "model",
    "mlp": "model",                  # TP over FFN hidden
    "expert": "model",               # EP over experts
    "capacity": None,                # MoE dispatch-buffer capacity dim
    "vocab": "model",                # TP over vocab (embed + lm head)
    "norm": None,
    "layers": None,
    "layers_none": None,
}

# Sequence-parallel variant: long activations sharded over "model" on seq.
SP_RULES = dict(BASE_RULES, seq="model")

# Archs whose head counts make TP-on-heads wasteful; shard mlp/embed instead
# and keep attention projections FSDP-only.
ARCH_OVERRIDES: dict[str, dict[str, Any]] = {
    "gemma3-4b": {"heads": None, "kv_heads": None},      # 8 q / 4 kv heads
    "xlstm-1.3b": {"heads": None, "kv_heads": None},     # 4 heads
    "zamba2-1.2b": {},                                    # mamba: mlp-sharded
    # 40 experts don't divide the 16-way model axis: shard the dispatch
    # buffer's capacity dim instead (experts replicate; see moe_ffn).
    "granite-moe-3b-a800m": {"expert": None, "capacity": "model"},
}


def axis_names(mesh) -> tuple[str, ...]:
    """The mesh's axis names: a `DeviceMesh`'s dim names, or `axis_names`
    of a shape-only stand-in (an object with `axis_names` and a `shape`
    dict, as the rule tests use)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_size(mesh, name: str) -> int:
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return mesh.size(mesh.mesh_dim_names.index(name))
    return mesh.shape[name]


def rules_for(arch: str | None, mesh, *, seq_parallel: bool = False,
              extra: Mapping[str, Any] | None = None) -> dict[str, Any]:
    rules = dict(SP_RULES if seq_parallel else BASE_RULES)
    if arch and arch in ARCH_OVERRIDES:
        rules.update(ARCH_OVERRIDES[arch])
    if extra:
        rules.update(extra)
    names = axis_names(mesh)

    # Drop mesh axes the mesh doesn't have (single-pod has no "pod").
    def fix(v):
        if v is None:
            return None
        axes = v if isinstance(v, tuple) else (v,)
        kept = tuple(a for a in axes if a in names)
        return kept if len(kept) > 1 else (kept[0] if kept else None)
    return {k: fix(v) for k, v in rules.items()}


# ---------------------------------------------------------------------------
# Context + constrain
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    mesh: Any
    rules: Mapping[str, Any]


_CTX: contextvars.ContextVar[ShardingCtx | None] = contextvars.ContextVar(
    "sharding_ctx", default=None)


@contextlib.contextmanager
def use_rules(mesh, rules: Mapping[str, Any]):
    token = _CTX.set(ShardingCtx(mesh, rules))
    try:
        yield
    finally:
        _CTX.reset(token)


def current() -> ShardingCtx | None:
    """The active rule context, or None."""
    return _CTX.get()


def bound(fn):
    """`fn`, run under the rule context active now wherever it is called
    (`fn` itself without one).  `torch.utils.checkpoint` recomputes a
    layer in the backward, which for CUDA tensors runs on the autograd
    engine's thread, where this thread's context is not set."""
    ctx = _CTX.get()
    if ctx is None:
        return fn

    def run(*args, **kwargs):
        token = _CTX.set(ctx)
        try:
            return fn(*args, **kwargs)
        finally:
            _CTX.reset(token)
    return run


def logical_to_spec(axes: Sequence[Any], rules: Mapping[str, Any]) -> tuple:
    """Logical axes -> spec tuple; a mesh axis is used once (a later logical
    axis that maps to it loses it)."""
    parts, used = [], set()
    for ax in axes:
        if ax is None:
            parts.append(None)
            continue
        mapped = rules.get(ax)
        if mapped is None:
            parts.append(None)
            continue
        flat = mapped if isinstance(mapped, tuple) else (mapped,)
        fresh = tuple(m for m in flat if m not in used)
        used.update(fresh)
        parts.append(fresh if len(fresh) > 1 else (fresh[0] if fresh else None))
    return tuple(parts)


def divisible_spec(spec: Sequence[Any], mesh, shape: Sequence[int]) -> tuple:
    """`spec` with every entry whose mesh-axis product does not divide its
    dim replaced by None (replicated)."""
    parts = []
    for dim, entry in zip(shape, spec):
        if entry is None:
            parts.append(None)
            continue
        size = 1
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            size *= axis_size(mesh, a)
        parts.append(entry if dim % size == 0 else None)
    return tuple(parts)


def placements(spec: Sequence[Any], mesh, shape: Sequence[int]) -> list:
    """DTensor placements of a tensor of `shape` under `spec` on `mesh`: one
    per mesh dim, `Shard(d)` where tensor dim d maps to that mesh axis and
    its size divides, `Replicate()` elsewhere.  A mesh dim of size 1 stays
    `Replicate()`, the same layout: DTensor then issues no collective over
    a group of one rank (gloo on CUDA tensors does not survive one in
    PyTorch 2.11)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(divisible_spec(spec, mesh, shape)):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis "
                             f"order {names}")
        for i in order:
            if axis_size(mesh, names[i]) > 1:
                out[i] = Shard(dim)
    return out


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x: Tensor, axes: Sequence[Any]) -> Tensor:
    """Redistribute `x` to the placements of its logical axes if a rule
    context is active and `x` is a DTensor; dims that do not divide by
    their mesh-axis product are replicated (the reference leaves them
    unconstrained: padded shards forced remat copies in its backward)."""
    ctx = _CTX.get()
    if ctx is None or not is_dtensor(x) or len(axes) != x.ndim:
        return x
    want = placements(logical_to_spec(axes, ctx.rules), ctx.mesh, x.shape)
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(ctx.mesh, want)


def replicate_except(x: Tensor, keep: Sequence[Any]) -> Tensor:
    """`x` (a DTensor under a context) with only the logical axes `keep`
    sharded, every other dim replicated, for an op DTensor has no rule for
    on a sharded dim; anything else unchanged."""
    return constrain(x, tuple(keep) + (None,) * (x.ndim - len(keep))) \
        if len(keep) <= x.ndim else x


def heads_local(fn, q: Tensor, k: Tensor, v: Tensor, *,
                kv_axis: str = "kv_heads") -> Tensor:
    """`fn(q, k, v)` -> (B, S, H, dv) attention, under a context on each
    rank's local (batch, heads) block: q (B, S, H, d), k and v (B, S, KV,
    d) with their batch over the data axes, their heads over the model
    axis where both head counts divide it (`kv_axis` names k's heads:
    "heads" for MLA's materialized keys), the sequence whole.  The
    output's blocks go back as a DTensor of q's layout.  Without a context
    or on plain tensors, `fn(q, k, v)`."""
    ctx = _CTX.get()
    if ctx is None or not is_dtensor(q):
        return fn(q, k, v)
    from torch.distributed.tensor import DTensor
    mesh, rules = ctx.mesh, ctx.rules
    sq = divisible_spec(logical_to_spec(("batch", None, "heads", None),
                                        rules), mesh, q.shape)
    sk = divisible_spec(logical_to_spec(("batch", None, kv_axis, None),
                                        rules), mesh, k.shape)
    if sq[2] != sk[2]:
        sq, sk = sq[:2] + (None, None), sk[:2] + (None, None)
    pq, pk = placements(sq, mesh, q.shape), placements(sk, mesh, k.shape)
    ql, kl, vl = (t.redistribute(mesh, p).to_local(grad_placements=p)
                  for t, p in ((q, pq), (k, pk), (v, pk)))
    return DTensor.from_local(fn(ql, kl, vl), mesh, pq, run_check=False)


def gather_local(table: Tensor, ids: Tensor) -> Tensor:
    """`table[ids]`; under a context with DTensor ids, on each rank's ids
    from the table replicated over every mesh axis, the rows going back
    as a DTensor of the ids' layout.  The table's gradient is partial over
    the mesh dims that shard the ids."""
    if _CTX.get() is None or not is_dtensor(ids):
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate
    place = list(ids.placements)
    local = replicated(table).to_local(grad_placements=[
        Replicate() if p.is_replicate() else Partial() for p in place])
    return DTensor.from_local(local[ids.to_local()], ids.device_mesh, place,
                              run_check=False)


def replicated(x: Tensor) -> Tensor:
    """A DTensor replicated over every mesh dim (the identity on a plain
    tensor)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    want = [Replicate()] * x.device_mesh.ndim
    return x if list(x.placements) == want else x.redistribute(
        x.device_mesh, want)


# ---------------------------------------------------------------------------
# Parameter trees (nested dicts; a spec leaf is a tuple of logical axes)
# ---------------------------------------------------------------------------

def map_specs(fn, specs, *trees):
    """`fn(spec, *leaves)` over a spec tree and the trees that mirror it."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, specs[k], *(t[k] for t in trees))
                for k in specs}
    return fn(specs, *trees)


def distribute(tree, specs, mesh, rules: Mapping[str, Any]):
    """A tree of full tensors, the same values on every rank -> DTensors
    placed by the rules; each rank keeps a copy of its own shards (no
    collective), so the full tensors can be freed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def put(ax, x):
        place = placements(logical_to_spec(ax, rules), mesh, x.shape)
        d = distribute_tensor(x, mesh, place, src_data_rank=None)
        if all(p.is_replicate() for p in place):
            return d
        return DTensor.from_local(d.to_local().clone(), mesh, place,
                                  run_check=False, shape=d.shape,
                                  stride=d.stride())
    return map_specs(put, specs, tree)


def full(tree):
    """A tree of DTensors -> full tensors on every rank (plain tensors pass
    through)."""
    from repro_torch.models.common import tree_map
    return tree_map(lambda x: x.full_tensor() if is_dtensor(x) else x, tree)
