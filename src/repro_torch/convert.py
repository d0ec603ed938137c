"""Carry a `LazyGPState`, a `TypeDescriptor` and a `NeuralBasisState`
between the two packages as numpy arrays.

The keys are the tree-path names under which the reference's checkpoint
store writes a `LazyGPState` (`repro/checkpoint/store.py`,
`_flatten_with_paths`) or a `TypeDescriptor`, so a port checkpoint can
later use the same names.  The GP state and its kernel params are what
weights are to a model.  A stacked state (a study engine's, DESIGN.md §7)
and a stacked descriptor go under the same names with a leading S on
every leaf; the stacked state's `n` and `since_refit` then stay (S,)
int32 tensors on the device.  A `NeuralBasisState` goes under its field
names (the keys of the reference's `nb_to_json`): float32 leaves and 0-d
int32 counters, each the shape the reference holds.  A pool
checkpoint's tree (`POOL_KEYS`, `pool_tree_*`) is the stacked state under
the names the reference's `StudyPool.checkpoint` writes
(`dataclasses.asdict` of the state: no leading dots).  A language model's
parameter tree (`lm_params_*`) and its `OptState` (`opt_state_*`) go under
the names the reference's store writes for `launch/train.py`'s checkpoint:
paths joined with "/" (`blocks/attn/wq`, `mu/embed`, `step`).  A decode
cache (`lm_cache_*`) goes under the tree paths of the reference's
`init_cache` (`k`, `mamba/ssm`, `pos`, ...).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint.store import _flatten_with_paths
from repro_torch.core.descriptor import TypeDescriptor
from repro_torch.core.gp import LazyGPState, resolve_device
from repro_torch.core.kernels import KernelParams
from repro_torch.core.neural_basis import COUNTERS as NB_COUNTERS
from repro_torch.core.neural_basis import FIELDS as NB_KEYS
from repro_torch.core.neural_basis import NeuralBasisState
from repro_torch.optim.optimizers import OptState

BUFFERS = (".x_buf", ".y_buf", ".l_buf", ".li_buf", ".alpha")
COUNTERS = (".n", ".since_refit")
PARAMS = (".params/.sigma2", ".params/.rho", ".params/.noise2")
KEYS = BUFFERS + COUNTERS + (".clamp_count",) + PARAMS
DESC_FLOATS = (".cont_mask", ".cat_mask", ".levels")
DESC_INDICES = (".group", ".parent")
DESC_KEYS = DESC_FLOATS + DESC_INDICES


def state_to_numpy(state: LazyGPState) -> dict[str, np.ndarray]:
    """Every leaf as a numpy array under its reference tree-path name
    (float32 buffers and params, int32 counters: 0-d, or (S,) for a
    stacked state)."""
    out = {k: state_leaf.detach().cpu().numpy() for k, state_leaf in zip(
        BUFFERS, (state.x_buf, state.y_buf, state.l_buf, state.li_buf,
                  state.alpha))}
    for k, v in zip(COUNTERS, (state.n, state.since_refit)):
        out[k] = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v)).astype(np.int32)
    out[".clamp_count"] = state.clamp_count.detach().cpu().numpy() \
        .astype(np.int32)
    for k, v in zip(PARAMS, (state.params.sigma2, state.params.rho,
                             state.params.noise2)):
        out[k] = torch.as_tensor(v).detach().cpu().numpy().astype(np.float32)
    return out


def state_from_numpy(leaves: dict[str, np.ndarray],
                     device: str | torch.device = "cuda") -> LazyGPState:
    """A port state on `device` from reference tree-path leaves: a
    single-study state (host counters) for 0-d counters, a stacked state
    ((S,) int32 counters on the device) for (S,) ones."""
    missing = [k for k in KEYS if k not in leaves]
    if missing:
        raise KeyError(f"state leaves missing: {missing}")
    dev = resolve_device(device)

    def t(k):
        return torch.as_tensor(np.array(leaves[k]), device=dev)

    def counter(k):
        v = np.asarray(leaves[k])
        return t(k).to(torch.int32) if v.ndim else int(v)

    return LazyGPState(
        x_buf=t(".x_buf"), y_buf=t(".y_buf"), l_buf=t(".l_buf"),
        li_buf=t(".li_buf"), alpha=t(".alpha"),
        n=counter(".n"), since_refit=counter(".since_refit"),
        clamp_count=t(".clamp_count").to(torch.int32),
        params=KernelParams(*(t(k) for k in PARAMS)))


def descriptor_to_numpy(desc: TypeDescriptor) -> dict[str, np.ndarray]:
    """The descriptor's fields under their reference leaf names (float32
    masks and levels, int32 group and parent ids, as the reference keeps
    them)."""
    out = {k: getattr(desc, k[1:]).detach().cpu().numpy().astype(np.float32)
           for k in DESC_FLOATS}
    out.update({k: getattr(desc, k[1:]).detach().cpu().numpy()
                .astype(np.int32) for k in DESC_INDICES})
    return out


def descriptor_from_numpy(leaves: dict[str, np.ndarray],
                          device: str | torch.device = "cuda"
                          ) -> TypeDescriptor:
    """A port descriptor on `device` from reference leaves (group and
    parent become int64, the port's index type)."""
    missing = [k for k in DESC_KEYS if k not in leaves]
    if missing:
        raise KeyError(f"descriptor leaves missing: {missing}")
    dev = resolve_device(device)
    fields = {k[1:]: torch.as_tensor(np.array(leaves[k], np.float32),
                                     device=dev) for k in DESC_FLOATS}
    fields.update({k[1:]: torch.as_tensor(np.array(leaves[k], np.int64),
                                          device=dev) for k in DESC_INDICES})
    return TypeDescriptor(**fields)


def nb_state_to_numpy(state: NeuralBasisState) -> dict[str, np.ndarray]:
    """Every leaf of a neural-basis state as a numpy array under its field
    name (float32, the counters 0-d int32)."""
    return {k: getattr(state, k).detach().cpu().numpy() for k in NB_KEYS}


def nb_state_from_numpy(leaves: dict[str, np.ndarray],
                        device: str | torch.device = "cuda"
                        ) -> NeuralBasisState:
    """A port neural-basis state on `device` from field-name leaves (the
    reference's state as numpy arrays), each leaf's bits kept."""
    missing = [k for k in NB_KEYS if k not in leaves]
    if missing:
        raise KeyError(f"neural-basis leaves missing: {missing}")
    dev = resolve_device(device)
    out = {}
    for k in NB_KEYS:
        a = np.array(leaves[k], np.int32 if k in NB_COUNTERS else np.float32)
        out[k] = torch.from_numpy(a).to(dev)
    return NeuralBasisState(**out)


# The leaves of a pool checkpoint's GP tree, in the order the reference's
# store writes them (its flatten sorts dict keys).
POOL_KEYS = ("alpha", "clamp_count", "l_buf", "li_buf", "n", "params/noise2",
             "params/rho", "params/sigma2", "since_refit", "x_buf", "y_buf")


def pool_tree_to_numpy(state: LazyGPState) -> dict[str, np.ndarray]:
    """A stacked state as a pool checkpoint's leaves: numpy arrays under
    `POOL_KEYS`, each with the leading S (float32 buffers and params,
    int32 counters)."""
    leaves = state_to_numpy(state)
    return {k: leaves["." + k.replace("/", "/.")] for k in POOL_KEYS}


def pool_tree_from_numpy(leaves: dict[str, np.ndarray],
                         device: str | torch.device = "cuda") -> LazyGPState:
    """A stacked port state on `device` from a pool checkpoint's leaves
    (`POOL_KEYS`, each with the leading S), bits kept."""
    missing = [k for k in POOL_KEYS if k not in leaves]
    if missing:
        raise KeyError(f"pool checkpoint leaves missing: {missing}")
    return state_from_numpy({"." + k.replace("/", "/."): leaves[k]
                             for k in POOL_KEYS}, device)


def _unflatten(leaves: dict) -> dict:
    """The tree of dicts whose `_flatten_with_paths` names are `leaves`."""
    tree: dict = {}
    for name, v in leaves.items():
        *path, last = name.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def lm_params_to_numpy(params: dict) -> dict[str, np.ndarray]:
    """A model's parameter tree as numpy arrays under the reference's tree
    paths (`blocks/attn/wq`, `embed`, ...), bits kept."""
    names, leaves, _ = _flatten_with_paths(params)
    return {k: v.detach().cpu().numpy() for k, v in zip(names, leaves)}


def lm_params_from_numpy(leaves: dict[str, np.ndarray],
                         device: str | torch.device = "cuda") -> dict:
    """A model's parameter tree on `device` from tree-path leaves (the
    reference's params, flattened), bits kept."""
    dev = resolve_device(device)
    return _unflatten({k: torch.from_numpy(np.array(v)).to(dev)
                       for k, v in leaves.items()})


def opt_state_to_numpy(state: OptState) -> dict[str, np.ndarray]:
    """An `OptState` under the reference's names (`step`, `mu/...`,
    `nu/...`, `ef_residual/...`; a None moment has no leaves)."""
    return lm_params_to_numpy(state._asdict())


def opt_state_from_numpy(leaves: dict[str, np.ndarray],
                         device: str | torch.device = "cuda") -> OptState:
    """An `OptState` on `device` from the reference's names; `step` becomes
    the 0-d int32 counter, a moment without leaves None."""
    if "step" not in leaves:
        raise KeyError("optimizer state leaves missing: ['step']")
    tree = lm_params_from_numpy(leaves, device)
    tree["step"] = tree["step"].to(torch.int32)
    return OptState(**{k: tree.get(k) for k in OptState._fields})


# The decode cache's float32 leaves (the recurrent carries); every other
# float leaf is in the activation dtype.
CACHE_FLOAT32 = ("mamba/ssm", "mlstm/c", "mlstm/n", "mlstm/m")


def lm_cache_to_numpy(cache: dict) -> dict[str, np.ndarray]:
    """A decode cache as numpy arrays under the reference's tree paths;
    `pos` a 0-d int32 array.  Copies, never views: a decode step writes
    the cache in place.  bfloat16 leaves widen to float32 (numpy has no
    bfloat16), exactly."""
    names, leaves, _ = _flatten_with_paths(
        {k: v for k, v in cache.items() if k != "pos"})
    out = {k: v.detach().to("cpu", torch.float32 if v.dtype == torch.bfloat16
                            else v.dtype, copy=True).numpy()
           for k, v in zip(names, leaves)}
    out["pos"] = np.asarray(cache["pos"], np.int32)
    return out


def lm_cache_from_numpy(leaves: dict[str, np.ndarray], cfg,
                        device: str | torch.device = "cuda") -> dict:
    """A decode cache for `cfg` on `device` from tree-path leaves: the
    reference's cache (its bfloat16 arrays included) or
    `lm_cache_to_numpy`'s.  Each leaf takes the cache's dtype (the
    activation dtype, float32 for `CACHE_FLOAT32`), bits kept; `pos`
    becomes a Python int."""
    dev = resolve_device(device)
    tree = {}
    for k, v in leaves.items():
        if k == "pos":
            tree[k] = int(np.asarray(v))
            continue
        dtype = torch.float32 if k in CACHE_FLOAT32 \
            else cfg.activation_dtype
        tree[k] = torch.from_numpy(np.asarray(v).astype(np.float32)).to(
            device=dev, dtype=dtype)
    return _unflatten(tree)
