"""Shared helpers of the port's parity tests (`tests/test_torch_*.py`).

The same numpy arrays go through the JAX package (the reference, on the
CPU) and through `repro_torch` on the CPU, where every wrapper runs its
plain PyTorch version.  One torch thread per test process, so six xdist
workers do not oversubscribe the CPU.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)

CPU = torch.device("cpu")


def t(a, dtype=torch.float32) -> torch.Tensor:
    """numpy / jax array -> CPU torch tensor (float32 unless told)."""
    return torch.from_numpy(np.array(a)).to(dtype)


def j(a) -> jax.Array:
    """numpy / torch -> jax array, float32 floats."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a)
    return jnp.asarray(a.astype(np.float32) if a.dtype.kind == "f" else a)


def n(a) -> np.ndarray:
    """torch / jax -> numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def spd(rng: np.random.Generator, size: int, batch=()) -> np.ndarray:
    """Well-conditioned SPD matrices, float32."""
    a = rng.standard_normal((*batch, size, size)).astype(np.float32)
    eye = np.eye(size, dtype=np.float32)
    return (a @ np.swapaxes(a, -1, -2) / size + 2.0 * eye).astype(np.float32)


def lower_factor(rng: np.random.Generator, size: int, batch=()) -> np.ndarray:
    return np.linalg.cholesky(spd(rng, size, batch).astype(np.float64)) \
        .astype(np.float32)


def jax_state_leaves(state) -> dict[str, np.ndarray]:
    """A JAX LazyGPState as {tree-path name: numpy leaf}, the names the
    reference checkpoint store writes."""
    from repro.checkpoint.store import _flatten_with_paths
    names, leaves, _ = _flatten_with_paths(state)
    return {k: np.asarray(v) for k, v in zip(names, leaves)}


def seeded_states(rng: np.random.Generator, n0: int, dim: int, n_max: int):
    """The same seeded GP state in both packages: (jax_state, torch_state).

    Built by the reference (append_batch from its empty state, then a full
    refactor), then carried to the port bit for bit through `convert`."""
    from repro.core import gp as jgp
    from repro.core.kernels import matern52 as jmatern52
    from repro_torch import convert
    xs = rng.uniform(size=(n0, dim)).astype(np.float32)
    ys = (np.sin(3.0 * xs.sum(-1)) + 0.1 * xs[:, 0]).astype(np.float32)
    cfg = jgp.GPConfig(n_max=n_max, dim=dim, implementation="xla")
    st = jgp.append_batch(jgp.init_state(cfg), jmatern52, j(xs), j(ys),
                          implementation="xla")
    st = jgp.refactor(st, jmatern52, implementation="xla")
    return st, convert.state_from_numpy(jax_state_leaves(st), device=CPU)
