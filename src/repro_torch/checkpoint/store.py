"""Checkpointing: atomic, shard-friendly save / restore for fault tolerance
(counterpart of `repro/checkpoint/store.py`, the same on-disk format).

Layout (one directory per step):
    ckpt_dir/
      step_000000123/
        manifest.json        # leaf names, dtypes, count, shard, metadata
        arrays-{shard}.npz   # the flattened leaves, keys a0 .. ak
        COMMITTED            # atomicity marker, written last

Restart semantics:
  * `latest_step` ignores directories without COMMITTED (a crash mid-save
    leaves a garbage directory that is skipped and later collected);
  * a save stages into a `.tmp_ckpt_*` directory and publishes it with one
    atomic rename, so a reader never sees half a step.

Trees are nested dicts (keys sorted, as JAX sorts them), lists and tuples
(by index), with tensors, numpy arrays or scalars as leaves; a leaf is
named by its path joined with "/".  A `dataclasses.asdict`-shaped GP state
thus gets the names the reference writes, so either package restores the
other's checkpoints.  bfloat16 and float8 leaves are stored as their bit
pattern (npz cannot hold them) and read back with torch's own dtypes.  A
restored leaf is a CPU tensor where the `like` leaf is a tensor, else a
numpy array.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Any

import numpy as np
import torch

Tree = Any

_COMMIT = "COMMITTED"

# Writers stage into `.tmp_ckpt_*` (save) / `.tmp_migrate_*`
# (copy_study_version) directories that an atomic rename publishes; a
# killed writer leaves its staging directory behind.  `sweep_tmp` reclaims
# that debris with an age guard: another process may be writing into the
# same store right now, and its fresh staging directory (every file write
# bumps the directory's mtime) must never be swept from under it.  One hour
# by default; REPRO_CKPT_TMP_TTL overrides it (seconds).
_TMP_PREFIXES = (".tmp_ckpt_", ".tmp_migrate_")
_TMP_TTL_S = 3600.0

# Dtypes npz cannot hold, stored as their bit pattern: name -> torch dtype.
_BIT_DTYPES = {"bfloat16": torch.bfloat16,
               "float8_e4m3fn": torch.float8_e4m3fn,
               "float8_e5m2": torch.float8_e5m2}


def _tmp_ttl() -> float:
    return float(os.environ.get("REPRO_CKPT_TMP_TTL", _TMP_TTL_S))


def sweep_tmp(ckpt_dir: str, ttl_s: float | None = None) -> list[str]:
    """Remove stale staging directories directly under `ckpt_dir`.

    Only directories older than `ttl_s` (mtime) go; a concurrent writer
    keeps its in-flight one.  Returns the swept paths."""
    ttl = _tmp_ttl() if ttl_s is None else ttl_s
    if not os.path.isdir(ckpt_dir):
        return []
    now = time.time()
    swept = []
    for d in os.listdir(ckpt_dir):
        if not d.startswith(_TMP_PREFIXES):
            continue
        p = os.path.join(ckpt_dir, d)
        try:
            age = now - os.path.getmtime(p)
        except OSError:
            continue  # the owning writer just published or removed it
        if age > ttl:
            shutil.rmtree(p, ignore_errors=True)
            swept.append(p)
    return swept


def _flatten_with_paths(tree: Tree):
    """(names, leaves, rebuild): the leaves in JAX's order (dict keys
    sorted, sequences by index), each named by its path joined with "/",
    and `rebuild(leaves)`, which puts new leaves back into the structure.
    None is an empty subtree, as in JAX."""
    names, leaves = [], []

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(node[k], path + (str(k),)) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            out = [walk(v, path + (str(i),)) for i, v in enumerate(node)]
            return out if isinstance(node, list) else tuple(out)
        if node is None:
            return None
        names.append("/".join(path))
        leaves.append(node)
        return len(leaves) - 1

    skeleton = walk(tree, ())

    def rebuild(new_leaves):
        def fill(node, orig):
            if isinstance(orig, dict):
                return {k: fill(node[k], orig[k]) for k in orig}
            if isinstance(orig, (list, tuple)):
                out = [fill(n, o) for n, o in zip(node, orig)]
                return out if isinstance(orig, list) else tuple(out)
            return None if orig is None else new_leaves[node]
        return fill(skeleton, tree)

    return names, leaves, rebuild


def _to_numpy(x) -> tuple[np.ndarray, str]:
    """A leaf as a numpy array (bit dtypes as their bit pattern) and the
    dtype name the manifest records."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        for name, dt in _BIT_DTYPES.items():
            if x.dtype == dt:
                bits = torch.int16 if dt.itemsize == 2 else torch.uint8
                arr = x.contiguous().view(bits).numpy()
                return (arr.view(np.uint16) if dt.itemsize == 2 else arr), name
        arr = x.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(x)
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree: Tree,
         metadata: dict | None = None, shard_id: int = 0,
         keep: int = 3) -> str:
    """Atomically save `tree` at `step`; returns the checkpoint path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=ckpt_dir)
    try:
        names, leaves, _ = _flatten_with_paths(tree)
        arrays, dtypes = {}, []
        for i, x in enumerate(leaves):
            arr, dtype = _to_numpy(x)
            dtypes.append(dtype)
            arrays[f"a{i}"] = arr
        np.savez(os.path.join(tmp, f"arrays-{shard_id}.npz"), **arrays)
        manifest = {
            "step": step,
            "names": names,
            "dtypes": dtypes,
            "num_leaves": len(leaves),
            "shard_id": shard_id,
            "metadata": metadata or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, _COMMIT), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = committed_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:09d}"),
                      ignore_errors=True)
    # uncommitted debris
    for d in os.listdir(ckpt_dir):
        p = os.path.join(ckpt_dir, d)
        if d.startswith("step_") and not os.path.exists(
                os.path.join(p, _COMMIT)):
            shutil.rmtree(p, ignore_errors=True)
    # ... and the staging directories of killed writers (age-guarded)
    sweep_tmp(ckpt_dir)


def committed_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, d, _COMMIT)):
            out.append(int(d[len("step_"):]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def _leaf_like(arr: np.ndarray, saved_dtype: str, ref):
    """A stored array as a leaf of `ref`'s kind: a CPU tensor of ref's
    dtype for a tensor, else a numpy array of ref's dtype (where it has
    one).  Bit-pattern dtypes come back as torch tensors."""
    if saved_dtype in _BIT_DTYPES:
        bits = torch.int16 if arr.dtype.itemsize == 2 else torch.uint8
        t = torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16 if arr.dtype.itemsize == 2 else np.uint8)).view(bits)
        t = t.view(_BIT_DTYPES[saved_dtype])
        if isinstance(ref, torch.Tensor):
            return t if ref.dtype == t.dtype else t.to(ref.dtype)
        return t.float().numpy().astype(np.asarray(ref).dtype)
    if isinstance(ref, torch.Tensor):
        t = torch.from_numpy(np.array(arr))
        return t if t.dtype == ref.dtype else t.to(ref.dtype)
    if hasattr(ref, "dtype") and arr.dtype != ref.dtype:
        return arr.astype(ref.dtype)
    return arr


def restore(ckpt_dir: str, step: int, like: Tree,
            shard_id: int = 0) -> tuple[Tree, dict]:
    """Restore into the structure of `like`; returns (tree, metadata).
    Only the names, shapes and dtypes of `like`'s leaves are read."""
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, f"arrays-{shard_id}.npz"))
    names, leaves, rebuild = _flatten_with_paths(like)
    if names != manifest["names"]:
        raise ValueError(
            "checkpoint tree mismatch: "
            f"{set(manifest['names']) ^ set(names)}")
    new_leaves = []
    for i, ref in enumerate(leaves):
        arr = data[f"a{i}"]
        want = tuple(ref.shape) if hasattr(ref, "shape") \
            else tuple(np.shape(ref))
        if tuple(arr.shape) != want:
            # names alone miss a resized buffer (a pool rebuilt with another
            # n_max): restoring it would misplace every later append
            raise ValueError(
                f"checkpoint shape mismatch at {names[i]}: saved "
                f"{tuple(arr.shape)}, expected {want} "
                "(was the state rebuilt with a different n_max, dim, or "
                "number of studies?)")
        new_leaves.append(_leaf_like(arr, manifest["dtypes"][i], ref))
    return rebuild(new_leaves), manifest["metadata"]


def restore_latest(ckpt_dir: str, like: Tree,
                   shard_id: int = 0) -> tuple[int, Tree, dict] | None:
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    tree, meta = restore(ckpt_dir, step, like, shard_id)
    return step, tree, meta


# ---------------------------------------------------------------------------
# Per-study snapshots (the gateway's eviction store, DESIGN.md §9): each
# study gets its own step-versioned directory under `ckpt_dir/studies/<study>/`
# with the same atomic protocol, so they sit beside whole-pool `step_*`
# snapshots in one root; the pool-level gc touches only `step_*` entries.
# ---------------------------------------------------------------------------

def study_dir(ckpt_dir: str, study: str) -> str:
    if "/" in study or study.startswith("."):
        raise ValueError(f"bad study key {study!r}")
    return os.path.join(ckpt_dir, "studies", study)


def save_study(ckpt_dir: str, study: str, version: int, tree: Tree,
               metadata: dict | None = None) -> str:
    """Atomically snapshot one study at `version` (monotonic per study).

    No garbage collection here: a whole-pool snapshot's registry names
    exact versions, so versions are pruned only once a newer pool snapshot
    commits (`prune_studies`)."""
    return save(study_dir(ckpt_dir, study), version, tree,
                metadata=metadata, keep=10 ** 9)


def restore_study(ckpt_dir: str, study: str, like: Tree,
                  version: int | None = None
                  ) -> tuple[int, Tree, dict] | None:
    """One study's committed snapshot: exact `version`, or latest if None.
    Crash recovery passes the version its registry recorded."""
    d = study_dir(ckpt_dir, study)
    if version is None:
        return restore_latest(d, like)
    if version not in committed_steps(d):
        return None
    tree, meta = restore(d, version, like)
    return version, tree, meta


def study_versions(ckpt_dir: str, study: str) -> list[int]:
    """Committed snapshot versions of one study (empty if none)."""
    return committed_steps(study_dir(ckpt_dir, study))


def copy_study_version(src_dir: str, dst_dir: str, study: str,
                       version: int) -> str:
    """Copy one committed study snapshot between checkpoint stores (study
    migration between shards, DESIGN.md §13), all or nothing: files land
    in a staging directory, COMMITTED last, then an atomic rename.  A
    fault mid-copy leaves the destination without the version and never
    touches the source."""
    src = os.path.join(study_dir(src_dir, study), f"step_{version:09d}")
    if not os.path.exists(os.path.join(src, _COMMIT)):
        raise FileNotFoundError(
            f"study {study!r} version {version} is not committed under "
            f"{src_dir}")
    dst_root = study_dir(dst_dir, study)
    os.makedirs(dst_root, exist_ok=True)
    # a killed copier leaves its `.tmp_migrate_*` directory here; the retry
    # is where it is swept
    sweep_tmp(dst_root)
    final = os.path.join(dst_root, f"step_{version:09d}")
    if os.path.exists(os.path.join(final, _COMMIT)):
        return final  # a retried migration finds it already published
    tmp = tempfile.mkdtemp(prefix=".tmp_migrate_", dir=dst_root)
    try:
        for name in os.listdir(src):
            if name != _COMMIT:
                shutil.copy2(os.path.join(src, name),
                             os.path.join(tmp, name))
        with open(os.path.join(tmp, _COMMIT), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)  # uncommitted debris of an earlier crash
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def prune_studies(ckpt_dir: str, keep_from: dict[str, int]) -> None:
    """Drop per-study versions below each study's floor (after a
    whole-pool snapshot that references `keep_from[study]` commits)."""
    for study, floor in keep_from.items():
        d = study_dir(ckpt_dir, study)
        for s in committed_steps(d):
            if s < floor:
                shutil.rmtree(os.path.join(d, f"step_{s:09d}"),
                              ignore_errors=True)


def drop_studies(ckpt_dir: str, studies: list[str]) -> None:
    """Delete whole per-study snapshot directories (closed tenants), after
    a whole-pool snapshot that no longer references them has committed."""
    for study in studies:
        shutil.rmtree(study_dir(ckpt_dir, study), ignore_errors=True)


def list_studies(ckpt_dir: str) -> list[str]:
    root = os.path.join(ckpt_dir, "studies")
    if not os.path.isdir(root):
        return []
    return sorted(d for d in os.listdir(root)
                  if committed_steps(os.path.join(root, d)))
