"""The port's checkpoint store (`repro_torch.checkpoint`) against the
reference's contract: atomic saves, COMMITTED-less steps skipped, keep-N
garbage collection, the name and shape errors, bit-pattern dtypes, the
per-study directories, the staging-directory sweep's age guard, and trees
that each package restores from the other's files bit for bit."""
import os
import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint import store


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"b": {"w": torch.from_numpy(rng.standard_normal((3, 4))
                                        .astype(np.float32)),
                  "n": torch.tensor([2, 5], dtype=torch.int32)},
            "a": [np.arange(3, dtype=np.int64), (np.float32(1.5),)],
            "z": None}


def _equal(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b)) and \
        np.asarray(a).dtype == np.asarray(b).dtype


def test_flatten_names_follow_jax_tree_paths():
    names, leaves, rebuild = store._flatten_with_paths(_tree())
    assert names == ["a/0", "a/1/0", "b/n", "b/w"]
    back = rebuild(leaves)
    assert back["z"] is None and isinstance(back["a"][1], tuple)
    from repro.checkpoint.store import _flatten_with_paths as jflat
    jtree = {"b": {"w": np.zeros((3, 4)), "n": np.zeros(2)},
             "a": [np.zeros(3), (np.zeros(()),)], "z": None}
    assert jflat(jtree)[0] == names


def test_save_restore_roundtrip_and_metadata(tmp_path):
    d = str(tmp_path)
    tree = _tree()
    path = ckpt.save(d, 7, tree, metadata={"k": [1, 2]})
    assert os.path.exists(os.path.join(path, "COMMITTED"))
    assert sorted(os.listdir(path)) == ["COMMITTED", "arrays-0.npz",
                                        "manifest.json"]
    step, back, meta = ckpt.restore_latest(d, _tree(1))
    assert step == 7 and meta == {"k": [1, 2]}
    assert torch.equal(back["b"]["w"], tree["b"]["w"])
    assert back["b"]["n"].dtype == torch.int32
    assert _equal(back["a"][0], tree["a"][0])
    assert _equal(back["a"][1][0], np.asarray(tree["a"][1][0]))


def test_uncommitted_step_is_skipped_and_collected(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, _tree())
    os.makedirs(os.path.join(d, "step_000000002"))   # crash mid-save
    assert ckpt.latest_step(d) == 1
    assert ckpt.committed_steps(d) == [1]
    ckpt.save(d, 3, _tree())
    assert not os.path.exists(os.path.join(d, "step_000000002"))


def test_failed_save_leaves_no_debris(tmp_path, monkeypatch):
    d = str(tmp_path)
    ckpt.save(d, 1, _tree())

    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(store.np, "savez", boom)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save(d, 2, _tree())
    monkeypatch.undo()
    assert ckpt.latest_step(d) == 1
    assert not [f for f in os.listdir(d) if f.startswith(".tmp_ckpt_")]


def test_keep_gc(tmp_path):
    d = str(tmp_path)
    for s in range(5):
        ckpt.save(d, s, _tree(), keep=2)
    assert ckpt.committed_steps(d) == [3, 4]


def test_name_and_shape_errors(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 0, {"x": np.zeros((2, 3), np.float32)})
    with pytest.raises(ValueError, match="tree mismatch"):
        ckpt.restore(d, 0, {"y": np.zeros((2, 3), np.float32)})
    with pytest.raises(ValueError, match="shape mismatch at x"):
        ckpt.restore(d, 0, {"x": torch.zeros((2, 4))})


@pytest.mark.parametrize("dtype", ["bfloat16", "float8_e4m3fn",
                                   "float8_e5m2"])
def test_bit_pattern_dtypes_roundtrip(tmp_path, dtype):
    d = str(tmp_path)
    tdt = getattr(torch, dtype)
    x = torch.tensor([1.5, -0.25, 3.0, 0.0]).to(tdt)
    ckpt.save(d, 0, {"x": x})
    back, _ = ckpt.restore(d, 0, {"x": torch.zeros(4, dtype=tdt)})
    assert back["x"].dtype == tdt
    assert torch.equal(back["x"].view(torch.uint8), x.view(torch.uint8))
    # the reference reads the same file with its ml_dtypes
    jback, _ = jckpt.restore(d, 0, {"x": jnp.zeros(4, getattr(ml_dtypes,
                                                              dtype))})
    assert np.asarray(jback["x"]).tobytes() == x.view(torch.uint8) \
        .numpy().tobytes()


def test_study_directories(tmp_path):
    d, other = str(tmp_path / "a"), str(tmp_path / "b")
    with pytest.raises(ValueError):
        ckpt.study_dir(d, "../x")
    for v in (1, 2, 3):
        ckpt.save_study(d, "s1", v, {"x": np.full(2, v, np.float32)},
                        metadata={"v": v})
    ckpt.save_study(d, "s2", 5, {"x": np.zeros(2, np.float32)})
    assert ckpt.study_versions(d, "s1") == [1, 2, 3]
    assert ckpt.list_studies(d) == ["s1", "s2"]
    v, tree, meta = ckpt.restore_study(d, "s1", {"x": np.zeros(2,
                                                              np.float32)})
    assert v == 3 and meta == {"v": 3} and tree["x"][0] == 3
    v, tree, _ = ckpt.restore_study(d, "s1", {"x": np.zeros(2, np.float32)},
                                    version=2)
    assert v == 2 and tree["x"][0] == 2
    assert ckpt.restore_study(d, "s1", {"x": np.zeros(2)}, version=9) is None
    ckpt.copy_study_version(d, other, "s1", 2)
    assert ckpt.study_versions(other, "s1") == [2]
    assert ckpt.copy_study_version(d, other, "s1", 2).endswith(
        "step_000000002")
    with pytest.raises(FileNotFoundError):
        ckpt.copy_study_version(d, other, "s1", 7)
    ckpt.prune_studies(d, {"s1": 3})
    assert ckpt.study_versions(d, "s1") == [3]
    ckpt.drop_studies(d, ["s2"])
    assert ckpt.list_studies(d) == ["s1"]
    # a pool-level save never collects the per-study versions
    for s in range(4):
        ckpt.save(d, s, {"x": np.zeros(1)}, keep=1)
    assert ckpt.study_versions(d, "s1") == [3]


def test_sweep_tmp_age_guard(tmp_path, monkeypatch):
    d = str(tmp_path)
    stale_a = os.path.join(d, ".tmp_ckpt_dead0")
    stale_b = os.path.join(d, ".tmp_migrate_dead1")
    fresh = os.path.join(d, ".tmp_ckpt_inflight")
    for p in (stale_a, stale_b, fresh):
        os.makedirs(p)
        with open(os.path.join(p, "arrays.npz"), "wb") as f:
            f.write(b"partial")
    old = time.time() - 7200.0           # default TTL is 3600 s
    for p in (stale_a, stale_b):
        os.utime(p, (old, old))
    assert sorted(ckpt.sweep_tmp(d)) == sorted([stale_a, stale_b])
    assert os.path.isdir(fresh), "swept a concurrent writer's staging dir"
    stale_c = os.path.join(d, ".tmp_migrate_dead2")
    os.makedirs(stale_c)
    os.utime(stale_c, (old, old))
    ckpt.save(d, 1, {"x": np.zeros(2)})
    assert not os.path.exists(stale_c), "_gc skipped stale staging debris"
    assert os.path.isdir(fresh)
    # the override: a TTL below the fresh directory's age sweeps it too
    monkeypatch.setenv("REPRO_CKPT_TMP_TTL", "-1")
    assert ckpt.sweep_tmp(d) == [fresh]


def test_port_save_restores_through_the_reference(tmp_path):
    d = str(tmp_path)
    rng = np.random.default_rng(3)
    tree = {"x_buf": torch.from_numpy(rng.standard_normal((2, 5, 3))
                                      .astype(np.float32)),
            "n": torch.tensor([4, 1], dtype=torch.int32),
            "params": {"rho": torch.tensor([0.25, 0.1])}}
    ckpt.save(d, 4, tree, metadata={"m": "x"})
    like = {"x_buf": jnp.zeros((2, 5, 3), jnp.float32),
            "n": jnp.zeros(2, jnp.int32),
            "params": {"rho": jnp.zeros(2, jnp.float32)}}
    step, back, meta = jckpt.restore_latest(d, like)
    assert step == 4 and meta == {"m": "x"}
    for k in ("x_buf", "n"):
        assert np.asarray(back[k]).tobytes() == tree[k].numpy().tobytes()
    assert np.asarray(back["params"]["rho"]).tobytes() == \
        tree["params"]["rho"].numpy().tobytes()


def test_reference_save_restores_through_the_port(tmp_path):
    d = str(tmp_path)
    rng = np.random.default_rng(4)
    jtree = {"l_buf": jnp.asarray(rng.standard_normal((3, 4, 4))
                                  .astype(np.float32)),
             "clamp_count": jnp.asarray([0, 2, 1], jnp.int32),
             "params": {"sigma2": jnp.asarray([1.0, 0.5, 2.0], jnp.float32)}}
    jckpt.save(d, 9, jtree, metadata={"n_studies": 3})
    like = {"l_buf": torch.zeros((3, 4, 4)),
            "clamp_count": torch.zeros(3, dtype=torch.int32),
            "params": {"sigma2": torch.zeros(3)}}
    step, back, meta = ckpt.restore_latest(d, like)
    assert step == 9 and meta == {"n_studies": 3}
    assert back["clamp_count"].dtype == torch.int32
    for got, want in ((back["l_buf"], jtree["l_buf"]),
                      (back["clamp_count"], jtree["clamp_count"]),
                      (back["params"]["sigma2"], jtree["params"]["sigma2"])):
        assert got.numpy().tobytes() == np.asarray(want).tobytes()
