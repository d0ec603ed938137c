"""The port's dry run (`repro_torch/launch/dryrun.py`) on the reference's
shrunk production meshes (tests/test_launch.py:93-131: 2x4 for 16x16,
2x2x2 for 2x16x16) with that test's reduced granite-3-2b: the train cell
on the single-pod mesh and the decode cell are `ok` with peak memory,
flops and collective link bytes above 0; and the collective census gives
known counts and bytes on a hand-built DTensor program.  The multi-pod
train cell is in tests/test_torch_launch_dryrun_multi.py.

The cells run without sequence parallelism: under it DTensor splits a
matmul's flattened (batch x sequence) dim into strided shards, whose
planning takes minutes on the CPU at train_4k's 1M rows."""
import pytest
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod

OVERRIDES = {"num_layers": 2, "d_model": 256, "num_heads": 8,
             "num_kv_heads": 4, "d_ff": 512, "vocab_size": 512}


@pytest.fixture
def small_meshes(monkeypatch):
    monkeypatch.setattr(mesh_mod, "SINGLE_POD", (2, 4))
    monkeypatch.setattr(mesh_mod, "MULTI_POD", (2, 2, 2))


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_dryrun_cell_on_small_mesh(small_meshes, shape):
    r = dryrun.run_cell("granite-3-2b", shape, False,
                        cfg_overrides=OVERRIDES, device_type="cpu")
    assert r["status"] == "ok", r.get("traceback")
    assert r["n_devices"] == 8
    assert r["memory"]["peak_per_device_bytes"] > 0
    assert r["cost"]["flops_per_device"] > 0
    if shape == "train_4k":
        assert r["collectives"]["total_link_bytes"] > 0


def test_skipped_and_failing_cells_are_records(monkeypatch):
    r = dryrun.run_cell("hubert-xlarge", "decode_32k", False,
                        device_type="cpu")
    assert r["status"] == "skipped" and "encoder" in r["reason"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    r = dryrun.run_cell("granite-3-2b", "train_4k", False)
    assert r["status"] == "error" and "CUDA is not available" in r["error"]


def test_collective_census_counts_a_hand_built_program():
    """One all-gather of a (8, 4) float32 shard over the 4-rank model axis
    (input 2 x 4 x 4 = 32 bytes) and one all-reduce of a (2, 2) float32
    partial over the 2-rank data axis (16 bytes)."""
    with dryrun.fake_world(8):
        mesh = mesh_mod.make_mesh((2, 4), ("data", "model"),
                                  device_type="cpu")
        census = dryrun._local_census_mode()
        with census:
            a = DTensor.from_local(torch.ones(2, 4), mesh,
                                   [Replicate(), Shard(0)], run_check=False)
            a.redistribute(mesh, [Replicate(), Replicate()])
            b = DTensor.from_local(torch.ones(2, 2), mesh,
                                   [Partial(), Replicate()], run_check=False)
            b.redistribute(mesh, [Replicate(), Replicate()])
            a.to_local() @ torch.ones(4, 3)
    assert census.calls == [("all_gather_into_tensor", 32, 4),
                            ("all_reduce", 16, 2)]
    assert census.flops == 2 * 2 * 4 * 3
    c = dryrun.collective_census(census.calls)
    assert c["all-gather"] == {"count": 1, "operand_bytes": 32,
                               "link_bytes": 96}
    assert c["all-reduce"] == {"count": 1, "operand_bytes": 16,
                               "link_bytes": 16}
    assert c["total_bytes"] == 48 and c["total_link_bytes"] == 112


def test_collective_census_arithmetic():
    """The reference's relations (dryrun.py:86-133): reduce-scatter link
    bytes are the result's times g - 1, all-to-all (g - 1) / g."""
    c = dryrun.collective_census([("reduce_scatter_tensor", 64, 4),
                                  ("all_to_all_single", 64, 4)])
    assert c["reduce-scatter"] == {"count": 1, "operand_bytes": 64,
                                   "link_bytes": 48}
    assert c["all-to-all"] == {"count": 1, "operand_bytes": 64,
                               "link_bytes": 48}
