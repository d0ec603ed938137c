"""The port's dry run on the reference's shrunk multi-pod mesh (2x2x2 for
2x16x16, tests/test_launch.py:93-131) with that test's reduced
granite-3-2b: the train cell is `ok` with peak memory above 0 (without
sequence parallelism, as tests/test_torch_launch_dryrun.py says why)."""
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod

OVERRIDES = {"num_layers": 2, "d_model": 256, "num_heads": 8,
             "num_kv_heads": 4, "d_ff": 512, "vocab_size": 512}


def test_dryrun_multi_pod_train_cell(monkeypatch):
    monkeypatch.setattr(mesh_mod, "MULTI_POD", (2, 2, 2))
    r = dryrun.run_cell("granite-3-2b", "train_4k", True,
                        cfg_overrides=OVERRIDES, device_type="cpu")
    assert r["status"] == "ok", r.get("traceback")
    assert r["mesh"] == "2x16x16" and r["n_devices"] == 8
    assert r["memory"]["peak_per_device_bytes"] > 0
    assert r["cost"]["flops_per_device"] > 0
    assert r["collectives"]["total_link_bytes"] > 0
