"""The port stays a package of its own: no JAX, nothing of `repro`, and
entry points that run on the card unless asked for the CPU."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.core import BayesOpt, BOConfig, GPConfig, init_state, run_bo
from repro_torch.core.levy import levy_bounds, neg_levy
from repro_torch.hpo.space import MIXED_DEMO_SPACE

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)"
    r"|from\s+repro(\.|\s)(?!_torch))", re.MULTILINE)


def test_import_leaves_jax_and_repro_out():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels.ops, "
            "repro_torch.kernels.tune_acq, "
            "repro_torch.convert, repro_torch.hpo.space, "
            "repro_torch.hpo.engine, repro_torch.hpo.mesh, "
            "repro_torch.hpo.pool, repro_torch.core.neural_basis, "
            "repro_torch.checkpoint, repro_torch.checkpoint.store, "
            "repro_torch.hpo.scheduler, repro_torch.hpo.gateway, "
            "repro_torch.hpo.federation, repro_torch.hpo.transport, "
            "repro_torch.hpo.shard_worker, repro_torch.models, "
            "repro_torch.models.attention, repro_torch.models.common, "
            "repro_torch.models.config, repro_torch.models.model, "
            "repro_torch.models.moe, repro_torch.models.ssm, "
            "repro_torch.models.xlstm, "
            "repro_torch.optim, repro_torch.optim.optimizers, "
            "repro_torch.data, repro_torch.data.pipeline, "
            "repro_torch.training, repro_torch.training.steps, "
            "repro_torch.launch, repro_torch.launch.train, "
            "repro_torch.launch.mesh, repro_torch.launch.sharding, "
            "repro_torch.launch.specs, repro_torch.launch.dryrun, "
            "repro_torch.configs\n"
            "for arch in repro_torch.configs.REGISTRY:\n"
            "    repro_torch.configs.get_config(arch, reduced=True)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_or_repro_import_in_source(path):
    text = path.read_text()
    assert not FORBIDDEN.search(text), f"{path} imports jax or repro"


def test_entry_points_default_to_cuda():
    assert BOConfig(dim=2).device == "cuda"
    assert BOConfig(dim=MIXED_DEMO_SPACE.dim,
                    desc=MIXED_DEMO_SPACE.descriptor()).device == "cuda"
    assert GPConfig().device == "cuda"
    assert run_bo.__kwdefaults__["device"] == "cuda"
    from repro_torch.core import neural_basis
    from repro_torch.hpo.engine import StudyEngine
    for fn in (neural_basis.nb_init, neural_basis.nb_from_data):
        assert fn.__kwdefaults__["device"] == "cuda"
    assert neural_basis.nb_from_json.__defaults__ == ("cuda",)
    assert StudyEngine.__init__.__kwdefaults__["device"] == "cuda"
    from repro_torch.hpo import StudyGateway, StudyPool, TrialScheduler
    for cls in (StudyGateway, StudyPool, TrialScheduler):
        assert cls.__init__.__kwdefaults__["device"] == "cuda"
    from repro_torch.hpo import FederatedGateway, TransportFederation
    from repro_torch.hpo import transport
    for cls in (FederatedGateway, TransportFederation):
        assert cls.__init__.__kwdefaults__["device"] == "cuda"
    assert transport.build_spec.__kwdefaults__["device"] == "cuda"
    from repro_torch.data import pipeline
    from repro_torch.launch import train
    from repro_torch.models import model
    from repro_torch.training import steps
    for fn in (model.init_params, steps.init_train_state,
               pipeline.synth_tokens, pipeline.host_local_batch,
               pipeline.DataIterator.__init__):
        assert fn.__kwdefaults__["device"] == "cuda"
    assert train.parse_args(["--arch", "tiny-lm"]).device == "cuda"
    from repro_torch.launch import dryrun, mesh
    assert mesh.make_mesh.__kwdefaults__["device_type"] == "cuda"
    assert mesh.make_production_mesh.__kwdefaults__["device_type"] == "cuda"
    assert mesh.single_device_mesh.__kwdefaults__["device_type"] == "cuda"
    assert dryrun.run_cell.__kwdefaults__["device_type"] == "cuda"


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lo, hi = levy_bounds(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BayesOpt(BOConfig(dim=2), lo, hi)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BayesOpt(BOConfig(dim=MIXED_DEMO_SPACE.dim,
                          desc=MIXED_DEMO_SPACE.descriptor()),
                 [0.0] * MIXED_DEMO_SPACE.dim, [1.0] * MIXED_DEMO_SPACE.dim)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_state(GPConfig(n_max=8, dim=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_bo(lambda x: neg_levy(x).numpy(), lo, hi, 1, dim=2)
    from repro_torch.hpo import SchedulerConfig, StudyPool, TrialScheduler
    from repro_torch.hpo.space import RESNET_SPACE
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StudyPool([RESNET_SPACE], SchedulerConfig(n_max=8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TrialScheduler(RESNET_SPACE, SchedulerConfig(n_max=8))
    from repro_torch.hpo import StudyGateway
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StudyGateway(RESNET_SPACE, SchedulerConfig(n_max=8, ckpt_dir="."))
    from repro_torch.hpo import FederatedGateway
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FederatedGateway(RESNET_SPACE, SchedulerConfig(n_max=8, ckpt_dir="."))
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, DataIterator
    from repro_torch.launch import train
    from repro_torch.models import init_params
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(get_config("tiny-lm", reduced=True), 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DataIterator(DataConfig(vocab_size=8, seq_len=4, global_batch=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.run(train.parse_args(["--arch", "tiny-lm", "--reduced"]))


def test_spec_without_device_builds_on_the_card(tmp_path, monkeypatch):
    """A worker spec with no `device` (a reference front end's) means the
    card: without one, `gateway_from_spec` raises instead of falling back
    to the CPU; the port's own specs name their device."""
    from repro_torch.hpo import GatewayConfig, SchedulerConfig
    from repro_torch.hpo import transport
    from repro_torch.hpo.space import RESNET_SPACE
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = transport.build_spec(RESNET_SPACE, SchedulerConfig(n_max=8),
                                GatewayConfig(slots=2))
    assert spec["device"] == "cuda"
    del spec["device"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transport.gateway_from_spec(spec, str(tmp_path))


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Without a card the smoke script exits non-zero and prints no result,
    and alone in a directory it fails as well."""
    for where in (ROOT, tmp_path):
        script = where / "chip_smoke.py"
        if where == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=where,
                             capture_output=True, text=True, timeout=120,
                             env={"PATH": "/usr/bin:/bin",
                                  "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
