"""The port's parallel_hpo, its trial objective (`nn_objective`) and
train_e2e (`repro_torch.examples`) against the JAX package's.

* parallel_hpo at `--parallel 1` (a fixed order) with faults and a
  resume, the JAX example as a subprocess: the absorbed counts, the
  injected failures recovered, the resumed n and the line structure.
* `nn_objective.train_trial` against `benchmarks.bench_nn_hpo.
  make_objective` at two unit points, both from the reference's init
  (carried across by `convert.lm_params_from_numpy`) on the reference's
  batches: the eval accuracy within float32's tolerance (1e-5 relative,
  as the LM train tests hold SGD-momentum), here a count of tokens.
* train_e2e on reduced tiny-lm: the loss falls, a second run on the same
  checkpoint directory resumes at the committed step with the loss of
  the uninterrupted run bit for bit, and a preset run leaves
  `tiny_lm.CONFIG` as it found it, also when the run raises.
* Every example's default `--device cuda` raises without a card, and the
  precision settings are set in one place (`gp.reference_precision`).
"""
import sys

import jax
import numpy as np
import pytest
import torch
from _torch_examples import (ROOT, numbers, reference_outputs, shape,
                             start_reference, stop)
from _torch_port import jax_state_leaves

from repro.configs import get_config as jget_config
from repro.data import DataConfig as JDataConfig
from repro.data import DataIterator as JDataIterator
from repro.models import init_params as jinit_params
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import gp
from repro_torch.examples import (hpo_service, nn_objective, parallel_hpo,
                                  quickstart, serve, serve_cluster, train_e2e)
from repro_torch.hpo.space import RESNET_SPACE

sys.path.insert(0, ROOT)
from benchmarks.bench_nn_hpo import make_objective  # noqa: E402

PARALLEL = ["--budget", "5", "--parallel", "1", "--train-steps", "2",
            "--faults"]
TOL_SGDM = 1e-5


@pytest.fixture(scope="module", autouse=True)
def parallel_reference(tmp_path_factory):
    """The JAX parallel_hpo run and its resume, started before this
    file's first test (its test comes last)."""
    argv = PARALLEL + ["--ckpt-dir", str(tmp_path_factory.mktemp("jax"))]
    proc = start_reference("parallel_hpo", argv, argv)
    yield proc
    stop(proc)


def test_nn_objective_matches_bench_nn_hpo():
    steps, seq, batch = 8, 32, 8
    units = np.array([[0.95, 0.1, 0.9], [0.8, 0.5, 0.6]])
    want = make_objective(steps=steps, seq_len=seq, batch=batch)(units)
    jcfg = jget_config("tiny-lm", reduced=True)
    cfg = get_config("tiny-lm", reduced=True)
    jp, _ = jinit_params(jcfg, jax.random.PRNGKey(1))
    params0 = convert.lm_params_from_numpy(jax_state_leaves(jp),
                                           device="cpu")
    dcfg = JDataConfig(vocab_size=jcfg.vocab_size, seq_len=seq,
                       global_batch=batch, seed=7)

    def port(b):
        return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}

    it = JDataIterator(dcfg)
    batches = [port(next(it)) for _ in range(steps)]
    eval_batch = port(next(JDataIterator(dcfg,
                                         start_step=nn_objective.EVAL_STEP)))
    got = []
    for u in units:
        hp = RESNET_SPACE.to_hparams(u)
        knobs = [torch.tensor(hp[k], dtype=torch.float32)
                 for k in nn_objective.KNOBS]
        got.append(nn_objective.train_trial(cfg, params0, batches,
                                            eval_batch, knobs)["accuracy"])
    assert min(want) > 0.05          # trained past chance (1/256)
    np.testing.assert_allclose(got, want, rtol=TOL_SGDM)


def test_nn_objective_trains_on_its_own_batches():
    objective = nn_objective.make_objective(steps=2, seq_len=16, batch=2,
                                            device="cpu")
    acc = objective(np.array([[0.5, 0.5, 0.5], [0.9, 0.1, 0.9]]))
    assert acc.shape == (2,) and np.all((acc >= 0) & (acc <= 1))
    # one trial is one code path: the same unit gives the same accuracy
    assert objective(np.array([0.5, 0.5, 0.5]))[0] == acc[0]


E2E = ["--arch", "tiny-lm", "--reduced", "--seq-len", "32",
       "--global-batch", "4", "--device", "cpu"]


def test_train_e2e_resumes_bit_for_bit(tmp_path):
    whole = train_e2e.main(E2E + ["--steps", "12", "--ckpt-dir",
                                  str(tmp_path / "whole")])
    assert whole["start"] == 0 and whole["steps"] == [0, 10, 11]
    assert whole["final_loss"] < whole["losses"][0]
    part = str(tmp_path / "part")
    first = train_e2e.main(E2E + ["--steps", "6", "--ckpt-dir", part])
    assert first["steps"] == [0, 5] and first["losses"][0] == \
        whole["losses"][0]
    resumed = train_e2e.main(E2E + ["--steps", "12", "--ckpt-dir", part])
    assert resumed["start"] == 6 and resumed["steps"] == [10, 11]
    assert resumed["losses"] == whole["losses"][1:]


def test_train_e2e_preset_leaves_tiny_lm_config(tmp_path):
    import repro_torch.configs.tiny_lm as tiny
    before = tiny.CONFIG
    out = train_e2e.main(["--preset", "15m", "--steps", "1", "--seq-len",
                          "8", "--global-batch", "1", "--ckpt-dir",
                          str(tmp_path / "a"), "--device", "cpu"])
    assert tiny.CONFIG is before
    assert np.isfinite(out["final_loss"])
    # the preset's vocabulary: the first loss is near ln(8192)
    assert abs(out["losses"][0] - np.log(8192)) < 1.0
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_e2e.main(["--preset", "100m", "--steps", "1", "--ckpt-dir",
                        str(tmp_path / "b")])
    assert tiny.CONFIG is before


@pytest.mark.parametrize("main, argv", [
    (quickstart.main, ["--iterations", "1", "--seeds", "1"]),
    (hpo_service.main, ["--studies", "1", "--budget", "1"]),
    (parallel_hpo.main, ["--budget", "1", "--train-steps", "1"]),
    (serve.main, ["--studies", "1", "--budget", "1"]),
    (serve_cluster.main, ["--studies", "1", "--budget", "1"]),
    (train_e2e.main, ["--arch", "tiny-lm", "--reduced", "--steps", "1"]),
], ids=["quickstart", "hpo_service", "parallel_hpo", "serve",
        "serve_cluster", "train_e2e"])
def test_default_device_is_the_card(tmp_path, monkeypatch, main, argv):
    """Without a card the default `--device cuda` raises; nothing falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)


def test_reference_precision_sets_all_three(monkeypatch):
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    monkeypatch.setattr(matmul, "allow_tf32", True)
    monkeypatch.setattr(cudnn, "allow_tf32", True)
    monkeypatch.setattr(matmul, "allow_bf16_reduced_precision_reduction",
                        True)
    gp.resolve_device("cpu")          # the CPU leaves them as they are
    assert matmul.allow_tf32 and cudnn.allow_tf32
    assert matmul.allow_bf16_reduced_precision_reduction
    gp.reference_precision()
    assert not matmul.allow_tf32
    assert not cudnn.allow_tf32
    assert not matmul.allow_bf16_reduced_precision_reduction


def test_parallel_hpo_matches_reference_and_resumes(capsys, tmp_path,
                                                    parallel_reference):
    argv = PARALLEL + ["--ckpt-dir", str(tmp_path), "--device", "cpu"]
    runs = []
    for _ in range(2):
        got = parallel_hpo.main(argv)
        runs.append((got, capsys.readouterr().out))
    wants = reference_outputs(parallel_reference)
    for (got, out), want in zip(runs, wants):
        assert shape(out) == shape(want)
        (absorbed, failed), = numbers(
            r"absorbed (\d+) observations \((\d+) injected", want)
        assert (got["absorbed"], got["failed"]) == (absorbed, failed)
        assert 0.0 <= got["best"] <= 1.0
        assert set(got["best_hparams"]) == {"lr", "weight_decay",
                                            "momentum"}
    (first, _), (second, _) = runs
    assert (first["absorbed"], first["resumed"]) == (5, None)
    assert first["failed"] == first["injected"] == 1   # call 5 of 6
    assert second["resumed"] == 5 and second["absorbed"] == 10
    assert second["failed"] == first["injected"] + second["injected"]
    assert numbers(r"resumed GP with n=(\d+)", wants[1]) == [(5,)]
