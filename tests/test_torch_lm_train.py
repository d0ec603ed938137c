"""The port's train step and train launcher against the reference's
(`repro/training/steps.py`, `repro/launch/train.py`): three SGD-momentum
steps and a microbatched step on the reference's batches (passed in as
numpy), AdamW's loss trajectory, and `launch.train.run(--device cpu)` in
process with checkpoints, resume, the data iterator's step and SIGTERM.
A checkpoint written by the reference's launcher restores into the port's
tree leaf for leaf and resumes there, and the reverse.

Tolerances, relative to each leaf's largest entry: SGD-momentum params
after three steps 1e-5, losses 1e-5 (float32; measured about 1e-6).
AdamW amplifies sign noise in near-zero gradients (after step 1,
mhat / sqrt(vhat) is +-1), so it is held by its losses, 1e-4 over five
steps.  bfloat16 gradients: 1e-2.  zamba2's `a_log` momentum after a
step (its gradient) 5e-5: that gradient sums terms of both signs over the
sequence, and each package's float32 value lies about 2.7e-5 from a
float64 run (tests/test_torch_lm_ssm.py).
"""
import dataclasses
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import CPU, jax_state_leaves, n

from repro import checkpoint as jckpt
from repro.configs import get_config as jget_config
from repro.data import DataConfig as JDataConfig
from repro.data import synth_tokens as jsynth_tokens
from repro.launch import train as jtrain
from repro.models import init_params as jinit_params
from repro.optim import OptimizerConfig as JOptimizerConfig
from repro.optim import init_opt_state as jinit_opt_state
from repro.training import TrainConfig as JTrainConfig
from repro.training import make_train_step as jmake_train_step
from repro_torch import checkpoint as ckpt
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, DataIterator
from repro_torch.launch import train
from repro_torch.models import init_params
from repro_torch.optim import OptimizerConfig, init_opt_state
from repro_torch.training import (TrainConfig, init_train_state,
                                  make_eval_step, make_train_step)

ARCH = "tiny-lm"
TOL_SGDM = 1e-5
TOL_ADAMW_LOSS = 1e-4
TOL_A_LOG = 5e-5


def _close(got, want, tol, what=""):
    got, want = n(got).astype(np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= tol, f"{what}: {err:.3g} > {tol}"


def _setup(opt_kw, seed=0, arch=ARCH, **cfg_changes):
    jcfg = dataclasses.replace(jget_config(arch, reduced=True), **cfg_changes)
    tcfg = dataclasses.replace(get_config(arch, reduced=True), **cfg_changes)
    jp, _ = jinit_params(jcfg, jax.random.PRNGKey(seed))
    tp = convert.lm_params_from_numpy(jax_state_leaves(jp), device=CPU)
    jo, to = JOptimizerConfig(**opt_kw), OptimizerConfig(**opt_kw)
    return jcfg, tcfg, jp, tp, jo, to


def _batches(steps, seq=32, batch=8, vocab=256, **data):
    """The reference pipeline's batches as numpy (threefry bits cannot be
    drawn in the port); `data` passes a frames frontend and its width."""
    dcfg = JDataConfig(vocab_size=vocab, seq_len=seq, global_batch=batch,
                       seed=1, **data)
    return [{k: np.asarray(v) for k, v in jsynth_tokens(dcfg, s).items()}
            for s in range(steps)]


def _run_both(jstep, tstep, jp, tp, js, ts, batches):
    jl, tl = [], []
    for b in batches:
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tstep(tp, ts, {k: torch.tensor(v) for k, v in b.items()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    return (jp, js, jl), (tp, ts, tl)


SGDM = dict(name="sgdm", lr=0.05, momentum=0.9, weight_decay=1e-4,
            warmup_steps=0, total_steps=100)


def test_three_sgdm_steps_match_reference():
    jcfg, tcfg, jp, tp, jo, to = _setup(SGDM)
    (jp, js, jl), (tp, ts, tl) = _run_both(
        jax.jit(jmake_train_step(jcfg, jo)), make_train_step(tcfg, to),
        jp, tp, jinit_opt_state(jo, jp), init_opt_state(to, tp), _batches(3))
    np.testing.assert_allclose(tl, jl, rtol=TOL_SGDM)
    want, got = jax_state_leaves(jp), convert.lm_params_to_numpy(tp)
    for k in want:
        _close(got[k], want[k], TOL_SGDM, k)
    mu_want = jax_state_leaves(js.mu)
    for k, v in convert.lm_params_to_numpy(ts.mu).items():
        _close(v, mu_want[k], TOL_SGDM, f"mu/{k}")
    assert int(ts.step) == 3 and ts.nu is None


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen3-moe-30b-a3b",
                                  "minicpm3-4b"])
def test_moe_and_mla_sgdm_steps_match_reference(arch):
    """Three SGD-momentum steps of a reduced MoE or MLA model at float32
    (the router's aux loss in the loss), each from the reference's state
    of the step before (converted by tree path): the loss, params and
    momentum against the reference's step.  Run on their own, the two
    packages' float32 sums drift apart by 1e-7, and routing is a
    discontinuous function of them: at granite-moe's third step two
    experts' probabilities (0.17245048, 0.17245066) swap order, and the
    loss moves by 1e-4."""
    jcfg, tcfg, jp, _, jo, to = _setup(SGDM, seed=5, arch=arch,
                                       dtype="float32")
    jstep, tstep = jax.jit(jmake_train_step(jcfg, jo)), make_train_step(tcfg,
                                                                        to)
    js = jinit_opt_state(jo, jp)
    for batch in _batches(3):
        tp = convert.lm_params_from_numpy(jax_state_leaves(jp), device=CPU)
        ts = convert.opt_state_from_numpy(jax_state_leaves(js._asdict()),
                                          device=CPU)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in
                                    batch.items()})
        tp, ts, tm = tstep(tp, ts, {k: torch.tensor(v) for k, v in
                                    batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=TOL_SGDM)
        want, got = jax_state_leaves(jp), convert.lm_params_to_numpy(tp)
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], TOL_SGDM, k)
        mu_want = jax_state_leaves(js.mu)
        for k, v in convert.lm_params_to_numpy(ts.mu).items():
            _close(v, mu_want[k], TOL_SGDM, f"mu/{k}")
    assert any(k.startswith("blocks/moe/") for k in want) == tcfg.is_moe
    assert int(ts.step) == 3


@pytest.mark.parametrize("arch", ["hubert-xlarge", "zamba2-1.2b",
                                  "xlstm-1.3b"])
def test_recurrent_and_frames_sgdm_step_matches_reference(arch):
    """One SGD-momentum step of the reduced frames encoder, mamba stack
    with shared attention, and mLSTM stack at float32, on the reference
    pipeline's batch (frames for hubert, with their frame labels): the
    loss, params and momentum against the reference's step."""
    jcfg, tcfg, jp, tp, jo, to = _setup(SGDM, seed=6, arch=arch,
                                       dtype="float32")
    data = ({"frontend": "frames", "d_model": jcfg.d_model}
            if jcfg.frontend == "frames" else {})
    (jp, js, jl), (tp, ts, tl) = _run_both(
        jax.jit(jmake_train_step(jcfg, jo)), make_train_step(tcfg, to),
        jp, tp, jinit_opt_state(jo, jp), init_opt_state(to, tp),
        _batches(1, vocab=jcfg.vocab_size, **data))
    np.testing.assert_allclose(tl, jl, rtol=TOL_SGDM)
    want, got = jax_state_leaves(jp), convert.lm_params_to_numpy(tp)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], TOL_SGDM, k)
    mu_want = jax_state_leaves(js.mu)
    for k, v in convert.lm_params_to_numpy(ts.mu).items():
        _close(v, mu_want[k], TOL_A_LOG if k.endswith("a_log") else TOL_SGDM,
               f"mu/{k}")


def test_microbatched_step_matches_reference():
    """Four microbatches, gradients summed in float32: params after one
    SGD-momentum step against the reference's microbatched step, and
    against the port's own full-batch step."""
    jcfg, tcfg, jp, tp, jo, to = _setup(SGDM, seed=2)
    batch = _batches(1)
    (jp4, _, jl), (tp4, _, tl) = _run_both(
        jax.jit(jmake_train_step(jcfg, jo, JTrainConfig(microbatches=4))),
        make_train_step(tcfg, to, TrainConfig(microbatches=4)),
        jp, tp, jinit_opt_state(jo, jp), init_opt_state(to, tp), batch)
    np.testing.assert_allclose(tl, jl, rtol=TOL_SGDM)
    want, got = jax_state_leaves(jp4), convert.lm_params_to_numpy(tp4)
    for k in want:
        _close(got[k], want[k], TOL_SGDM, k)
    tp1, _, _ = make_train_step(tcfg, to)(
        tp, init_opt_state(to, tp),
        {k: torch.tensor(v) for k, v in batch[0].items()})
    for k, v in convert.lm_params_to_numpy(tp1).items():
        _close(v, got[k], TOL_SGDM, f"full batch {k}")


def test_bf16_grads_step_matches_reference():
    jcfg, tcfg, jp, tp, jo, to = _setup(SGDM, seed=3)
    (jp, _, jl), (tp, _, tl) = _run_both(
        jax.jit(jmake_train_step(jcfg, jo, JTrainConfig(bf16_grads=True))),
        make_train_step(tcfg, to, TrainConfig(bf16_grads=True)),
        jp, tp, jinit_opt_state(jo, jp), init_opt_state(to, tp), _batches(1))
    np.testing.assert_allclose(tl, jl, rtol=1e-2)
    want, got = jax_state_leaves(jp), convert.lm_params_to_numpy(tp)
    for k in want:
        _close(got[k], want[k], 1e-2, k)


def test_adamw_loss_trajectory_near_reference():
    kw = dict(name="adamw", lr=3e-3, warmup_steps=2, total_steps=100)
    jcfg, tcfg, jp, tp, jo, to = _setup(kw, seed=4)
    (_, _, jl), (_, _, tl) = _run_both(
        jax.jit(jmake_train_step(jcfg, jo)), make_train_step(tcfg, to),
        jp, tp, jinit_opt_state(jo, jp), init_opt_state(to, tp), _batches(5))
    np.testing.assert_allclose(tl, jl, rtol=TOL_ADAMW_LOSS)
    assert tl[-1] < tl[0]


def test_train_step_reduces_loss_and_eval_step():
    cfg = get_config(ARCH, reduced=True)
    ocfg = OptimizerConfig(lr=3e-3, warmup_steps=5, total_steps=100)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    params, opt_state, _ = init_train_state(cfg, ocfg, 0, device="cpu")
    step = make_train_step(cfg, ocfg)
    it = DataIterator(dcfg, device="cpu")
    losses = []
    for _ in range(20):
        params, opt_state, m = step(params, opt_state, next(it))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    held_out = DataIterator(dcfg, start_step=10_000, device="cpu")
    metrics = make_eval_step(cfg)(params, next(held_out))
    assert set(metrics) == {"ce", "aux", "accuracy", "loss"}
    assert 0.0 <= float(metrics["accuracy"]) <= 1.0
    assert not metrics["loss"].requires_grad


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------
def _args(d, steps, *extra, module=train):
    argv = ["--arch", ARCH, "--reduced", "--steps", str(steps),
            "--seq-len", "32", "--global-batch", "4", "--ckpt-every", "4",
            "--log-every", "1"]
    if d is not None:
        argv += ["--ckpt-dir", str(d)]
    if module is train:
        argv += ["--device", "cpu"]
    return module.parse_args(argv + list(extra))


def test_train_cli_checkpoints_and_resumes(tmp_path):
    """A run to 8 checkpoints at 4 and 8 with the data iterator's step; a
    second run from a copy of step 4 resumes there and logs steps 4-7 with
    the first run's losses (to 1e-6: the same values, but a restored
    tensor's alignment may route a CPU matmul through other code); a run
    to 10 resumes from 8."""
    first = train.run(_args(tmp_path / "a", 8))
    assert ckpt.committed_steps(tmp_path / "a") == [4, 8]
    assert first["steps"] == list(range(8)) and first["start"] == 0
    _, _, meta = ckpt.restore_latest(
        str(tmp_path / "a"), _like(get_config(ARCH, reduced=True)))
    assert meta == {"data_iter": {"step": 8}, "arch": ARCH}
    os.makedirs(tmp_path / "b")
    shutil.copytree(tmp_path / "a" / "step_000000004",
                    tmp_path / "b" / "step_000000004")
    resumed = train.run(_args(tmp_path / "b", 8))
    assert resumed["start"] == 4 and resumed["steps"] == [4, 5, 6, 7]
    np.testing.assert_allclose(resumed["losses"], first["losses"][4:],
                               rtol=1e-6)
    more = train.run(_args(tmp_path / "a", 10))
    assert more["start"] == 8 and ckpt.latest_step(tmp_path / "a") == 10


def test_moe_launcher_resumes_bit_for_bit(tmp_path):
    """`--arch qwen3-moe-30b-a3b --reduced` (bfloat16, routed): a run to 6
    checkpointing at 4, then a run from a copy of step 4 logs steps 4 and 5
    with the first run's losses bit for bit (the same routing, the same
    reductions)."""
    def args(d):
        return train.parse_args([
            "--arch", "qwen3-moe-30b-a3b", "--reduced", "--steps", "6",
            "--seq-len", "32", "--global-batch", "4", "--ckpt-every", "4",
            "--log-every", "1", "--ckpt-dir", str(d), "--device", "cpu"])

    first = train.run(args(tmp_path / "a"))
    assert first["steps"] == list(range(6))
    os.makedirs(tmp_path / "b")
    shutil.copytree(tmp_path / "a" / "step_000000004",
                    tmp_path / "b" / "step_000000004")
    resumed = train.run(args(tmp_path / "b"))
    assert resumed["start"] == 4 and resumed["steps"] == [4, 5]
    assert resumed["losses"] == first["losses"][4:]
    assert first["losses"][-1] < first["losses"][0]


@pytest.mark.parametrize("arch", ["hubert-xlarge", "zamba2-1.2b",
                                  "xlstm-1.3b"])
def test_launcher_trains_recurrent_and_frames(arch):
    """`launch.train.run --arch A --reduced --device cpu` trains the frames
    encoder (frame batches from the pipeline), the mamba stack with shared
    attention and the mLSTM stack: six AdamW steps, finite losses that
    fall."""
    out = train.run(train.parse_args([
        "--arch", arch, "--reduced", "--steps", "6", "--seq-len", "32",
        "--global-batch", "4", "--lr", "3e-3", "--warmup", "1",
        "--log-every", "1", "--device", "cpu"]))
    assert out["steps"] == list(range(6))
    assert np.all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0]


def test_train_sigterm_checkpoints_and_exits_3(tmp_path, monkeypatch):
    """SIGTERM during step 2: the loop checkpoints step 3 and exits with
    code 3, and the previous handler is back afterwards."""
    real_next = DataIterator.__next__

    def next_then_signal(self):
        if self.step == 2:
            signal.raise_signal(signal.SIGTERM)
        return real_next(self)

    monkeypatch.setattr(DataIterator, "__next__", next_then_signal)
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as exc:
        train.run(_args(tmp_path, 8))
    assert exc.value.code == 3
    assert ckpt.latest_step(tmp_path) == 3
    assert signal.getsignal(signal.SIGTERM) is before


def test_train_cli_one_device_only():
    """Without a process group of its size, a mesh other than 1x1 is
    refused before anything runs (the sharded launcher's own tests:
    tests/test_torch_launch_resume.py)."""
    with pytest.raises(ValueError, match="WORLD_SIZE is 1"):
        train.run(_args(None, 1, "--mesh-shape", "2x1"))


def _like(cfg, opt="adamw"):
    params, _ = init_params(cfg, 0, device="cpu")
    state = init_opt_state(OptimizerConfig(name=opt), params)
    return {"params": params, "opt": state._asdict()}


def _jlike(cfg, opt="adamw"):
    params, _ = jinit_params(cfg, jax.random.PRNGKey(0))
    state = jinit_opt_state(JOptimizerConfig(name=opt), params)
    return {"params": params, "opt": state._asdict()}


@pytest.fixture
def keep_sigterm():
    """The reference's launcher leaves its SIGTERM handler installed; put
    the worker's own back."""
    before = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, before)


@pytest.mark.parametrize("opt", ["adamw", "sgdm"])
def test_checkpoints_cross_between_the_launchers(tmp_path, opt, keep_sigterm):
    """The reference's launcher writes step 3; the port restores it leaf for
    leaf and resumes there.  The port's launcher writes step 5; the
    reference restores it leaf for leaf and resumes there."""
    jcfg, tcfg = jget_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    jtrain.run(_args(tmp_path, 3, "--optimizer", opt, module=jtrain))
    _, jtree, jmeta = jckpt.restore_latest(str(tmp_path), _jlike(jcfg, opt))
    step, ttree, tmeta = ckpt.restore_latest(str(tmp_path), _like(tcfg, opt))
    assert step == 3 and tmeta == jmeta == {"data_iter": {"step": 3},
                                            "arch": ARCH}
    want, got = jax_state_leaves(jtree), convert.lm_params_to_numpy(ttree)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]) and got[k].dtype == want[k].dtype
    out = train.run(_args(tmp_path, 5, "--optimizer", opt))
    assert out["start"] == 3 and out["steps"] == [3, 4]

    step, ttree, _ = ckpt.restore_latest(str(tmp_path), _like(tcfg, opt))
    _, jtree, _ = jckpt.restore_latest(str(tmp_path), _jlike(jcfg, opt))
    assert step == 5
    want, got = convert.lm_params_to_numpy(ttree), jax_state_leaves(jtree)
    for k in want:
        assert np.array_equal(got[k], want[k]) and got[k].dtype == want[k].dtype
    jtrain.run(_args(tmp_path, 6, "--optimizer", opt, module=jtrain))
    assert jckpt.latest_step(str(tmp_path)) == 6


def test_reference_batches_through_the_port_pipeline_shapes():
    """The port's batch has the reference's keys, shapes and mask."""
    jb = _batches(1, seq=16, batch=2)[0]
    tb = next(DataIterator(DataConfig(vocab_size=256, seq_len=16,
                                      global_batch=2, seed=1), device="cpu"))
    assert {k: v.shape for k, v in jb.items()} == \
        {k: tuple(v.shape) for k, v in tb.items()}
    assert np.array_equal(n(tb["mask"]), jb["mask"])
