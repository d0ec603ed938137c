"""The port's optimizers and data pipeline against the reference's
(`repro/optim/optimizers.py`, `repro/data/pipeline.py`): the schedule,
global-norm clipping, `apply_updates` for AdamW and SGD-momentum on
identical gradients, the int8 error-feedback compression, and the
pipeline's determinism across a restart, its disjoint host shards and its
pattern rule.  Mirrors `tests/test_substrate.py:23-149`.

Tolerances: the schedule 1e-6 relative; updates 1e-6 relative to each
leaf's largest entry per step (float32 elementwise work, the same
formulas; the bias corrections' `pow` may differ in the last bit).
JAX's threefry bits cannot be matched, so the pipeline is held to its
own determinism and to the reference's law.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import jax_state_leaves, n

from repro.data import DataConfig as JDataConfig
from repro.data import synth_tokens as jsynth_tokens
from repro.optim import OptimizerConfig as JOptimizerConfig
from repro.optim import apply_updates as japply_updates
from repro.optim import clip_by_global_norm as jclip
from repro.optim import init_opt_state as jinit_opt_state
from repro.optim import schedule as jschedule
from repro.optim.optimizers import _compress_int8 as jcompress
from repro.optim.optimizers import ef_compress_grads as jef_compress
from repro_torch import convert
from repro_torch.data import (DataConfig, DataIterator, host_local_batch,
                              synth_tokens)
from repro_torch.optim import (OptimizerConfig, apply_updates,
                               clip_by_global_norm, ef_compress_grads,
                               global_norm, init_opt_state, schedule)
from repro_torch.optim.optimizers import _compress_int8

UPDATE = 1e-6


def _tree(rng, scale=1.0):
    return {"w": (rng.standard_normal((8, 8)) * scale).astype(np.float32),
            "b": {"x": (rng.standard_normal((8,)) * scale).astype(np.float32)},
            "e": (rng.standard_normal((4, 3)) * scale).astype(np.float32)}


def _torch(tree):
    return convert.lm_params_from_numpy(jax_state_leaves(tree), device="cpu")


def _close(got, want, tol, what=""):
    got, want = n(got).astype(np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(got - want))) <= tol * scale, what


def _trees_close(got, want, tol):
    got, want = convert.lm_params_to_numpy(got), jax_state_leaves(want)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], tol, k)


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("warmup,total", [(10, 110), (0, 50), (100, 10_000),
                                          (20, 20)])
def test_schedule_matches_reference(warmup, total):
    kw = dict(lr=3e-4, warmup_steps=warmup, total_steps=total,
              min_lr_frac=0.1)
    jcfg, tcfg = JOptimizerConfig(**kw), OptimizerConfig(**kw)
    for step in list(range(0, 130, 7)) + [warmup, total, total + 5]:
        want = float(jschedule(jcfg, jnp.asarray(step, jnp.int32)))
        got = schedule(tcfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_schedule_warmup_and_cosine():
    cfg = OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=110,
                          min_lr_frac=0.1)
    assert float(schedule(cfg, torch.tensor(0))) == 0.0
    assert float(schedule(cfg, torch.tensor(10))) == pytest.approx(1.0)
    assert float(schedule(cfg, torch.tensor(110))) == pytest.approx(0.1)


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_by_global_norm_matches_reference(scale):
    grads = _tree(np.random.default_rng(0), scale)
    want, wnorm = jclip(jax.tree.map(jnp.asarray, grads), 1.0)
    got, norm = clip_by_global_norm(_torch(grads), 1.0)
    assert float(norm) == pytest.approx(float(wnorm), rel=1e-6)
    _trees_close(got, want, 1e-6)


def test_clip_by_global_norm():
    clipped, norm = clip_by_global_norm({"a": torch.full((4,), 10.0)}, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "ef-int8"])
@pytest.mark.parametrize("name", ["adamw", "sgdm"])
def test_apply_updates_matches_reference(name, compress):
    """Five updates on the same gradients in both packages: params, every
    moment, the residual, the step and the metrics after each."""
    kw = dict(name=name, lr=0.05, weight_decay=0.01, warmup_steps=2,
              total_steps=10, compress_grads=compress)
    jcfg, tcfg = JOptimizerConfig(**kw), OptimizerConfig(**kw)
    rng = np.random.default_rng(1)
    params = _tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, params), _torch(params)
    js, ts = jinit_opt_state(jcfg, jp), init_opt_state(tcfg, tp)
    for _ in range(5):
        grads = _tree(rng, 3.0)
        jp, js, jm = japply_updates(jcfg, jp, jax.tree.map(jnp.asarray, grads),
                                    js)
        tp, ts, tm = apply_updates(tcfg, tp, _torch(grads), ts)
        _trees_close(tp, jp, UPDATE)
        _trees_close(ts.mu, js.mu, UPDATE)
        assert (ts.nu is None) == (js.nu is None) == (name == "sgdm")
        if name == "adamw":
            _trees_close(ts.nu, js.nu, UPDATE)
        if compress:
            _trees_close(ts.ef_residual, js.ef_residual, UPDATE)
        assert ts.step.dtype == torch.int32 and int(ts.step) == int(js.step)
        for k in ("lr", "grad_norm"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)
    # the optimizer state crosses by the reference's names
    back = convert.opt_state_from_numpy(
        convert.opt_state_to_numpy(ts), device="cpu")
    for a, b in zip(convert.opt_state_to_numpy(back).values(),
                    convert.opt_state_to_numpy(ts).values()):
        assert np.array_equal(a, b)
    assert sorted(convert.opt_state_to_numpy(ts)) == \
        sorted(jax_state_leaves(js._asdict()))


def test_adamw_reduces_quadratic():
    cfg = OptimizerConfig(name="adamw", lr=0.05, weight_decay=0.0,
                          warmup_steps=0, total_steps=100)
    params = {"w": torch.randn(8, 8, generator=torch.Generator().manual_seed(0)),
              "b": torch.zeros(8)}
    state = init_opt_state(cfg, params)

    def loss(p):
        return torch.sum(p["w"] ** 2) + torch.sum((p["b"] - 1) ** 2)

    l0 = float(loss(params))
    for _ in range(50):
        grads = {"w": 2 * params["w"], "b": 2 * (params["b"] - 1)}
        params, state, _ = apply_updates(cfg, params, grads, state)
    assert float(loss(params)) < 0.2 * l0


def test_sgdm_momentum_accumulates():
    cfg = OptimizerConfig(name="sgdm", lr=0.01, momentum=0.9,
                          weight_decay=0.0, warmup_steps=0, total_steps=10)
    params = {"w": torch.ones(4)}
    state = init_opt_state(cfg, params)
    grads = {"w": torch.ones(4)}
    p1, state, _ = apply_updates(cfg, params, grads, state)
    p2, state, _ = apply_updates(cfg, p1, grads, state)
    step1 = float(params["w"][0] - p1["w"][0])
    step2 = float(p1["w"][0] - p2["w"][0])
    assert step2 > step1 * 1.5  # momentum compounding


def test_int8_compression_matches_reference_bit_for_bit():
    """Round half to even in both packages, ties included: x / scale lands
    exactly on k + 0.5 for these inputs (scale = 127 / 127 = 1)."""
    x = np.array([127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.49, 126.5],
                 np.float32)
    jq, jscale = jcompress(jnp.asarray(x))
    tq, tscale = _compress_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    assert np.array_equal(n(tq), np.asarray(jq))
    assert float(tscale) == float(jscale)
    rng = np.random.default_rng(3)
    for scale in (1e-3, 1.0, 1e3):
        y = (rng.standard_normal(1000) * scale).astype(np.float32)
        jq, jscale = jcompress(jnp.asarray(y))
        tq, tscale = _compress_int8(torch.from_numpy(y))
        assert np.array_equal(n(tq), np.asarray(jq))
        assert float(tscale) == float(jscale)


def test_ef_compress_matches_reference():
    rng = np.random.default_rng(4)
    g, r = _tree(rng, 5.0), _tree(rng, 0.01)
    jsent, jres = jef_compress(jax.tree.map(jnp.asarray, g),
                               jax.tree.map(jnp.asarray, r))
    tsent, tres = ef_compress_grads(_torch(g), _torch(r))
    _trees_close(tsent, jsent, 1e-6)
    _trees_close(tres, jres, 1e-6)


@pytest.mark.parametrize("seed", range(10))
def test_ef_compression_error_feedback_is_lossless_over_time(seed):
    """Sum of compressed grads + final residual == sum of true grads
    (seeded draws in place of the reference's hypothesis examples)."""
    rng = np.random.default_rng(seed)
    scale = float(rng.uniform(0.01, 100.0))
    grads = [torch.from_numpy((rng.standard_normal(16) * scale)
                              .astype(np.float32)) for _ in range(8)]
    residual = {"g": torch.zeros(16)}
    sent_total = torch.zeros(16)
    for g in grads:
        sent, residual = ef_compress_grads({"g": g}, residual)
        sent_total = sent_total + sent["g"]
    np.testing.assert_allclose(n(sent_total + residual["g"]),
                               n(sum(grads)), rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------
def test_data_deterministic_across_restart():
    cfg = DataConfig(vocab_size=128, seq_len=32, global_batch=4, seed=3)
    a = synth_tokens(cfg, 7, device="cpu")
    b = synth_tokens(cfg, 7, device="cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["inputs"],
                           synth_tokens(cfg, 8, device="cpu")["inputs"])
    it = DataIterator(cfg, device="cpu")
    for _ in range(5):
        next(it)
    state = it.state_dict()
    assert state == {"step": 5}
    x1 = next(it)
    it2 = DataIterator(cfg, device="cpu")
    it2.load_state_dict(state)
    x2 = next(it2)
    assert torch.equal(x1["targets"], x2["targets"])
    assert torch.equal(x1["inputs"], synth_tokens(cfg, 5, device="cpu")["inputs"])


def test_data_host_sharding_disjoint():
    cfg = DataConfig(vocab_size=128, seq_len=16, global_batch=8, seed=0)
    shards = [host_local_batch(cfg, 0, host_id=h, num_hosts=4, device="cpu")
              for h in range(4)]
    assert shards[0]["inputs"].shape == (2, 16)
    for i in range(4):
        for j in range(i + 1, 4):
            assert not torch.equal(shards[i]["inputs"], shards[j]["inputs"])
    again = host_local_batch(cfg, 0, host_id=1, num_hosts=4, device="cpu")
    assert torch.equal(again["inputs"], shards[1]["inputs"])
    with pytest.raises(ValueError, match="does not split"):
        host_local_batch(cfg, 0, host_id=0, num_hosts=3, device="cpu")


def test_data_has_learnable_signal():
    cfg = DataConfig(vocab_size=128, seq_len=64, global_batch=8,
                     pattern_frac=1.0)
    batch = synth_tokens(cfg, 0, device="cpu")
    assert batch["inputs"].dtype == torch.int64
    assert torch.equal(batch["targets"], (batch["inputs"] * 31 + 7) % 128)
    assert torch.equal(batch["mask"], torch.ones(8, 64))


def test_data_law_matches_reference():
    """The reference's law: tokens in range, Zipf unigrams (rank 1 most
    frequent, about the same share in both packages), and about
    `pattern_frac` of the targets on the pattern rule."""
    kw = dict(vocab_size=64, seq_len=128, global_batch=16, seed=5)
    ours = [synth_tokens(DataConfig(**kw), s, device="cpu") for s in range(4)]
    theirs = [jsynth_tokens(JDataConfig(**kw), s) for s in range(4)]
    p1 = 1.0 / np.sum(np.arange(1, 65, dtype=np.float64) ** -1.1)
    for batches, to_np in ((ours, n), (theirs, np.asarray)):
        inputs = np.concatenate([to_np(b["inputs"]) for b in batches])
        targets = np.concatenate([to_np(b["targets"]) for b in batches])
        assert inputs.min() >= 0 and inputs.max() < 64
        counts = np.bincount(inputs.ravel(), minlength=64) / inputs.size
        assert counts[0] == counts.max()
        pattern = np.mean(targets == (inputs * 31 + 7) % 64)
        assert 0.45 < pattern < 0.6
        # rank 1's probability, within 4 standard errors of 8192 draws
        assert abs(counts[0] - p1) < 0.02


def test_frames_frontend_batch():
    cfg = DataConfig(vocab_size=32, seq_len=16, global_batch=2,
                     frontend="frames", d_model=24)
    b = synth_tokens(cfg, 0, device="cpu")
    assert b["inputs"].shape == (2, 16, 24)
    assert b["targets"].shape == (2, 16)
    assert int(b["targets"].max()) < 32
