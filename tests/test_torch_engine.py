"""The port's stacked `StudyEngine` (float studies) against the JAX
package's (`implementation="xla"`, `mesh="none"`), on the same numpy
observations and the reference's own restart draws (the JAX keys' seeds
and jitter are handed to the port): the batched absorb and serving
rounds, the routed suggest and absorb, the per-study lag refit and the
fully lazy re-anchor, slot loads and snapshots, the capacity fault, and a
stacked state carried across the two packages by `convert`."""
import jax
import numpy as np
import pytest
import torch
from _torch_port import (CPU, TOL, assert_engines_match, engine_draws,
                         jax_state_leaves, n, scaled_levy)

from repro.core import acquisition as jacqm
from repro.hpo import engine as jengine
from repro.hpo import pool as jpool
from repro_torch import convert
from repro_torch.core import acquisition as acqm
from repro_torch.core import gp as gp_mod
from repro_torch.hpo import engine as tengine
from repro_torch.hpo import mesh as mesh_mod
from repro_torch.hpo import pool as tpool

S, DIM, N_MAX, RESTARTS, STEPS, LAG = 3, 3, 24, 8, 4, 3
SUGGEST_TOL = dict(atol=1e-4)       # tests/test_torch_bayesopt.py:50
EI_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_fused_acq.py:65


_objective = scaled_levy


def _engines(dim=DIM, n_max=N_MAX, lag=LAG, inv_refresh=128, studies=S,
             kernel="matern52"):
    """The reference engine and the port's, configured alike."""
    kw = dict(n_max=n_max, lag=lag, inv_refresh=inv_refresh, kernel=kernel)
    jcfg = jpool.SchedulerConfig(implementation="xla", acq=jacqm.AcqConfig(
        restarts=RESTARTS, ascent_steps=STEPS), **kw)
    tcfg = tpool.SchedulerConfig(acq=acqm.AcqConfig(
        restarts=RESTARTS, ascent_steps=STEPS), **kw)
    return (jengine.StudyEngine(dim, jcfg, studies),
            tengine.StudyEngine(dim, tcfg, studies, device="cpu"))


def _prefill(rng, *engines, rounds=8):
    """Ragged prefill through absorb_round, the same observations into
    each engine: study s skips some rounds, so the studies reach
    different n and lag events fall in different rounds."""
    for r in range(rounds):
        flags = np.array([True, r % 2 == 0, r < rounds - 2])
        xs = rng.uniform(size=(S, DIM)).astype(np.float32)
        for eng in engines:
            eng.absorb_round(flags, xs, _objective(xs))


def _advance_both(jeng, teng, rng, key, flags, top_t=1, val_tol=EI_TOL):
    key, sub = jax.random.split(key)
    keys, seeds, jitter = engine_draws(sub, S, RESTARTS, DIM, top_t)
    xs = rng.uniform(size=(S, DIM)).astype(np.float32)
    uj, vj = jeng.advance(flags, xs, _objective(xs), keys, top_t=top_t)
    ut, vt = teng.advance(flags, xs, _objective(xs), top_t=top_t,
                          seeds=seeds, jitter=jitter)
    assert ut.shape == (S, top_t, DIM) and vt.shape == (S, top_t)
    np.testing.assert_allclose(n(ut), n(uj), **SUGGEST_TOL)
    np.testing.assert_allclose(n(vt), n(vj), **val_tol)
    return key


@pytest.mark.parametrize("lag,inv_refresh,kernel", [
    (LAG, 128, "matern52"), (0, 4, "matern52"), (LAG, 128, "matern32")],
    ids=["lag_refit", "reanchor", "unfused_matern32"])
def test_rounds_match_reference(lag, inv_refresh, kernel):
    """Batched rounds.  Matérn-3/2 has no fused EI, so its suggest runs the
    autodiff ascent study by study in both packages; its EI values go
    through the posterior variance k** - |L^{-1} k*|^2, whose float32
    cancellation after a long-length-scale refit carries the buffers'
    TOL (2e-4 relative seen), so they are held at TOL."""
    rng = np.random.default_rng(0)
    jeng, teng = _engines(lag=lag, inv_refresh=inv_refresh, kernel=kernel)
    _prefill(rng, jeng, teng)
    assert_engines_match(jeng, teng)
    key = jax.random.PRNGKey(1)
    val_tol = EI_TOL if kernel == "matern52" else TOL
    for flags in ([True, True, True], [True, False, True],
                  [False, True, False], [True, True, True]):
        key = _advance_both(jeng, teng, rng, key, np.array(flags),
                            val_tol=val_tol)
        assert_engines_match(jeng, teng)
    # Lag events fired, in different rounds for different studies.
    cadence = lag if lag > 0 else inv_refresh
    assert all(teng.since_refit(s) < min(teng.n(s), cadence)
               for s in range(S))
    assert len({teng.since_refit(s) for s in range(S)}) > 1


def test_suggest_all_top_t_matches_reference():
    rng = np.random.default_rng(1)
    jeng, teng = _engines()
    _prefill(rng, jeng, teng)
    keys, seeds, jitter = engine_draws(jax.random.PRNGKey(2), S, RESTARTS,
                                       DIM, top_t=3)
    uj, vj = jeng.suggest_all(keys, top_t=3)
    ut, vt = teng.suggest_all(3, seeds=seeds, jitter=jitter)
    np.testing.assert_allclose(n(ut), n(uj), **SUGGEST_TOL)
    np.testing.assert_allclose(n(vt), n(vj), **EI_TOL)
    _advance_both(jeng, teng, rng, jax.random.PRNGKey(3),
                  np.array([True, False, True]), top_t=3)
    assert_engines_match(jeng, teng)


def test_routed_suggest_and_absorb_match_reference():
    rng = np.random.default_rng(2)
    jeng, teng = _engines()
    _prefill(rng, jeng, teng, rounds=4)
    key = jax.random.PRNGKey(4)
    for r in range(5):                 # study 1 passes its lag event
        study = 1 if r < 4 else 2
        x = rng.uniform(size=DIM).astype(np.float32)
        y = float(_objective(x))
        jeng.absorb(study, x, y, cost=2.0)
        teng.absorb(study, x, y, cost=2.0)
        key, sub = jax.random.split(key)
        seeds = np.asarray(jax.random.uniform(sub, (RESTARTS, DIM)))
        uj, vj = jeng.suggest(study, sub)
        ut, vt = teng.suggest(study, seeds=seeds)
        np.testing.assert_allclose(n(ut), n(uj), **SUGGEST_TOL)
        np.testing.assert_allclose(n(vt), n(vj), **EI_TOL)
    assert_engines_match(jeng, teng)
    np.testing.assert_array_equal(teng.cost_row(1), jeng.cost_row(1))
    assert teng.cost_row(1)[teng.n(1) - 1] == 2.0


def test_unflagged_lanes_and_snapshots_keep_every_bit():
    rng = np.random.default_rng(3)
    _, teng = _engines()
    for r in range(5):
        xs = rng.uniform(size=(S, DIM)).astype(np.float32)
        teng.absorb_round(np.ones(S, bool), xs, _objective(xs))
    before = [teng.study_state(s) for s in range(S)]
    held = teng.study_state(1)
    xs = rng.uniform(size=(S, DIM)).astype(np.float32)
    teng.advance(np.array([True, False, True]), xs, _objective(xs))
    after = [teng.study_state(s) for s in range(S)]

    def leaves(st):
        return gp_mod._leaves(st) + (st.n, st.since_refit)

    assert all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
               for a, b in zip(leaves(before[1]), leaves(after[1])))
    assert all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
               for a, b in zip(leaves(held), leaves(after[1])))
    assert after[0].n == before[0].n + 1 and after[2].n == before[2].n + 1
    assert not torch.equal(after[0].l_buf, before[0].l_buf)


def test_observations_on_the_device_equal_host_ones():
    """The last round's suggestions may go back in as a tensor: the same
    rounds as with the same points on the host."""
    rng = np.random.default_rng(7)
    _, host = _engines()
    _, dev = _engines()
    _prefill(np.random.default_rng(8), host, dev, rounds=4)
    flags = np.array([True, False, True])
    for r in range(3):
        seeds = rng.uniform(size=(S, RESTARTS, DIM)).astype(np.float32)
        units, _ = dev.suggest_all(seeds=seeds)
        xs = units[:, 0]
        ys = _objective(n(xs))
        host.advance(flags, n(xs).copy(), ys, seeds=seeds)
        dev.advance(flags, xs, ys, seeds=seeds)
        if r == 0:
            host.absorb(1, n(xs[1]), float(ys[1]))
            dev.absorb(1, xs[1], float(ys[1]))
    for s in range(S):
        a, b = host.study_state(s), dev.study_state(s)
        assert all(torch.equal(u, v) for u, v in zip(gp_mod._leaves(a),
                                                     gp_mod._leaves(b)))


def test_load_slot_and_study_state_round_trip():
    rng = np.random.default_rng(4)
    jeng, teng = _engines()
    _prefill(rng, jeng, teng)
    for eng in (jeng, teng):
        eng.load_slot(2, eng.study_state(0))
    snap = teng.study_state(0)
    got = teng.study_state(2)
    for a, b in zip(gp_mod._leaves(got), gp_mod._leaves(snap)):
        assert torch.equal(a, b)
    assert (got.n, got.since_refit) == (snap.n, snap.since_refit)
    assert_engines_match(jeng, teng)
    _advance_both(jeng, teng, rng, jax.random.PRNGKey(5), np.ones(S, bool))
    assert_engines_match(jeng, teng)
    jeng.reset_slot(1)
    teng.reset_slot(1)
    assert teng.n(1) == 0 and int(teng.state.n[1]) == 0
    assert np.all(teng.cost_row(1) == 1.0)
    assert_engines_match(jeng, teng)


def test_capacity_fault_leaves_every_lane_untouched():
    rng = np.random.default_rng(5)
    _, teng = _engines(n_max=6)
    for r in range(6):
        xs = rng.uniform(size=(S, DIM)).astype(np.float32)
        teng.absorb_round(np.array([True, r < 3, r < 2]), xs, _objective(xs))
    assert [teng.n(s) for s in range(S)] == [6, 3, 2]
    before = [teng.study_state(s) for s in range(S)]
    xs = rng.uniform(size=(S, DIM)).astype(np.float32)
    for call in (lambda: teng.absorb_round(np.ones(S, bool), xs,
                                           _objective(xs)),
                 lambda: teng.advance(np.ones(S, bool), xs, _objective(xs)),
                 lambda: teng.absorb(0, xs[0], 1.0)):
        with pytest.raises(gp_mod.StudySaturatedError):
            call()
    for s in range(S):
        st = teng.study_state(s)
        assert (st.n, st.since_refit) == (before[s].n, before[s].since_refit)
        assert all(torch.equal(a, b) for a, b in zip(
            gp_mod._leaves(st), gp_mod._leaves(before[s])))
    np.testing.assert_array_equal(n(teng.state.n), [6, 3, 2])


def test_convert_round_trips_a_stacked_state():
    rng = np.random.default_rng(6)
    jeng, teng = _engines()
    for r in range(7):
        xs = rng.uniform(size=(S, DIM)).astype(np.float32)
        jeng.absorb_round(np.array([True, r > 1, r % 3 == 0]), xs,
                          _objective(xs))
    leaves = jax_state_leaves(jeng.state)
    assert leaves[".n"].shape == (S,)
    teng.state = convert.state_from_numpy(leaves, device=CPU)
    assert teng.state.is_batched and teng.state.n.dtype == torch.int32
    back = convert.state_to_numpy(teng.state)
    assert back.keys() == leaves.keys()
    for k, v in leaves.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == v.dtype, k
    assert [teng.n(s) for s in range(S)] == [jeng.n(s) for s in range(S)]
    _advance_both(jeng, teng, rng, jax.random.PRNGKey(7),
                  np.array([True, True, False]))
    assert_engines_match(jeng, teng)
    back = convert.state_to_numpy(teng.state)
    for k, v in jax_state_leaves(jeng.state).items():
        np.testing.assert_allclose(back[k], v, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_mesh_specs_resolve_to_the_unsharded_engine():
    """"none", and "auto" on one device, give no mesh (the unsharded
    engine); every other spec that fits its device list builds one."""
    assert mesh_mod.parse_spec("none") is None
    assert mesh_mod.parse_spec("auto") == "auto"
    assert mesh_mod.parse_spec("4x2") == (4, 2)
    assert mesh_mod.parse_spec("8") == (8, 1)
    with pytest.raises(ValueError, match="bad mesh spec"):
        mesh_mod.parse_spec("2y2")
    assert mesh_mod.build("none", S, RESTARTS) is None
    assert mesh_mod.build("auto", S, RESTARTS, devices=["cpu"]) is None
    for spec, devices, shards in (("auto", 4, (3, 1)), ("1x1", 1, (1, 1)),
                                  ("1x8", 8, (1, 8))):
        m = mesh_mod.build(spec, S, RESTARTS, devices=["cpu"] * devices)
        assert (m.study_shards, m.restart_shards) == shards
    cfg = tpool.SchedulerConfig(n_max=8, mesh="2x1")
    with pytest.raises(ValueError, match="devices"):
        tengine.StudyEngine(DIM, cfg, 2, device="cpu")
    eng = tengine.StudyEngine(DIM, cfg, 2, device="cpu", devices=["cpu"] * 2)
    assert eng.mesh.study_shards == 2 and eng.state.x_buf.shape[0] == 2


def test_engine_defaults_to_cuda(monkeypatch):
    assert tengine.StudyEngine.__init__.__kwdefaults__["device"] == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tengine.StudyEngine(DIM, tpool.SchedulerConfig(n_max=8), 2)


def test_scheduler_config_mirrors_the_reference():
    """The port's SchedulerConfig has the reference's fields and defaults,
    less the substrate knob."""
    import dataclasses
    jf = {f.name: f for f in dataclasses.fields(jpool.SchedulerConfig)}
    tf = {f.name: f for f in dataclasses.fields(tpool.SchedulerConfig)}
    assert set(jf) - set(tf) == {"implementation"}
    assert set(tf) <= set(jf)
    jd, td = jpool.SchedulerConfig(), tpool.SchedulerConfig()
    for name in tf:
        if name not in ("acq", "fantasy", "neural"):
            assert getattr(td, name) == getattr(jd, name), name
    assert (td.acq.restarts, td.acq.ascent_steps) == (jd.acq.restarts,
                                                      jd.acq.ascent_steps)
    assert td.fantasy.liar == jd.fantasy.liar
    assert dataclasses.asdict(td.neural) == dataclasses.asdict(jd.neural)
