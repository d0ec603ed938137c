"""The port's StudyPool (`repro_torch.hpo.pool`): mirrors of
tests/test_pool.py (batched suggest, routed and queued absorption,
per-study isolation of capacity, faults, lag and telemetry, pool
checkpoints, the one-code-path contract with TrialScheduler), each on the
CPU, and the port's pool against the JAX package's on the same spaces and
observations with the reference's own EI draws."""
import tempfile

import numpy as np
import pytest
from _torch_port import (TOL, assert_engines_match, mirror_pool_draws, n,
                         scaled_levy)

from repro.core.acquisition import AcqConfig as JAcqConfig
from repro.hpo import pool as jpool
from repro.hpo import space as jspace
from repro_torch import checkpoint as ckpt_mod
from repro_torch.core import GPCapacityError
from repro_torch.core.acquisition import AcqConfig
from repro_torch.hpo.pool import SchedulerConfig, StudyPool
from repro_torch.hpo.scheduler import TrialScheduler
from repro_torch.hpo.space import LENET_SPACE, RESNET_SPACE

SUGGEST_TOL = dict(atol=1e-4)       # tests/test_torch_bayesopt.py:50


def Pool(spaces, cfg, **kw):
    return StudyPool(spaces, cfg, device="cpu", **kw)


def Sched(space, cfg):
    return TrialScheduler(space, cfg, device="cpu")


def quad(center):
    """Smooth per-study objective on the unit cube (maximize)."""
    def f(unit):
        return float(-np.sum((np.asarray(unit) - center) ** 2))
    return f


CENTERS = [np.asarray([0.3, 0.6, 0.5]), np.asarray([0.8, 0.2, 0.4]),
           np.asarray([0.5, 0.5, 0.9])]


def _drive(pool, rounds, t=1):
    """suggest_all -> evaluate -> absorb_many, completion order shuffled."""
    rng = np.random.default_rng(0)
    for _ in range(rounds):
        suggestions = pool.suggest_all(t=t)
        events = [(sid, tr, quad(CENTERS[sid])(tr.unit))
                  for sid, trs in suggestions.items() for tr in trs]
        rng.shuffle(events)
        pool.absorb_many(events)


def test_pool_round_advances_every_study():
    cfg = SchedulerConfig(n_max=32, seed=0)
    pool = Pool([RESNET_SPACE] * 3, cfg)
    _drive(pool, rounds=4)
    for s in range(3):
        assert pool.engine.n(s) == 4
        assert pool.best(s) is not None
        units = np.stack([t.unit for t in pool.studies[s].trials])
        assert units.min() >= 0.0 and units.max() <= 1.0
    assert [t.trial_id for t in pool.studies[1].trials[:2]] == [0, 1]


def test_pool_matches_independent_schedulers():
    cfg = SchedulerConfig(n_max=16, seed=0)
    pool = Pool([RESNET_SPACE] * 2, cfg)
    scheds = [Sched(RESNET_SPACE, cfg) for _ in range(2)]
    rng = np.random.default_rng(3)
    for k in range(5):
        for s in range(2):
            unit = rng.uniform(size=3).astype(np.float32)
            val = quad(CENTERS[s])(unit)
            pool.absorb(s, pool._make_trial(s, unit), val)
            scheds[s].absorb(scheds[s]._make_trial(unit), val)
    for s in range(2):
        got, want = pool.state(s), scheds[s].state
        assert got.n == want.n == 5
        np.testing.assert_allclose(n(got.l_buf), n(want.l_buf), rtol=1e-6)
        np.testing.assert_allclose(n(got.alpha), n(want.alpha), rtol=1e-5,
                                   atol=1e-7)


def test_absorb_many_matches_routed_absorbs():
    cfg = SchedulerConfig(n_max=16, seed=0)
    a = Pool([RESNET_SPACE] * 3, cfg)
    b = Pool([RESNET_SPACE] * 3, cfg)
    rng = np.random.default_rng(7)
    events_a, events_b = [], []
    for sid in (1, 0, 1, 2, 0):
        unit = rng.uniform(size=3).astype(np.float32)
        val = quad(CENTERS[sid])(unit)
        events_a.append((sid, a._make_trial(sid, unit), val))
        events_b.append((sid, b._make_trial(sid, unit), val))
    a.absorb_many(events_a)
    for sid, tr, val in events_b:
        b.absorb(sid, tr, val)
    for s in range(3):
        np.testing.assert_allclose(n(a.state(s).l_buf), n(b.state(s).l_buf),
                                   rtol=1e-6)
        np.testing.assert_allclose(n(a.state(s).alpha), n(b.state(s).alpha),
                                   rtol=1e-5, atol=1e-7)
        assert a.state(s).n == b.state(s).n
        assert a.studies[s].trials[-1].clamp_count is not None


def test_pool_capacity_fault_is_per_study():
    pool = Pool([RESNET_SPACE] * 2, SchedulerConfig(n_max=2, seed=0))
    rng = np.random.default_rng(0)
    for _ in range(2):
        u = rng.uniform(size=3).astype(np.float32)
        pool.absorb(1, pool._make_trial(1, u), 0.5)
    with pytest.raises(GPCapacityError):
        pool.absorb(1, pool._make_trial(
            1, rng.uniform(size=3).astype(np.float32)), 0.1)
    assert pool.engine.n(1) == 2
    pool.absorb(0, pool._make_trial(
        0, rng.uniform(size=3).astype(np.float32)), 0.3)
    assert pool.engine.n(0) == 1


def test_absorb_many_capacity_fault_leaves_neighbors_consistent():
    pool = Pool([RESNET_SPACE] * 2, SchedulerConfig(n_max=2, seed=0))
    rng = np.random.default_rng(0)
    for _ in range(2):
        u = rng.uniform(size=3).astype(np.float32)
        pool.absorb(0, pool._make_trial(0, u), 0.5)
    t_full = pool._make_trial(0, rng.uniform(size=3).astype(np.float32))
    t_ok = pool._make_trial(1, rng.uniform(size=3).astype(np.float32))
    with pytest.raises(GPCapacityError):
        pool.absorb_many([(1, t_ok, 0.7), (0, t_full, 0.9)])
    assert t_ok.status == "pending" and pool.engine.n(1) == 0
    assert t_full.status == "pending" and pool.engine.n(0) == 2
    assert pool.best(1) is None
    pool.absorb_many([(1, t_ok, 0.7)])
    assert t_ok.status == "done" and pool.engine.n(1) == 1


def test_absorb_many_whole_queue_capacity_check_covers_later_rounds():
    pool = Pool([RESNET_SPACE] * 2, SchedulerConfig(n_max=2, seed=0))
    rng = np.random.default_rng(0)

    def u():
        return rng.uniform(size=3).astype(np.float32)

    pool.absorb(0, pool._make_trial(0, u()), 0.5)
    a, b = pool._make_trial(0, u()), pool._make_trial(0, u())
    c, d = pool._make_trial(1, u()), pool._make_trial(1, u())
    with pytest.raises(GPCapacityError):
        pool.absorb_many([(0, a, 0.1), (1, c, 0.2), (0, b, 0.3),
                          (1, d, 0.4)])
    assert [t.status for t in (a, b, c, d)] == ["pending"] * 4
    assert pool.engine.n(0) == 1 and pool.engine.n(1) == 0


def test_pool_lag_refit_is_per_study():
    pool = Pool([RESNET_SPACE] * 2, SchedulerConfig(n_max=16, seed=0, lag=2))
    rng = np.random.default_rng(1)
    for k in range(2):
        u = rng.uniform(size=3).astype(np.float32)
        pool.absorb(0, pool._make_trial(0, u), float(k))
    assert pool.engine.since_refit(0) == 0
    assert pool.engine.n(0) == 2
    assert pool.engine.since_refit(1) == 0 and pool.engine.n(1) == 0
    p = pool.engine.state.params
    assert p.rho.shape == (2,)
    assert float(p.rho[0]) != pytest.approx(float(p.rho[1])) or \
        float(p.sigma2[0]) != pytest.approx(float(p.sigma2[1]))


def test_pool_failure_policy_routed_to_owner():
    cfg = SchedulerConfig(n_max=16, seed=0, max_retries=1,
                          failure_penalty=-50.0)
    pool = Pool([RESNET_SPACE] * 2, cfg)
    tr = pool.seed_trials(1, 1)[0]
    retry = pool.record_failure(1, tr, "node lost")
    assert tr.status == "failed"
    assert retry is not None and retry.retries == 1
    assert pool.engine.n(1) == 1 and pool.engine.n(0) == 0
    assert float(pool.state(1).y_buf[0]) == pytest.approx(-50.0)


def test_pool_checkpoint_restore_roundtrip():
    with tempfile.TemporaryDirectory() as d:
        cfg = SchedulerConfig(n_max=16, seed=0, ckpt_dir=d)
        pool = Pool([RESNET_SPACE] * 3, cfg)
        _drive(pool, rounds=3)
        alphas = [n(pool.state(s).alpha) for s in range(3)]
        pool2 = Pool([RESNET_SPACE] * 3, cfg)
        assert pool2.restore()
        for s in range(3):
            assert pool2.engine.n(s) == 3
            np.testing.assert_array_equal(n(pool2.state(s).alpha), alphas[s])
            assert len(pool2.studies[s].trials) == \
                len(pool.studies[s].trials)
            assert pool2.studies[s].next_id == pool.studies[s].next_id
        _drive(pool2, rounds=1)
        assert all(pool2.engine.n(s) == 4 for s in range(3))


def test_restore_resumes_prng_streams_no_replayed_batches():
    with tempfile.TemporaryDirectory() as d:
        cfg = SchedulerConfig(n_max=16, seed=0, ckpt_dir=d)
        pool = Pool([RESNET_SPACE] * 2, cfg)
        drawn = {tuple(t.unit.tolist()) for t in pool.seed_trials(0, 2)}
        tr = pool.seed_trials(1, 1)[0]
        pool.absorb(1, tr, 0.5)
        pool2 = Pool([RESNET_SPACE] * 2, cfg)
        assert pool2.restore()
        again = {tuple(t.unit.tolist()) for t in pool2.seed_trials(0, 2)}
        assert drawn.isdisjoint(again), \
            "restored pool replayed a pre-crash seed batch"


def test_restore_resumes_ei_streams():
    """The port's own stream (the EI generator) rides the checkpoint too:
    the restored pool's next suggestion is the live pool's."""
    with tempfile.TemporaryDirectory() as d:
        cfg = SchedulerConfig(n_max=16, seed=0, ckpt_dir=d, acq=AcqConfig(
            restarts=8, ascent_steps=4))
        pool = Pool([RESNET_SPACE] * 2, cfg)
        _drive(pool, rounds=2)
        pool.checkpoint()
        pool2 = Pool([RESNET_SPACE] * 2, cfg)
        assert pool2.restore()
        for s in range(2):
            np.testing.assert_array_equal(pool2.suggest(s, 2)[1].unit,
                                          pool.suggest(s, 2)[1].unit)


def test_pool_rejects_mismatched_dims_and_study_counts():
    with pytest.raises(ValueError, match="dimensionality"):
        Pool([RESNET_SPACE, LENET_SPACE], SchedulerConfig(n_max=8))
    with tempfile.TemporaryDirectory() as d:
        cfg = SchedulerConfig(n_max=8, seed=0, ckpt_dir=d)
        pool = Pool([RESNET_SPACE] * 2, cfg)
        pool.checkpoint()
        with pytest.raises(ValueError, match="studies"):
            Pool([RESNET_SPACE] * 3, cfg).restore()
        with pytest.raises(ValueError, match="shape mismatch"):
            Pool([RESNET_SPACE] * 2,
                 SchedulerConfig(n_max=12, seed=0, ckpt_dir=d)).restore()


def test_repeated_seeding_draws_fresh_points():
    pool = Pool([RESNET_SPACE], SchedulerConfig(n_max=16, seed=0))
    first = pool.suggest(0, 2)
    second = pool.suggest(0, 2)
    units = {tuple(t.unit.tolist()) for t in first + second}
    assert len(units) == 4, "seed batches repeated"


def test_parallel_width_topup_at_n0_has_no_duplicate_points():
    sched = Sched(RESNET_SPACE, SchedulerConfig(n_max=32, seed=0, parallel=4))
    sched.run(lambda hp: quad(CENTERS[0])(RESNET_SPACE.to_unit(hp)),
              budget=6, n_seed=1)
    launched = [tuple(t.unit.tolist()) for t in sched.trials]
    assert len(set(launched)) == len(launched), "duplicate launches"


def test_fully_lazy_inverse_reanchor_keeps_params():
    cfg = SchedulerConfig(n_max=16, seed=0, lag=0, inv_refresh=3)
    pool = Pool([RESNET_SPACE] * 2, cfg)
    rho_before = float(pool.engine.state.params.rho[0])
    rng = np.random.default_rng(0)
    for k in range(3):
        u = rng.uniform(size=3).astype(np.float32)
        pool.absorb(0, pool._make_trial(0, u), float(k) * 0.1)
    assert pool.engine.since_refit(0) == 0
    assert pool.engine.since_refit(1) == 0 and pool.engine.n(1) == 0
    assert float(pool.engine.state.params.rho[0]) == pytest.approx(
        rho_before)
    assert pool.engine.n(0) == 3


def test_checkpoint_cadence_batches_snapshots():
    with tempfile.TemporaryDirectory() as d:
        cfg = SchedulerConfig(n_max=16, seed=0, ckpt_dir=d, ckpt_every=3)
        pool = Pool([RESNET_SPACE], cfg)
        rng = np.random.default_rng(0)
        for k in range(2):
            u = rng.uniform(size=3).astype(np.float32)
            pool.absorb(0, pool._make_trial(0, u), float(k))
        assert ckpt_mod.latest_step(d) is None
        u = rng.uniform(size=3).astype(np.float32)
        pool.absorb(0, pool._make_trial(0, u), 0.9)
        assert ckpt_mod.latest_step(d) == 3


def test_scheduler_is_one_study_pool():
    sched = Sched(RESNET_SPACE, SchedulerConfig(n_max=16, seed=0))
    assert isinstance(sched.pool, StudyPool)
    assert sched.trials is sched.pool.studies[0].trials
    tr = sched._make_trial(np.full(3, 0.4, np.float32))
    sched.absorb(tr, 1.0)
    assert sched.pool.engine.n(0) == 1
    assert sched.state.n == 1


def test_round_begin_then_finish_is_advance_round():
    """`advance_round_begin` mints nothing and flips nothing; `finish()`
    then gives what `advance_round` gives, bit for bit in the state."""
    cfg = SchedulerConfig(n_max=16, seed=0, acq=AcqConfig(restarts=8,
                                                          ascent_steps=4))
    a, b = Pool([RESNET_SPACE] * 3, cfg), Pool([RESNET_SPACE] * 3, cfg)
    _drive(a, 2), _drive(b, 2)
    for _ in range(3):
        ta, tb = a.suggest_all(), b.suggest_all()
        ev_a = [(s, ta[s][0], quad(CENTERS[s])(ta[s][0].unit)) for s in ta]
        ev_b = [(s, tb[s][0], quad(CENTERS[s])(tb[s][0].unit)) for s in tb]
        got = a.advance_round(ev_a)
        before = len(b.studies[0].trials)
        pending = b.advance_round_begin(ev_b)
        assert len(b.studies[0].trials) == before
        assert all(tr.status == "pending" for _, tr, _ in ev_b)
        want = pending.finish()
        with pytest.raises(RuntimeError, match="already finished"):
            pending.finish()
        for s in range(3):
            np.testing.assert_array_equal(got[s][0].unit, want[s][0].unit)
            assert ev_b[s][1].status == "done"
    for s in range(3):
        for leaf in ("x_buf", "l_buf", "li_buf", "alpha"):
            np.testing.assert_array_equal(n(getattr(a.state(s), leaf)),
                                          n(getattr(b.state(s), leaf)))


# ---------------------------------------------------------------------------
# Parity with the JAX package's pool
# ---------------------------------------------------------------------------
def _pair(n_max=24, lag=4):
    jcfg = jpool.SchedulerConfig(n_max=n_max, lag=lag, seed=0,
                                 implementation="xla",
                                 acq=JAcqConfig(restarts=8, ascent_steps=4))
    tcfg = SchedulerConfig(n_max=n_max, lag=lag, seed=0,
                           acq=AcqConfig(restarts=8, ascent_steps=4))
    jp = jpool.StudyPool([jspace.RESNET_SPACE] * 3, jcfg)
    tp = Pool([RESNET_SPACE] * 3, tcfg)
    mirror_pool_draws(tp, tcfg.seed)
    return jp, tp


def _tell_both(jp, tp, jtrials, ttrials, value):
    """Hold the port's suggestions to the reference's, then give both
    pools the reference's points (the port's trials take its units), so
    the two posteriors see the same observations."""
    jev, tev = [], []
    for (s, jt), (s2, tt) in zip(jtrials, ttrials):
        assert s == s2 and jt.trial_id == tt.trial_id
        np.testing.assert_allclose(tt.unit, jt.unit, **SUGGEST_TOL)
        tt.unit = np.asarray(jt.unit, np.float32).copy()
        tt.hparams = RESNET_SPACE.to_hparams(tt.unit)
        v = value(s, jt.unit)
        jev.append((s, jt, v))
        tev.append((s, tt, v))
    return jev, tev


def _ledger(pool, s):
    return [(t["trial_id"], t["unit"], t["status"], t["value"],
             t["clamp_count"], t["retries"], t["cost"])
            for t in pool.history(s)]


def test_pool_matches_the_reference_pool():
    """Seed trials bit for bit (numpy in both), EI suggestions within the
    engine tests' tolerance on the reference's own draws, through routed
    suggests and absorbs, batched rounds (suggest_all + absorb_many,
    advance_round) and lag refits; every lane of the states at TOL, the
    ledgers equal.  On 0.05 x Levy, as the engine tests run: the quadratic
    objectives refit to rho 1.6 on a handful of points, where the ascent's
    normalized step turns the packages' round-off in a near-zero gradient
    into suggestions 7e-4 apart."""
    jp, tp = _pair()

    def value(s, u):
        return float(scaled_levy(np.asarray(u)[None])[0])

    flat = [(s, tr) for s in range(3) for tr in tp.seed_trials(s, 2)]
    jflat = [(s, tr) for s in range(3) for tr in jp.seed_trials(s, 2)]
    for (_, a), (_, b) in zip(flat, jflat):
        np.testing.assert_array_equal(a.unit, b.unit)
    jev, tev = _tell_both(jp, tp, jflat, flat, value)
    jp.absorb_many(jev)
    tp.absorb_many(tev)
    for _ in range(2):                      # routed
        for s in range(3):
            jev, tev = _tell_both(jp, tp, [(s, jp.suggest(s, 1)[0])],
                                  [(s, tp.suggest(s, 1)[0])], value)
            jp.absorb(*jev[0])
            tp.absorb(*tev[0])
    for _ in range(2):                      # batched, then serving rounds
        js, ts = jp.suggest_all(), tp.suggest_all()
        jev, tev = _tell_both(jp, tp, [(s, js[s][0]) for s in range(3)],
                              [(s, ts[s][0]) for s in range(3)], value)
        jp.absorb_many(jev[::-1])
        tp.absorb_many(tev[::-1])
    js, ts = jp.suggest_all(), tp.suggest_all()
    for _ in range(3):
        jev, tev = _tell_both(jp, tp, [(s, js[s][0]) for s in range(3)],
                              [(s, ts[s][0]) for s in range(3)], value)
        js, ts = jp.advance_round(jev), tp.advance_round(tev)
    for s in range(3):
        np.testing.assert_allclose(ts[s][0].unit, js[s][0].unit,
                                   **SUGGEST_TOL)
    assert_engines_match(jp.engine, tp.engine)
    for s in range(3):
        assert _ledger(tp, s)[:-1] == _ledger(jp, s)[:-1]
        assert tp.engine.n(s) == jp.engine.n(s) == 9
        np.testing.assert_allclose(n(tp.state(s).alpha),
                                   n(jp.state(s).alpha), **TOL)
