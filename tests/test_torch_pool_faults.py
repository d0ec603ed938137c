"""Fault contracts of the port's StudyPool, mirrored from the reference's
pool-only fault tests (tests/test_faults.py: a failed checkpoint write, a
kill between checkpoints, the q-fantasy rollback against a twin that never
fantasized, a checkpoint taken with fantasies out; tests/test_tier.py: an
escalated study's checkpoint), each bit for bit within the port on the
CPU."""
import os
import tempfile

import numpy as np
import pytest
import torch
from _torch_port import assert_slots_equal

from repro_torch import checkpoint as ckpt_mod
from repro_torch.checkpoint import store as store_mod
from repro_torch.core import neural_basis as nb_mod
from repro_torch.core.acquisition import AcqConfig
from repro_torch.core.neural_basis import NeuralConfig
from repro_torch.hpo.pool import SchedulerConfig, StudyPool, Trial
from repro_torch.hpo.space import RESNET_SPACE

# tests/test_tier.py's small neural tier
NB = NeuralConfig(hidden=16, features=8, refit_every=8, refit_steps=40,
                  cap0=16)


def _cfg(d, n_max=16, **kw):
    """tests/_traffic.py's make_cfg: small acquisition budget, the pool's
    own per-absorb snapshot cadence off unless a test asks."""
    kw.setdefault("acq", AcqConfig(restarts=8, ascent_steps=4))
    kw.setdefault("ckpt_every", 10_000)
    kw.setdefault("seed", 0)
    return SchedulerConfig(n_max=n_max, ckpt_dir=d, **kw)


def _pool(cfg, n_studies=1):
    return StudyPool([RESNET_SPACE] * n_studies, cfg, device="cpu")


def obj(sid, unit):
    """Deterministic per-study objective (tests/_traffic.py)."""
    c = 0.15 + 0.7 * ((sid * 0.37) % 1.0)
    return float(-np.sum((np.asarray(unit) - c) ** 2))


def _foreign_trial(unit) -> Trial:
    """An observation told out of band (never asked)."""
    return Trial(10_000, np.asarray(unit, np.float32), {})


def test_checkpoint_write_failure_leaves_previous_snapshot(monkeypatch):
    with tempfile.TemporaryDirectory() as d:
        cfg = _cfg(d)
        pool = _pool(cfg, 2)
        rng = np.random.default_rng(0)
        pool.absorb(0, pool._make_trial(0, rng.uniform(size=3).astype(
            np.float32)), 0.5)
        pool.checkpoint()
        good_step = ckpt_mod.latest_step(d)
        pool.absorb(1, pool._make_trial(1, rng.uniform(size=3).astype(
            np.float32)), 0.7)

        def boom(*a, **k):
            raise OSError("disk full")
        monkeypatch.setattr(store_mod.np, "savez", boom)
        with pytest.raises(OSError, match="disk full"):
            pool.checkpoint()
        monkeypatch.undo()
        assert ckpt_mod.latest_step(d) == good_step
        assert not [f for f in os.listdir(d) if f.startswith(".tmp_ckpt_")]
        pool.checkpoint()
        assert ckpt_mod.latest_step(d) > good_step
        fresh = _pool(cfg, 2)
        assert fresh.restore()
        assert fresh.engine.n(0) == 1 and fresh.engine.n(1) == 1


def test_pool_kill_mid_round_restores_to_last_commit():
    with tempfile.TemporaryDirectory() as d:
        pool = _pool(_cfg(d, ckpt_every=1), 2)
        rng = np.random.default_rng(3)
        units = [rng.uniform(size=3).astype(np.float32) for _ in range(4)]
        pool.absorb(0, pool._make_trial(0, units[0]), 0.1)
        pool.absorb(1, pool._make_trial(1, units[1]), 0.2)
        alpha_commit = pool.state(0).alpha.clone()
        # the next absorb lands on the GP but its checkpoint never commits
        pool.cfg = _cfg(d, ckpt_every=10_000)
        pool.absorb(0, pool._make_trial(0, units[2]), 0.3)

        fresh = _pool(_cfg(d, ckpt_every=1), 2)
        assert fresh.restore()
        assert fresh.engine.n(0) == 1 and fresh.engine.n(1) == 1
        assert torch.equal(fresh.state(0).alpha, alpha_commit)
        fresh.absorb(0, fresh._make_trial(0, units[2]), 0.3)
        assert torch.equal(fresh.state(0).alpha, pool.state(0).alpha)


def _twin_pools(d1, d2, n_max=48):
    pa, pb = _pool(_cfg(d1, n_max=n_max)), _pool(_cfg(d2, n_max=n_max))
    rng = np.random.RandomState(7)
    for _ in range(3):
        u = rng.rand(RESNET_SPACE.dim).astype(np.float32)
        v = obj(0, u)
        pa.absorb(0, _foreign_trial(u), v)
        pb.absorb(0, _foreign_trial(u), v)
    return pa, pb


@pytest.mark.parametrize("order", [
    [0, 1, 2, 3],          # tell all, in suggestion order
    [2, 0, 3, 1],          # out of order
    [1, 3],                # partial: the rest told after more q-asks
])
def test_ask_q_rollback_bitwise_equals_never_fantasized(order):
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        pa, pb = _twin_pools(d1, d2)
        trials = pa.ask_q(0, 4)
        assert pa.fantasy_active(0) == 4 and pa.n_real(0) == 3
        for i in order:
            tr = trials[i]
            v = obj(0, tr.unit)
            pa.absorb(0, tr, v)
            pb.absorb(0, _foreign_trial(tr.unit), v)
        rest = [i for i in range(4) if i not in order]
        if rest:
            more = pa.ask_q(0, 2)
            for tr in [trials[i] for i in rest] + list(more):
                v = obj(0, tr.unit)
                pa.absorb(0, tr, v)
                pb.absorb(0, _foreign_trial(tr.unit), v)
        assert pa.fantasy_active(0) == 0
        assert pa.engine.n(0) == pb.engine.n(0)
        assert_slots_equal(pa, 0, pb, 0, "after rollback")


def test_ask_q_checkpoint_mid_fantasy_snapshots_only_real_state():
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        pa, pb = _twin_pools(d1, d2)
        trials = pa.ask_q(0, 3)
        rb0 = pa.fantasy_rollbacks
        assert pa.checkpoint() is not None
        assert pa.fantasy_active(0) == 3
        assert pa.fantasy_rollbacks == rb0 + 1
        pr = _pool(_cfg(d1, n_max=48))
        assert pr.restore()
        assert pr.fantasy_active(0) == 0 and pr.engine.n(0) == 3
        assert_slots_equal(pr, 0, pb, 0, "after restore")
        for tr in trials:
            pr.absorb(0, _foreign_trial(tr.unit), obj(0, tr.unit))
        assert pr.engine.n(0) == 6


def test_escalated_pool_checkpoint_restore_is_exact():
    def mk(d):
        return _pool(_cfg(d, n_max=6, neural=NB))
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        pa, pb = mk(d1), mk(d2)
        rng = np.random.RandomState(11)
        for i in range(6):                       # fill to n_max, twinned
            u = rng.rand(3).astype(np.float32)
            v = obj(0, u)
            pa.absorb(0, _foreign_trial(u), v, cost=1.0 + 0.25 * i)
            pb.absorb(0, _foreign_trial(u), v, cost=1.0 + 0.25 * i)
        pa.promote(0), pb.promote(0)
        assert pa.tier(0) == 1 and pa.engine.nb_n(0) == 6
        for i in range(2):                       # tier absorbs, twinned
            u = rng.rand(3).astype(np.float32)
            v = obj(0, u)
            pa.absorb(0, _foreign_trial(u), v, cost=3.0)
            pb.absorb(0, _foreign_trial(u), v, cost=3.0)
        trials = pa.ask_q(0, 3)
        assert pa.fantasy_active(0) == 3 and pa.n_real(0) == 8
        for tr in trials:
            v = obj(0, tr.unit)
            pa.absorb(0, tr, v)
            pb.absorb(0, _foreign_trial(tr.unit), v)
        assert pa.fantasy_active(0) == 0
        assert nb_mod.nb_to_json(pa.engine.nb_state(0)) == \
            nb_mod.nb_to_json(pb.engine.nb_state(0))
        pending = pa.ask_q(0, 2)
        assert pa.checkpoint() is not None
        assert pa.fantasy_active(0) == 2
        pr = mk(d1)
        assert pr.restore()
        assert pr.tier(0) == 1 and pr.engine.nb_n(0) == 11
        assert pr.fantasy_active(0) == 0
        np.testing.assert_array_equal(pr.engine.cost_row(0),
                                      pb.engine.cost_row(0))
        assert nb_mod.nb_to_json(pr.engine.nb_state(0)) == \
            nb_mod.nb_to_json(pb.engine.nb_state(0))
        more = pr.ask_q(0, 2)
        assert len(more) == 2 and pr.fantasy_active(0) == 2
        for tr in more + pending:
            pr.absorb(0, _foreign_trial(tr.unit), obj(0, tr.unit))
        assert pr.engine.nb_n(0) == 15


def test_materialize_fault_leaves_ledger_unflipped(monkeypatch):
    """A device error surfacing at `finish()`'s materialization happens
    before any ledger flip: the told trials stay pending."""
    from repro_torch.hpo import pool as pool_mod
    with tempfile.TemporaryDirectory() as d:
        pool = _pool(_cfg(d), 2)
        first = pool.suggest_all()
        events = [(s, trs[0], obj(s, trs[0].unit)) for s, trs in
                  first.items()]
        pool.absorb_many(events)
        second = pool.suggest_all()
        events = [(s, trs[0], obj(s, trs[0].unit)) for s, trs in
                  second.items()]
        pending = pool.advance_round_begin(events)

        def boom(x):
            raise RuntimeError("device fault")
        monkeypatch.setattr(pool_mod, "_materialize", boom)
        with pytest.raises(RuntimeError, match="device fault"):
            pending.finish()
        assert all(tr.status == "pending" for _, tr, _ in events)
