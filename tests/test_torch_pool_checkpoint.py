"""Pool checkpoints across the packages: the JAX package's StudyPool
restores a port pool's snapshot and the port's restores the reference's,
each with the GP tree bit for bit (the reference's leaf names, stacked),
the ledgers equal and the next seed trials identical (the numpy streams'
`rng_state` rides the snapshot in both)."""
import json
import os

import numpy as np
from _torch_port import scaled_levy

from repro import checkpoint as jckpt
from repro.core.acquisition import AcqConfig as JAcqConfig
from repro.hpo import pool as jpool
from repro.hpo import space as jspace
from repro_torch import convert
from repro_torch.core.acquisition import AcqConfig
from repro_torch.hpo.pool import SchedulerConfig, StudyPool
from repro_torch.hpo.space import RESNET_SPACE

S, N_MAX = 3, 16


def _value(unit):
    return float(scaled_levy(np.asarray(unit)[None])[0])


def _jpool(d):
    return jpool.StudyPool([jspace.RESNET_SPACE] * S, jpool.SchedulerConfig(
        n_max=N_MAX, lag=3, seed=0, ckpt_dir=d, ckpt_every=10_000,
        implementation="xla", acq=JAcqConfig(restarts=8, ascent_steps=4)))


def _tpool(d):
    return StudyPool([RESNET_SPACE] * S, SchedulerConfig(
        n_max=N_MAX, lag=3, seed=0, ckpt_dir=d, ckpt_every=10_000,
        acq=AcqConfig(restarts=8, ascent_steps=4)), device="cpu")


def _drive(pool, rounds):
    """Seed, then serving rounds; study 2 sits out the last round."""
    out = pool.suggest_all(t=2)
    for r in range(rounds):
        events = [(s, tr, _value(tr.unit)) for s, trs in out.items()
                  for tr in trs if not (s == 2 and r == rounds - 1)]
        out = pool.advance_round(events)


def _jax_tree(pool) -> dict:
    from repro.checkpoint.store import _flatten_with_paths
    import dataclasses
    names, leaves, _ = _flatten_with_paths(dataclasses.asdict(
        pool.engine.state))
    return {k: np.asarray(v) for k, v in zip(names, leaves)}


def _ledger(pool, s):
    return [(t["trial_id"], t["unit"], t["hparams"], t["status"], t["value"],
             t["clamp_count"], t["retries"], t["cost"], t["started"],
             t["finished"]) for t in pool.history(s)]


def _manifest_names(d):
    step = jckpt.latest_step(d)
    with open(os.path.join(d, f"step_{step:09d}", "manifest.json")) as f:
        return json.load(f)["names"]


def test_reference_pool_restores_a_port_checkpoint(tmp_path):
    d = str(tmp_path)
    tp = _tpool(d)
    _drive(tp, 4)
    tp.ask_q(1, 2)                 # fantasies out: the snapshot is real
    assert tp.checkpoint() is not None
    assert _manifest_names(d) == list(convert.POOL_KEYS)
    jp = _jpool(d)
    assert jp.restore()
    got = _jax_tree(jp)
    tp.release_fantasies(1, [u for u in tp._fantasies[1]])
    want = convert.pool_tree_to_numpy(tp.engine.state)
    assert list(got) == list(convert.POOL_KEYS)
    for k in convert.POOL_KEYS:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k
    for s in range(S):
        assert _ledger(jp, s) == _ledger(tp, s)
        assert jp.engine.n(s) == tp.engine.n(s)
        a = [t.unit for t in jp.seed_trials(s, 2)]
        b = [t.unit for t in tp.seed_trials(s, 2)]
        np.testing.assert_array_equal(np.stack(a), np.stack(b))


def test_port_pool_restores_a_reference_checkpoint(tmp_path):
    d = str(tmp_path)
    jp = _jpool(d)
    _drive(jp, 4)
    assert jp.checkpoint() is not None
    tp = _tpool(d)
    gen_before = [h.gen.get_state().clone() for h in tp.studies]
    assert tp.restore()
    got = convert.pool_tree_to_numpy(tp.engine.state)
    want = _jax_tree(jp)
    for k in convert.POOL_KEYS:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k
    for s in range(S):
        assert tp.engine.n(s) == int(jp.engine.n(s))
        assert tp.engine.since_refit(s) == jp.engine.since_refit(s)
        assert _ledger(tp, s) == _ledger(jp, s)
        # no port generator state in the reference's snapshot: kept
        assert (tp.studies[s].gen.get_state() == gen_before[s]).all()
        a = [t.unit for t in tp.seed_trials(s, 2)]
        b = [t.unit for t in jp.seed_trials(s, 2)]
        np.testing.assert_array_equal(np.stack(a), np.stack(b))
    # the restored port pool keeps serving from the restored posteriors
    out = tp.suggest_all()
    assert all(np.isfinite(trs[0].unit).all() for trs in out.values())
    step = tp._n_done
    tp.absorb_many([(s, trs[0], _value(trs[0].unit))
                    for s, trs in out.items()])
    assert tp.checkpoint().endswith(f"step_{step + S:09d}")
