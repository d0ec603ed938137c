"""The port engine's neural-basis tier (`promote_slot`, `nb_absorb`,
`nb_suggest`, `nb_ask_q`, `nb_rollback`, `nb_refantasize`,
`clear_nb_slot`, `reset_slot`), float and mixed, against the JAX
`StudyEngine` (`implementation="xla"`, `mesh="none"`) on the same tells and
the reference's own draws, and an engine-level mirror of
tests/test_tier.py:202 (a study served past twice n_max).

Held: the escalated ledger (points, observations, log costs) and the
counters bit for bit; the MLP params, the head's sums and means at
rtol 1e-5 / atol 1e-6; the head's factor by its backward error (its
forward values carry the head's conditioning, see
tests/test_torch_neural_basis.py); suggestions at the port's suggestion
and EI tolerances.  Within the port: the rollback bit for bit to the
pre-ask snapshot, the frozen GP lane bit for bit through the tier's calls
and unflagged rounds.  Observations are 0.002 x the sine objective, so EI
stays out of its float32 lower tail (see that file's EXPLORE_SCALE).
"""
import jax
import numpy as np
import pytest
import torch
from _torch_port import engine_draws, jax_space, mixed_space4, n, \
    sine_objective
from test_torch_neural_basis import (EXPLORE_SCALE, LEDGER, SUMS, TIGHT,
                                     assert_backward_stable, to64)

from repro.core import acquisition as jacqm
from repro.core import gp as jgp
from repro.core import neural_basis as jnb
from repro.hpo import engine as jengine
from repro.hpo import pool as jpool
from repro_torch.core import acquisition as acqm
from repro_torch.core import gp as gp_mod
from repro_torch.core import neural_basis as nb
from repro_torch.hpo import engine as tengine
from repro_torch.hpo import pool as tpool
from repro_torch.hpo.space import Dim, SearchSpace

S, DIM, N_MAX, RESTARTS, STEPS = 3, 4, 12, 8, 6
NB = dict(hidden=16, features=8, refit_every=4, refit_steps=40, cap0=16)
SUGGEST_TOL = dict(atol=1e-4)         # tests/test_torch_bayesopt.py:50
EI_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_fused_acq.py:65
MIXED = mixed_space4()
FLOAT = SearchSpace(tuple(Dim(f"x{i}", 0.0, 1.0) for i in range(DIM)))
LAYOUTS = {"float": [FLOAT] * S, "mixed": [MIXED, FLOAT, MIXED]}


def objective(u) -> np.ndarray:
    return (EXPLORE_SCALE * sine_objective(u)).astype(np.float32)


def _both(spaces, liar="mean"):
    acq = dict(restarts=RESTARTS, ascent_steps=STEPS)
    kw = dict(n_max=N_MAX, lag=0)
    jcfg = jpool.SchedulerConfig(implementation="xla",
                                 acq=jacqm.AcqConfig(**acq),
                                 neural=jnb.NeuralConfig(**NB),
                                 fantasy=jgp.FantasyConfig(liar),
                                 **kw)
    tcfg = tpool.SchedulerConfig(acq=acqm.AcqConfig(**acq),
                                 neural=nb.NeuralConfig(**NB),
                                 fantasy=gp_mod.FantasyConfig(liar), **kw)
    mixed = any(sp is MIXED for sp in spaces)
    jd = [jax_space(sp).descriptor() for sp in spaces] if mixed else None
    td = [sp.descriptor() for sp in spaces] if mixed else None
    return (jengine.StudyEngine(DIM, jcfg, S, jd),
            tengine.StudyEngine(DIM, tcfg, S, td, device="cpu"))


def _fill(spaces, rng, *engines):
    """Slot 0 to n_max with real tells (costs 1..2), the others part way."""
    for r in range(N_MAX):
        xs = np.stack([sp.sample(rng, 1)[0] for sp in spaces]).astype(
            np.float32)
        costs = (1.0 + rng.uniform(size=S)).astype(np.float32)
        flags = np.array([True, r % 2 == 0, r < 5])
        for eng in engines:
            eng.absorb_round(flags, xs, objective(xs), costs)


def _promote(jeng, teng, slot, key):
    """Promote `slot` in both engines from the same MLP params: the
    reference draws them from `key` inside `nb_from_data`; the port takes
    the same draws (`nb_init` at the promotion's capacity)."""
    cfg = jeng.neural
    init = jnb.nb_init(DIM, jnb.nb_capacity(jeng.n(slot), cfg), key, cfg)
    jeng.promote_slot(slot, key)
    teng.promote_slot(slot, params={k: np.asarray(getattr(init, k))
                                    for k in nb.PARAMS})


def assert_tier_matches(jeng, teng, slot):
    js, ts = jeng.nb_state(slot), teng.nb_state(slot)
    assert teng.tier(slot) == jeng.tier(slot) == 1
    assert teng.nb_n(slot) == jeng.nb_n(slot) == int(ts.n)
    assert teng._nb_sr[slot] == int(ts.since_refit)
    for k in LEDGER:
        np.testing.assert_array_equal(n(getattr(ts, k)),
                                      np.asarray(getattr(js, k)), err_msg=k)
    for k in nb.PARAMS + SUMS:
        np.testing.assert_allclose(n(getattr(ts, k)),
                                   np.asarray(getattr(js, k)), **TIGHT,
                                   err_msg=k)
    assert_backward_stable(ts)


def nb_draws(key, dim, top_t=1):
    """The draws of the reference's `nb_suggest` from `key` (it does not
    split the key): seeds (R, d) and the top-t jitter (top_t, d)."""
    return (np.asarray(jax.random.uniform(key, (RESTARTS, dim))),
            np.asarray(jax.random.normal(jax.random.fold_in(key, 1),
                                         (top_t, dim))))


def _lane(eng, slot):
    return [v.clone() for v in gp_mod._leaves(eng.study_state(slot))]


def _same(a, b) -> bool:
    return all(torch.equal(u, v) for u, v in zip(a, b))


def _snapshot(st):
    return {k: getattr(st, k).clone() for k in nb.FIELDS}


def _equal_to(st, snap) -> bool:
    return all(torch.equal(getattr(st, k), v) for k, v in snap.items())


@pytest.mark.parametrize("layout", ["float", "mixed"])
def test_tier_routes_match_reference(layout):
    spaces = LAYOUTS[layout]
    rng = np.random.default_rng(0)
    jeng, teng = _both(spaces)
    _fill(spaces, rng, jeng, teng)
    slot, sp = 0, spaces[0]
    frozen = _lane(teng, slot)
    with pytest.raises(gp_mod.StudySaturatedError):
        teng.ask_q(slot, 1)
    assert _same(_lane(teng, slot), frozen)

    _promote(jeng, teng, slot, jax.random.PRNGKey(7))
    assert_tier_matches(jeng, teng, slot)
    assert teng.nb_state(slot).cap == 32
    # through one refit (refit_every 4): five absorbs with costs
    for i in range(5):
        x = sp.sample(rng, 1)[0].astype(np.float32)
        for eng in (jeng, teng):
            eng.nb_absorb(slot, x, float(objective(x)), cost=1.0 + 0.25 * i)
    assert teng._nb_sr[slot] == 1
    assert_tier_matches(jeng, teng, slot)

    key = jax.random.PRNGKey(8)
    seeds, jitter = nb_draws(key, DIM)
    uj, vj = jeng.nb_suggest(slot, key)
    ut, vt = teng.nb_suggest(slot, seeds=seeds, jitter=jitter)
    np.testing.assert_allclose(n(vt), n(vj), **EI_TOL)
    np.testing.assert_allclose(n(ut), n(uj), **SUGGEST_TOL)
    np.testing.assert_array_equal(sp.project(n(ut)), n(ut))

    # ask_q, then the rollback: bit for bit the pre-ask state
    before = _snapshot(teng.nb_state(slot))
    n_real = teng.nb_n(slot)
    key, q = jax.random.PRNGKey(9), 3
    _, seeds, jitter = engine_draws(key, q, RESTARTS, DIM)
    uj, vj = jeng.nb_ask_q(slot, key, q)
    ut, vt = teng.nb_ask_q(slot, q, seeds=seeds, jitter=jitter)
    np.testing.assert_allclose(n(vt), n(vj), **EI_TOL)
    np.testing.assert_allclose(n(ut[0]), n(uj[0]), **SUGGEST_TOL)
    np.testing.assert_array_equal(sp.project(n(ut)), n(ut))
    assert teng.nb_n(slot) == jeng.nb_n(slot) == n_real + q
    for eng in (jeng, teng):
        eng.nb_rollback(slot)
    assert _equal_to(teng.nb_state(slot), before)
    assert teng.nb_n(slot) == n_real and teng._nb_sr[slot] == 1
    assert_tier_matches(jeng, teng, slot)

    # a tell, then the replay of the still-pending points (the same points
    # in both engines), then a second rollback
    x, pend = n(ut[1]), np.stack([n(ut[0]), n(ut[2])])
    for eng in (jeng, teng):
        eng.nb_absorb(slot, x, float(objective(x)))
    after_tell = _snapshot(teng.nb_state(slot))
    for eng in (jeng, teng):
        eng.nb_refantasize(slot, pend)
    ts, js = teng.nb_state(slot), jeng.nb_state(slot)
    np.testing.assert_array_equal(n(ts.x_buf), np.asarray(js.x_buf))
    assert teng.nb_n(slot) == jeng.nb_n(slot) == n_real + 3
    np.testing.assert_allclose(n(ts.y_buf), np.asarray(js.y_buf),
                               rtol=1e-4, atol=1e-6)
    for eng in (jeng, teng):
        eng.nb_rollback(slot)
    assert _equal_to(teng.nb_state(slot), after_tell)
    assert_tier_matches(jeng, teng, slot)

    # the frozen GP lane: untouched by the tier's calls and by a round with
    # its flag off; a flagged absorb into it is refused before any write
    flags = np.array([False, True, True])
    xs = np.stack([s.sample(rng, 1)[0] for s in spaces]).astype(np.float32)
    teng.advance(flags, xs, objective(xs))
    assert _same(_lane(teng, slot), frozen)
    with pytest.raises(RuntimeError, match="escalated"):
        teng.absorb_round(np.ones(S, bool), xs, objective(xs))
    with pytest.raises(RuntimeError, match="escalated"):
        teng.absorb(slot, xs[0], 0.0)
    assert _same(_lane(teng, slot), frozen)
    with pytest.raises(RuntimeError, match="already escalated"):
        teng.promote_slot(slot)

    # back to the GP tier: clear, and reset (which clears too)
    for eng in (jeng, teng):
        eng.clear_nb_slot(slot)
    assert teng.tier(slot) == jeng.tier(slot) == 0
    np.testing.assert_array_equal(teng.cost_row(slot), jeng.cost_row(slot))
    assert slot not in teng._nb and slot not in teng._nb_shadow
    teng.promote_slot(slot, params=None)
    teng.reset_slot(slot)
    jeng.reset_slot(slot)
    assert teng.tier(slot) == 0 and teng.n(slot) == 0
    assert not teng._nb and not teng._nb_n and not teng._nb_sr


def test_ledger_grows_through_the_engine():
    """Absorbs past the promoted capacity double it (`nb_grow`) in both
    engines, refitting every 4th absorb on the way (six refits of 40 Adam
    steps): the ledger bit for bit, and the MLP params and the head's sums
    within twice the reference's float32 error against the same absorbs
    replayed by the port in float64 (`nb_append` / `nb_refit` / `nb_grow`
    on the promoted state taken to float64 before its first refit)."""
    rng = np.random.default_rng(3)
    jeng, teng = _both(LAYOUTS["float"])
    _fill(LAYOUTS["float"], rng, jeng, teng)
    key = jax.random.PRNGKey(2)
    _promote(jeng, teng, 0, key)
    cfg = teng.neural
    lane = teng.study_state(0)
    costs = teng.cost_row(0)
    cap = teng.nb_state(0).cap
    exact = nb.nb_init(DIM, cap, cfg, params={
        k: np.asarray(getattr(jnb.nb_init(DIM, cap, key, jeng.neural), k))
        for k in nb.PARAMS}, device="cpu")
    pad = cap - N_MAX
    exact = to64(nb._replace(
        exact, x_buf=torch.cat([lane.x_buf, torch.zeros(pad, DIM)]),
        y_buf=torch.cat([lane.y_buf, torch.zeros(pad)]),
        c_buf=torch.cat([torch.from_numpy(np.log(costs[:N_MAX])),
                         torch.zeros(pad)]),
        n=torch.tensor(N_MAX, dtype=torch.int32)))
    exact = nb.nb_refit(exact, cfg)
    for i in range(cap - N_MAX + 1):
        x = rng.uniform(size=DIM).astype(np.float32)
        y = float(objective(x))
        for eng in (jeng, teng):
            eng.nb_absorb(0, x, y)
        if int(exact.n) == exact.cap:
            exact = nb.nb_grow(exact)
        exact = nb.nb_append(exact, torch.from_numpy(x).double(), y, 0.0,
                             cfg)
        if int(exact.since_refit) >= cfg.refit_every:
            exact = nb.nb_refit(exact, cfg)
    ts, js = teng.nb_state(0), jeng.nb_state(0)
    assert ts.cap == js.cap == 2 * cap
    assert teng.nb_n(0) == jeng.nb_n(0) == int(ts.n) == cap + 1
    for k in LEDGER:
        np.testing.assert_array_equal(n(getattr(ts, k)),
                                      np.asarray(getattr(js, k)), err_msg=k)
    for k in nb.PARAMS + SUMS:
        e = getattr(exact, k)
        err = float((getattr(ts, k).double() - e).abs().max())
        ref_err = float((torch.from_numpy(np.asarray(getattr(js, k))).double()
                         - e).abs().max())
        assert err <= 2.0 * ref_err, (k, err, ref_err)
    assert_backward_stable(ts)


def test_pessimistic_liar_and_a_second_ask_keep_the_first_snapshot():
    rng = np.random.default_rng(5)
    jeng, teng = _both(LAYOUTS["float"], liar="pessimistic")
    _fill(LAYOUTS["float"], rng, jeng, teng)
    _promote(jeng, teng, 0, jax.random.PRNGKey(4))
    before = _snapshot(teng.nb_state(0))
    for k in (10, 11):
        key = jax.random.PRNGKey(k)
        _, seeds, jitter = engine_draws(key, 2, RESTARTS, DIM)
        uj, vj = jeng.nb_ask_q(0, key, 2)
        ut, vt = teng.nb_ask_q(0, 2, seeds=seeds, jitter=jitter)
        np.testing.assert_allclose(n(vt), n(vj), **EI_TOL)
    ts, js = teng.nb_state(0), jeng.nb_state(0)
    # the pessimistic liar is the best observation, in both packages
    np.testing.assert_array_equal(n(ts.y_buf), np.asarray(js.y_buf))
    for eng in (jeng, teng):
        eng.nb_rollback(0)
    assert _equal_to(teng.nb_state(0), before)
    assert teng.nb_n(0) == N_MAX
    assert_tier_matches(jeng, teng, 0)


def test_load_nb_slot_and_json_carry_a_reference_state():
    """A reference state installed in a port slot through `nb_from_json`
    serves the reference's suggestion."""
    rng = np.random.default_rng(6)
    jeng, teng = _both(LAYOUTS["float"])
    _fill(LAYOUTS["float"], rng, jeng, teng)
    jeng.promote_slot(0, jax.random.PRNGKey(1))
    teng.load_nb_slot(0, nb.nb_from_json(jnb.nb_to_json(jeng.nb_state(0)),
                                         device="cpu"))
    assert teng.tier(0) == 1 and teng.nb_n(0) == N_MAX
    assert nb.nb_to_json(teng.nb_state(0)) == jnb.nb_to_json(
        jeng.nb_state(0))
    key = jax.random.PRNGKey(3)
    seeds, jitter = nb_draws(key, DIM)
    uj, vj = jeng.nb_suggest(0, key)
    ut, vt = teng.nb_suggest(0, seeds=seeds, jitter=jitter)
    np.testing.assert_allclose(n(vt), n(vj), **EI_TOL)
    np.testing.assert_allclose(n(ut), n(uj), **SUGGEST_TOL)


# ---------------------------------------------------------------------------
# Engine-level mirror of tests/test_tier.py:202: served past 2 x n_max
# ---------------------------------------------------------------------------
def _levy_run(escalate: bool, asks: int = 24, n_max: int = 10):
    """One Levy-4d study (raw values, the reference test's objective) on a
    one-slot port engine: ask, tell, and at n_max promote and go on
    through the tier (or, truncated, stop at the saturation error)."""
    from repro_torch.core.levy import levy_bounds, neg_levy
    lo, hi = (np.asarray(b, np.float64) for b in levy_bounds(4))
    cfg = tpool.SchedulerConfig(
        n_max=n_max, acq=acqm.AcqConfig(restarts=16, ascent_steps=8),
        neural=nb.NeuralConfig(hidden=16, features=8, refit_every=8,
                               refit_steps=40, cap0=16))
    eng = tengine.StudyEngine(4, cfg, 1, device="cpu")
    best, hist = -np.inf, []
    for _ in range(asks):
        tier = eng.tier(0)
        u, _ = eng.nb_suggest(0) if tier else eng.suggest(0)
        u = n(u[0])
        v = float(neg_levy(torch.as_tensor(lo + u * (hi - lo))))
        try:
            if tier:
                eng.nb_absorb(0, u, v)
            else:
                eng.absorb(0, u, v)
        except gp_mod.StudySaturatedError:
            if not escalate:
                break
            eng.promote_slot(0)
            eng.nb_absorb(0, u, v)
        best = max(best, v)
        hist.append(best)
    return best, hist, eng


def test_levy4d_escalated_no_worse_than_truncated_gp():
    esc, esc_hist, eng = _levy_run(escalate=True)
    trunc, trunc_hist, teng = _levy_run(escalate=False)
    assert len(trunc_hist) == 10                 # terminal at n_max
    assert len(esc_hist) == 24                   # served past 2 x n_max
    assert esc_hist[:10] == trunc_hist           # the same path until then
    assert esc >= trunc
    assert eng.tier(0) == 1 and teng.tier(0) == 0
    assert eng.nb_n(0) == 24 and eng.n(0) == 10
