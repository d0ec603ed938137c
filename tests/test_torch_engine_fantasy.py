"""The port engine's fantasy protocol (`ask_q`, `truncate_slot`,
`refantasize`), float and mixed:

* against the JAX engine (`implementation="xla"`, `mesh="none"`) on the
  same observations and the reference's own draws;
* its rollback against a twin engine that absorbed the same real
  observations and never fantasized: bit for bit on every leaf of every
  lane, alpha included, for the tell orders of tests/test_faults.py:411
  and seeded scripts of asks, tells, foreign tells and releases in the
  manner of tests/test_properties.py:381 (the pool's bookkeeping, at
  engine level).  The reference's own rollback keeps alpha's bits only
  where a real append follows (a release with nothing left to tell leaves
  its recomputed alpha, 1 ulp off), so the pinned script
  ['ask1', 'release', 'tell'] holds the port to more than the reference;
* capacity rejection, which leaves every lane as it was.
"""
import jax
import numpy as np
import pytest
import torch
from _torch_port import (assert_engines_match, engine_draws, jax_space,
                         mixed_space4, n, sine_objective)

from repro.core import acquisition as jacqm
from repro.core import gp as jgp
from repro.hpo import engine as jengine
from repro.hpo import pool as jpool
from repro_torch.core import acquisition as acqm
from repro_torch.core import gp as gp_mod
from repro_torch.hpo import engine as tengine
from repro_torch.hpo import pool as tpool
from repro_torch.hpo.space import Dim, SearchSpace

S, DIM, N_MAX, RESTARTS, STEPS, LAG = 3, 4, 40, 8, 4, 5
SUGGEST_TOL = dict(atol=1e-4)         # tests/test_torch_bayesopt.py:50
EI_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_fused_acq.py:65
MIXED = mixed_space4()
FLOAT = SearchSpace(tuple(Dim(f"x{i}", 0.0, 1.0) for i in range(DIM)))
LAYOUTS = {"float": [FLOAT] * S, "mixed": [MIXED, FLOAT, MIXED]}


def _cfgs(liar="mean", lag=LAG, **kw):
    kw = dict(n_max=N_MAX, lag=lag, **kw)
    acq = dict(restarts=RESTARTS, ascent_steps=STEPS)
    return (jpool.SchedulerConfig(implementation="xla",
                                  acq=jacqm.AcqConfig(**acq),
                                  fantasy=jgp.FantasyConfig(liar), **kw),
            tpool.SchedulerConfig(acq=acqm.AcqConfig(**acq),
                                  fantasy=gp_mod.FantasyConfig(liar), **kw))


def _port(spaces, liar="mean", **kw):
    descs = None
    if any(sp is MIXED for sp in spaces):
        descs = [sp.descriptor() for sp in spaces]
    return tengine.StudyEngine(DIM, _cfgs(liar, **kw)[1], len(spaces), descs,
                               device="cpu")


def _both(spaces, liar="mean"):
    """The reference engine and the port's, fully lazy (lag 0): after a
    grid refit to rho = 0.05, the reference's routed append computed one
    new row's self-covariance k(x, x) as 0.24996 against sigma2 = 0.25
    (the expansion |x|^2 + |x|^2 - 2 x.x kept ~5e-7 of round-off, which
    rho = 0.05 turns into a 1.6e-4 drop), so its factor left TOL there;
    the port's stayed sigma2.  The twins below run with lag refits."""
    jcfg, _ = _cfgs(liar, lag=0)
    descs = None
    if any(sp is MIXED for sp in spaces):
        descs = [jax_space(sp).descriptor() for sp in spaces]
    return (jengine.StudyEngine(DIM, jcfg, len(spaces), descs),
            _port(spaces, liar, lag=0))


def _observe(spaces, rng):
    xs = np.stack([sp.sample(rng, 1)[0] for sp in spaces]).astype(np.float32)
    return xs, sine_objective(xs)


def _prefill(spaces, rng, *engines, rounds=6):
    for r in range(rounds):
        flags = np.array([True, r % 2 == 0, r < rounds - 1])
        xs, ys = _observe(spaces, rng)
        for eng in engines:
            eng.absorb_round(flags, xs, ys)


def _leaf_bytes(eng) -> list[bytes]:
    st = eng.state
    return [n(v).tobytes() for v in gp_mod._leaves(st)] + [
        n(st.n).tobytes(), n(st.since_refit).tobytes(),
        eng._n_host.tobytes(), eng._sr_host.tobytes()]


def assert_bitwise(a, b) -> None:
    """Every leaf of every lane, and the host and device counters, of two
    port engines: the same bytes."""
    names = ["x_buf", "y_buf", "l_buf", "li_buf", "alpha", "clamp_count",
             "sigma2", "rho", "noise2", "n", "since_refit", "n mirror",
             "since_refit mirror"]
    for name, u, v in zip(names, _leaf_bytes(a), _leaf_bytes(b)):
        assert u == v, f"{name} differs"


class Pending:
    """The pool's fantasy bookkeeping for one slot of a port engine
    (src/repro/hpo/pool.py:338-440, at engine level): pending points in
    append order; a tell, foreign or not, rolls the fantasy rows back,
    absorbs, and appends the survivors again; a release drops one."""

    def __init__(self, eng, study: int):
        self.eng, self.study, self.points = eng, study, []

    def ask(self, q: int) -> list[np.ndarray]:
        units, _ = self.eng.ask_q(self.study, q)
        units = n(units)
        assert len({tuple(u) for u in units.tolist()}) == q
        self.points.extend(u.copy() for u in units)
        return list(units)

    def _drop(self, unit) -> None:
        for i, p in enumerate(self.points):
            if np.array_equal(p, unit):
                del self.points[i]
                return

    def _around(self, between) -> None:
        if self.points:
            self.eng.truncate_slot(self.study,
                                   self.eng.n(self.study) - len(self.points))
        between()
        if self.points:
            self.eng.refantasize(self.study, np.stack(self.points))

    def tell(self, unit, y: float) -> None:
        def absorb():
            self._drop(unit)
            self.eng.absorb(self.study, unit, y)
        self._around(absorb)

    def release(self, unit) -> None:
        self._around(lambda: self._drop(unit))


@pytest.mark.parametrize("layout", ["float", "mixed"])
def test_fantasy_routes_match_reference(layout):
    spaces = LAYOUTS[layout]
    rng = np.random.default_rng(0)
    jeng, teng = _both(spaces)
    _prefill(spaces, rng, jeng, teng)
    study, q = 0, 3
    n_real = teng.n(study)
    key = jax.random.PRNGKey(3)
    _, seeds, jitter = engine_draws(key, q, RESTARTS, DIM)
    uj, vj = jeng.ask_q(study, key, q)
    ut, vt = teng.ask_q(study, q, seeds=seeds, jitter=jitter)
    np.testing.assert_allclose(n(ut), n(uj), **SUGGEST_TOL)
    np.testing.assert_allclose(n(vt), n(vj), **EI_TOL)
    np.testing.assert_array_equal(spaces[study].project(n(ut)), n(ut))
    assert teng.n(study) == int(teng.state.n[study]) == n_real + q
    assert teng.since_refit(study) == jeng.since_refit(study)
    assert_engines_match(jeng, teng, pending={study: q})

    # The tell of pick 1: roll back, absorb it, re-append picks 0 and 2
    # (the same points in both engines).
    for eng in (jeng, teng):
        eng.truncate_slot(study, n_real)
    assert_engines_match(jeng, teng)
    x = n(ut[1])
    y = float(sine_objective(x))
    pend = np.stack([n(ut[0]), n(ut[2])])
    for eng in (jeng, teng):
        eng.absorb(study, x, y)
        eng.refantasize(study, pend)
    assert_engines_match(jeng, teng, pending={study: 2})
    # A second slot asks too; the first rolls back again.
    key, sub = jax.random.split(key)
    _, seeds, jitter = engine_draws(sub, 1, RESTARTS, DIM)
    u1j, _ = jeng.ask_q(1, sub, 1)
    u1t, _ = teng.ask_q(1, 1, seeds=seeds, jitter=jitter)
    np.testing.assert_allclose(n(u1t), n(u1j), **SUGGEST_TOL)
    assert_engines_match(jeng, teng, pending={study: 2, 1: 1})
    for eng in (jeng, teng):
        eng.truncate_slot(study, n_real + 1)
        eng.truncate_slot(1, eng.n(1) - 1)
    assert_engines_match(jeng, teng)
    # Served on: the next round matches as it did before the fantasies.
    keys, seeds, jitter = engine_draws(jax.random.PRNGKey(5), S, RESTARTS,
                                       DIM)
    xs, ys = _observe(spaces, rng)
    uj, vj = jeng.advance(np.ones(S, bool), xs, ys, keys)
    ut, vt = teng.advance(np.ones(S, bool), xs, ys, seeds=seeds,
                          jitter=jitter)
    np.testing.assert_allclose(n(ut), n(uj), **SUGGEST_TOL)
    assert_engines_match(jeng, teng)


def test_pessimistic_liar_matches_reference():
    spaces = LAYOUTS["float"]
    rng = np.random.default_rng(1)
    jeng, teng = _both(spaces, liar="pessimistic")
    _prefill(spaces, rng, jeng, teng)
    assert teng.liar == "pessimistic"
    key = jax.random.PRNGKey(6)
    _, seeds, jitter = engine_draws(key, 3, RESTARTS, DIM)
    uj, vj = jeng.ask_q(2, key, 3)
    ut, vt = teng.ask_q(2, 3, seeds=seeds, jitter=jitter)
    np.testing.assert_allclose(n(ut), n(uj), **SUGGEST_TOL)
    np.testing.assert_allclose(n(vt), n(vj), **EI_TOL)
    assert_engines_match(jeng, teng, pending={2: 3})
    worst = float(n(teng.study_state(2).y_buf[:teng.n(2) - 3]).max())
    assert np.all(n(teng.study_state(2).y_buf[teng.n(2) - 3:teng.n(2)])
                  == worst)


def _twins(layout, rng):
    spaces = LAYOUTS[layout]
    a, b = _port(spaces), _port(spaces)
    _prefill(spaces, rng, a, b, rounds=4)
    assert_bitwise(a, b)
    return spaces, a, b


def value(u) -> float:
    """tests/test_properties.py:395's objective."""
    return float(-np.sum((np.asarray(u) - 0.3) ** 2))


@pytest.mark.parametrize("layout", ["float", "mixed"])
@pytest.mark.parametrize("order", [[0, 1, 2, 3], [2, 0, 3, 1], [1, 3]],
                         ids=["in_order", "out_of_order", "partial"])
def test_tell_orders_roll_back_bitwise(order, layout):
    """tests/test_faults.py:411 at engine level: ask(4); the tells arrive
    in any order, any subset (the rest after one more ask(2)); the engine
    ends bit for bit the twin that took the same tells and no fantasies."""
    _, a, b = _twins(layout, np.random.default_rng(2))
    slot = Pending(a, 0)
    asked = slot.ask(4)
    for i in order:
        slot.tell(asked[i], value(asked[i]))
        b.absorb(0, asked[i], value(asked[i]))
    rest = [asked[i] for i in range(4) if i not in order]
    if rest:
        for u in rest + slot.ask(2):
            slot.tell(u, value(u))
            b.absorb(0, u, value(u))
    assert not slot.points and a.n(0) == b.n(0)
    assert_bitwise(a, b)


SCRIPT_OPS = ["ask1", "ask2", "ask3", "tell", "foreign", "release"]
SCRIPTS = [["ask1", "release", "tell"]] + [
    list(np.random.default_rng(seed).choice(SCRIPT_OPS, size=size))
    for seed, size in ((0, 6), (1, 10), (2, 8), (3, 10), (4, 5))]


@pytest.mark.parametrize("layout", ["float", "mixed"])
@pytest.mark.parametrize("script", SCRIPTS, ids=lambda s: "-".join(s))
def test_scripted_interleavings_roll_back_bitwise(script, layout):
    """tests/test_properties.py:381 at engine level: asks, tells of
    pending points out of order, foreign tells and releases, then a drain
    of every survivor; every leaf of every lane ends as the twin's, alpha
    included (the first script is the one that leaves the reference's
    alpha 1 ulp off)."""
    spaces, a, b = _twins(layout, np.random.default_rng(3))
    rng = np.random.RandomState(sum(map(len, script)))
    slot, pending = Pending(a, 0), []
    for op in script:
        if op.startswith("ask"):
            q = int(op[3:])
            if a.n(0) + q <= N_MAX:
                pending.extend(slot.ask(q))
        elif op == "tell" and pending:
            u = pending.pop(rng.randint(len(pending)))
            slot.tell(u, value(u))
            b.absorb(0, u, value(u))
        elif op == "foreign":
            u = spaces[0].sample(np.random.default_rng(rng.randint(1 << 30)),
                                 1)[0]
            slot.tell(u, value(u))
            b.absorb(0, u, value(u))
        elif op == "release" and pending:
            slot.release(pending.pop(rng.randint(len(pending))))
        assert a.n(0) - len(slot.points) == b.n(0)
    while pending:
        u = pending.pop(rng.randint(len(pending)))
        slot.tell(u, value(u))
        b.absorb(0, u, value(u))
    assert not slot.points
    assert_bitwise(a, b)


@pytest.mark.parametrize("layout", ["float", "mixed"])
def test_rollback_alone_restores_every_bit(layout):
    """ask_q then truncate_slot to the real count, with no real append
    between: every leaf as before the ask; a truncate to another count
    recomputes alpha (as `gp.truncate` does) and drops the kept copy."""
    _, a, b = _twins(layout, np.random.default_rng(4))
    a.ask_q(1, 3)
    a.refantasize(1, n(a.ask_q(1, 2)[0]))      # fantasies on fantasies
    a.truncate_slot(1, b.n(1))
    assert_bitwise(a, b)
    a.ask_q(1, 3)
    a.truncate_slot(1, b.n(1) + 1)             # partial: recomputed alpha
    a.truncate_slot(1, b.n(1))                 # back to the real count
    assert_bitwise(a, b)
    a.ask_q(1, 2)
    a.truncate_slot(1, b.n(1) - 1)             # below it: a real row goes
    b.truncate_slot(1, b.n(1) - 1)
    assert_bitwise(a, b)
    with pytest.raises(ValueError, match="truncate to"):
        a.truncate_slot(1, a.n(1) + 1)


@pytest.mark.parametrize("layout", ["float", "mixed"])
def test_capacity_rejection_leaves_every_lane(layout):
    spaces, a, b = _twins(layout, np.random.default_rng(5))
    room = N_MAX - a.n(0)
    for call in (lambda: a.ask_q(0, room + 1),
                 lambda: a.refantasize(0, spaces[0].sample(
                     np.random.default_rng(6), room + 1))):
        with pytest.raises(gp_mod.GPCapacityError):
            call()
        assert_bitwise(a, b)
    a.ask_q(0, room)                           # exactly full
    assert a.n(0) == N_MAX
    with pytest.raises(gp_mod.StudySaturatedError):
        a.ask_q(0, 1)
    a.truncate_slot(0, b.n(0))
    assert_bitwise(a, b)
    with pytest.raises(ValueError, match="q must be"):
        a.ask_q(0, 0)
    assert_bitwise(a, b)


def test_draws_come_from_the_engine_generator():
    """Without explicit draws, ask_q takes them from the engine's
    generator (seeded from cfg.seed): two engines alike ask alike."""
    a, b = _port(LAYOUTS["float"], seed=7), _port(LAYOUTS["float"], seed=7)
    _prefill(LAYOUTS["float"], np.random.default_rng(7), a, b, rounds=3)
    ua, va = a.ask_q(1, 2)
    ub, vb = b.ask_q(1, 2)
    assert torch.equal(ua, ub) and torch.equal(va, vb)
    assert_bitwise(a, b)
