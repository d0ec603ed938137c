"""The port's stacked `StudyEngine` in mixed mode against the JAX
package's (`implementation="xla"`, `mesh="none"`): studies with different
type layouts (an Int + Categorical space and an all-continuous one of the
same width) in one engine, advancing in the same launches, on the same
numpy observations and the reference's own restart draws.  Covers the
batched and routed paths, the lag refit and the re-anchor, a slot's
layout swap (`set_desc`), every suggestion on its study's lattice, and the
stacked descriptor carried across the packages by `convert`."""
import jax
import numpy as np
import pytest
from _torch_port import (CPU, assert_engines_match, engine_draws,
                         jax_state_leaves, n, scaled_levy)

from repro.core import acquisition as jacqm
from repro.hpo import engine as jengine
from repro.hpo import pool as jpool
from repro.hpo import space as jspace
from repro_torch import convert
from repro_torch.core import acquisition as acqm
from repro_torch.hpo import engine as tengine
from repro_torch.hpo import pool as tpool
from repro_torch.hpo.space import (Categorical, Dim, Int, SearchSpace,
                                   space_to_dicts)

S, DIM, N_MAX, RESTARTS, STEPS, LAG = 3, 4, 24, 8, 4, 3
SUGGEST_TOL = dict(atol=1e-4)       # tests/test_torch_bayesopt.py:50
EI_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_fused_acq.py:65
MIXED = SearchSpace((Dim("a", 0.0, 1.0), Int("k", 0, 3),
                     Categorical("c", ("p", "q"))))          # width 4
FLOAT = SearchSpace(tuple(Dim(f"x{i}", 0.0, 1.0) for i in range(DIM)))


def _jdesc(space):
    return jspace.space_from_dicts(space_to_dicts(space)).descriptor()


def _engines(spaces, lag=LAG, inv_refresh=128):
    """The reference engine and the port's over the same per-study
    layouts."""
    kw = dict(n_max=N_MAX, lag=lag, inv_refresh=inv_refresh)
    jcfg = jpool.SchedulerConfig(implementation="xla", acq=jacqm.AcqConfig(
        restarts=RESTARTS, ascent_steps=STEPS), **kw)
    tcfg = tpool.SchedulerConfig(acq=acqm.AcqConfig(
        restarts=RESTARTS, ascent_steps=STEPS), **kw)
    jeng = jengine.StudyEngine(DIM, jcfg, S, [_jdesc(sp) for sp in spaces])
    teng = tengine.StudyEngine(DIM, tcfg, S,
                               [sp.descriptor() for sp in spaces],
                               device="cpu")
    assert jeng.mixed and teng.mixed
    return jeng, teng


def _observe(spaces, rng):
    """One feasible point per study, from its own layout."""
    xs = np.stack([sp.sample(rng, 1)[0] for sp in spaces]).astype(np.float32)
    return xs, scaled_levy(xs)


def _prefill(jeng, teng, spaces, rng, rounds=6):
    for r in range(rounds):
        flags = np.array([True, r % 2 == 0, r < rounds - 1])
        xs, ys = _observe(spaces, rng)
        jeng.absorb_round(flags, xs, ys)
        teng.absorb_round(flags, xs, ys)


def _on_lattice(units, spaces) -> int:
    """Points off their study's lattice (`space.project(u) == u` fails)."""
    u = n(units)
    return sum(int((sp.project(u[s]) != u[s]).any(axis=-1).sum())
               for s, sp in enumerate(spaces))


def _advance_both(jeng, teng, spaces, rng, key, flags, top_t=1):
    key, sub = jax.random.split(key)
    keys, seeds, jitter = engine_draws(sub, S, RESTARTS, DIM, top_t)
    xs, ys = _observe(spaces, rng)
    uj, vj = jeng.advance(flags, xs, ys, keys, top_t=top_t)
    ut, vt = teng.advance(flags, xs, ys, top_t=top_t, seeds=seeds,
                          jitter=jitter)
    np.testing.assert_allclose(n(ut), n(uj), **SUGGEST_TOL)
    np.testing.assert_allclose(n(vt), n(vj), **EI_TOL)
    assert _on_lattice(ut, spaces) == 0
    return key


def test_heterogeneous_layouts_match_reference():
    spaces = [MIXED, FLOAT, MIXED]
    rng = np.random.default_rng(0)
    jeng, teng = _engines(spaces)
    _prefill(jeng, teng, spaces, rng)
    assert_engines_match(jeng, teng)
    key = jax.random.PRNGKey(1)
    for flags in ([True, True, True], [True, False, True],
                  [False, True, True]):
        key = _advance_both(jeng, teng, spaces, rng, key, np.array(flags))
    assert_engines_match(jeng, teng)
    # New tenants in slots 1 and 2 swap their layouts, as a gateway swaps
    # one in: the slot blanked, its descriptor row written (no rebuild).
    spaces = [MIXED, MIXED, FLOAT]
    kernel, desc = teng.kernel, teng.desc
    for eng, d1, d2 in ((jeng, _jdesc(MIXED), _jdesc(FLOAT)),
                        (teng, MIXED.descriptor(), FLOAT.descriptor())):
        for slot, dsc in ((1, d1), (2, d2)):
            eng.reset_slot(slot)
            eng.set_desc(slot, dsc)
    assert teng.kernel is kernel and teng.desc is desc
    np.testing.assert_array_equal(n(teng.desc.cat_mask),
                                  n(jeng.desc.cat_mask))
    for flags in ([True, True, True], [True, True, True], [False, True, True]):
        key = _advance_both(jeng, teng, spaces, rng, key, np.array(flags))
    assert_engines_match(jeng, teng)
    assert teng.since_refit(0) < teng.n(0) and teng.n(1) == teng.n(2) == 3


def test_routed_paths_and_reanchor_match_reference():
    spaces = [MIXED, FLOAT, MIXED]
    rng = np.random.default_rng(2)
    jeng, teng = _engines(spaces, lag=0, inv_refresh=4)
    _prefill(jeng, teng, spaces, rng, rounds=5)
    key = jax.random.PRNGKey(3)
    for study in (0, 1, 0, 2, 0):
        xs, ys = _observe(spaces, rng)
        jeng.absorb(study, xs[study], float(ys[study]))
        teng.absorb(study, xs[study], float(ys[study]))
        key, sub = jax.random.split(key)
        seeds = np.asarray(jax.random.uniform(sub, (RESTARTS, DIM)))
        uj, vj = jeng.suggest(study, sub)
        ut, vt = teng.suggest(study, seeds=seeds)
        np.testing.assert_allclose(n(ut), n(uj), **SUGGEST_TOL)
        np.testing.assert_allclose(n(vt), n(vj), **EI_TOL)
        assert _on_lattice(ut[None], spaces[study:study + 1]) == 0
    assert_engines_match(jeng, teng)
    assert teng.since_refit(0) < teng.n(0) - 4       # re-anchored
    _advance_both(jeng, teng, spaces, rng, key, np.ones(S, bool), top_t=2)
    assert_engines_match(jeng, teng)


def test_set_desc_on_a_float_engine():
    cfg = tpool.SchedulerConfig(n_max=8)
    teng = tengine.StudyEngine(DIM, cfg, 2, device="cpu")
    assert not teng.mixed and teng.desc is None
    teng.set_desc(0, FLOAT.descriptor())             # all-continuous: no-op
    with pytest.raises(ValueError, match="without mixed-space support"):
        teng.set_desc(0, MIXED.descriptor())
    forced = tengine.StudyEngine(DIM, tpool.SchedulerConfig(n_max=8,
                                                            mixed=True),
                                 2, device="cpu")
    assert forced.mixed and forced.desc.cont_mask.shape == (2, DIM)
    forced.set_desc(1, MIXED.descriptor())
    np.testing.assert_array_equal(n(forced.desc.cat_mask[1]),
                                  n(MIXED.descriptor().cat_mask))


def test_convert_round_trips_the_stacked_descriptor_and_state():
    spaces = [MIXED, FLOAT, MIXED]
    rng = np.random.default_rng(4)
    jeng, teng = _engines(spaces)
    _prefill(jeng, teng, spaces, rng, rounds=4)
    leaves = jax_state_leaves(jeng.desc)
    got = convert.descriptor_to_numpy(teng.desc)
    assert got.keys() == leaves.keys()
    for k, v in leaves.items():
        assert got[k].shape == (S, DIM)
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    back = convert.descriptor_from_numpy(got, device=CPU)
    assert back.is_batched
    for k in leaves:
        np.testing.assert_array_equal(n(getattr(back, k[1:])),
                                      n(getattr(teng.desc, k[1:])))
    teng.state = convert.state_from_numpy(jax_state_leaves(jeng.state),
                                          device=CPU)
    _advance_both(jeng, teng, spaces, rng, jax.random.PRNGKey(5),
                  np.ones(S, bool))
    assert_engines_match(jeng, teng)
