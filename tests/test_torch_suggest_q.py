"""The port's `acquisition.suggest_q` (q ascents, each followed by a
fantasy row) against the JAX package's (`implementation="xla"`), on the
same seeded states and the reference's own draws: its key split into q
keys, each step's restart seeds drawn from one of them
(`_torch_port.engine_draws` makes the same split for q "studies").  Both
liars, float and mixed; the picks at the suggestion tolerance, their EI
values at the fused EI's, the fantasized state at `TOL`.

The states hold `seeded_states`' objective (O(1) values): on 0.05 x Levy
values the mixed mean-liar chain's fourth step starts three restarts where
EI underflows to 0, where the two packages' gradients differ by design
(ROADMAP queue 3, EI underflow), and one of them wins 1.4e-3 apart."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import (TOL, engine_draws, jax_space, levy_states,
                         mixed_space4, n, sine_objective)

from repro.core import acquisition as jacq
from repro.core import gp as jgp
from repro_torch.core import acquisition as tacq
from repro_torch.core import gp as tgp

DIM, N_MAX, N0, Q, RESTARTS, STEPS = 4, 32, 10, 4, 8, 4
SUGGEST_TOL = dict(atol=1e-4)         # tests/test_torch_bayesopt.py:50
EI_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_fused_acq.py:65
MIXED = mixed_space4()


def _setup(mixed: bool, seed: int):
    rng = np.random.default_rng(seed)
    xs = (MIXED.sample(rng, N0) if mixed
          else rng.uniform(size=(N0, DIM)).astype(np.float32))
    jst, tst, jkern, tkern = levy_states(xs, N_MAX, MIXED if mixed else None,
                                         sine_objective)
    descs = ((jax_space(MIXED).descriptor(), MIXED.descriptor()) if mixed
             else (None, None))
    return jst, tst, jkern, tkern, descs


@pytest.mark.parametrize("mixed", [False, True], ids=["float", "mixed"])
@pytest.mark.parametrize("liar", tgp.FANTASY_LIARS)
def test_suggest_q_matches_reference(liar, mixed):
    """The q picks and values against the reference `suggest_q`'s, and
    each step against the reference's step (its scan body:
    `optimize_acquisition(top_t=1)` on its i-th split key, then
    `gp.fantasize` of the pick) from the port's earlier picks, so that the
    fantasized states compare on the same rows."""
    jst, tst, jkern, tkern, (jdesc, tdesc) = _setup(mixed, 0)
    key = jax.random.PRNGKey(11)
    keys = jax.random.split(key, Q)       # the reference's split
    _, seeds, jitter = engine_draws(key, Q, RESTARTS, DIM)
    jcfg = jacq.AcqConfig(restarts=RESTARTS, ascent_steps=STEPS)
    tcfg = tacq.AcqConfig(restarts=RESTARTS, ascent_steps=STEPS)
    lo, hi = np.zeros(DIM, np.float32), np.ones(DIM, np.float32)
    jlo, jhi = jnp.asarray(lo), jnp.asarray(hi)
    before = [v.clone() for v in tgp._leaves(tst)]
    ut, vt, st = tacq.suggest_q(tst, tkern, torch.from_numpy(lo),
                                torch.from_numpy(hi), tcfg, Q, liar=liar,
                                seeds=torch.from_numpy(seeds),
                                jitter=torch.from_numpy(jitter), desc=tdesc)
    assert ut.shape == (Q, DIM) and vt.shape == (Q,)
    js = jst
    for i in range(Q):
        uj, vj = jacq.optimize_acquisition(js, jkern, jlo, jhi, keys[i], jcfg,
                                           1, implementation="xla",
                                           desc=jdesc)
        np.testing.assert_allclose(n(ut[i]), n(uj[0]), **SUGGEST_TOL,
                                   err_msg=f"pick {i}")
        np.testing.assert_allclose(n(vt[i]), n(vj[0]), **EI_TOL,
                                   err_msg=f"value {i}")
        js = jgp.fantasize(js, jkern, jnp.asarray(n(ut[i:i + 1])), liar,
                           implementation="xla")
    uq, vq, _ = jacq.suggest_q(jst, jkern, jlo, jhi, key, jcfg, Q, liar=liar,
                               implementation="xla", desc=jdesc)
    np.testing.assert_allclose(n(ut), n(uq), **SUGGEST_TOL)
    np.testing.assert_allclose(n(vt), n(vq), **EI_TOL)
    # The q picks differ from each other: each step sees the fantasies.
    assert len({tuple(u) for u in n(ut).tolist()}) == Q
    if mixed:
        np.testing.assert_array_equal(MIXED.project(n(ut)), n(ut))
    assert st.n == N0 + Q and st.since_refit == tst.since_refit
    np.testing.assert_array_equal(n(st.clamp_count), n(js.clamp_count))
    np.testing.assert_array_equal(n(st.x_buf), n(js.x_buf))
    for leaf in ("y_buf", "l_buf", "li_buf", "alpha"):
        np.testing.assert_allclose(n(getattr(st, leaf)), n(getattr(js, leaf)),
                                   **TOL, err_msg=leaf)
    # The input state is the caller's unless `in_place`.
    assert all(torch.equal(a, b) for a, b in zip(before, tgp._leaves(tst)))


def test_suggest_q_in_place_draws_and_capacity():
    _, tst, _, tkern, _ = _setup(False, 1)
    cfg = tacq.AcqConfig(restarts=RESTARTS, ascent_steps=STEPS)
    lo, hi = torch.zeros(DIM), torch.ones(DIM)

    def run(state, in_place, seed=5, q=Q):
        gen = torch.Generator().manual_seed(seed)
        return tacq.suggest_q(state, tkern, lo, hi, cfg, q, generator=gen,
                              in_place=in_place)

    ua, va, sa = run(tst, False)
    own = tgp._copy(tst)
    ub, vb, sb = run(own, True)
    assert torch.equal(ua, ub) and torch.equal(va, vb)
    assert sb.l_buf is own.l_buf and sb.n == N0 + Q
    assert all(torch.equal(a, b) for a, b in zip(tgp._leaves(sa),
                                                 tgp._leaves(own)))
    # A single step is the routed suggest and one fantasy row.
    gen = torch.Generator().manual_seed(5)
    u1, v1 = tacq.optimize_acquisition(tst, tkern, lo, hi, cfg, 1,
                                       generator=gen)
    assert torch.equal(u1[0], ua[0]) and torch.equal(v1[0], va[0])
    with pytest.raises(ValueError, match="q must be"):
        run(tst, False, q=0)
    full = tgp._copy(tst)
    with pytest.raises(tgp.StudySaturatedError):
        run(full, True, q=N_MAX - N0 + 1)
    assert all(torch.equal(a, b) for a, b in zip(tgp._leaves(full),
                                                 tgp._leaves(tst)))
