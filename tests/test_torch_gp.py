"""The port's GP state machine against the JAX package: a reference state
is carried over bit for bit, then the same transitions run in both packages
on the same inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_port import j, n, seeded_states, t

from repro.core import gp as jgp
from repro.core.kernels import KernelParams as JParams
from repro.core.kernels import matern52 as jmatern52
from repro_torch.core import gp
from repro_torch.core.kernels import matern52

N_MAX, DIM, N0 = 32, 4, 11
POST_TOL = dict(rtol=2e-3, atol=5e-4)    # tests/test_substrate_parity.py:63
STATE_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def pair():
    return seeded_states(np.random.default_rng(0), N0, DIM, N_MAX)


def _assert_states_close(ts, js, tol=STATE_TOL):
    assert ts.n == int(js.n) and ts.since_refit == int(js.since_refit)
    assert int(ts.clamp_count) == int(js.clamp_count)
    for leaf in ("x_buf", "y_buf", "l_buf", "li_buf", "alpha"):
        np.testing.assert_allclose(n(getattr(ts, leaf)), n(getattr(js, leaf)),
                                   err_msg=leaf, **tol)


def test_append_and_append_batch(pair):
    js, ts = pair
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(DIM,)).astype(np.float32)
    js1 = jgp.append(js, jmatern52, j(x), jnp.float32(0.7), implementation="xla")
    ts1 = gp.append(ts, matern52, t(x), 0.7)
    _assert_states_close(ts1, js1)
    xs = rng.uniform(size=(4, DIM)).astype(np.float32)
    ys = rng.standard_normal(4).astype(np.float32)
    js2 = jgp.append_batch(js1, jmatern52, j(xs), j(ys), implementation="xla")
    ts2 = gp.append_batch(ts1, matern52, t(xs), t(ys))
    _assert_states_close(ts2, js2)
    # The input state is untouched (transitions never write its buffers).
    np.testing.assert_array_equal(n(ts1.x_buf), n(js1.x_buf))


def test_posterior_and_lml(pair):
    js, ts = pair
    xq = np.random.default_rng(2).uniform(size=(9, DIM)).astype(np.float32)
    mw, vw = jgp.posterior(js, jmatern52, j(xq), implementation="xla")
    mg, vg = gp.posterior(ts, matern52, t(xq))
    np.testing.assert_allclose(n(mg), n(mw), **POST_TOL)
    np.testing.assert_allclose(n(vg), n(vw), **POST_TOL)
    np.testing.assert_allclose(float(gp.log_marginal_likelihood(ts)),
                               float(jgp.log_marginal_likelihood(js)),
                               rtol=1e-4, atol=1e-3)
    # The textbook posterior from a fresh factorization agrees as well.
    x, y = n(js.x_buf)[:N0], n(js.y_buf)[:N0]
    mw, vw = jgp.dense_posterior(j(x), j(y), j(xq), jmatern52, js.params,
                                 implementation="xla")
    mg, vg = gp.dense_posterior(t(x), t(y), t(xq), matern52, ts.params)
    np.testing.assert_allclose(n(mg), n(mw), **POST_TOL)
    np.testing.assert_allclose(n(vg), n(vw), **POST_TOL)


def test_lml_grid_matches_reference_per_candidate(pair):
    """The lag refit scores its 18 candidates as one batch; each score is
    the reference's full-refactor LML under that candidate."""
    js, ts = pair
    cand = np.array([[s2, rho] for rho in (0.05, 0.2, 0.8, 1.6)
                     for s2 in (0.25, 4.0)], np.float32)
    got = n(gp._lml_grid(ts, matern52, t(cand)))
    want = [float(jgp._lml_for(js, jmatern52, JParams(
        sigma2=jnp.float32(s2), rho=jnp.float32(rho), noise2=js.params.noise2),
        implementation="xla")) for s2, rho in cand]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_refactor_and_refit_params(pair):
    js, ts = pair
    pw = jgp.refit_params(js, jmatern52, implementation="xla")
    pg = gp.refit_params(ts, matern52)
    assert float(pg.sigma2) == float(pw.sigma2)
    assert float(pg.rho) == float(pw.rho)
    js1 = jgp.refactor(js, jmatern52, pw, implementation="pallas")
    ts1 = gp.refactor(ts, matern52, pg)
    _assert_states_close(ts1, js1)
    # maybe_refit: not due below the lag, due at it.
    assert gp.maybe_refit(ts, matern52, lag=3) is ts
    due = gp.maybe_refit(gp.append(ts, matern52, t(np.full(DIM, 0.5)), 0.1),
                         matern52, lag=1)
    assert due.since_refit == 0
