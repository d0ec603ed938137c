"""The port's padded-state ops against `repro.kernels.ops` on shared
buffers at heterogeneous active counts (the factor and the inverse also
batched, as the lag refit runs them), and the state conversion between the
two packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import j, jax_state_leaves, lower_factor, n, seeded_states, t

from repro.core import gp as jgp
from repro.core.kernels import KernelParams as JParams
from repro.core.kernels import matern52 as jmatern52
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core.kernels import KernelParams, matern52
from repro_torch.kernels import ops, ref

N_MAX, DIM = 24, 3
COUNTS = (5, 11, 17)
TOL = dict(rtol=2e-4, atol=2e-4)      # the solve / factor tolerance family


@pytest.fixture(scope="module")
def states():
    """Three seeded studies with heterogeneous n, in both packages."""
    rng = np.random.default_rng(0)
    return [seeded_states(rng, c, DIM, N_MAX) for c in COUNTS]


def _stack(states, leaf):
    return np.stack([n(getattr(js, leaf)) for js, _ in states])


def _params(states):
    vals = [np.stack([n(getattr(js.params, f)) for js, _ in states])
            for f in ("sigma2", "rho", "noise2")]
    return JParams(*(j(v) for v in vals)), KernelParams(*(t(v) for v in vals))


@pytest.mark.parametrize("study", range(len(COUNTS)))
def test_masked_gram(states, study):
    js, ts = states[study]
    want = jops.masked_gram(js.x_buf, js.n, jmatern52, js.params,
                            implementation="pallas")
    got = ops.masked_gram(ts.x_buf, ts.n, matern52, ts.params)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("batched", [False, True])
def test_padded_cholesky_and_tri_inverse(states, batched):
    jp, _ = _params(states)
    xb = _stack(states, "x_buf")
    k = n(jops.masked_gram(j(xb), jnp.asarray(COUNTS), jmatern52, jp,
                           implementation="xla"))
    if not batched:
        k = k[2]
    want_l = jops.padded_cholesky(j(k), implementation="pallas")
    got_l = ops.padded_cholesky(t(k))
    np.testing.assert_allclose(n(got_l), n(want_l), **TOL)
    want_li = jops.padded_tri_inverse(want_l, implementation="pallas")
    got_li = ops.padded_tri_inverse(t(want_l))
    np.testing.assert_allclose(n(got_li), n(want_li), **TOL)


def test_padded_trsv_on_padded_buffer():
    """A right-hand side zero past the active block solves exactly on the
    identity-padded factor, both ways."""
    rng = np.random.default_rng(4)
    l_buf = np.eye(N_MAX, dtype=np.float32)
    l_buf[:13, :13] = lower_factor(rng, 13)
    b = np.zeros((N_MAX, 2), np.float32)
    b[:13] = rng.standard_normal((13, 2))
    for trans in (False, True):
        want = jops.padded_trsv(j(l_buf), j(b), trans=trans, implementation="xla")
        got = ops.padded_trsv(t(l_buf), t(b), trans=trans)
        np.testing.assert_allclose(n(got), n(want), **TOL)
        assert np.all(n(got)[13:] == 0.0)


def _append_inputs(rng, js, cnt):
    """A new point for one study: its padded column, self-covariance and
    residual."""
    x_new = rng.uniform(size=(DIM,)).astype(np.float32)
    p = n(jmatern52(js.x_buf, j(x_new[None]), js.params))[:, 0]
    p = np.where(np.arange(N_MAX) < cnt, p, 0.0).astype(np.float32)
    c = np.float32(1.0 + float(n(js.params.noise2)))
    y = n(js.y_buf).copy()
    y[cnt] = 0.3
    act = np.arange(N_MAX) <= cnt
    resid = np.where(act, y - y[act].mean(), 0.0).astype(np.float32)
    return p, c, resid


@pytest.mark.parametrize("study", range(len(COUNTS)))
def test_padded_append_row_and_lazy_append(states, study):
    rng = np.random.default_rng(1)
    js, cnt = states[study][0], COUNTS[study]
    p, c, resid = _append_inputs(rng, js, cnt)
    l_buf, li_buf = n(js.l_buf), n(js.li_buf)
    jcnt = jnp.asarray(cnt)
    want = jops.padded_append_row(j(l_buf), j(li_buf), j(p), j(c), jcnt)
    got = ops.padded_append_row(t(l_buf), t(li_buf), t(p), t(c), cnt)
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), n(w), **TOL)
    want = jops.lazy_append(j(l_buf), j(li_buf), j(p), j(c), j(resid), jcnt)
    got = ops.lazy_append(t(l_buf), t(li_buf), t(p), t(c), t(resid), cnt)
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), n(w), **TOL)
    # The inputs are the caller's: never written.
    np.testing.assert_array_equal(n(t(l_buf)), l_buf)


@pytest.mark.parametrize("study", range(len(COUNTS)))
def test_lazy_append_rows(states, study):
    rng = np.random.default_rng(2)
    q = 3
    js, cnt = states[study][0], COUNTS[study]
    xs = rng.uniform(size=(q, DIM)).astype(np.float32)
    xb = n(js.x_buf).copy()
    xb[cnt:cnt + q] = xs
    p_all = n(jmatern52(j(xb), j(xs), js.params))
    idx = np.arange(N_MAX)[:, None]
    cols = np.where(idx < cnt + np.arange(q)[None], p_all, 0.0).T
    cs = np.full((q,), 1.0 + float(n(js.params.noise2)), np.float32)
    y = n(js.y_buf).copy()
    y[cnt:cnt + q] = rng.standard_normal(q)
    act = np.arange(N_MAX) < cnt + q
    resid = np.where(act, y - y[act].mean(), 0.0)
    arrs = [np.asarray(a, np.float32) for a in
            (n(js.l_buf), n(js.li_buf), cols, cs, resid)]
    want = jops.lazy_append_rows(*(j(a) for a in arrs), jnp.asarray(cnt))
    got = ops.lazy_append_rows(*(t(a) for a in arrs), cnt)
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), n(w), **TOL)


def test_write_append_row():
    rng = np.random.default_rng(3)
    buf = lower_factor(rng, 8)
    q = rng.standard_normal(8).astype(np.float32)
    want = jops.write_append_row(j(buf), j(q), jnp.float32(0.5), 4)
    got = ops.write_append_row(t(buf), t(q), torch.tensor(0.5), 4)
    np.testing.assert_array_equal(n(got), n(want))


def test_chol_append_and_posterior_solve():
    rng = np.random.default_rng(6)
    l = lower_factor(rng, 50)
    p = (rng.standard_normal(50) * 0.1).astype(np.float32)
    qw, dw = jops.chol_append(j(l), j(p), jnp.float32(3.0), implementation="ref")
    for qg, dg in (ops.chol_append(t(l), t(p), 3.0),
                   ref.chol_append(t(l), t(p), 3.0)):
        np.testing.assert_allclose(n(qg), n(qw), **TOL)
        np.testing.assert_allclose(float(dg), float(dw), rtol=1e-5)
    resid = rng.standard_normal(50).astype(np.float32)
    k_star = rng.uniform(size=(50, 7)).astype(np.float32)
    k_ss = np.full((7,), 2.0, np.float32)
    mw, vw = jops.gp_posterior_solve(j(l), j(resid), j(k_star), j(k_ss),
                                     implementation="ref")
    for mg, vg in (ops.gp_posterior_solve(t(l), t(resid), t(k_star), t(k_ss)),
                   ref.gp_posterior_solve(t(l), t(resid), t(k_star), t(k_ss))):
        np.testing.assert_allclose(n(mg), n(mw), rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(n(vg), n(vw), rtol=1e-3, atol=1e-3)


def test_convert_round_trips_jax_state_bit_for_bit():
    rng = np.random.default_rng(8)
    js, _ = seeded_states(rng, 7, DIM, N_MAX)
    js = jgp.append(js, jmatern52, j(rng.uniform(size=DIM)), jnp.float32(0.5),
                    implementation="xla")
    leaves = jax_state_leaves(js)
    assert sorted(leaves) == sorted(convert.KEYS)
    back = convert.state_to_numpy(convert.state_from_numpy(leaves, "cpu"))
    assert sorted(back) == sorted(leaves)
    for k, v in leaves.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
