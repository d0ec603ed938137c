"""The port's acquisition (EI, the fused and the autodiff step, the
multi-start ascent and its tie-break) against the JAX package on a
reference state carried over bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import j, n, seeded_states, t

from repro.core import acquisition as jacqm
from repro.core.kernels import matern52 as jmatern52
from repro_torch.core import acquisition as acqm
from repro_torch.core.kernels import matern52

N_MAX, DIM, N0 = 32, 4, 11
EI_TOL = dict(rtol=1e-4, atol=1e-5)      # tests/test_fused_acq.py:65


@pytest.fixture(scope="module")
def pair():
    return seeded_states(np.random.default_rng(0), N0, DIM, N_MAX)


@pytest.mark.parametrize("fused", [True, False])
def test_ei_value_and_grad(pair, fused):
    js, ts = pair
    x = np.random.default_rng(3).uniform(size=(13, DIM)).astype(np.float32)
    vw, gw = jacqm.ei_value_and_grad(js, jmatern52, j(x), implementation="xla",
                                     fused=False)
    vg, gg = acqm.ei_value_and_grad(ts, matern52, t(x), fused=fused)
    np.testing.assert_allclose(n(vg), n(vw), **EI_TOL)
    np.testing.assert_allclose(n(gg), n(gw), **EI_TOL)


def test_fused_matches_unfused_within_port(pair):
    _, ts = pair
    x = torch.rand((17, DIM), generator=torch.Generator().manual_seed(4))
    vf, gf = acqm.ei_value_and_grad(ts, matern52, x, fused=True)
    vu, gu = acqm.ei_value_and_grad(ts, matern52, x, fused=False)
    np.testing.assert_allclose(n(vf), n(vu), **EI_TOL)
    np.testing.assert_allclose(n(gf), n(gu), **EI_TOL)


@pytest.mark.parametrize("top_t,fused", [(1, "auto"), (3, "auto"), (1, "off")])
def test_optimize_acquisition_with_reference_seeds(pair, top_t, fused):
    """Given the reference's own restart seeds (and backfill jitter), the
    port's ascent lands on the same points."""
    js, ts = pair
    key = jax.random.PRNGKey(5)
    cfg_j = jacqm.AcqConfig(restarts=8, ascent_steps=6, fused=fused)
    cfg_t = acqm.AcqConfig(restarts=8, ascent_steps=6, fused=fused)
    lo, hi = np.zeros(DIM, np.float32), np.ones(DIM, np.float32)
    pw, vw = jacqm.optimize_acquisition(js, jmatern52, j(lo), j(hi), key, cfg_j,
                                        top_t, implementation="xla")
    seeds = jax.random.uniform(key, (cfg_j.restarts, DIM), dtype=jnp.float32)
    jitter = jax.random.normal(jax.random.fold_in(key, 1), (top_t, DIM),
                               dtype=jnp.float32)
    pg, vg = acqm.optimize_acquisition(ts, matern52, t(lo), t(hi), cfg_t, top_t,
                                       seeds=t(seeds), jitter=t(jitter))
    np.testing.assert_allclose(n(pg), n(pw), atol=1e-4)
    np.testing.assert_allclose(n(vg), n(vw), **EI_TOL)


def test_quantize_for_tiebreak_is_bitwise():
    rng = np.random.default_rng(6)
    vals = np.concatenate([rng.standard_normal(200) * 10.0 ** rng.integers(
        -30, 30, 200), [0.0, -0.0, 1e-45, np.inf, -np.inf]]).astype(np.float32)
    want = n(jacqm._quantize_for_tiebreak(j(vals))).view(np.uint32)
    got = n(acqm._quantize_for_tiebreak(t(vals))).view(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_expected_improvement_matches(pair):
    rng = np.random.default_rng(7)
    mean = rng.standard_normal(50).astype(np.float32)
    var = np.abs(rng.standard_normal(50)).astype(np.float32)
    var[:5] = 0.0
    want = jacqm.expected_improvement(j(mean), j(var), jnp.float32(0.2))
    got = acqm.expected_improvement(t(mean), t(var), torch.tensor(0.2))
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        n(acqm.upper_confidence_bound(t(mean), t(var), None)),
        n(jacqm.upper_confidence_bound(j(mean), j(var), None)), rtol=1e-6)


def _unit_gp_state():
    """tests/test_tier.py:361's state (6 points of -|x - 0.5|^2 on the
    unit square, noise 1e-6, refactored), in both packages."""
    import dataclasses

    from _torch_port import CPU, jax_state_leaves

    from repro.core import gp as jgp
    from repro_torch import convert
    xs = jax.random.uniform(jax.random.PRNGKey(0), (6, 2))
    ys = -jnp.sum((xs - 0.5) ** 2, axis=-1)
    st = jgp.init_state(jgp.GPConfig(n_max=16, dim=2, noise2=1e-6))
    st = dataclasses.replace(st, x_buf=st.x_buf.at[:6].set(xs),
                             y_buf=st.y_buf.at[:6].set(ys),
                             n=jnp.asarray(6, jnp.int32))
    st = jgp.refactor(st, jmatern52)
    return st, convert.state_from_numpy(jax_state_leaves(st), device=CPU)


def test_ei_per_cost_steers_away_from_expensive_region():
    """Mirror of tests/test_tier.py:372: with a log-cost head that makes the
    half x0 > 0.5 exponentially expensive, the cost-scaled ascent (the
    autodiff one: the fused kernel covers plain EI only) lands in the cheap
    half, as the reference's does from the same seeds; without a cost head
    "ei_per_cost" is plain EI, bit for bit."""
    js, ts = _unit_gp_state()
    key = jax.random.PRNGKey(42)
    seeds = t(jax.random.uniform(key, (16, 2)))
    kw = dict(restarts=16, ascent_steps=12)
    lo, hi = torch.zeros(2), torch.ones(2)

    def log_cost(x):
        return 12.0 * torch.clamp(x[..., 0] - 0.5, min=0.0)

    def jlog_cost(x):
        return 12.0 * jnp.maximum(x[..., 0] - 0.5, 0.0)

    acq = acqm.AcqConfig(name="ei_per_cost", **kw)
    assert not acqm._use_fused(acq, matern52)
    x_cheap, v_cheap = acqm.optimize_acquisition(ts, matern52, lo, hi, acq,
                                                 seeds=seeds,
                                                 log_cost_fn=log_cost)
    assert float(x_cheap[0, 0]) <= 0.5 + 1e-3
    jx, jv = jacqm.optimize_acquisition(
        js, jmatern52, jnp.zeros(2), jnp.ones(2), key,
        jacqm.AcqConfig(name="ei_per_cost", fused="off", **kw),
        log_cost_fn=jlog_cost)
    np.testing.assert_allclose(n(x_cheap), n(jx), atol=1e-4)
    np.testing.assert_allclose(n(v_cheap), n(jv), **EI_TOL)
    x_plain, v_plain = acqm.optimize_acquisition(
        ts, matern52, lo, hi, acqm.AcqConfig(name="ei", fused="off", **kw),
        seeds=seeds)
    x_none, v_none = acqm.optimize_acquisition(ts, matern52, lo, hi, acq,
                                               seeds=seeds)
    assert torch.equal(x_none, x_plain) and torch.equal(v_none, v_plain)
    assert acqm.cost_scaled(torch.tensor(2.0), torch.tensor(100.0)) == \
        2.0 * np.exp(np.float32(-20.0))
