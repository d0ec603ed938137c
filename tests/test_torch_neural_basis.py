"""The port's neural-basis tier (`repro_torch.core.neural_basis`) against
the JAX package's (`repro.core.neural_basis`) on the same numpy inputs and
the same MLP params (the reference's `nb_init` draws).

Tolerances.  Features, the cost head, the posterior on one state, the
head's sums (ptp, pty, ptc, pt1), the means, s2, one Adam step and the
liar values taken against one state are held at rtol 1e-5 / atol 1e-6;
the posterior mean (and a mean liar value) with rtol taken on the scale
of its terms, |y_mean| + |phi| |w_y|: w_y has entries near 14 whose
products with phi cancel to means near 0.1, so the sum's own float32
round-off, in either package, is that scale times a few 2^-24.
The head's factor and weights are not: A = ptp + noise2 I has a condition
number near 1e5 at these sizes (the ridge is 1e-4 against entries of tens),
so an ulp of float32 in ptp, or another LAPACK's order of operations on
the same inputs, moves `chol`'s last pivots and `w_y` / `w_c` by about
kappa 2^-24 of their size in either package.  Those leaves,
and what is computed from them after them (a posterior after a rebuild, a
second fantasy row's liar value), are held to a float64 port run on the
same inputs: within twice the reference's own float32 error there, or
within the perturbation bound 2 kappa(A) 2^-24 max|leaf| of a float32
solve; the factor must also rebuild A (backward error 1e-5).  The 200-step
refit holds the MLP params to the twice-the-reference rule.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import CPU, j, jax_space, mixed_space4, n, t

from repro.core import acquisition as jacqm
from repro.core import neural_basis as jnb
from repro_torch import convert
from repro_torch.core import acquisition as acqm
from repro_torch.core import neural_basis as nb

TIGHT = dict(rtol=1e-5, atol=1e-6)
EI_TOL = dict(rtol=1e-4, atol=1e-5)           # tests/test_fused_acq.py:65
SUGGEST_TOL = dict(atol=1e-4)                 # tests/test_torch_bayesopt.py:50
U32 = 2.0 ** -24
NCFG = jnb.NeuralConfig()
TCFG = nb.NeuralConfig(**dataclasses.asdict(NCFG))
SUMS = ("ptp", "pty", "ptc", "pt1", "y_mean", "c_mean", "s2")
HEAD = ("chol", "w_y", "w_c")
LEDGER = ("x_buf", "y_buf", "c_buf", "n", "since_refit")


def leaves(st) -> dict:
    """A reference state as {field name: numpy leaf}."""
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st)}


def port(st) -> nb.NeuralBasisState:
    """A reference state carried to the port, bit for bit."""
    return convert.nb_state_from_numpy(leaves(st), device=CPU)


def to64(st: nb.NeuralBasisState) -> nb.NeuralBasisState:
    return nb._replace(st, **{k: getattr(st, k).double() for k in nb.FIELDS
                              if k not in nb.COUNTERS})


def ledger(seed: int, n0: int, d: int, scale: float = 1.0):
    """n0 seeded rows on the unit cube: scale (sin(3 sum x) + 0.1 x_0) and a
    log cost of 0.5 x_1."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(size=(n0, d)).astype(np.float32)
    ys = (scale * (np.sin(3.0 * xs.sum(-1)) + 0.1 * xs[:, 0])).astype(
        np.float32)
    return xs, ys, (0.5 * xs[:, 1]).astype(np.float32), rng


# The ascent tests run on values scaled by 0.002, so that the head's
# residual variance sits at its floor (noise2) and EI stays out of its
# float32 lower tail on the whole cube: there the reference's Phi,
# 0.5 (1 + erf), is exactly 0 with a zero gradient while the port's erfc
# form is not (ROADMAP queue 3, EI underflow), and the restarts of the two
# packages would part there by design.  Z is unchanged by the scale
# until s2 reaches the floor.
EXPLORE_SCALE = 0.002


@pytest.fixture(scope="module")
def explorable():
    xs, ys, lc, _ = ledger(0, 60, 4, EXPLORE_SCALE)
    return jnb.nb_from_data(xs, ys, lc, jax.random.PRNGKey(3), NCFG)


@pytest.fixture(scope="module")
def trained():
    """A reference state trained on 60 rows (d = 4, cap 128) and probes."""
    xs, ys, lc, rng = ledger(0, 60, 4)
    st = jnb.nb_from_data(xs, ys, lc, jax.random.PRNGKey(3), NCFG)
    return st, rng.uniform(size=(64, 4)).astype(np.float32)


def assert_mean_close(got, want, st, x):
    """The posterior mean at x: |got - want| <= 1e-6 + 1e-5 (|y_mean| +
    |phi(x)| |w_y|), rtol on the scale of the sum's terms."""
    scale = float(st.y_mean.abs()) + (nb._features(st, x).abs()
                                      @ st.w_y.abs())
    err = (torch.as_tensor(np.array(n(got))) - torch.as_tensor(
        np.array(want))).abs()
    assert bool((err <= 1e-6 + 1e-5 * scale).all()), (
        f"mean off by {float(err.max())}, scale {scale}")


def held_f64(tag, got, ref, exact, kappa):
    """`got` (port, float32) within twice the reference's float32 error
    against `exact` (a float64 port run), or within the float32 solve's
    perturbation bound 2 kappa u max|exact|."""
    got, ref, exact = (torch.as_tensor(np.asarray(n(v))).double()
                       for v in (got, ref, exact))
    err = float((got - exact).abs().max())
    ref_err = float((ref - exact).abs().max())
    room = 2.0 * kappa * U32 * float(exact.abs().max())
    assert err <= max(2.0 * ref_err, room), (
        f"{tag}: port error {err}, reference {ref_err}, bound {room}")


def kappa_of(st) -> float:
    a = st.ptp.double() + TCFG.noise2 * torch.eye(st.ptp.shape[0],
                                                  dtype=torch.float64)
    return float(torch.linalg.cond(a))


def assert_backward_stable(st):
    """chol rebuilds ptp + noise2 I, and the heads solve their systems, to
    1e-5 of the matrix's size (the backward error of a float32 solve)."""
    a = st.ptp.double() + TCFG.noise2 * torch.eye(st.ptp.shape[0],
                                                  dtype=torch.float64)
    l = st.chol.double()
    scale = float(a.abs().max())
    assert float((l @ l.T - a).abs().max()) <= 1e-5 * scale
    for w, b in ((st.w_y, st.pty - st.y_mean * st.pt1),
                 (st.w_c, st.ptc - st.c_mean * st.pt1)):
        resid = a @ w.double() - b.double()
        assert float(resid.abs().max()) <= 1e-5 * scale * float(
            w.double().abs().max() + 1.0)


def assert_state_matches(tst, jst, t64, *, tight=SUMS, head=HEAD):
    """Ledger bit for bit, `tight` leaves at TIGHT, `head` leaves by the
    float64 rule, and the port's head backward stable."""
    for k in LEDGER:
        np.testing.assert_array_equal(n(getattr(tst, k)),
                                      np.asarray(getattr(jst, k)), err_msg=k)
    for k in tight:
        np.testing.assert_allclose(n(getattr(tst, k)),
                                   np.asarray(getattr(jst, k)), **TIGHT,
                                   err_msg=k)
    kappa = kappa_of(t64)
    for k in head:
        held_f64(k, getattr(tst, k), getattr(jst, k), getattr(t64, k), kappa)
    assert_backward_stable(tst)


# ---------------------------------------------------------------------------
# Features, cost head, posterior
# ---------------------------------------------------------------------------
def test_features_cost_and_posterior_match(trained):
    st, probes = trained
    tst = port(st)
    np.testing.assert_allclose(n(nb._features(tst, t(probes))),
                               np.asarray(jnb._features(st, j(probes))),
                               **TIGHT)
    np.testing.assert_allclose(n(nb._features(tst, t(probes[0]))),
                               np.asarray(jnb._features(st, j(probes[0]))),
                               **TIGHT)
    np.testing.assert_allclose(n(nb.nb_log_cost(tst, t(probes))),
                               np.asarray(jnb.nb_log_cost(st, j(probes))),
                               **TIGHT)
    mean, var = nb.nb_posterior(tst, t(probes))
    jmean, jvar = jnb.nb_posterior(st, j(probes))
    assert_mean_close(mean, jmean, tst, t(probes))
    np.testing.assert_allclose(n(var), np.asarray(jvar), **TIGHT)
    assert float(nb._f_best(tst)) == float(jnb._f_best(st))
    np.testing.assert_array_equal(n(nb._active_mask(tst)),
                                  np.asarray(jnb._active_mask(st)))


def test_rebuild_cache_matches(trained):
    """The exact rebuild on the same ledger and params (its own refit's
    params): sums and means tight, the head by the float64 rule."""
    st, probes = trained
    st = dataclasses.replace(st, since_refit=jnp.int32(5))
    tst = port(st)
    got, want = nb._rebuild_cache(tst, TCFG), jnb._rebuild_cache(st, NCFG)
    exact = nb._rebuild_cache(to64(tst), TCFG)
    assert int(got.since_refit) == 0
    assert_state_matches(got, want, exact)
    kappa = kappa_of(exact)
    for a, b, c, tag in zip(nb.nb_posterior(got, t(probes)),
                            jnb.nb_posterior(want, j(probes)),
                            nb.nb_posterior(exact, t(probes).double()),
                            ("mean", "var")):
        held_f64(f"posterior {tag}", a, b, c, kappa)


def test_append_matches(trained):
    st, probes = trained
    x, y, c = probes[0], np.float32(0.25), np.float32(-0.5)
    tst = port(st)
    got = nb.nb_append(tst, t(x), float(y), float(c), TCFG)
    want = jnb.nb_append(st, j(x), jnp.float32(y), jnp.float32(c), ncfg=NCFG)
    exact = nb.nb_append(to64(tst), t(x).double(), float(y), float(c), TCFG)
    assert_state_matches(got, want, exact)
    assert int(got.n) == int(st.n) + 1
    # the input state is left as it was
    np.testing.assert_array_equal(n(tst.x_buf), np.asarray(st.x_buf))


@pytest.mark.parametrize("liar", ["mean", "pessimistic"])
def test_fantasize_matches(trained, liar):
    """Three fantasy rows: the points bit for bit, the first liar value
    (taken against the given state) tight, the later ones and the head
    by the float64 rule."""
    st, probes = trained
    xs = probes[:3]
    tst = port(st)
    got = nb.nb_fantasize(tst, t(xs), TCFG, liar)
    want = jnb.nb_fantasize(st, j(xs), ncfg=NCFG, liar=liar)
    exact = nb.nb_fantasize(to64(tst), t(xs).double(), TCFG, liar)
    k0 = int(st.n)
    first = nb.nb_fantasy_value(tst, t(xs[0]), liar)
    assert_mean_close(first, jnb.nb_fantasy_value(st, j(xs[0]), liar), tst,
                      t(xs[0]))
    np.testing.assert_array_equal(n(got.x_buf), np.asarray(want.x_buf))
    np.testing.assert_array_equal(n(got.y_buf)[:k0],
                                  np.asarray(want.y_buf)[:k0])
    assert int(got.n) == int(want.n) == k0 + 3
    assert int(got.since_refit) == int(want.since_refit)
    assert_mean_close(got.y_buf[k0], np.asarray(want.y_buf)[k0], tst,
                      t(xs[0]))
    kappa = kappa_of(exact)
    for k in ("y_buf", "c_buf") + SUMS + HEAD:
        held_f64(k, getattr(got, k), getattr(want, k), getattr(exact, k),
                 kappa)
    assert_backward_stable(got)


# ---------------------------------------------------------------------------
# The refit: one Adam step tight, 200 steps by the float64 rule
# ---------------------------------------------------------------------------
def _untrained(seed=1, n0=50, d=5):
    xs, ys, lc, rng = ledger(seed, n0, d)
    cap = jnb.nb_capacity(n0, NCFG)
    init = jnb.nb_init(d, cap, jax.random.PRNGKey(seed), NCFG)
    pad = cap - n0
    st = dataclasses.replace(
        init, x_buf=j(np.pad(xs, ((0, pad), (0, 0)))),
        y_buf=j(np.pad(ys, (0, pad))), c_buf=j(np.pad(lc, (0, pad))),
        n=jnp.int32(n0))
    return st, rng.uniform(size=(64, d)).astype(np.float32)


def test_one_adam_step_matches():
    st, _ = _untrained()
    one = dataclasses.replace(NCFG, refit_steps=1)
    got = nb.nb_refit(port(st), nb.NeuralConfig(**dataclasses.asdict(one)))
    want = jnb.nb_refit(st, ncfg=one)
    for k in nb.PARAMS:
        np.testing.assert_allclose(n(getattr(got, k)),
                                   np.asarray(getattr(want, k)), **TIGHT,
                                   err_msg=k)
        assert not np.array_equal(n(getattr(got, k)),
                                  np.asarray(getattr(st, k))), k


def test_padding_rows_add_exactly_nothing_to_the_gradient():
    """The masked loss runs its forward pass over all cap rows; rows past
    n must change no bit of the gradient, whatever they hold."""
    st, _ = _untrained()
    tst = port(st)
    mask = nb._active_mask(tst)
    nf = tst.n.float()
    targets = torch.where(mask, tst.y_buf - 0.1, 0.0)
    params = [getattr(tst, k) for k in nb.PARAMS]
    g0 = nb._refit_grad(tst.x_buf, mask, targets, nf, params)
    junk = torch.where(mask[:, None], tst.x_buf, 7.0)
    g1 = nb._refit_grad(junk, mask, targets, nf, params)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_refit_200_steps_float64_rule():
    """The full refit from the reference's params: the MLP params within
    twice the reference's float32 error against a float64 port run; the
    head, s2 and the posterior at 64 probes by the float64 rule."""
    st, probes = _untrained()
    tst = port(st)
    got, want = nb.nb_refit(tst, TCFG), jnb.nb_refit(st, ncfg=NCFG)
    exact = nb.nb_refit(to64(tst), TCFG)
    for k in nb.PARAMS:
        e = getattr(exact, k)
        err = float((getattr(got, k).double() - e).abs().max())
        ref_err = float((t(getattr(want, k)).double() - e).abs().max())
        assert err <= 2.0 * ref_err, (k, err, ref_err)
    kappa = kappa_of(exact)
    for k in HEAD + ("s2",):
        held_f64(k, getattr(got, k), getattr(want, k), getattr(exact, k),
                 kappa)
    for a, b, c, tag in zip(nb.nb_posterior(got, t(probes)),
                            jnb.nb_posterior(want, j(probes)),
                            nb.nb_posterior(exact, t(probes).double()),
                            ("mean", "var")):
        held_f64(f"posterior {tag}", a, b, c, kappa)
    assert int(got.since_refit) == 0 and int(got.n) == int(st.n)


# ---------------------------------------------------------------------------
# Suggest at passed seeds, float and mixed
# ---------------------------------------------------------------------------
ACQ = dict(restarts=16, ascent_steps=12)


@pytest.mark.parametrize("name", ["ei", "ei_per_cost"])
def test_suggest_matches_with_reference_seeds(explorable, name):
    st = explorable
    key = jax.random.PRNGKey(9)
    seeds = np.asarray(jax.random.uniform(key, (ACQ["restarts"], 4)))
    jx, jv = jnb.nb_suggest(st, key, acq=jacqm.AcqConfig(name=name, **ACQ))
    x, v = nb.nb_suggest(port(st), acq=acqm.AcqConfig(name=name, **ACQ),
                         seeds=t(seeds))
    assert x.shape == (1, 4) and v.shape == (1,)
    np.testing.assert_allclose(n(v), np.asarray(jv), **EI_TOL)
    np.testing.assert_allclose(n(x), np.asarray(jx), **SUGGEST_TOL)
    assert float(v[0]) > 0.0


def test_suggest_mixed_matches_and_stays_on_the_lattice():
    space = mixed_space4()
    jdesc = jax_space(space).descriptor()
    d = space.dim
    rng = np.random.default_rng(4)
    xs = space.sample(rng, 60).astype(np.float32)
    ys = (EXPLORE_SCALE * (np.sin(3.0 * xs.sum(-1)) + 0.1 * xs[:, 0])
          ).astype(np.float32)
    st = jnb.nb_from_data(xs, ys, np.zeros(60, np.float32),
                          jax.random.PRNGKey(5), NCFG)
    key = jax.random.PRNGKey(10)
    seeds = np.asarray(jax.random.uniform(key, (ACQ["restarts"], d)))
    acq = dict(**ACQ)
    jx, jv = jnb.nb_suggest(st, key, jdesc, acq=jacqm.AcqConfig(**acq),
                            top_t=2)
    jitter = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (2, d)))
    x, v = nb.nb_suggest(port(st), space.descriptor(),
                         acq=acqm.AcqConfig(**acq), top_t=2, seeds=t(seeds),
                         jitter=t(jitter))
    np.testing.assert_allclose(n(v), np.asarray(jv), **EI_TOL)
    np.testing.assert_allclose(n(x), np.asarray(jx), **SUGGEST_TOL)
    np.testing.assert_array_equal(space.project(n(x)), n(x))


def test_ask_q_matches_the_reference(explorable):
    st = explorable
    key, q = jax.random.PRNGKey(11), 3
    seeds = np.stack([np.asarray(jax.random.uniform(k, (ACQ["restarts"], 4)))
                      for k in jax.random.split(key, q)])
    jxs, jvals, jst = jnb.nb_ask_q(st, key, ncfg=NCFG,
                                   acq=jacqm.AcqConfig(**ACQ), q=q)
    xs, vals, tst = nb.nb_ask_q(port(st), TCFG, acq=acqm.AcqConfig(**ACQ),
                                q=q, seeds=t(seeds))
    # Values at EI_TOL; the first pick's point at SUGGEST_TOL.  Later picks
    # ascend on heads that carry the earlier fantasy appends' round-off,
    # amplified by the head's conditioning (kappa near 1e5, see the module
    # docstring), and land about 2e-4 apart while their EI agrees.
    np.testing.assert_allclose(n(vals), np.asarray(jvals), **EI_TOL)
    np.testing.assert_allclose(n(xs[0]), np.asarray(jxs[0]), **SUGGEST_TOL)
    assert int(tst.n) == int(jst.n) == int(st.n) + q
    np.testing.assert_array_equal(n(tst.x_buf)[int(st.n):int(st.n) + q],
                                  n(xs))


# ---------------------------------------------------------------------------
# Capacity, growth, init, serialization
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n0", [0, 1, 31, 32, 33, 1024, 4096])
def test_capacity_matches(n0):
    assert nb.nb_capacity(n0, TCFG) == jnb.nb_capacity(n0, NCFG)


def test_grow_keeps_every_leaf_and_zero_pads(trained):
    st, _ = trained
    tst = port(st)
    grown = nb.nb_grow(tst, TCFG)
    want = jnb.nb_grow(st, NCFG)
    assert grown.cap == 2 * tst.cap
    for k in nb.FIELDS:
        np.testing.assert_array_equal(n(getattr(grown, k)),
                                      np.asarray(getattr(want, k)), err_msg=k)
        if k not in ("x_buf", "y_buf", "c_buf"):
            assert getattr(grown, k) is getattr(tst, k)
    assert not grown.x_buf[tst.cap:].any() and not grown.y_buf[tst.cap:].any()
    assert torch.equal(grown.x_buf[:tst.cap], tst.x_buf)


def test_init_draws_and_params():
    gen = torch.Generator().manual_seed(0)
    st = nb.nb_init(3, 64, TCFG, generator=gen, device=CPU)
    assert st.w1.shape == (3, 32) and st.w2.shape == (32, 16)
    assert st.w3.shape == (16,) and st.b3.shape == ()
    assert st.n.dtype == torch.int32 and st.n.shape == ()
    ref = jnb.nb_init(3, 64, jax.random.PRNGKey(0), NCFG)
    got = nb.nb_init(3, 64, TCFG, params=leaves(ref), device=CPU)
    for k in nb.FIELDS:
        np.testing.assert_array_equal(n(getattr(got, k)),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    with pytest.raises(ValueError):
        nb.nb_init(3, 64, TCFG, device=CPU)
    with pytest.raises(ValueError):
        nb.nb_init(4, 64, TCFG, params=leaves(ref), device=CPU)


def test_json_round_trips_across_packages(trained):
    st, _ = trained
    ref_json = jnb.nb_to_json(st)
    tst = nb.nb_from_json(ref_json, device=CPU)
    assert nb.nb_to_json(tst) == ref_json
    assert tst.n.shape == () and tst.s2.shape == ()
    back = jnb.nb_from_json(nb.nb_to_json(tst))
    assert jnb.nb_to_json(back) == ref_json
    grown = nb.nb_append(tst, t([0.1, 0.2, 0.3, 0.4]), 0.5, 0.0, TCFG)
    again = nb.nb_from_json(nb.nb_to_json(grown), device=CPU)
    for k in nb.FIELDS:
        assert torch.equal(getattr(again, k), getattr(grown, k)), k


def test_convert_round_trips(trained):
    st, _ = trained
    tst = port(st)
    back = convert.nb_state_to_numpy(tst)
    for k, v in leaves(st).items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
    with pytest.raises(KeyError):
        convert.nb_state_from_numpy({"x_buf": back["x_buf"]}, device=CPU)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nb.nb_init(2, 8, TCFG, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nb.nb_from_data(np.zeros((2, 2)), np.zeros(2), np.zeros(2), TCFG,
                        generator=torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nb.nb_from_json({})


def test_head_factor_falls_back_where_float32_loses_definiteness():
    """ptp + noise2 I that float32 round-off left indefinite: the plain
    factor fails (the reference's is NaN there), the head takes the first
    of noise2 x 10^k on the diagonal that factors; a definite one keeps
    the plain factor bit for bit."""
    ncfg = nb.NeuralConfig()
    rng = np.random.default_rng(0)
    phi = rng.standard_normal((40, 17)).astype(np.float32)
    good = torch.from_numpy(phi.T @ phi)
    # 5e-4 below noise2's floor along the smallest eigenvector: indefinite
    lam, vecs = torch.linalg.eigh(good.double())
    v = vecs[:, 0].float()
    bad = good - float(lam[0] + ncfg.noise2 + 5e-4) * torch.outer(v, v)
    zeros = torch.zeros(17)
    one = torch.tensor(1.0)
    eye = torch.eye(17)
    for ptp, plain_ok in ((good, True), (bad, False)):
        a = ptp + ncfg.noise2 * eye
        plain, info = torch.linalg.cholesky_ex(a)
        assert (int(info) == 0) == plain_ok
        chol, w_y, w_c = nb._solve_heads(ncfg, ptp, zeros + 1.0, zeros,
                                         zeros, one, one)
        assert torch.isfinite(chol).all() and torch.isfinite(w_y).all()
        if plain_ok:
            assert torch.equal(chol, plain)
            continue
        for k in range(1, nb.JITTER_STEPS + 1):
            want, info = torch.linalg.cholesky_ex(
                a + ncfg.noise2 * 10.0 ** k * eye)
            if int(info) == 0:
                break
        np.testing.assert_allclose(n(chol), n(want), rtol=1e-6, atol=1e-7)
        assert k > 1 or torch.equal(chol, want)
