"""Mixed search spaces in the port against the JAX package, on the same
numpy inputs (the mirror of `tests/test_mixed.py` and of the mixed case of
`tests/test_fused_acq.py`):
  * the round-and-repair projection `descriptor.project_units`;
  * the mixed gram (`kernels/mixed.py`), its PSD and Hamming semantics and
    its continuous-block-only gradient;
  * the mixed form of the fused EI step (`kernels/acq.py`);
  * the ascent on the lattice, and the slice as a whole: `BayesOpt.step`
    on `MIXED_DEMO_SPACE` round by round, given the reference's restart
    seeds.
Where the reference reaches a Pallas kernel it runs in interpret mode
(`implementation="pallas"`), as its own tests run it here."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import CPU, j, jax_state_leaves, n, t

from repro.core import acquisition as jacqm
from repro.core import bayesopt as jbo
from repro.core import descriptor as jdesc
from repro.core import gp as jgp
from repro.core.kernels import make_mixed_kernel as jmake_mixed_kernel
from repro.hpo import space as jspace
from repro.kernels import acq as jacq
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import acquisition as acqm
from repro_torch.core import bayesopt as bo
from repro_torch.core import descriptor as desc_mod
from repro_torch.core import gp as gp_mod
from repro_torch.core.kernels import (KernelParams, make_mixed_kernel,
                                      matern52, mixed_matern52)
from repro_torch.hpo.space import (MIXED_DEMO_SPACE, Categorical, Dim,
                                   SearchSpace, space_to_dicts)
from repro_torch.kernels import acq, mixed, ops, ref

MIXED = MIXED_DEMO_SPACE          # Float log + Int(7) + Cat(3) + Conditional
J_MIXED = jspace.MIXED_DEMO_SPACE
SMALL = SearchSpace((Dim("a", 0.0, 1.0), Categorical("c", ("p", "q", "r"))))
GRAM_TOL = dict(atol=1e-5)                    # tests/test_mixed.py:101
GRAD_TOL = dict(atol=1e-4)                    # tests/test_mixed.py:143
EI_TOL = dict(rtol=1e-4, atol=1e-5)           # tests/test_fused_acq.py:65


def _descs(space=MIXED):
    """The port's descriptor and the reference's, from the same space."""
    jsp = jspace.space_from_dicts(space_to_dicts(space))
    return space.descriptor(), jsp.descriptor()


def _mixed_states(rng, n0, n_max, space=MIXED):
    """The same seeded mixed-kernel GP state in both packages, built by the
    reference (append_batch, then a refactor) and carried over by
    `convert`: (jax_state, torch_state, jax_kernel, torch_kernel)."""
    desc, jd = _descs(space)
    jk = jmake_mixed_kernel(jd.cont_mask, jd.cat_mask)
    xs = space.sample(rng, n0)
    ys = (np.sin(3.0 * xs.sum(-1)) + 0.1 * xs[:, 0]).astype(np.float32)
    cfg = jgp.GPConfig(n_max=n_max, dim=space.dim, implementation="xla",
                       desc=jd)
    st = jgp.append_batch(jgp.init_state(cfg), jk, j(xs), j(ys),
                          implementation="xla")
    st = jgp.refactor(st, jk, implementation="xla")
    return (st, convert.state_from_numpy(jax_state_leaves(st), device=CPU),
            jk, make_mixed_kernel(desc.cont_mask, desc.cat_mask))


# ---------------------------------------------------------------------------
# Projection
# ---------------------------------------------------------------------------
def test_project_feasible_idempotent_and_matches_reference():
    desc, jd = _descs()
    rng = np.random.default_rng(0)
    u = rng.uniform(size=(64, MIXED.dim)).astype(np.float32)
    p = desc_mod.project_units(t(u), desc)
    np.testing.assert_array_equal(n(desc_mod.project_units(p, desc)), n(p))
    np.testing.assert_allclose(n(p), MIXED.project(u), atol=1e-6)
    np.testing.assert_array_equal(n(p), n(jdesc.project_units(j(u), jd)))
    for row in n(p):
        assert row[2:5].sum() == 1.0 and set(row[2:5]) <= {0.0, 1.0}
        assert round(row[1] * 6) == pytest.approx(row[1] * 6, abs=1e-5)
        if row[2] != 1.0:
            assert row[5] == 0.0
    # one row at a time gives the same rows
    np.testing.assert_array_equal(n(desc_mod.project_units(t(u[3]), desc)),
                                  n(p)[3])


def test_project_is_identity_on_continuous():
    desc = desc_mod.all_continuous(5)
    u = torch.linspace(0, 1, 5)
    np.testing.assert_array_equal(n(desc_mod.project_units(u, desc)), n(u))
    assert not desc.has_discrete


def test_project_tie_break_is_first_index():
    desc = SMALL.descriptor()
    u = torch.tensor([0.3, 0.7, 0.7, 0.1])
    np.testing.assert_allclose(n(desc_mod.project_units(u, desc)),
                               [0.3, 1.0, 0.0, 0.0])


def test_project_int_snap_rounds_half_to_even_like_reference():
    """Units on the half-lattice points: both packages round half to even."""
    desc, jd = _descs()
    u = np.full((7, MIXED.dim), 0.25, np.float32)
    u[:, 1] = (np.arange(7) + 0.5) / 6.0
    np.testing.assert_array_equal(n(desc_mod.project_units(t(u), desc)),
                                  n(jdesc.project_units(j(u), jd)))


# ---------------------------------------------------------------------------
# Mixed gram: parity, PSD, Hamming semantics, gradient contract
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_mixed_gram_matches_reference(impl):
    desc, jd = _descs()
    rng = np.random.default_rng(1)
    x = MIXED.sample(rng, 24)
    y = MIXED.sample(rng, 17)
    want = jops.mixed_gram(j(x), j(y), 1.3, 0.4, jd.cont_mask, jd.cat_mask,
                           implementation=impl)
    got = ops.mixed_gram(t(x), t(y), 1.3, 0.4, desc.cont_mask, desc.cat_mask)
    np.testing.assert_allclose(n(got), n(want), **GRAM_TOL)
    # off the lattice as well (the factor is an RBF in the embedding there)
    u = rng.uniform(size=(9, MIXED.dim)).astype(np.float32)
    np.testing.assert_allclose(
        n(ref.mixed_gram(t(u), t(x), 1.3, 0.4, desc.cont_mask,
                         desc.cat_mask)),
        n(jops.mixed_gram(j(u), j(x), 1.3, 0.4, jd.cont_mask, jd.cat_mask,
                          implementation=impl)), **GRAM_TOL)


def test_mixed_gram_psd():
    desc = MIXED.descriptor()
    x = t(MIXED.sample(np.random.default_rng(2), 40))
    k = n(ops.mixed_gram(x, x, 1.0, 0.3, desc.cont_mask,
                         desc.cat_mask)).astype(np.float64)
    assert np.linalg.eigvalsh(k + 1e-5 * np.eye(40)).min() > 0.0


def test_mixed_gram_hamming_semantics():
    desc = SMALL.descriptor()
    rho = 0.7
    same = torch.tensor([[0.5, 1.0, 0.0, 0.0]])
    diff = torch.tensor([[0.5, 0.0, 1.0, 0.0]])
    k_same = float(ops.mixed_gram(same, same, 1.0, rho, desc.cont_mask,
                                  desc.cat_mask)[0, 0])
    k_diff = float(ops.mixed_gram(same, diff, 1.0, rho, desc.cont_mask,
                                  desc.cat_mask)[0, 0])
    assert k_same == pytest.approx(1.0, abs=1e-6)
    assert k_diff == pytest.approx(np.exp(-1.0 / rho), abs=1e-6)


def test_mixed_kernel_reduces_to_matern_on_continuous():
    desc = desc_mod.all_continuous(3)
    kern = make_mixed_kernel(desc.cont_mask, desc.cat_mask)
    x = t(np.random.default_rng(3).uniform(size=(9, 3)))
    p = KernelParams(sigma2=1.0, rho=0.5, noise2=1e-6)
    np.testing.assert_allclose(n(kern(x, x, p)), n(matern52(x, x, p)),
                               atol=1e-6)
    np.testing.assert_allclose(
        n(ops.kernel_gram(kern, x, x, p)), n(matern52(x, x, p)), atol=1e-6)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_mixed_gradient_continuous_block_only(impl):
    """Zero cotangent on the categorical block; dx, dsigma2 and drho match
    `jax.grad` of the reference (its stop_gradient'd jnp form, or the
    Pallas custom VJP)."""
    desc, jd = _descs()
    rng = np.random.default_rng(4)
    x = MIXED.sample(rng, 12)
    y = MIXED.sample(rng, 12)
    gw = rng.standard_normal((12, 12)).astype(np.float32)

    def jtotal(xx, s2, rho):
        return jnp.sum(j(gw) * jops.mixed_gram(
            xx, j(y), s2, rho, jd.cont_mask, jd.cat_mask,
            implementation=impl))

    jg = jax.grad(jtotal, argnums=(0, 1, 2))(j(x), jnp.float32(1.0),
                                             jnp.float32(0.4))
    xt = t(x).requires_grad_(True)
    s2 = torch.tensor(1.0, requires_grad=True)
    rho = torch.tensor(0.4, requires_grad=True)
    total = torch.sum(t(gw) * mixed.mixed_gram(xt, t(y), s2, rho,
                                                desc.cont_mask, desc.cat_mask))
    gx, gs2, grho = torch.autograd.grad(total, (xt, s2, rho))
    assert float((gx * desc.cat_mask).abs().max()) == 0.0
    np.testing.assert_allclose(n(gx), n(jg[0]), **GRAD_TOL)
    np.testing.assert_allclose(float(gs2), float(jg[1]), rtol=1e-4)
    np.testing.assert_allclose(float(grho), float(jg[2]), rtol=1e-4)
    # the analytic backward against torch autodiff of the plain form
    xa = t(x).requires_grad_(True)
    sa = torch.tensor(1.0, requires_grad=True)
    ra = torch.tensor(0.4, requires_grad=True)
    auto = torch.autograd.grad(torch.sum(t(gw) * mixed_matern52(
        xa, t(y), KernelParams(sa, ra, 1e-6), desc.cont_mask,
        desc.cat_mask)), (xa, sa, ra))
    for got, want in zip((gx, gs2, grho), auto):
        np.testing.assert_allclose(n(got), n(want), rtol=1e-4, atol=1e-5)


def test_cuda_wrappers_refuse_cpu_tensors():
    """On the CPU the wrappers take the plain version; the CUDA entry points
    themselves launch or raise, never fall back."""
    desc = MIXED.descriptor()
    x = t(MIXED.sample(np.random.default_rng(5), 4))
    with pytest.raises(ValueError, match="CUDA"):
        mixed.mixed_gram_cuda(x, x, 1.0, 0.4, desc.cont_mask, desc.cat_mask)
    with pytest.raises(ValueError, match="CUDA"):
        acq.fused_ei_grad_mixed_cuda(
            x, x, torch.ones(4), torch.zeros(4), torch.eye(4), 1.0, 0.4, 0.0,
            desc.cont_mask, desc.cat_mask)


# ---------------------------------------------------------------------------
# Fused EI step, mixed form
# ---------------------------------------------------------------------------
def test_fused_mixed_matches_autodiff_and_reference():
    rng = np.random.default_rng(6)
    st_j, st_t, jk, tk = _mixed_states(rng, 8, 16)
    desc, jd = _descs()
    x = rng.uniform(size=(11, MIXED.dim)).astype(np.float32)
    v_f, g_f = acqm.ei_value_and_grad(st_t, tk, t(x), fused=True)
    v_u, g_u = acqm.ei_value_and_grad(st_t, tk, t(x), fused=False)
    np.testing.assert_allclose(n(v_f), n(v_u), **EI_TOL)
    np.testing.assert_allclose(n(g_f), n(g_u), **EI_TOL)
    # exactly zero on the categorical coordinates, like autodiff
    np.testing.assert_array_equal(n(g_f * desc.cat_mask),
                                  np.zeros_like(n(g_f)))
    for impl in ("xla", "pallas"):
        v_j, g_j = jacqm.ei_value_and_grad(st_j, jk, j(x),
                                           implementation=impl, fused=True)
        np.testing.assert_allclose(n(v_f), n(v_j), **EI_TOL, err_msg=impl)
        np.testing.assert_allclose(n(g_f), n(g_j), **EI_TOL, err_msg=impl)


def test_ei_grad_torch_mixed_matches_reference_math():
    """The plain mixed form on pre-split operands against the reference's
    `ei_grad_jnp` with masks, on the same hoisted operands."""
    rng = np.random.default_rng(7)
    st_j, st_t, _, _ = _mixed_states(rng, 10, 16)
    desc, jd = _descs()
    x = MIXED.sample(rng, 13)
    amask = (np.arange(16) < 10).astype(np.float32)
    a_buf = n(st_t.li_buf.T @ st_t.li_buf)
    args = (amask, n(st_t.alpha), a_buf, 1.0, 0.25, -0.3)
    ei_j, g_j = jacq.ei_grad_jnp(j(x), st_j.x_buf, *(j(a) for a in args[:3]),
                                 *args[3:], cont_mask=jd.cont_mask,
                                 cat_mask=jd.cat_mask)
    xc, xbc, xk, xbk = acq.split_rows(t(x), st_t.x_buf, desc.cont_mask,
                                      desc.cat_mask)
    ei_t, g_t = acq.ei_grad_torch(xc, xbc, *(t(a) for a in args[:3]),
                                  *args[3:], xk=xk, xbk=xbk)
    np.testing.assert_allclose(n(ei_t), n(ei_j), **EI_TOL)
    np.testing.assert_allclose(n(g_t), n(g_j), **EI_TOL)
    got = ops.fused_ei_grad(t(x), st_t.x_buf, t(amask), *(t(a) for a in
                            args[1:3]), *args[3:], cont_mask=desc.cont_mask,
                            cat_mask=desc.cat_mask)
    np.testing.assert_array_equal(n(got[1]), n(g_t))


def test_fused_supported_covers_mixed():
    desc = MIXED.descriptor()
    kern = make_mixed_kernel(desc.cont_mask, desc.cat_mask)
    assert ops.fused_supported(kern, "ei")
    assert not ops.fused_supported(kern, "ucb")


# ---------------------------------------------------------------------------
# GP layer and the ascent
# ---------------------------------------------------------------------------
def test_mixed_gp_append_and_refit_match_reference():
    rng = np.random.default_rng(8)
    st_j, st_t, jk, tk = _mixed_states(rng, 6, 16)
    xs = MIXED.sample(rng, 3)
    ys = rng.standard_normal(3).astype(np.float32)
    st_j = jgp.append_batch(st_j, jk, j(xs), j(ys), implementation="xla")
    st_t = gp_mod.append_batch(st_t, tk, t(xs), t(ys))
    p_j = jgp.refit_params(st_j, jk, implementation="xla")
    p_t = gp_mod.refit_params(st_t, tk)
    np.testing.assert_allclose(float(p_t.rho), float(p_j.rho))
    np.testing.assert_allclose(float(p_t.sigma2), float(p_j.sigma2))
    st_j = jgp.refactor(st_j, jk, p_j, implementation="xla")
    st_t = gp_mod.refactor(st_t, tk, p_t)
    for leaf in ("l_buf", "li_buf", "alpha"):
        np.testing.assert_allclose(n(getattr(st_t, leaf)),
                                   n(getattr(st_j, leaf)), rtol=5e-4,
                                   atol=5e-4, err_msg=leaf)


def test_refit_skips_nan_candidates(monkeypatch):
    """A grid candidate whose float32 factor broke down (NaN LML; the mixed
    workload's long length scales at n ~ 500) never wins the lag refit.
    The reference's jnp.argmax would return the first NaN instead."""
    assert int(jnp.argmax(jnp.asarray([np.nan, 1.0, 2.0]))) == 0
    rng = np.random.default_rng(9)
    _, st_t, _, tk = _mixed_states(rng, 6, 16)
    lmls = torch.full((18,), -5.0)
    lmls[[0, 7, 17]] = torch.nan
    lmls[4] = -1.0                      # rho 0.1 (row 1), sigma2 1.0 (col 1)
    monkeypatch.setattr(gp_mod, "_lml_grid", lambda st, k, c: lmls)
    p = gp_mod.refit_params(st_t, tk)
    assert (float(p.rho), float(p.sigma2)) == pytest.approx((0.1, 1.0))


@pytest.mark.parametrize("top_t", [1, 3])
def test_acquisition_lands_on_lattice(top_t):
    desc = MIXED.descriptor()
    kern = make_mixed_kernel(desc.cont_mask, desc.cat_mask)
    cfg = gp_mod.GPConfig(n_max=16, dim=MIXED.dim, desc=desc, device="cpu")
    rng = np.random.default_rng(5)
    state = gp_mod.append_batch(gp_mod.init_state(cfg), kern,
                                t(MIXED.sample(rng, 6)),
                                t(rng.normal(size=6)))
    gen = torch.Generator().manual_seed(0)
    pts, vals = acqm.optimize_acquisition(
        state, kern, torch.zeros(MIXED.dim), torch.ones(MIXED.dim),
        acqm.AcqConfig(restarts=8, ascent_steps=5), top_t=top_t,
        generator=gen, desc=desc)
    assert pts.shape == (top_t, MIXED.dim) and vals.shape == (top_t,)
    np.testing.assert_allclose(MIXED.project(n(pts)), n(pts), atol=1e-6)


def test_gpconfig_mixed_requires_matern():
    with pytest.raises(ValueError, match="matern52"):
        gp_mod.GPConfig(n_max=8, dim=MIXED.dim, kernel="rbf",
                        desc=MIXED.descriptor(), device="cpu")
    # an all-continuous descriptor keeps the plain Matérn kernel
    cfg = gp_mod.GPConfig(n_max=8, dim=3, desc=desc_mod.all_continuous(3),
                          device="cpu")
    assert cfg.kernel_fn is matern52
    assert gp_mod.GPConfig(n_max=8, dim=MIXED.dim, desc=MIXED.descriptor(),
                           device="cpu").kernel_fn.gram_kernel == "mixed"


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------
N_SEED, N_MAX, ROUNDS, RESTARTS, STEPS = 8, 32, 6, 8, 6
OPT_BONUS = {"sgd": 0.2, "adam": 0.5, "rmsprop": 0.0}


def _objective(u: np.ndarray) -> np.ndarray:
    """An O(1) function of the decoded hyper-parameters (EI does not
    underflow at this scale, ROADMAP queue 3)."""
    out = []
    for row in np.atleast_2d(u):
        hp = MIXED.to_hparams(row)
        v = -0.1 * (np.log10(hp["lr"]) + 2.5) ** 2 \
            - 0.05 * (hp["depth"] - 5) ** 2 + OPT_BONUS[hp["optimizer"]]
        if hp["momentum"] is not None:
            v -= (hp["momentum"] - 0.9) ** 2
        out.append(v)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("mode,lag", [("lazy", 3), ("naive", 0)])
def test_mixed_step_loop_matches_reference(mode, lag):
    desc, jd = _descs()
    lo, hi = np.zeros(MIXED.dim, np.float32), np.ones(MIXED.dim, np.float32)
    bo_j = jbo.BayesOpt(jbo.BOConfig(
        dim=MIXED.dim, n_max=N_MAX, mode=mode, lag=lag, implementation="xla",
        desc=jd, acq=jacqm.AcqConfig(restarts=RESTARTS, ascent_steps=STEPS)),
        lo, hi)
    bo_t = bo.BayesOpt(bo.BOConfig(
        dim=MIXED.dim, n_max=N_MAX, mode=mode, lag=lag, desc=desc,
        device="cpu",
        acq=acqm.AcqConfig(restarts=RESTARTS, ascent_steps=STEPS)), lo, hi)
    key, sub = jax.random.split(jax.random.PRNGKey(0))
    x0 = np.array(jdesc.project_units(
        jax.random.uniform(sub, (N_SEED, MIXED.dim)), jd))
    y0 = _objective(x0)
    st_j, st_t = bo_j.init(x0, y0), bo_t.init(x0, y0)
    h_j, h_t = jbo.BOHistory(), bo.BOHistory()
    for r in range(ROUNDS):
        key, sub = jax.random.split(key)
        seeds = jax.random.uniform(sub, (RESTARTS, MIXED.dim),
                                   dtype=jnp.float32)
        st_j = bo_j.step(st_j, sub, _objective, h_j)
        st_t = bo_t.step(st_t, _objective, h_t, seeds=t(seeds))
        got, want = n(st_t.x_buf)[N_SEED + r], n(st_j.x_buf)[N_SEED + r]
        np.testing.assert_allclose(got, want, atol=1e-4, err_msg=f"round {r}")
        np.testing.assert_array_equal(MIXED.project(got), got)
        assert MIXED.to_hparams(got)["optimizer"] == \
            J_MIXED.to_hparams(want)["optimizer"]
    for leaf in ("l_buf", "li_buf", "alpha"):
        np.testing.assert_allclose(n(getattr(st_t, leaf)),
                                   n(getattr(st_j, leaf)), rtol=1e-4,
                                   atol=1e-4, err_msg=leaf)
    np.testing.assert_allclose(h_t.best_y, h_j.best_y, rtol=1e-4, atol=1e-4)


def test_run_bo_mixed_stays_on_lattice():
    """`run_bo(desc=...)` on the encoded unit cube: the seed points and
    every suggestion lie on the lattice, and the run is deterministic."""
    kw = dict(dim=MIXED.dim, n_seed=5, n_max=16, lag=4, device="cpu",
              desc=MIXED.descriptor(),
              acq=acqm.AcqConfig(restarts=8, ascent_steps=3))
    lo, hi = np.zeros(MIXED.dim), np.ones(MIXED.dim)
    st, hist = bo.run_bo(_objective, lo, hi, 6, **kw)
    xs = np.asarray(hist.xs)
    assert st.n == 11 and xs.shape == (11, MIXED.dim)
    np.testing.assert_array_equal(MIXED.project(xs), xs)
    assert all(np.isfinite(v) and v >= 0.0 for v in hist.acq_values)
    _, again = bo.run_bo(_objective, lo, hi, 6, **kw)
    assert again.ys == hist.ys
