"""Each kernel module of the port (plain path, on the CPU) against the JAX
package on the same numpy inputs.

Where the reference reaches a Pallas kernel it runs as `test_kernels.py`
runs it here (`implementation="pallas"`, interpret mode) at small shapes;
other shapes hold the port against the reference's XLA / jnp oracles.
Tolerances are the reference suite's own for the same kernels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import j, lower_factor, n, seeded_states, spd, t

from repro.kernels import acq as jacq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import acq, chol, matern, ref, trsv

MATERN_TOL = dict(rtol=1e-5, atol=2e-5)       # tests/test_kernels.py:39
TRSV_TOL = dict(rtol=2e-4, atol=2e-4)         # tests/test_kernels.py:64
CHOL_TOL = dict(rtol=5e-4, atol=5e-4)         # tests/test_kernels.py:88
EI_TOL = dict(rtol=1e-4, atol=1e-5)           # tests/test_fused_acq.py:65


# ---------------------------------------------------------------------------
# Matérn gram
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nn,m,d,impl", [(100, 77, 5, "pallas"),
                                         (1, 1, 1, "pallas"),
                                         (300, 200, 7, "xla")])
def test_matern_value_matches_reference(nn, m, d, impl):
    rng = np.random.default_rng(nn * 1000 + m)
    x = rng.uniform(-3, 3, (nn, d)).astype(np.float32)
    y = rng.uniform(-3, 3, (m, d)).astype(np.float32)
    want = jops.matern52_gram(j(x), j(y), 1.3, 0.7, implementation=impl)
    got = matern.matern52_gram(t(x), t(y), 1.3, 0.7)
    np.testing.assert_allclose(n(got), n(want), **MATERN_TOL)
    np.testing.assert_allclose(n(ref.matern52_gram(t(x), t(y), 1.3, 0.7)),
                               n(jref.matern52_gram_ref(j(x), j(y), 1.3, 0.7)),
                               **MATERN_TOL)


def test_matern_backward_matches_pallas_vjp():
    """dx, dy, dsigma2, drho of sum(G * K) against jax.grad through the
    Pallas kernel's custom VJP."""
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (40, 5)).astype(np.float32)
    y = rng.uniform(0, 1, (23, 5)).astype(np.float32)
    g = rng.standard_normal((40, 23)).astype(np.float32)

    def loss(xx, yy, s2, rh):
        k = jops.matern52_gram(xx, yy, s2, rh, implementation="pallas")
        return jnp.sum(k * j(g))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(j(x), j(y), jnp.float32(1.3),
                                                jnp.float32(0.4))
    xt, yt = t(x).requires_grad_(), t(y).requires_grad_()
    s2, rh = torch.tensor(1.3, requires_grad=True), torch.tensor(0.4, requires_grad=True)
    (matern.matern52_gram(xt, yt, s2, rh) * t(g)).sum().backward()
    for got, w in zip((xt.grad, yt.grad, s2.grad, rh.grad), want):
        np.testing.assert_allclose(n(got), n(w), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Triangular solve
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("size,r,impl", [(37, 0, "pallas"), (130, 17, "pallas"),
                                         (300, 0, "xla"), (200, 64, "xla")])
def test_trsv_matches_reference(size, r, impl, trans):
    """r = 0 is a vector right-hand side."""
    rng = np.random.default_rng(size + r + int(trans))
    l = lower_factor(rng, size)
    b = rng.standard_normal((size, r) if r else (size,)).astype(np.float32)
    want = jops.trsv(j(l), j(b), trans=trans, implementation=impl)
    got = trsv.trsv(t(l), t(b), trans=trans)
    assert got.shape == b.shape
    np.testing.assert_allclose(n(got), n(want), **TRSV_TOL)


@pytest.mark.parametrize("trans", [False, True])
def test_trsv_vjp_matches_pallas_vjp(trans):
    rng = np.random.default_rng(11 + int(trans))
    l = lower_factor(rng, 40)
    b = rng.standard_normal((40, 3)).astype(np.float32)
    g = rng.standard_normal((40, 3)).astype(np.float32)

    def loss(ll, bb):
        q = jops.trsv(ll, bb, trans=trans, implementation="pallas")
        return jnp.sum(q * j(g))

    dl_w, db_w = jax.grad(loss, argnums=(0, 1))(j(l), j(b))
    lt, bt = t(l).requires_grad_(), t(b).requires_grad_()
    (trsv.trsv(lt, bt, trans=trans) * t(g)).sum().backward()
    np.testing.assert_allclose(n(lt.grad), n(dl_w), **TRSV_TOL)
    np.testing.assert_allclose(n(bt.grad), n(db_w), **TRSV_TOL)


def test_trsv_batched_matches_per_system():
    rng = np.random.default_rng(3)
    l = lower_factor(rng, 45, batch=(3,))
    b = rng.standard_normal((3, 45, 5)).astype(np.float32)
    got = trsv.trsv(t(l), t(b), trans=True)
    for s in range(3):
        want = jref.trsv_ref(j(l[s]), j(b[s]), trans=True)
        np.testing.assert_allclose(n(got[s]), n(want), **TRSV_TOL)


# ---------------------------------------------------------------------------
# Cholesky
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size,impl", [(40, "pallas"), (200, "pallas"),
                                       (300, "xla")])
def test_cholesky_matches_reference(size, impl):
    k = spd(np.random.default_rng(size), size)
    want = jops.cholesky(j(k), implementation=impl)
    got = chol.cholesky(t(k))
    np.testing.assert_allclose(n(got), n(want), **CHOL_TOL)


def test_cholesky_clamps_like_pallas_on_non_pd_input():
    """A matrix that is not positive definite (a zero pivot and a negative
    one): the clamp sqrt(max(., 1e-12)) keeps the factor finite, as the
    Pallas kernel does, where a LAPACK Cholesky fails."""
    rng = np.random.default_rng(5)
    k = np.zeros((48, 48), np.float32)
    k[:30, :30] = spd(rng, 30)
    k[30:32, 30:32] = [[4.0, 2.0], [2.0, 1.0]]      # exact zero pivot
    k[32, 32] = -1.0
    k[33:, 33:] = spd(rng, 15)
    want = jops.cholesky(j(k), implementation="pallas")
    got = chol.cholesky(t(k))
    assert np.all(np.isfinite(n(got)))
    np.testing.assert_allclose(n(got), n(want), **CHOL_TOL)
    assert n(got)[31, 31] == pytest.approx(1e-6)


def test_cholesky_batched_matches_per_matrix():
    k = spd(np.random.default_rng(9), 70, batch=(2,))
    got = chol.cholesky(t(k))
    for s in range(2):
        np.testing.assert_allclose(n(got[s]), np.linalg.cholesky(k[s]),
                                   **CHOL_TOL)


# ---------------------------------------------------------------------------
# Fused EI value + gradient
# ---------------------------------------------------------------------------
def _ei_inputs(rng, n0=9, dim=4, n_max=16, r=13):
    jst, tst = seeded_states(rng, n0, dim, n_max)
    amask = (np.arange(n_max) < n0).astype(np.float32)
    a_buf = n(jst.li_buf).T @ n(jst.li_buf)
    y = n(jst.y_buf)[:n0]
    shift = np.float32(y.mean() - y.max() - 0.01)
    x = rng.uniform(size=(r, dim)).astype(np.float32)
    return (x, n(jst.x_buf), amask, n(jst.alpha), a_buf.astype(np.float32),
            float(n(jst.params.sigma2)), float(n(jst.params.rho)), shift)


@pytest.mark.parametrize("oracle", ["pallas", "jnp"])
def test_fused_ei_matches_reference(oracle):
    args = _ei_inputs(np.random.default_rng(0))
    x, xb, am, al, ab, s2, rho, shift = args
    if oracle == "pallas":
        ei_w, g_w = jops.fused_ei_grad(j(x), j(xb), j(am), j(al), j(ab), s2,
                                       rho, shift, implementation="pallas")
    else:
        ei_w, g_w = jacq.ei_grad_jnp(j(x), j(xb), j(am), j(al), j(ab), s2,
                                     rho, shift)
    ei, g = acq.fused_ei_grad(t(x), t(xb), t(am), t(al), t(ab), s2, rho, shift)
    np.testing.assert_allclose(n(ei), n(ei_w), **EI_TOL)
    np.testing.assert_allclose(n(g), n(g_w), **EI_TOL)


def test_fused_ei_batched_matches_per_study():
    rng = np.random.default_rng(1)
    studies = [_ei_inputs(rng, n0=n0) for n0 in (3, 6, 9)]
    stacked = [np.stack([s[i] for s in studies]) for i in range(8)]
    ei, g = acq.ei_grad_torch(*(t(a) for a in stacked))
    for s, args in enumerate(studies):
        ei_w, g_w = jacq.ei_grad_jnp(*(j(a) for a in args[:5]), *args[5:])
        np.testing.assert_allclose(n(ei[s]), n(ei_w), **EI_TOL)
        np.testing.assert_allclose(n(g[s]), n(g_w), **EI_TOL)


def test_ei_variance_floor_zeroes_dvar():
    """At a training point with tiny noise the variance clamp binds: the
    gradient must drop the dvar term exactly as the reference does."""
    rng = np.random.default_rng(2)
    x, xb, am, al, ab, s2, rho, shift = _ei_inputs(rng)
    x[:3] = xb[:3]
    ei_w, g_w = jacq.ei_grad_jnp(j(x), j(xb), j(am), j(al), j(ab), s2, rho, shift)
    ei, g = acq.ei_grad_torch(t(x), t(xb), t(am), t(al), t(ab), s2, rho, shift)
    np.testing.assert_allclose(n(ei), n(ei_w), **EI_TOL)
    np.testing.assert_allclose(n(g), n(g_w), **EI_TOL)


@pytest.mark.parametrize("z", [-6.0, -8.0, -12.0])
def test_fused_ei_keeps_the_lower_tail(z):
    """Far below the incumbent, Phi = 0.5 erfc(-Z / sqrt2) keeps EI and its
    gradient alive in float32 (1 + erf(Z / sqrt2) cancels to 0 there): the
    port agrees with a float64 evaluation of the same function at 2e-3,
    and with the reference's erf form within its absolute tolerance."""
    x, xb, am, al, ab, s2, rho, shift = _ei_inputs(np.random.default_rng(3))
    wide = [torch.from_numpy(a.copy()).double() for a in (x, xb, am, al, ab)]
    k = ref.matern52_gram(wide[0], wide[1], s2, rho) * wide[2]
    gam = k @ wide[3] + shift
    sig = torch.sqrt(s2 - torch.sum((k @ wide[4]) * k, dim=-1))
    shift = float(shift - gam[0] + z * sig[0])        # row 0 sits at Z = z
    ei, g = acq.ei_grad_torch(t(x), t(xb), t(am), t(al), t(ab), s2, rho, shift)
    ei_d, g_d = acq.ei_grad_torch(*wide, s2, rho, shift)
    assert float(ei[0]) > 0.0 and np.all(n(g[0]) != 0.0)
    np.testing.assert_allclose(n(ei[0]), n(ei_d[0]), rtol=2e-3)
    np.testing.assert_allclose(n(g[0]), n(g_d[0]), rtol=2e-3)
    ei_w, g_w = jacq.ei_grad_jnp(j(x), j(xb), j(am), j(al), j(ab), s2, rho, shift)
    np.testing.assert_allclose(n(ei), n(ei_w), **EI_TOL)
    np.testing.assert_allclose(n(g), n(g_w), **EI_TOL)
