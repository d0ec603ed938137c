"""Per-study type masks: the plain versions of the two mixed kernels (the
mixed gram in its plain and masked form, the mixed fused EI) with stacked
(S, d) masks against the JAX package's ops vmapped over per-study masks
(`implementation="xla"`), stacked masks with identical rows bit for bit
the shared (d,) masks, the mixed kernel closure and its gradient over a
stack, and the stacked descriptor (`stack_descriptors`,
`index_descriptor`, `project_units` on (S, R, d) points) against the
reference on `MIXED_DEMO_SPACE` and an all-continuous layout of its
width."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import j, n, t

from repro.core import descriptor as jdesc_mod
from repro.core.kernels import KernelParams as JParams
from repro.core.kernels import make_mixed_kernel as jmake_mixed_kernel
from repro.hpo import space as jspace
from repro.kernels import ops as jops
from repro_torch.core import descriptor as desc_mod
from repro_torch.core.kernels import KernelParams, make_mixed_kernel
from repro_torch.hpo.space import MIXED_DEMO_SPACE, space_to_dicts
from repro_torch.kernels import acq, mixed, ops

GRAM_TOL = dict(atol=1e-5)                    # tests/test_mixed.py:101
EI_TOL = dict(rtol=1e-4, atol=1e-5)           # tests/test_fused_acq.py:65
DIM = MIXED_DEMO_SPACE.dim                    # 6
S, N_MAX, M, R = 3, 20, 5, 7


def _descs():
    """(port, reference) descriptors of study 0, 1, 2: the mixed demo
    space, an all-continuous layout of its width, the demo space again."""
    jsp = jspace.space_from_dicts(space_to_dicts(MIXED_DEMO_SPACE))
    port = [MIXED_DEMO_SPACE.descriptor(), desc_mod.all_continuous(DIM),
            MIXED_DEMO_SPACE.descriptor()]
    ref = [jsp.descriptor(), jdesc_mod.all_continuous(DIM), jsp.descriptor()]
    return port, ref


def _masks():
    port, _ = _descs()
    st = desc_mod.stack_descriptors(port)
    return st.cont_mask, st.cat_mask


def _points(rng, rows):
    """Feasible points of each study's layout, (S, rows, d)."""
    port, _ = _descs()
    u = torch.from_numpy(rng.uniform(size=(S, rows, DIM)).astype(np.float32))
    return desc_mod.project_units(u, desc_mod.stack_descriptors(port))


def test_mixed_gram_with_stacked_masks_matches_vmapped_reference():
    rng = np.random.default_rng(0)
    x, y = _points(rng, N_MAX), _points(rng, M)
    sigma2 = torch.tensor([1.0, 0.5, 2.0])
    rho = torch.tensor([0.3, 0.8, 0.2])
    cm, km = _masks()
    got = mixed.mixed_gram(x, y, sigma2, rho, cm, km)
    want = jax.vmap(lambda xx, yy, s2, rh, c, k: jops.mixed_gram(
        xx, yy, s2, rh, c, k, implementation="xla"))(
        j(x), j(y), j(sigma2), j(rho), j(cm), j(km))
    assert got.shape == (S, N_MAX, M)
    np.testing.assert_allclose(n(got), n(want), **GRAM_TOL)
    # Each study alone, under its own (d,) masks: the same bits.
    for s in range(S):
        assert torch.equal(got[s], mixed.mixed_gram(x[s], y[s], sigma2[s],
                                                     rho[s], cm[s], km[s]))


def test_masked_gram_with_stacked_masks_matches_vmapped_reference():
    rng = np.random.default_rng(1)
    x = _points(rng, N_MAX)
    nn = torch.tensor([N_MAX, 11, 1], dtype=torch.int32)
    params = KernelParams(sigma2=torch.tensor([1.0, 4.0, 0.25]),
                          rho=torch.tensor([0.2, 0.4, 1.6]),
                          noise2=torch.tensor([1e-6, 1e-5, 1e-4]))
    cm, km = _masks()
    got = ops.masked_gram(x, nn, make_mixed_kernel(cm, km), params)
    want = jax.vmap(lambda xb, nb, s2, rh, nz, c, k: jops.masked_gram(
        xb, nb, jmake_mixed_kernel(c, k), JParams(s2, rh, nz),
        implementation="xla"))(
        j(x), j(nn), j(params.sigma2), j(params.rho), j(params.noise2),
        j(cm), j(km))
    np.testing.assert_allclose(n(got), n(want), **GRAM_TOL)
    for s in range(S):
        single = ops.masked_gram(x[s], int(nn[s]),
                                 make_mixed_kernel(cm[s], km[s]),
                                 KernelParams(params.sigma2[s], params.rho[s],
                                              params.noise2[s]))
        assert torch.equal(got[s], single)


def _ei_operands(rng):
    x_buf = _points(rng, N_MAX)
    cand = _points(rng, R)
    nn = torch.tensor([N_MAX, 9, 3])
    amask = (torch.arange(N_MAX) < nn[:, None]).float()
    alpha = torch.from_numpy(rng.normal(size=(S, N_MAX)).astype(np.float32)) \
        * amask
    li = torch.from_numpy(np.tril(rng.normal(
        size=(S, N_MAX, N_MAX)) * 0.1).astype(np.float32))
    a_buf = li.transpose(-1, -2) @ li
    scal = [torch.tensor(v) for v in ([1.0, 0.5, 2.0], [0.3, 0.6, 0.2],
                                      [0.1, -0.2, 0.05])]
    return cand, x_buf, amask, alpha, a_buf, scal


def test_mixed_fused_ei_with_stacked_masks_matches_vmapped_reference():
    rng = np.random.default_rng(2)
    cand, x_buf, amask, alpha, a_buf, (s2, rho, shift) = _ei_operands(rng)
    cm, km = _masks()
    ei, grad = acq.fused_ei_grad(cand, x_buf, amask, alpha, a_buf, s2, rho,
                                 shift, cont_mask=cm, cat_mask=km)
    jei, jgrad = jax.vmap(lambda *a: jops.fused_ei_grad(
        *a[:8], cont_mask=a[8], cat_mask=a[9], implementation="xla"))(
        *(j(v) for v in (cand, x_buf, amask, alpha, a_buf, s2, rho, shift,
                         cm, km)))
    assert ei.shape == (S, R) and grad.shape == (S, R, DIM)
    np.testing.assert_allclose(n(ei), n(jei), **EI_TOL)
    np.testing.assert_allclose(n(grad), n(jgrad), **EI_TOL)
    assert torch.all(grad[0][:, km[0] > 0] == 0)      # no categorical step
    # Study s's lane is the same batch under study s's (d,) masks shared.
    for s in range(S):
        e1, g1 = acq.fused_ei_grad(cand, x_buf, amask, alpha, a_buf, s2, rho,
                                   shift, cont_mask=cm[s], cat_mask=km[s])
        assert torch.equal(ei[s], e1[s]) and torch.equal(grad[s], g1[s])


def test_identical_stacked_rows_equal_shared_masks():
    """(S, d) masks whose rows are all one layout give exactly what the
    shared (d,) masks give, in all three plain versions."""
    rng = np.random.default_rng(3)
    desc = MIXED_DEMO_SPACE.descriptor()
    cm, km = desc.cont_mask, desc.cat_mask
    cms, kms = cm.expand(S, DIM).contiguous(), km.expand(S, DIM).contiguous()
    x, y = _points(rng, N_MAX), _points(rng, M)
    s2, rho = torch.tensor([1.0, 0.5, 2.0]), torch.tensor([0.3, 0.8, 0.2])
    assert torch.equal(mixed.mixed_gram(x, y, s2, rho, cms, kms),
                       mixed.mixed_gram(x, y, s2, rho, cm, km))
    nn = torch.tensor([N_MAX, 4, 1])
    assert torch.equal(
        mixed.masked_gram(x, nn, s2, rho, 1e-6, cms, kms),
        mixed.masked_gram(x, nn, s2, rho, 1e-6, cm, km))
    cand, x_buf, amask, alpha, a_buf, (s2, rho, shift) = _ei_operands(rng)
    stacked = acq.fused_ei_grad(cand, x_buf, amask, alpha, a_buf, s2, rho,
                                shift, cont_mask=cms, cat_mask=kms)
    shared = acq.fused_ei_grad(cand, x_buf, amask, alpha, a_buf, s2, rho,
                               shift, cont_mask=cm, cat_mask=km)
    assert all(torch.equal(a, b) for a, b in zip(stacked, shared))


def test_mixed_kernel_over_a_stack_and_its_gradient():
    """The closure over (S, d) masks is the per-study closures side by
    side, values and gradients (on the continuous block only)."""
    rng = np.random.default_rng(4)
    cm, km = _masks()
    x = _points(rng, M).requires_grad_(True)
    y = _points(rng, N_MAX)
    params = KernelParams(torch.tensor([1.0, 2.0, 0.5]),
                          torch.tensor([0.3, 0.5, 0.9]), 1e-6)
    stacked = make_mixed_kernel(cm, km)
    k = stacked(x, y, params)
    (gk,) = torch.autograd.grad(k.sum(), x)
    kg = mixed.mixed_gram(x, y, params.sigma2, params.rho, cm, km)
    (gg,) = torch.autograd.grad(kg.sum(), x)
    for s in range(S):
        p = KernelParams(params.sigma2[s], params.rho[s], 1e-6)
        xs = x[s].detach().requires_grad_(True)
        ks = make_mixed_kernel(cm[s], km[s])(xs, y[s], p)
        (gs,) = torch.autograd.grad(ks.sum(), xs)
        np.testing.assert_allclose(n(k[s]), n(ks), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(n(gk[s]), n(gs), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(n(gg[s]), n(gs), rtol=1e-4, atol=1e-5)
        assert torch.all(gg[s][:, km[s] > 0] == 0)


def test_stacked_descriptor_matches_reference():
    port, ref = _descs()
    st, jst = desc_mod.stack_descriptors(port), jdesc_mod.stack_descriptors(ref)
    assert st.is_batched and not port[0].is_batched
    for f in desc_mod.FIELDS:
        np.testing.assert_array_equal(n(getattr(st, f)), n(getattr(jst, f)))
        for s in range(S):
            np.testing.assert_array_equal(
                n(getattr(desc_mod.index_descriptor(st, s), f)),
                n(getattr(jdesc_mod.index_descriptor(jst, jnp.int32(s)), f)))
    assert st.has_discrete
    with pytest.raises(ValueError, match="one width"):
        desc_mod.stack_descriptors([port[0], desc_mod.all_continuous(3)])


def test_stacked_projection_matches_reference():
    port, ref = _descs()
    st, jst = desc_mod.stack_descriptors(port), jdesc_mod.stack_descriptors(ref)
    rng = np.random.default_rng(5)
    u = rng.uniform(-0.2, 1.2, size=(S, 16, DIM)).astype(np.float32)
    u[:, :4, 2:5] = 0.5                       # one-hot ties: first wins
    got = desc_mod.project_units(t(u), st)
    want = jax.vmap(jdesc_mod.project_units)(j(u), jst)
    np.testing.assert_array_equal(n(got), n(want))
    for s in range(S):
        assert torch.equal(got[s], desc_mod.project_units(t(u[s]), port[s]))
    np.testing.assert_array_equal(n(got[1]), u[1])     # all-continuous row
    assert torch.equal(desc_mod.project_units(got, st), got)   # idempotent
