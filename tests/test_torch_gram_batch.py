"""The gram kernels' study axis in the port against the JAX package, on
the same numpy inputs:
  * the batched `ops.masked_gram` (per-study n and parameters) for the
    Matérn and the mixed kernel, against the reference's batched
    `masked_gram` (its Pallas gram in interpret mode, and XLA);
  * the lag refit's form (one `x_buf` shared by 18 candidates) against
    each candidate's reference `masked_gram`;
  * the batched gradient in x, sigma2 and rho against `jax.vmap` of the
    reference's custom VJP;
  * `matern.launch_plan`: each tile pair once, lower tiles and their
    mirrors covering a matrix exactly, the column layout for small m, the
    batch groups;
  * that a CPU tensor never reaches the kernel loader;
  * the lag refit on a real Levy-4d state where the reference's argmax
    picks a NaN candidate: the port picks a finite one and refactors to a
    finite factor and inverse."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import CPU, j, jax_state_leaves, n, t

from repro.core import gp as jgp
from repro.core.kernels import KernelParams as JParams
from repro.core.kernels import make_mixed_kernel as jmake_mixed_kernel
from repro.core.kernels import matern52 as jmatern52
from repro.core.levy import neg_levy as jneg_levy
from repro.hpo import space as jspace
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import gp
from repro_torch.core.kernels import KernelParams, make_mixed_kernel, matern52
from repro_torch.hpo.space import MIXED_DEMO_SPACE, space_to_dicts
from repro_torch.kernels import _build, matern, mixed, ops

S, N_MAX, DIM = 3, 128, 5
COUNTS = (5, 11, 17)
TOL = dict(rtol=1e-5, atol=2e-5)            # tests/test_torch_ops.py:47
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)       # tests/test_torch_mixed.py:47
MIXED = MIXED_DEMO_SPACE
GRID = [(s2, rho) for rho in (0.05, 0.1, 0.2, 0.4, 0.8, 1.6)
        for s2 in (0.25, 1.0, 4.0)]          # gp.refit_params' order


def _kernels(form):
    """(torch kernel fn, jax kernel fn, width, point sampler) of a form."""
    if form == "matern52":
        return matern52, jmatern52, DIM, \
            lambda rng, k: rng.uniform(size=(k, DIM)).astype(np.float32)
    desc = MIXED.descriptor()
    jd = jspace.space_from_dicts(space_to_dicts(MIXED)).descriptor()
    return (make_mixed_kernel(desc.cont_mask, desc.cat_mask),
            jmake_mixed_kernel(jd.cont_mask, jd.cat_mask), MIXED.dim,
            lambda rng, k: MIXED.sample(rng, k).astype(np.float32))


def _exact_padded(x_buf, active, s2, rho, noise, cont, cat):
    """The padded Gram in float64 numpy from direct differences (the mixed
    kernel's masks given; the Matérn kernel: cont all ones, cat all
    zeros)."""
    x = x_buf.astype(np.float64)
    diff = x[:, None, :] - x[None, :, :]
    z = np.sqrt(5.0) * np.sqrt(np.sum((diff * cont) ** 2, -1)) / rho
    cat_f = np.exp(-0.5 * np.sum((diff * cat) ** 2, -1) / rho)
    k = s2 * (1.0 + z + z * z / 3.0) * np.exp(-z) * cat_f
    k = k + noise * np.eye(len(x))
    act = np.arange(len(x)) < active
    return np.where(act[:, None] & act[None, :], k, np.eye(len(x)))


def _assert_held(got, want, exact):
    """`got` within TOL of the reference's `want`, or within twice the
    reference's own error against the float64 `exact`: the rule
    `chip_smoke.held_to_plain` and `held_ei` hold the kernels to.  At the
    grid's short length scales the cancelling cross term of a close pair
    rounds a few float32 ulps apart in the two packages, and z = sqrt5 d
    / rho multiplies that."""
    if not np.allclose(got, want, **TOL):
        assert np.abs(got - exact).max() <= 2.0 * np.abs(want - exact).max()


def _study_params(rng):
    s2 = rng.uniform(0.5, 2.0, S).astype(np.float32)
    rho = rng.uniform(0.2, 0.9, S).astype(np.float32)
    noise = np.asarray([1e-6, 1e-4, 1e-2], np.float32)
    return s2, rho, noise


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("form", ["matern52", "mixed"])
def test_batched_masked_gram_matches_reference(form, impl):
    kern, jkern, d, sample = _kernels(form)
    rng = np.random.default_rng(0)
    xb = np.stack([sample(rng, N_MAX) for _ in range(S)])
    s2, rho, noise = _study_params(rng)
    want = jops.masked_gram(j(xb), jnp.asarray(COUNTS), jkern,
                            JParams(j(s2), j(rho), j(noise)),
                            implementation=impl)
    got = ops.masked_gram(t(xb), torch.tensor(COUNTS), kern,
                          KernelParams(t(s2), t(rho), t(noise)))
    assert got.shape == (S, N_MAX, N_MAX)
    np.testing.assert_allclose(n(got), n(want), **TOL)
    # Outside each study's active block: exactly the identity.
    for s, c in enumerate(COUNTS):
        pad = n(got[s]).copy()
        pad[:c, :c] = 0.0
        np.testing.assert_array_equal(pad, np.diag((np.arange(N_MAX) >= c)
                                                   .astype(np.float32)))


@pytest.mark.parametrize("form", ["matern52", "mixed"])
def test_lag_form_matches_each_candidate(form):
    """One x_buf expanded over the 18 grid candidates (batch stride 0), as
    `gp._lml_grid` builds it, against the reference's masked_gram of each
    candidate."""
    kern, jkern, d, sample = _kernels(form)
    rng = np.random.default_rng(1)
    n_max, active = 24, 17
    x_buf = np.zeros((n_max, d), np.float32)
    x_buf[:active] = sample(rng, active)
    cand = torch.tensor(GRID)
    xt = t(x_buf)
    got = ops.masked_gram(xt.expand(len(GRID), n_max, d), active, kern,
                          KernelParams(cand[:, 0], cand[:, 1], 1e-6))
    masks = ((np.ones(d), np.zeros(d)) if form == "matern52" else
             (n(MIXED.descriptor().cont_mask), n(MIXED.descriptor().cat_mask)))
    for g, (s2, rho) in enumerate(GRID):
        single = ops.masked_gram(xt, active, kern,
                                 KernelParams(cand[g, 0], cand[g, 1], 1e-6))
        assert torch.equal(got[g], single)
        want = jops.masked_gram(j(x_buf), active, jkern, JParams(
            jnp.float32(s2), jnp.float32(rho), jnp.float32(1e-6)),
            implementation="pallas")
        _assert_held(n(got[g]), n(want), _exact_padded(
            x_buf, active, np.float32(s2), np.float32(rho), np.float32(1e-6),
            *masks))


@pytest.mark.parametrize("form", ["matern52", "mixed"])
def test_batched_gradient_matches_vmap_of_reference_vjp(form):
    kern, _, d, sample = _kernels(form)
    rng = np.random.default_rng(2)
    x = np.stack([sample(rng, 19) for _ in range(S)])
    y = np.stack([sample(rng, 13) for _ in range(S)])
    w = rng.standard_normal((S, 19, 13)).astype(np.float32)
    s2, rho, _ = _study_params(rng)
    if form == "matern52":
        def jgram(xx, yy, a, b):
            return jops.matern52_gram(xx, yy, a, b, implementation="pallas")

        def gram(xx, yy, a, b):
            return matern.matern52_gram(xx, yy, a, b)
    else:
        desc = MIXED.descriptor()
        jd = jspace.space_from_dicts(space_to_dicts(MIXED)).descriptor()

        def jgram(xx, yy, a, b):
            return jops.mixed_gram(xx, yy, a, b, jd.cont_mask, jd.cat_mask,
                                   implementation="pallas")

        def gram(xx, yy, a, b):
            return mixed.mixed_gram(xx, yy, a, b, desc.cont_mask,
                                    desc.cat_mask)

    def loss(xx, yy, ww, a, b):
        return jnp.sum(ww * jgram(xx, yy, a, b))

    want = jax.vmap(jax.grad(loss, argnums=(0, 3, 4)))(j(x), j(y), j(w),
                                                      j(s2), j(rho))
    xt, st, rt = (t(v).requires_grad_() for v in (x, s2, rho))
    (gram(xt, t(y), st, rt) * t(w)).sum().backward()
    for got, ref_grad in zip((xt.grad, st.grad, rt.grad), want):
        np.testing.assert_allclose(n(got), n(ref_grad), **GRAD_TOL)
    # One x shared by the batch (the lag refit's form): its gradient is the
    # sum of the per-matrix gradients.
    x0 = t(x[0]).requires_grad_()
    (gram(x0, t(y), t(s2), t(rho)) * t(w)).sum().backward()
    shared = jax.vmap(jax.grad(loss), in_axes=(None, 0, 0, 0, 0))(
        j(x[0]), j(y), j(w), j(s2), j(rho))
    np.testing.assert_allclose(n(x0.grad), n(shared).sum(0), **GRAD_TOL)


# ---------------------------------------------------------------------------
# The launch plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("size", [9, 64, 65, 130, 1000, 1024])
def test_plan_runs_each_tile_pair_once(size, symmetric):
    plan = matern.launch_plan(size, size, 5, 1, symmetric, True)
    assert plan.layout == "tile" and plan.symmetric == symmetric
    pairs = [matern.tile_pair(plan, p) for p in range(plan.grid[0])]
    tiles = plan.tiles_n
    want = ({(bi, bj) for bi in range(tiles) for bj in range(bi + 1)}
            if symmetric else
            {(bi, bj) for bi in range(tiles) for bj in range(tiles)})
    assert len(pairs) == len(set(pairs)) == len(want)
    assert set(pairs) == want


@pytest.mark.parametrize("size", [9, 64, 65, 130, 1000])
def test_lower_tiles_and_mirrors_cover_the_matrix_exactly(size):
    """Every entry of a symmetric build is written once: by its lower tile
    pair or by that pair's mirror (the diagonal tiles only once)."""
    plan = matern.launch_plan(size, size, 5, 1, True, True)
    tile = matern.TILE
    writes = np.zeros((size, size), np.int32)
    for p in range(plan.grid[0]):
        bi, bj = matern.tile_pair(plan, p)
        writes[bi * tile:(bi + 1) * tile, bj * tile:(bj + 1) * tile] += 1
        if bi != bj:
            writes[bj * tile:(bj + 1) * tile, bi * tile:(bi + 1) * tile] += 1
    assert (writes == 1).all()


def test_tile_pair_decodes_far_into_the_triangle():
    plan = matern.launch_plan(2 ** 20, 2 ** 20, 5, 1, True, True)
    for bi in (0, 1, 2047, 8191, 16383):
        for bj in sorted({0, bi // 2, bi}):
            assert matern.tile_pair(plan, bi * (bi + 1) // 2 + bj) == (bi, bj)


@pytest.mark.parametrize("m", [1, 7, 8, 9])
def test_column_layout_for_small_m(m):
    plan = matern.launch_plan(1000, m, 5, 1, False, True)
    if m <= matern.COL_MAX_M:
        assert plan.layout == "column" and not plan.symmetric
        assert plan.grid == (-(-1000 // matern.COL_THREADS), 1)
        assert plan.threads == matern.COL_THREADS
    else:
        assert plan.layout == "tile"
        assert plan.grid[0] == 16 * 1


@pytest.mark.parametrize("batch,shared", [(1, True), (3, False), (18, True),
                                          (18, False), (1000, True)])
@pytest.mark.parametrize("size", [1, 100, 1024])
def test_groups_cover_the_batch(batch, shared, size):
    plan = matern.launch_plan(size, size, 6, batch, True, shared)
    groups = plan.grid[1]
    assert plan.per_group * groups >= batch > plan.per_group * (groups - 1)
    if not shared:
        assert plan.per_group == 1 and groups == batch
    else:
        assert groups <= max(1, -(-matern.TARGET_CTAS // plan.grid[0]))


def test_lag_batch_plan():
    """The lag refit's 18 Grams at n_max 1024: 136 lower tile pairs, the
    batch in 6 groups of 3 (one rho each in the refit's order)."""
    plan = matern.launch_plan(1024, 1024, 5, 18, True, True)
    assert (plan.layout, plan.per_group, plan.grid) == ("tile", 3, (136, 6))


@pytest.mark.parametrize("args", [(0, 4, 5, 1, False, True),
                                  (4, 4, 5, 0, True, True),
                                  (8, 9, 5, 1, True, True),
                                  (100, 100, 5, 70000, True, False)])
def test_plan_rejects_what_the_kernel_cannot_run(args):
    with pytest.raises(ValueError):
        matern.launch_plan(*args)


# ---------------------------------------------------------------------------
# Dispatch on the CPU
# ---------------------------------------------------------------------------
def test_cpu_tensor_never_reaches_the_loader(monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernel loader")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    before = (matern.LAUNCHES, mixed.LAUNCHES)
    rng = np.random.default_rng(3)
    for form in ("matern52", "mixed"):
        kern, _, d, sample = _kernels(form)
        x = t(np.stack([sample(rng, 12) for _ in range(S)]))
        p = KernelParams(t(np.ones(S)), t(np.full(S, 0.5)), 1e-6)
        ops.masked_gram(x, torch.tensor([3, 5, 12]), kern, p)
        ops.masked_gram(x[0], 4, kern, KernelParams(1.0, 0.5, 1e-6))
        ops.kernel_gram(kern, x, x, p)
        ops.kernel_gram(kern, x[0], x[0, :1], KernelParams(1.0, 0.5, 1e-6))
    assert (matern.LAUNCHES, mixed.LAUNCHES) == before


def test_cuda_entries_refuse_cpu_tensors():
    x = torch.rand(4, 3)
    cm, km = torch.ones(3), torch.zeros(3)
    for call in (lambda: matern.matern52_gram_cuda(x, x, 1.0, 0.5),
                 lambda: matern.masked_gram_cuda(x, 2, 1.0, 0.5, 1e-6),
                 lambda: mixed.mixed_gram_cuda(x, x, 1.0, 0.5, cm, km),
                 lambda: mixed.masked_gram_cuda(x, 2, 1.0, 0.5, 1e-6, cm, km)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


# ---------------------------------------------------------------------------
# The lag refit on a real state where the reference picks a NaN candidate
# ---------------------------------------------------------------------------
def _levy4d_state():
    """A Levy-4d state at tests/test_accuracy.py's setting (8 uniform seed
    points, n_max 40, noise 1e-6) after 20 BO-like rounds, each a step of
    0.01 from the incumbent on the unit box, found by a seeded search
    (seed 0): its Gram under the long length scales is not positive
    definite in float32."""
    rng = np.random.default_rng(0)
    pts = [rng.uniform(size=(8, 4))]

    def values(u):
        return np.asarray(jneg_levy(jnp.asarray(-10.0 + 20.0 * u, jnp.float32)))

    for _ in range(20):
        u = np.concatenate(pts)
        pts.append(np.clip(u[np.argmax(values(u))]
                           + 0.01 * rng.standard_normal((1, 4)), 0.0, 1.0))
    x = np.concatenate(pts).astype(np.float32)
    cfg = jgp.GPConfig(n_max=40, dim=4, noise2=1e-6, implementation="xla")
    return jgp.append_batch(jgp.init_state(cfg), jmatern52, j(x),
                            j(values(x).astype(np.float32)),
                            implementation="xla")


def test_refit_stays_finite_where_the_reference_picks_nan():
    js = _levy4d_state()
    lmls = jnp.stack([jgp._lml_for(js, jmatern52, JParams(
        sigma2=jnp.float32(s2), rho=jnp.float32(rho), noise2=js.params.noise2),
        implementation="xla") for s2, rho in GRID])
    assert bool(jnp.isnan(lmls[jnp.argmax(lmls)]))     # the reference's pick
    ts = convert.state_from_numpy(jax_state_leaves(js), device=CPU)
    p = gp.refit_params(ts, matern52)
    cand = torch.tensor(GRID)
    port_lmls = gp._lml_grid(ts, matern52, cand)
    pick = int(((cand[:, 0] == p.sigma2) & (cand[:, 1] == p.rho)).nonzero())
    finite = torch.isfinite(port_lmls)
    assert bool(finite[pick])
    assert float(port_lmls[pick]) == float(port_lmls[finite].max())
    st = gp.refactor(ts, matern52, p)
    assert bool(torch.isfinite(st.l_buf).all())
    assert bool(torch.isfinite(st.li_buf).all())
    assert bool(torch.isfinite(st.alpha).all())
