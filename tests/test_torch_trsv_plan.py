"""The general triangular solve's launch plan (`kernels/trsv.launch_plan`)
and the solve-based append that runs on it.

The kernel (`repro_trsv` in `csrc/trsv.cu`) runs only on the card
(`chip_smoke.py`); here its plan is walked as the kernel walks it: the
regime switch, the narrow regime's ticket order (each CTA waits only on
blocks of earlier tickets), shared memory, scratch and grid.  The plain
versions, which stand in for the kernel on the CPU, are held to the JAX
package on shared numpy inputs: the paper's solve-based append (Alg. 3,
`core/cholesky.lazy_append_row` / `lazy_append_block`), `padded_trsv` on a
study axis against the reference's `vmap`, and the solve's VJP in both
directions against autograd through the plain solve.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import j, lower_factor, n, spd, t

from repro.core import cholesky as jchol
from repro.kernels import ops as jops
from repro_torch.core import cholesky as chol_core
from repro_torch.kernels import _build, ops, ref, trsv

MAX_SHARED = 232448            # opt-in shared memory of one H100 CTA
# Well-conditioned factors (spd: A A^T / n + 2 I): the two packages differ
# only by float32 rounding in their block sums.
TOL = dict(rtol=1e-5, atol=1e-6)
# A gradient is a product of O(1) matrices summed over n terms.
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
N_MAX = 64


def _plan(monkeypatch, regime, nn, r, batch=1):
    """`trsv.launch_plan` with the switch moved so that it picks `regime`
    (None: the switch as it is)."""
    if regime is not None:
        monkeypatch.setattr(trsv, "NARROW_MAX_R", r if regime == "narrow" else r - 1)
    return trsv.launch_plan(nn, r, batch)


# ---------------------------------------------------------------------------
# The launch plan.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("r", [1, 2, 8, 9, 64, trsv.NARROW_MAX_R])
def test_narrow_regime_up_to_the_switch(r):
    assert trsv.launch_plan(1024, r, 1).regime == "narrow"


@pytest.mark.parametrize("r", [trsv.NARROW_MAX_R + 1, 1024, 6144])
def test_wide_regime_past_the_switch(r):
    assert trsv.launch_plan(1024, r, 1).regime == "wide"


@pytest.mark.parametrize("nn", [64, 65, 100, 128, 129, 256, 1000, 1024, 4096,
                                16384])
def test_a_vector_spreads_over_more_than_one_cta(nn):
    plan = trsv.launch_plan(nn, 1, 1)
    assert plan.regime == "narrow" and plan.grid > 1
    assert plan.grid == -(-nn // plan.rows)
    assert plan.rows in (32, 64, 128)


@pytest.mark.parametrize("nn", [1, 31, 32, 64])
def test_a_short_vector_takes_32_row_blocks(nn):
    plan = trsv.launch_plan(nn, 1, 1)
    assert plan.rows == 32 and plan.grid == -(-nn // 32)


@pytest.mark.parametrize("nn", [1, 31, 64, 1000, 1024, 4096, 6112, 6144, 16384])
@pytest.mark.parametrize("r", [1, 8, 64, "n"])
@pytest.mark.parametrize("regime", [None, "narrow", "wide"])
def test_shared_memory_fits_one_cta(nn, r, regime, monkeypatch):
    r = nn if r == "n" else r
    plan = _plan(monkeypatch, regime, nn, r)
    assert regime is None or plan.regime == regime
    assert 0 < plan.shared_bytes <= MAX_SHARED
    # The ring, the window of two blocks of q's rows (8 floats a row), the
    # control words.
    window = 2 * plan.rows * 8
    assert plan.shared_bytes == 4 * (plan.stages * plan.rows * 36 + window) + 16


@pytest.mark.parametrize("nn", [32, 1024, 4960, 6080, 6081, 6112, 6144, 16384])
def test_wide_streams_q_through_a_window_of_two_blocks(nn, monkeypatch):
    plan = trsv.launch_plan(nn, nn, 1)
    assert plan.regime == "wide" or nn <= trsv.NARROW_MAX_R
    wide = _plan(monkeypatch, "wide", nn, nn)
    # One geometry at every n: 128-row blocks, 4 stages, 80 KB a CTA.
    assert (wide.rows, wide.stages, wide.cols) == (128, 4, 8)
    assert wide.shared_bytes == 4 * (4 * 128 * 36 + 2 * 128 * 8) + 16
    # Beyond the L X = I kernel's limit L X = I takes this regime.
    assert trsv.MAX_N == 6112 and trsv.inverse_entry(6144) == "trsv"


@pytest.mark.parametrize("nn,r,batch", [(1024, 1, 1), (1024, 1, 3), (1000, 7, 2),
                                        (1024, 64, 1), (97, 9, 18), (1024, 1024, 18)])
def test_scratch_holds_a_progress_word_per_matrix_and_panel(nn, r, batch, monkeypatch):
    narrow = _plan(monkeypatch, "narrow", nn, r, batch)
    assert narrow.scratch_ints == 2 + batch * -(-r // 8)
    assert _plan(monkeypatch, "wide", nn, r, batch).scratch_ints == 0


@pytest.mark.parametrize("nn,r,batch", [(1024, 1, 1), (1024, 1, 3), (1000, 7, 2),
                                        (1024, 64, 1), (6144, 6144, 1),
                                        (1024, 1024, 18)])
def test_grid(nn, r, batch, monkeypatch):
    panels = -(-r // 8)
    narrow = _plan(monkeypatch, "narrow", nn, r, batch)
    assert narrow.grid == batch * panels * -(-nn // narrow.rows)
    assert _plan(monkeypatch, "wide", nn, r, batch).grid == batch * panels
    assert narrow.cols == 8


def test_grid_past_one_launch_is_refused(monkeypatch):
    # 2^32 CTAs: 8 systems of 2^24 panels of 8 columns in 32 blocks of 128
    # rows; 2^31 in the wide regime: 2^15 systems of 2^16 panels.
    with pytest.raises(ValueError, match="grid"):
        _plan(monkeypatch, "narrow", 4096, 8 * 2**24, 8)
    with pytest.raises(ValueError, match="grid"):
        _plan(monkeypatch, "wide", 128, 8 * 2**16, 2**15)
    assert _plan(monkeypatch, "wide", 128, 8, 2**31 - 1).grid == 2**31 - 1


@pytest.mark.parametrize("args", [(0, 1, 1), (8, 0, 1), (8, 1, 0), (-1, 1, 1)])
def test_plan_rejects_an_empty_solve(args):
    with pytest.raises(ValueError):
        trsv.launch_plan(*args)


@pytest.mark.parametrize("switch", [0, 1, 7, 64, 10**6])
def test_plan_reads_the_switch_at_each_call(switch, monkeypatch):
    monkeypatch.setattr(trsv, "NARROW_MAX_R", switch)
    for r in (1, 8, 64, 1024):
        assert trsv.launch_plan(64, r, 1).regime == ("narrow" if r <= switch
                                                     else "wide")


@pytest.mark.parametrize("nn,r,batch", [(1024, 1, 1), (1000, 3, 3), (300, 20, 2),
                                        (64, 1, 1), (129, 9, 5)])
@pytest.mark.parametrize("trans", [False, True])
def test_narrow_tickets_wait_only_on_earlier_tickets(nn, r, batch, trans, monkeypatch):
    """Ticket -> (matrix, panel, block) as the kernel maps it: every block
    once, and every block a CTA waits on (above it for L, below it for L^T,
    same matrix and panel) has an earlier ticket, so a CTA only ever waits
    on CTAs that were already running."""
    order = trsv.narrow_order(nn, r, batch, trans)
    plan = _plan(monkeypatch, "narrow", nn, r, batch)
    nblk, panels = -(-nn // plan.rows), -(-r // 8)
    assert sorted(order) == [(m, p, k) for m in range(batch) for p in range(panels)
                             for k in range(nblk)]
    ticket = {key: i for i, key in enumerate(order)}
    for (m, p, k), i in ticket.items():
        waits = range(k + 1, nblk) if trans else range(k)
        assert all(ticket[(m, p, w)] < i for w in waits)
    # Blocks in solve order: the first tickets are the first blocks.
    assert order[0][2] == (nblk - 1 if trans else 0)


# ---------------------------------------------------------------------------
# Dispatch.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,r", [((1, 1), 1), ((100, 100), 1), ((3, 97, 97), 9),
                                     ((40, 40), 600)])
@pytest.mark.parametrize("trans", [False, True])
def test_cpu_tensor_goes_to_the_plain_version(shape, r, trans, monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernel loader")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    rng = np.random.default_rng(shape[-1] + r)
    l = t(lower_factor(rng, shape[-1], shape[:-2]))
    b = t(rng.standard_normal((*shape[:-1], r)))
    before = (trsv.LAUNCHES, trsv.LAUNCHES_GENERAL)
    got = trsv.trsv(l, b, trans=trans)
    assert (trsv.LAUNCHES, trsv.LAUNCHES_GENERAL) == before
    assert torch.equal(got, ref.trsv(l, b, trans=trans))


def test_kernel_wrapper_refuses_a_cpu_tensor():
    before = (trsv.LAUNCHES, trsv.LAUNCHES_GENERAL)
    with pytest.raises(ValueError, match="CUDA"):
        trsv.trsv_cuda(torch.eye(4), torch.ones(4, 1))
    assert (trsv.LAUNCHES, trsv.LAUNCHES_GENERAL) == before


# ---------------------------------------------------------------------------
# The solve-based append (paper Alg. 3) against the JAX package.
# ---------------------------------------------------------------------------
def _padded_state(rng, active: int, extra: int):
    """An identity-padded factor of the first `active` points of an SPD
    Gram of active + extra points, and the Gram itself."""
    k = spd(rng, active + extra)
    l_buf = np.eye(N_MAX, dtype=np.float32)
    l_buf[:active, :active] = np.linalg.cholesky(
        k[:active, :active].astype(np.float64)).astype(np.float32)
    return l_buf, k


def _columns(k, active: int, count: int):
    """Padded columns p_i (rows < active + i) and self-covariances c_i of
    the next `count` points."""
    p = np.zeros((count, N_MAX), np.float32)
    for i in range(count):
        p[i, :active + i] = k[:active + i, active + i]
    return p, np.array([k[active + i, active + i] for i in range(count)],
                       np.float32)


@pytest.mark.parametrize("active", [0, 1, 40, N_MAX - 1])
def test_lazy_append_row_matches_reference(active):
    rng = np.random.default_rng(active + 3)
    l_buf, k = _padded_state(rng, active, 1)
    p, c = _columns(k, active, 1)
    want_l, want_d = jchol.lazy_append_row(
        j(l_buf), j(p[0]), jnp.float32(c[0]), jnp.int32(active), n_max=N_MAX,
        implementation="ref")
    got_l, got_d = chol_core.lazy_append_row(t(l_buf), t(p[0]), float(c[0]),
                                             active, n_max=N_MAX)
    np.testing.assert_allclose(n(got_l), n(want_l), **TOL)
    np.testing.assert_allclose(float(got_d), float(want_d), **TOL)


@pytest.mark.parametrize("active,count", [(32, 8), (0, 16), (50, N_MAX - 50)])
def test_lazy_append_block_matches_reference_and_refactor(active, count):
    rng = np.random.default_rng(active * 100 + count)
    l_buf, k = _padded_state(rng, active, count)
    p, c = _columns(k, active, count)
    want = jchol.lazy_append_block(j(l_buf), j(p), j(c), jnp.int32(active),
                                   n_max=N_MAX, implementation="ref")
    got = chol_core.lazy_append_block(t(l_buf), t(p), t(c), active, n_max=N_MAX)
    np.testing.assert_allclose(n(got), n(want), **TOL)
    # Alg. 3 rebuilds the factor of the whole padded Gram (Alg. 2).
    k_pad = np.eye(N_MAX, dtype=np.float32)
    k_pad[:active + count, :active + count] = k
    full = ops.padded_cholesky(t(k_pad))
    np.testing.assert_allclose(n(got), n(full), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# The study axis of padded_trsv: (S, n, n) with (S, n) or (S, n, r).
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rhs", [(), (3,)])
@pytest.mark.parametrize("trans", [False, True])
def test_padded_trsv_study_axis_matches_reference_vmap(rhs, trans):
    rng = np.random.default_rng(11 + len(rhs))
    active = (5, 40, 64)
    l_buf = np.broadcast_to(np.eye(N_MAX, dtype=np.float32),
                            (len(active), N_MAX, N_MAX)).copy()
    b = np.zeros((len(active), N_MAX, *rhs), np.float32)
    for s, a in enumerate(active):
        l_buf[s, :a, :a] = lower_factor(rng, a)
        b[s, :a] = rng.standard_normal((a, *rhs))
    want = jax.vmap(lambda ll, bb: jops.padded_trsv(
        ll, bb, trans=trans, implementation="ref"))(j(l_buf), j(b))
    got = chol_core.padded_trsv(t(l_buf), t(b), trans=trans)
    np.testing.assert_allclose(n(got), n(want), **TOL)
    for s, a in enumerate(active):
        assert np.all(n(got)[s, a:] == 0.0)


# ---------------------------------------------------------------------------
# The solve's VJP against autograd through the plain solve.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("shape,r", [((45, 45), 3), ((2, 70, 70), 1), ((33, 33), None)])
def test_trsv_vjp_matches_autograd_through_the_plain_solve(trans, shape, r):
    rng = np.random.default_rng(shape[-1] + (r or 0) + 2 * trans)
    l = t(lower_factor(rng, shape[-1], shape[:-2]))
    rhs = shape[:-1] + ((r,) if r else ())
    b = t(rng.standard_normal(rhs))
    g = t(rng.standard_normal(rhs))
    l1, b1 = l.clone().requires_grad_(), b.clone().requires_grad_()
    (trsv.trsv(l1, b1, trans=trans) * g).sum().backward()
    l2, b2 = l.clone().requires_grad_(), b.clone().requires_grad_()
    bb = b2 if r else b2[..., None]
    q = ref.trsv(l2, bb, trans=trans)
    (q if r else q[..., 0]).mul(g).sum().backward()
    # The plain solve's autograd also reaches L's zero upper half, which a
    # lower-triangular factor does not have: hold the lower triangle.
    np.testing.assert_allclose(n(l1.grad), n(torch.tril(l2.grad)), **GRAD_TOL)
    np.testing.assert_allclose(n(b1.grad), n(b2.grad), **GRAD_TOL)
    assert np.all(np.triu(n(l1.grad), 1) == 0)
