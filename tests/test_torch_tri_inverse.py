"""The inverse factor X = L^{-1} (`kernels/trsv.tri_inverse`, the refactor's
and the lag refit's solve) against the JAX package's
`padded_tri_inverse` on shared numpy inputs, its gradient against
`jax.grad`, its dispatch by device, and the kernel's launch order.  The
kernel itself (`repro_tri_inverse` in `csrc/trsv.cu`) runs only on the
card (`chip_smoke.py`); here the launch order is walked as the kernel
walks it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import j, lower_factor, n, t

from repro.kernels import ops as jops
from repro_torch.kernels import _build, ops, ref, trsv

N_MAX = 256
# Well-conditioned factors (lower_factor: A A^T / n + 2 I), so X's entries
# are O(1) and the two packages differ only by float32 rounding in their
# block sums (32-row blocks here, 128-row blocks in the Pallas kernel).
TOL = dict(rtol=1e-5, atol=1e-6)
# The gradient is a product of three O(1) matrices summed over n_max terms.
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def padded_factor(rng, active: int, batch=()) -> np.ndarray:
    """Identity-padded (n_max, n_max) factors with `active` rows of data."""
    l = np.broadcast_to(np.eye(N_MAX, dtype=np.float32),
                        (*batch, N_MAX, N_MAX)).copy()
    l[..., :active, :active] = lower_factor(rng, active, batch)
    return l


@pytest.mark.parametrize("batch,active", [((), 200), ((3,), 131)])
def test_tri_inverse_matches_pallas(batch, active):
    l = padded_factor(np.random.default_rng(active), active, batch)
    got = n(trsv.tri_inverse(t(l)))
    for s in np.ndindex(*batch):
        want = jops.padded_tri_inverse(j(l[s]), implementation="pallas")
        np.testing.assert_allclose(got[s], n(want), **TOL)


@pytest.mark.parametrize("batch,active", [((), 200), ((3,), 131)])
def test_padded_tri_inverse_routes_to_tri_inverse(batch, active):
    """`ops.padded_tri_inverse` is `tri_inverse` and builds no identity: on
    the CPU it is bit for bit the general solve at B = I."""
    lt = t(padded_factor(np.random.default_rng(active + 1), active, batch))
    eye = torch.eye(N_MAX).expand_as(lt)
    assert torch.equal(ops.padded_tri_inverse(lt), ref.trsv(lt, eye))
    assert torch.equal(ops.padded_tri_inverse(lt), trsv.tri_inverse(lt))


def test_tri_inverse_gradient_matches_jax_grad():
    rng = np.random.default_rng(7)
    l = padded_factor(rng, 150)
    g = rng.standard_normal((N_MAX, N_MAX)).astype(np.float32)

    def loss(ll):
        x = jops.padded_tri_inverse(ll, implementation="pallas")
        return jnp.sum(x * j(g))

    want = jax.grad(loss)(j(l))
    lt = t(l).requires_grad_()
    (trsv.tri_inverse(lt) * t(g)).sum().backward()
    np.testing.assert_allclose(n(lt.grad), n(want), **GRAD_TOL)
    assert np.all(np.triu(n(lt.grad), 1) == 0)


def test_tri_inverse_gradient_is_the_solve_vjp_at_identity():
    """The same cotangent through `trsv(l, I)` gives the same L_bar."""
    rng = np.random.default_rng(8)
    l = t(lower_factor(rng, 45, (2,)))
    g = t(rng.standard_normal((2, 45, 45)))
    a, b = l.clone().requires_grad_(), l.clone().requires_grad_()
    (trsv.tri_inverse(a) * g).sum().backward()
    (trsv.trsv(b, torch.eye(45).expand(2, 45, 45)) * g).sum().backward()
    torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(1, 1), (48, 48), (3, 97, 97)])
def test_cpu_tensor_goes_to_the_plain_version(shape, monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernel loader")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    l = t(lower_factor(np.random.default_rng(shape[-1]), shape[-1], shape[:-2]))
    before = trsv.LAUNCHES
    got = trsv.tri_inverse(l)
    assert trsv.LAUNCHES == before
    assert torch.equal(got, ref.tri_inverse(l))


def test_kernel_wrapper_refuses_a_cpu_tensor():
    before = trsv.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        trsv.tri_inverse_cuda(torch.eye(4))
    assert trsv.LAUNCHES == before


@pytest.mark.parametrize("size,batch", [(1, ()), (97, (3,)), (48, ())])
def test_plain_version_matches_reference_at_the_chip_check_shapes(size, batch):
    """The ragged shapes `chip_smoke.py` holds the kernel to the plain
    version at: the plain version against the JAX package's Pallas solve
    (interpret mode) at B = I on the same numpy factor."""
    l = lower_factor(np.random.default_rng(size), size, batch)
    got = n(trsv.tri_inverse(t(l)))
    eye = j(np.eye(size, dtype=np.float32))
    for s in np.ndindex(*batch):
        want = jops.trsv(j(l[s]), eye, implementation="pallas")
        np.testing.assert_allclose(got[s], n(want), **TOL)


# ---------------------------------------------------------------------------
# Launch order of repro_tri_inverse: CTA i of the grid -> (matrix, panel).
# ---------------------------------------------------------------------------
def panel_fmas(size: int, c0: int) -> int:
    """FMAs of the panel at column c0: column c runs rows c + 1 .. n - 1,
    row i against the solved rows c .. i - 1."""
    return sum((size - c) * (size - c - 1) // 2
               for c in range(c0, min(c0 + trsv.PANEL, size)))


# (n, batch): one matrix, the lag refit's 18, ragged n, tiny n.
ORDERS = [(1024, 1), (1024, 18), (1000, 18), (1000, 1), (97, 3), (1, 1),
          (5, 7), (33, 2), (48, 1)]


@pytest.mark.parametrize("size,batch", ORDERS)
def test_launch_order_covers_every_panel_once(size, batch):
    order = trsv.launch_order(size, batch)
    panels = [(m, c0) for m in range(batch) for c0 in range(0, size, trsv.PANEL)]
    assert sorted(order) == panels


@pytest.mark.parametrize("size,batch", ORDERS)
def test_launch_order_issues_the_heaviest_panels_first(size, batch):
    work = [panel_fmas(size, c0) for _, c0 in trsv.launch_order(size, batch)]
    assert work == sorted(work, reverse=True)
    assert work[0] == max(panel_fmas(size, c0) for c0 in range(0, size, trsv.PANEL))


def test_launch_order_of_the_lag_batch_starts_with_every_panel_zero():
    order = trsv.launch_order(1024, 18)
    assert order[:18] == [(m, 0) for m in range(18)]
    assert order[18:36] == [(m, trsv.PANEL) for m in range(18)]


@pytest.mark.parametrize("args", [(0, 1), (8, 0)])
def test_launch_order_rejects_an_empty_launch(args):
    with pytest.raises(ValueError):
        trsv.launch_order(*args)


def test_shared_memory_holds_the_staged_tiles_and_the_panel():
    # Two 128 x 36 float tiles of L, then 8 floats a row of X (rows
    # rounded up to 32); n = 1024 fits three CTAs (and the 1 KB the card
    # keeps for each) in an SM's 228 KB.
    assert trsv.shared_bytes(1024) == 2 * 128 * 36 * 4 + 1024 * 32
    assert trsv.shared_bytes(1000) == trsv.shared_bytes(1024)
    assert 3 * (trsv.shared_bytes(1024) + 1024) <= 228 * 1024
    assert trsv.MAX_N == 6112
    assert trsv.shared_bytes(trsv.MAX_N) <= 232448
    assert trsv.shared_bytes(trsv.MAX_N + 1) > 232448
