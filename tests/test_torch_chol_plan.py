"""The Cholesky kernel's launch plan (`kernels/chol.launch_plan`), which
splits the CTAs of one cooperative launch into groups of matrices, and the
wrapper's dispatch by device.  The kernel itself runs only on the card
(`chip_smoke.py`); here the plan is walked as the kernel walks it: group g
of `groups` factors matrices g, g + groups, ...
"""
import numpy as np
import pytest
import torch
from _torch_port import j, n, spd, t

from repro.kernels import ops as jops
from repro_torch.kernels import chol, ref

CHOL_TOL = dict(rtol=5e-4, atol=5e-4)         # tests/test_kernels.py:88

# (batch, resident): one matrix, the lag refit's 18 grid candidates on one
# and two CTAs per SM of an H100, a batch that does not divide the CTAs, a
# batch of exactly the resident count, batches beyond it, the largest batch.
PLANS = [(1, 132), (1, 264), (18, 132), (18, 264), (3, 132), (100, 132),
         (132, 132), (133, 132), (1000, 264), (65535, 264), (7, 1), (1, 1)]


def _walk(batch, groups):
    """Matrices each group factors, in the kernel's order."""
    return [list(range(g, batch, groups)) for g in range(groups)]


@pytest.mark.parametrize("batch,resident", PLANS)
def test_plan_covers_every_matrix_once(batch, resident):
    groups, ctas = chol.launch_plan(batch, resident)
    seen = [m for walk in _walk(batch, groups) for m in walk]
    assert sorted(seen) == list(range(batch))
    assert all(walk for walk in _walk(batch, groups))   # no idle group


@pytest.mark.parametrize("batch,resident", PLANS)
def test_plan_stays_within_the_resident_ctas(batch, resident):
    groups, ctas = chol.launch_plan(batch, resident)
    assert groups >= 1 and ctas >= 1
    assert groups * ctas <= resident
    # Whatever is left over is less than one more CTA per group.
    assert resident - groups * ctas < groups


@pytest.mark.parametrize("resident", [1, 132, 264])
def test_one_matrix_gets_every_cta(resident):
    assert chol.launch_plan(1, resident) == (1, resident)


def test_batch_of_18_gets_a_group_per_matrix():
    assert chol.launch_plan(18, 132) == (18, 7)
    assert chol.launch_plan(18, 264) == (18, 14)


@pytest.mark.parametrize("batch,resident", [(133, 132), (1000, 264), (65535, 264)])
def test_batch_beyond_the_resident_ctas_walks_in_groups(batch, resident):
    groups, ctas = chol.launch_plan(batch, resident)
    assert (groups, ctas) == (resident, 1)
    walks = _walk(batch, groups)
    assert max(len(w) for w in walks) == -(-batch // resident)
    assert walks[0][:2] == [0, groups]


@pytest.mark.parametrize("batch,resident", [(0, 132), (1, 0), (-1, 8)])
def test_plan_rejects_an_empty_launch(batch, resident):
    with pytest.raises(ValueError):
        chol.launch_plan(batch, resident)


def test_scratch_holds_each_groups_sync_words_and_inverse():
    # csrc/chol.cu: 64 ints per group (counter, flag), then 32^2 floats each.
    assert chol.scratch_floats(1) == 64 + 1024
    assert chol.scratch_floats(18) == 18 * (64 + 1024)


@pytest.mark.parametrize("shape", [(1, 1), (48, 48), (3, 97, 97)])
def test_cpu_tensor_goes_to_the_plain_version(shape):
    rng = np.random.default_rng(shape[-1])
    k = t(spd(rng, shape[-1], batch=shape[:-2]))
    before = chol.LAUNCHES
    got = chol.cholesky(k)
    assert chol.LAUNCHES == before
    assert torch.equal(got, ref.cholesky(k))


def test_kernel_wrapper_refuses_a_cpu_tensor():
    before = chol.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        chol.cholesky_cuda(torch.eye(4))
    assert chol.LAUNCHES == before


@pytest.mark.parametrize("size,batch", [(1, ()), (97, (3,))])
def test_plain_version_matches_reference_at_the_chip_check_shapes(size, batch):
    """The ragged shapes `chip_smoke.py` holds the kernel to the plain
    version at: the plain version against the JAX package's Pallas kernel
    (interpret mode) on the same numpy input."""
    k = spd(np.random.default_rng(size), size, batch=batch)
    got = n(chol.cholesky(t(k)))
    for s in np.ndindex(*batch):
        want = jops.cholesky(j(k[s]), implementation="pallas")
        np.testing.assert_allclose(got[s], n(want), **CHOL_TOL)
