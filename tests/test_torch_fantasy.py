"""The port's fantasy rows (`gp.FantasyConfig`, `fantasy_values`,
`fantasize`, `truncate`) against the JAX package's (`implementation=
"xla"`), on the same seeded states (built by the reference and carried
across by `convert`) and the same fantasy points: single-study and
stacked, Matérn and mixed.  The points land bit for bit; the liar values
of the "mean" liar are posterior means, and they, the factor, its inverse
and alpha are held at `TOL`; the rollback re-pads x, y, the factor and its
inverse bit for bit."""
import numpy as np
import pytest
import torch
from _torch_port import (CPU, TOL, j, jax_state_leaves, levy_states,
                         mixed_space4, n, t)

from repro.core import gp as jgp
from repro_torch import convert
from repro_torch.core import gp as tgp

DIM, N_MAX, N0 = 4, 32, 12
SEPARATION = 0.1          # least distance of a fantasy point (`_points`)
MIXED = mixed_space4()


def _points(rng, mixed: bool, count: int, away_from=None) -> np.ndarray:
    """`count` points (on the mixed lattice where `mixed`).  With
    `away_from` (rows already in a state), each point is at least
    `SEPARATION` from those rows and from the points before it: a fantasy
    row at a near-duplicate point has a new diagonal d^2 = c - |q|^2 that
    cancels to ~1e-4, where float32 round-off of either package is
    amplified by 1/d^2 past TOL (the same in both packages, against a
    float64 evaluation)."""
    def draw(k):
        if mixed:
            return MIXED.sample(rng, k)
        return rng.uniform(size=(k, DIM)).astype(np.float32)
    if away_from is None:
        return draw(count)
    taken, out = [np.asarray(a) for a in away_from], []
    while len(out) < count:
        u = draw(1)[0]
        if all(np.linalg.norm(u - v) >= SEPARATION for v in taken):
            taken.append(u)
            out.append(u)
    return np.stack(out)


def _states(rng, mixed: bool, n0: int = N0):
    return levy_states(_points(rng, mixed, n0), N_MAX,
                       MIXED if mixed else None)


def _leaves(st):
    return [n(v) for v in tgp._leaves(st)]


def _bits_equal(a, b) -> bool:
    return all(np.asarray(u).tobytes() == np.asarray(v).tobytes()
               for u, v in zip(_leaves(a), _leaves(b)))


def _held(got, want, n_real, liar):
    """A port state against the reference's after the same fantasy rows:
    the counters exactly, x bit for bit, y bit for bit on the real rows
    (and on the fantasy rows for the constant liar), the rest at TOL."""
    assert np.array_equal(n(got.n), n(want.n))
    assert np.array_equal(n(got.since_refit), n(want.since_refit))
    assert np.array_equal(n(got.clamp_count), n(want.clamp_count))
    np.testing.assert_array_equal(n(got.x_buf), n(want.x_buf))
    gy, wy = n(got.y_buf), n(want.y_buf)
    for s, count in enumerate(np.atleast_1d(n_real)):
        gs, ws = np.atleast_2d(gy)[s], np.atleast_2d(wy)[s]
        np.testing.assert_array_equal(gs[:count], ws[:count])
        if liar == "pessimistic":
            np.testing.assert_array_equal(gs, ws)
    np.testing.assert_allclose(gy, wy, **TOL)
    for leaf in ("l_buf", "li_buf", "alpha"):
        np.testing.assert_allclose(n(getattr(got, leaf)),
                                   n(getattr(want, leaf)), **TOL,
                                   err_msg=leaf)


def test_fantasy_config_validates_the_liar():
    assert tgp.FANTASY_LIARS == jgp.FANTASY_LIARS
    assert tgp.FantasyConfig().liar == jgp.FantasyConfig().liar == "mean"
    assert tgp.FantasyConfig("pessimistic").liar == "pessimistic"
    with pytest.raises(ValueError, match="unknown fantasy liar"):
        tgp.FantasyConfig("median")
    _, tst, _, tkern = _states(np.random.default_rng(0), False)
    with pytest.raises(ValueError, match="unknown fantasy liar"):
        tgp.fantasy_values(tst, tkern, tst.x_buf[:2], "median")


@pytest.mark.parametrize("mixed", [False, True], ids=["matern", "mixed"])
@pytest.mark.parametrize("liar", tgp.FANTASY_LIARS)
def test_fantasy_values_match_reference(liar, mixed):
    rng = np.random.default_rng(1)
    jst, tst, jkern, tkern = _states(rng, mixed)
    xs = _points(rng, mixed, 5)
    want = jgp.fantasy_values(jst, jkern, j(xs), liar, implementation="xla")
    got = tgp.fantasy_values(tst, tkern, t(xs), liar)
    assert got.shape == (5,)
    np.testing.assert_allclose(n(got), n(want), **TOL)
    if liar == "pessimistic":
        np.testing.assert_array_equal(n(got), n(want))
    # The empty state: the prior mean 0, and 0 for the constant liar.
    cfg = jgp.GPConfig(n_max=N_MAX, dim=DIM, implementation="xla")
    jempty = jgp.init_state(cfg)
    tempty = convert.state_from_numpy(jax_state_leaves(jempty), device=CPU)
    want = jgp.fantasy_values(jempty, jkern, j(xs), liar,
                              implementation="xla")
    got = tgp.fantasy_values(tempty, tkern, t(xs), liar)
    np.testing.assert_array_equal(n(got), n(want))
    assert not n(got).any()


@pytest.mark.parametrize("mixed", [False, True], ids=["matern", "mixed"])
@pytest.mark.parametrize("liar", tgp.FANTASY_LIARS)
@pytest.mark.parametrize("q", [1, 4])
def test_fantasize_and_truncate_single_study(q, liar, mixed):
    rng = np.random.default_rng(2)
    jst, tst, jkern, tkern = _states(rng, mixed)
    before = [v.clone() for v in tgp._leaves(tst)]
    xs = _points(rng, mixed, q, n(tst.x_buf[:N0]))
    want = jgp.fantasize(jst, jkern, j(xs), liar, implementation="xla")
    got = tgp.fantasize(tst, tkern, t(xs), liar)
    assert got.n == N0 + q and got.since_refit == tst.since_refit
    _held(got, want, N0, liar)
    # The input state is the caller's: never written.
    assert all(torch.equal(a, b) for a, b in zip(before, tgp._leaves(tst)))
    # In place: the same bits, written into the given buffers.
    own = tgp._copy(tst)
    inplace = tgp.fantasize(own, tkern, t(xs), liar, in_place=True)
    assert inplace.l_buf is own.l_buf and _bits_equal(inplace, got)

    # Rollback: x, y, L and L^-1 re-padded to the pre-fantasy bits; alpha
    # recomputed as the reference recomputes it, or the kept copy.
    back = tgp.truncate(got, N0)
    jback = jgp.truncate(want, N0)
    assert back.n == N0 and back.since_refit == tst.since_refit
    for leaf in ("x_buf", "y_buf", "l_buf", "li_buf", "clamp_count"):
        assert n(getattr(back, leaf)).tobytes() == \
            n(getattr(tst, leaf)).tobytes(), leaf
    np.testing.assert_allclose(n(back.alpha), n(jback.alpha), **TOL)
    np.testing.assert_allclose(n(back.alpha), n(tst.alpha), **TOL)
    kept = tgp.truncate(got, N0, alpha=tst.alpha)
    assert _bits_equal(kept, tst)


@pytest.mark.parametrize("mixed", [False, True], ids=["matern", "mixed"])
@pytest.mark.parametrize("q", [1, 4])
def test_fantasize_and_truncate_stacked(q, mixed):
    rng = np.random.default_rng(3)
    lanes = [_states(rng, mixed, n0) for n0 in (N0, N0 - 3)]
    jkern, tkern = lanes[0][2], lanes[0][3]
    jst = jgp.stack_states([lane[0] for lane in lanes])
    tst = tgp.stack_states([lane[1] for lane in lanes])
    xs = np.stack([_points(rng, mixed, q, n(lane[1].x_buf[:lane[1].n]))
                   for lane in lanes])
    want = jgp.fantasize(jst, jkern, j(xs), "mean", implementation="xla")
    got = tgp.fantasize(tst, tkern, t(xs), "mean")
    np.testing.assert_array_equal(n(got.n), [N0 + q, N0 - 3 + q])
    _held(got, want, [N0, N0 - 3], "mean")
    np.testing.assert_array_equal(n(tst.n), [N0, N0 - 3])   # input kept
    # Each lane is the single-study fantasize of that lane, bit for bit.
    for s, lane in enumerate(lanes):
        single = tgp.fantasize(lane[1], tkern, t(xs[s]), "mean")
        assert _bits_equal(tgp.unstack_state(got, s), single)

    n_real = np.array([N0, N0 - 3])
    back = tgp.truncate(got, torch.as_tensor(n_real))
    jback = jgp.truncate(want, j(n_real).astype(np.int32))
    np.testing.assert_array_equal(n(back.n), n_real)
    for leaf in ("x_buf", "y_buf", "l_buf", "li_buf"):
        assert n(getattr(back, leaf)).tobytes() == \
            n(getattr(tst, leaf)).tobytes(), leaf
    np.testing.assert_allclose(n(back.alpha), n(jback.alpha), **TOL)
    assert _bits_equal(tgp.truncate(got, n_real, alpha=tst.alpha), tst)


def test_fantasize_checks_capacity_before_writing():
    rng = np.random.default_rng(4)
    _, tst, _, tkern = _states(rng, False, n0=N_MAX - 2)
    own = tgp._copy(tst)
    with pytest.raises(tgp.StudySaturatedError):
        tgp.fantasize(own, tkern, t(_points(rng, False, 3)), in_place=True)
    assert _bits_equal(own, tst) and own.n == tst.n
