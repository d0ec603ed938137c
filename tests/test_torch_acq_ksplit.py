"""The fused EI's k-split and the order of its sums, on the CPU.

`csrc/acq.cu` may split k (the rows of A) into slices, one CTA a slice.
On the ill-conditioned states of `tune_acq.key_inputs` a slice's partial
U = K[:, slice] A[slice, :] is a sum of large terms that cancel, its
entries tens of times those of U.  The kernel used to take the column
sums q = sum U K, S2 = sum U s and V2 = (U s) x_buf of each slice's
partial U and add those; it now adds the slices' partial U first, in
slice order, and takes the column sums of the whole U, as the reference's
one dot gives it (`src/repro/kernels/acq.py`, `_fused_ei_grad_math`).

A float32 model of the three orders, here and not in the package: U's
k-tiles of 32 rows each summed term by term (the kernel's chain), added
tile by tile within a slice; then "one" (a single slice), "slices" (the
column sums of each slice's U, added slice by slice) or "summed" (the
slices' U added in slice order, then the column sums).  The slice bounds
are those of `acq.launch_plan` at R = 8 and 2, 3, 4, 6 or 8 slices.  Each
order is held, on the 6 seeded states of the two main keys, to a float64
evaluation of the plain version (by `tune_acq.held_states`' rule) and to
the JAX package's `ei_grad_jnp` (TOL_EI).
"""
import functools

import numpy as np
import pytest
import torch
from _torch_port import j, n

from repro.kernels import acq as jacq
from repro_torch.kernels import acq, tune_acq

KEYS = ((64, 1024, 6, "mixed"), (64, 1024, 5, "float"))
KEY_IDS = ["-".join(map(str, k)) for k in KEYS]
SLICES = (2, 3, 4, 6, 8)
STATES = range(tune_acq.HELD_STATES)
TOL_EI = tune_acq.TOL_EI
MARGIN = 2.0       # held_states' rule: twice the plain version's own error


@functools.lru_cache(maxsize=None)
def _inputs(key):
    plan_rows, nn, d, form = key
    return tune_acq.key_inputs(plan_rows, nn, d, form == "mixed",
                               tune_acq.HELD_STATES, device="cpu")


def _bounds(key, slices):
    """k ranges of each slice of the R = 8 plan at `slices` k-slices."""
    plan_rows, nn, d, form = key
    k_tiles = -(-nn // acq.TK)
    plan = acq.launch_plan(1, plan_rows, nn, d, form == "mixed",
                           config=acq.AcqTileConfig(8, -(-k_tiles // slices),
                                                    True))
    assert plan.slices == slices
    step = plan.tiles_per_slice * acq.TK
    return [(k0, min(nn, k0 + step)) for k0 in range(0, nn, step)]


def _operands(args, mixed):
    """(x, x_buf, amask, alpha, a_buf, sigma2, rho, shift, xk, xbk): the
    mixed form's rows split by its masks, as the kernel splits them."""
    if not mixed:
        return (*args, None, None)
    x, xb, *rest, cm, km = args
    xc, xbc, xk, xbk = acq.split_rows(x, xb, cm, km)
    return (xc, xbc, *rest, xk, xbk)


@functools.lru_cache(maxsize=None)
def _model_parts(key, state):
    """K, s, the k-tile sums of U and the operands of one state, float32."""
    x, xb, am, al, ab, s2, rho, shift, xk, xbk = _operands(
        tune_acq.lane(_inputs(key), state), key[3] == "mixed")
    z = torch.sqrt(torch.clamp((x * x).sum(-1)[:, None]
                               + (xb * xb).sum(-1)[None, :] - 2.0 * x @ xb.T,
                               min=0.0) + 1e-36) * (5.0 ** 0.5) / rho
    ez = torch.exp(-z)
    k = s2 * (1.0 + z + z * z / 3.0) * ez
    cat = 1.0
    if xk is not None:
        sqk = torch.clamp((xk * xk).sum(-1)[:, None]
                          + (xbk * xbk).sum(-1)[None, :] - 2.0 * xk @ xbk.T,
                          min=0.0)
        cat = torch.exp(-0.5 * sqk / rho)
        k = k * cat
    km = k * am
    s_am = (-s2 * (5.0 / (3.0 * rho * rho))) * (1.0 + z) * ez * cat * am
    tiles = []
    for t0 in range(0, xb.shape[0], acq.TK):
        u = torch.zeros_like(km)
        for kk in range(t0, min(xb.shape[0], t0 + acq.TK)):
            u = u + km[:, kk, None] * ab[kk][None, :]      # k ascending
        tiles.append(u)
    return (x, xb, am, al, s2, shift), km, s_am, tiles


def _model(key, state, bounds, order):
    """(ei, grad) of one state, float32, with U summed in `order`."""
    (x, xb, am, al, s2, shift), km, s_am, tiles = _model_parts(key, state)
    us = []
    for k0, k1 in bounds:
        u = tiles[k0 // acq.TK]
        for t in range(k0 // acq.TK + 1, -(-k1 // acq.TK)):
            u = u + tiles[t]
        us.append(u)

    def sums(u):
        a2 = u * s_am
        return (u * km).sum(-1), a2.sum(-1), a2 @ xb

    if order == "slices":
        q, s2sum, v2 = sums(us[0])
        for u in us[1:]:
            dq, ds, dv = sums(u)
            q, s2sum, v2 = q + dq, s2sum + ds, v2 + dv
    else:
        u = us[0]
        for more in us[1:]:
            u = u + more
        q, s2sum, v2 = sums(u)
    a1 = (al * am)[None, :] * s_am
    s1, v1, gam = a1.sum(-1), a1 @ xb, km @ al + shift
    raw = s2 - q
    sig = torch.sqrt(torch.clamp(raw, min=acq.VAR_FLOOR))
    zs = gam / torch.clamp(sig, min=1e-12)
    cdf = 0.5 * torch.erfc(-zs / 2.0 ** 0.5)
    pdf = torch.exp(-0.5 * zs * zs) / (2.0 * np.pi) ** 0.5
    ei = torch.clamp(gam * cdf + sig * pdf, min=0.0)
    dvar = torch.where(raw > acq.VAR_FLOOR, pdf / (2.0 * sig),
                       torch.zeros_like(sig))
    rs = cdf * s1 - 2.0 * dvar * s2sum
    grad = rs[:, None] * x - (cdf[:, None] * v1 - 2.0 * dvar[:, None] * v2)
    return ei, grad


@functools.lru_cache(maxsize=None)
def _plain(key, state):
    """The plain version's (ei, grad) in float32 and in float64."""
    args = tune_acq.lane(_inputs(key), state)
    mixed = key[3] == "mixed"
    return (tune_acq.plain(args, mixed),
            tune_acq.plain([a.double() for a in args], mixed))


def _errors(key, state, out):
    """Max |out - float64| of (ei, grad)."""
    _, exact = _plain(key, state)
    return [float((o.double() - e).abs().max()) for o, e in zip(out, exact)]


def _held(key, state, out) -> bool:
    """`tune_acq.held_states`' rule: each output within TOL_EI of the
    plain version, or no further from float64 than MARGIN times it."""
    p32, p64 = _plain(key, state)
    ok = True
    for o, p, e in zip(out, p32, p64):
        err = float((o.double() - e).abs().max())
        ok &= bool(torch.allclose(o, p, **TOL_EI)) or \
            err <= MARGIN * float((p.double() - e).abs().max())
    return ok


def _one(key, state):
    return _model(key, state, [(0, key[1])], "one")


@pytest.mark.parametrize("slices", SLICES)
@pytest.mark.parametrize("key", KEYS, ids=KEY_IDS)
def test_slice_order_costs_the_gradient(key, slices):
    """Column sums of each slice's partial U: on at least one seeded state
    the gradient's float64 error exceeds the one-slice order's by more
    than the rule's margin, and at least one state leaves the rule."""
    bounds = _bounds(key, slices)
    ratios, held = [], []
    for s in STATES:
        out = _model(key, s, bounds, "slices")
        ratios.append(_errors(key, s, out)[1] / _errors(key, s, _one(key, s))[1])
        held.append(_held(key, s, out))
    assert max(ratios) > MARGIN, ratios
    assert not all(held), ratios


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("key", KEYS, ids=KEY_IDS)
def test_summed_order_keeps_the_one_slice_accuracy(key, state):
    """The slices' U added in slice order before the column sums: at every
    slice count the gradient's float64 error stays within the rule's
    margin of the one-slice order's, and the state holds the rule (ei and
    gradient) wherever the one-slice order holds it.  (EI's own error is
    float32 noise of the same size in all three orders, a few 1e-8 to
    3e-7 here, which the rule reads.)"""
    one = _one(key, state)
    err_one = _errors(key, state, one)[1]
    for slices in SLICES:
        out = _model(key, state, _bounds(key, slices), "summed")
        err = _errors(key, state, out)[1]
        assert err <= MARGIN * err_one, (slices, err, err_one)
        assert _held(key, state, out) or not _held(key, state, one)


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("key", KEYS, ids=KEY_IDS)
def test_orders_against_the_reference(key, state):
    """Against the JAX package's `ei_grad_jnp` on the same operands: where
    the one-slice order is within TOL_EI, the summed order is too at every
    slice count."""
    x, xb, am, al, ab, s2, rho, shift, *masks = (
        a.numpy() if a.ndim else float(a)
        for a in tune_acq.lane(_inputs(key), state))
    mk = {} if not masks else dict(cont_mask=j(masks[0]),
                                   cat_mask=j(masks[1]))
    ei_j, g_j = jacq.ei_grad_jnp(j(x), j(xb), j(am), j(al), j(ab), s2, rho,
                                 shift, **mk)

    def close(out):
        return all(np.allclose(n(o), n(w), **TOL_EI)
                   for o, w in zip(out, (ei_j, g_j)))

    if not close(_one(key, state)):
        return
    for slices in SLICES:
        assert close(_model(key, state, _bounds(key, slices), "summed")), \
            slices
