"""The port's mLSTM block (`repro_torch/models/xlstm.py`) against the
reference's (`repro/models/xlstm.py`): the chunkwise scan against the
port's own per-token recurrence (mirroring `tests/test_models.py:195-231`),
and `mlstm_chunked`, `mlstm_recurrent_ref` and `mlstm_block` against the
reference's on the same numpy inputs, values and gradients, with a case
whose stabilizer maxima are ties.

Tolerances: chunked against recurrent 2e-4 absolute and relative for the
outputs, and 2e-3 for the states up to the stabilizer's gauge (C e^m), as
the reference's own test holds its pair.  Against the reference, relative
to each tensor's largest entry: float32 1e-5 for values and 2e-5 for
gradients (the LM tests' F32); bfloat16 (the block's input and parameters
in bfloat16, as the configs run it) 2e-2 for the output and 6e-2 for
gradients (the LM tests' bfloat16 gradient tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import n

from repro.configs import get_config as jget_config
from repro.models import xlstm as jxlstm
from repro_torch.configs import get_config
from repro_torch.models import xlstm

F32 = dict(value=1e-5, grad=2e-5)
BF16 = dict(value=2e-2, grad=6e-2)
RECURRENT = dict(atol=2e-4, rtol=2e-4)
GAUGE = dict(atol=2e-3, rtol=2e-3)


def _close(got, want, tol, what=""):
    got, want = n(got).astype(np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= tol, f"{what}: {err:.3g} > {tol}"


def _log_sigmoid(a):
    return -np.logaddexp(0.0, -a)


def _mlstm_inputs(seed, b, l, h, dh):
    """q, k, v, log i, log f as in tests/test_models.py's mLSTM tests, from
    a numpy seed."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return [rng.standard_normal((b, l, h, dh)).astype(f),
            (rng.standard_normal((b, l, h, dh)) / dh ** 0.5).astype(f),
            rng.standard_normal((b, l, h, dh)).astype(f),
            rng.standard_normal((b, l, h)).astype(f),
            _log_sigmoid(rng.standard_normal((b, l, h)) + 3.0).astype(f)]


def _t(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype).requires_grad_(True)
            for a in arrays]


@pytest.mark.parametrize("l,chunk", [(64, 16), (96, 32)])
def test_mlstm_chunked_matches_recurrent(l, chunk):
    ins = _t(_mlstm_inputs(0, 2, l, 2, 8))
    with torch.no_grad():
        y_chunk, (c1, n1, m1) = xlstm.mlstm_chunked(
            *ins, chunk=chunk, return_final_state=True)
        y_rec, (c2, n2, m2) = xlstm.mlstm_recurrent_ref(*ins)
    np.testing.assert_allclose(n(y_chunk), n(y_rec), **RECURRENT)
    # The states agree up to the stabilizer's gauge: compare C e^m, n e^m.
    np.testing.assert_allclose(n(c1 * torch.exp(m1)[..., None, None]),
                               n(c2 * torch.exp(m2)[..., None, None]),
                               **GAUGE)
    np.testing.assert_allclose(n(n1 * torch.exp(m1)[..., None]),
                               n(n2 * torch.exp(m2)[..., None]), **GAUGE)


def test_mlstm_chunked_continues_from_state():
    """The state of a chunked prefix seeds the chunked scan of the rest:
    its outputs are the recurrence's over the whole sequence."""
    ins = _t(_mlstm_inputs(1, 1, 80, 2, 8))
    with torch.no_grad():
        y_all, _ = xlstm.mlstm_recurrent_ref(*ins)
        _, state = xlstm.mlstm_chunked(*(a[:, :48] for a in ins), chunk=16,
                                       return_final_state=True)
        y_rest = xlstm.mlstm_chunked(*(a[:, 48:] for a in ins), chunk=16,
                                     state=state)
    np.testing.assert_allclose(n(y_rest), n(y_all[:, 48:]), **RECURRENT)


def _held_to_reference(arrays, chunk, state=None, seed=3):
    """y and the final (C, n, m), and the gradients of a weighted sum of y,
    C and n with respect to every input and the initial state, against the
    reference's `mlstm_chunked`; every gradient finite."""
    b, l, h, dh = arrays[0].shape
    wy, wc, wn = (np.random.default_rng(seed).standard_normal(s)
                  .astype(np.float32)
                  for s in ((b, l, h, dh), (b, h, dh, dh), (b, h, dh)))
    nin = len(arrays)

    def jfn(*ins):
        st = None if state is None else tuple(ins[nin:])
        y, (c, nn, m) = jxlstm.mlstm_chunked(*ins[:nin], chunk=chunk,
                                             state=st,
                                             return_final_state=True)
        return (jnp.sum(y * wy) + jnp.sum(c * wc) + jnp.sum(nn * wn),
                (y, c, nn, m))

    extra = [] if state is None else list(state)
    (_, jout), jg = jax.jit(jax.value_and_grad(
        jfn, argnums=tuple(range(nin + len(extra))), has_aux=True))(
        *map(jnp.asarray, arrays + extra))
    ins = _t(arrays)
    st = None if state is None else _t(list(state))
    y, (c, nn, m) = xlstm.mlstm_chunked(*ins, chunk=chunk, state=st,
                                        return_final_state=True)
    (torch.sum(y * torch.from_numpy(wy)) + torch.sum(c * torch.from_numpy(wc))
     + torch.sum(nn * torch.from_numpy(wn))).backward()
    for name, got, want in zip(("y", "C", "n", "m"), (y, c, nn, m), jout):
        _close(got, want, F32["value"], name)
    names = ["q", "k", "v", "logi", "logf", "C0", "n0", "m0"]
    for name, t, g in zip(names, ins + (st or []), jg):
        assert torch.isfinite(t.grad).all(), name
        _close(t.grad, g, F32["grad"], f"d{name}")


@pytest.mark.parametrize("l,chunk,with_state", [(96, 32, False),
                                                (70, 16, True)],
                         ids=["m0=-inf", "state, padded"])
def test_mlstm_chunked_matches_reference(l, chunk, with_state):
    arrays = _mlstm_inputs(2, 2, l, 2, 8)
    state = None
    if with_state:
        rng = np.random.default_rng(4)
        state = [rng.standard_normal((2, 2, 8, 8)).astype(np.float32),
                 rng.standard_normal((2, 2, 8)).astype(np.float32),
                 rng.standard_normal((2, 2)).astype(np.float32)]
    _held_to_reference(arrays, chunk, state)


def test_mlstm_stabilizer_ties_spread_the_gradient():
    """log f = 0 and one log i for every step: every intra-chunk exponent
    D[t, s] and every end-of-chunk exponent ties, so the stabilizer's maxima
    (`amax`, `maximum`) have ties everywhere.  The reference's reductions
    spread the gradient evenly over ties, and so do the port's."""
    arrays = _mlstm_inputs(5, 1, 32, 2, 8)
    arrays[3] = np.full_like(arrays[3], 0.25)
    arrays[4] = np.zeros_like(arrays[4])
    _held_to_reference(arrays, chunk=16)


def test_mlstm_recurrent_ref_matches_reference():
    arrays = _mlstm_inputs(6, 2, 24, 2, 8)
    jy, jst = jxlstm.mlstm_recurrent_ref(*map(jnp.asarray, arrays))
    y, st = xlstm.mlstm_recurrent_ref(*_t(arrays))
    _close(y, jy, F32["value"], "y")
    for name, got, want in zip(("C", "n", "m"), st, jst):
        _close(got, want, F32["value"], name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_block_matches_reference(dtype):
    """xlstm-reduced's block at 2 x 80 (a padded chunk): the output, the
    decode state it returns, and the gradients of a weighted sum of the
    output with respect to x and every parameter, in `dtype`."""
    jcfg = jget_config("xlstm-1.3b", reduced=True)
    cfg = get_config("xlstm-1.3b", reduced=True)
    jp, _ = jxlstm.init_mlstm_params(
        jax.random.PRNGKey(5), jcfg.d_model, heads=jcfg.mlstm_heads,
        pf=jcfg.mlstm_pf, dtype=jnp.float32)
    rng = np.random.default_rng(7)
    npp = {k: np.array(v) for k, v in jp.items()}
    npp["conv_b"] = (0.1 * rng.standard_normal(npp["conv_b"].shape)
                     ).astype(np.float32)
    x = rng.standard_normal((2, 80, jcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 80, jcfg.d_model)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def jfn(p, xin):
        out, st = jxlstm.mlstm_block(p, xin, jcfg, return_state=True)
        return jnp.sum(out.astype(jnp.float32) * w), (out, st)

    (_, (jout, jst)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(v, jdt) for k, v in npp.items()},
        jnp.asarray(x, jdt))
    tp = {k: torch.from_numpy(v).to(tdt).requires_grad_(True)
          for k, v in npp.items()}
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    out, st = xlstm.mlstm_block(tp, tx, cfg, return_state=True)
    torch.sum(out.float() * torch.from_numpy(w)).backward()
    tol = F32 if dtype == "float32" else BF16
    _close(out.float(), np.asarray(jout, np.float32), tol["value"], "out")
    for k in ("conv", "c", "n", "m"):
        _close(st[k].float(), np.asarray(jst[k], np.float32), tol["value"],
               f"state {k}")
    _close(tx.grad.float(), np.asarray(jgx, np.float32), tol["grad"], "dx")
    for k in npp:
        _close(tp[k].grad.float(), np.asarray(jgp[k], np.float32),
               tol["grad"], f"d{k}")
