"""The port's Mamba-2 (SSD) mixer (`repro_torch/models/ssm.py`) against the
reference's (`repro/models/ssm.py`): the chunked scan against the port's
own per-token recurrence (mirroring `tests/test_models.py:160-192`), and
`ssd_chunked`, `ssd_recurrent_ref` and `mamba_block` against the
reference's on the same numpy inputs, values and gradients.

Tolerances: chunked against recurrent 2e-4 absolute and relative, as the
reference's own test holds its pair.  Against the reference, relative to
each tensor's largest entry: float32 1e-5 for values and 5e-5 for
gradients (`a_log`'s gradient sums terms of both signs over the sequence:
both packages' float32 values lie 2.7e-5 from a float64 run of the port,
and 2.2e-5 from each other; every other leaf within 1.2e-6 of each
other, and 9e-6 for `dt_bias`); bfloat16 (the mixer's inputs and
parameters in bfloat16, as the configs run it) 2e-2 for the output and
6e-2 for gradients (the LM tests' bfloat16 gradient tolerance; bfloat16
keeps 8 bits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from _torch_port import n

from repro.configs import get_config as jget_config
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.models import ssm

F32 = dict(value=1e-5, grad=5e-5)
BF16 = dict(value=2e-2, grad=6e-2)
RECURRENT = dict(atol=2e-4, rtol=2e-4)


def _close(got, want, tol, what=""):
    got, want = n(got).astype(np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= tol, f"{what}: {err:.3g} > {tol}"


def _softplus(a):
    return np.logaddexp(a, 0.0)


def _ssd_inputs(seed, b, l, h, p, g, nstate, with_h0=False):
    """x, dt, a, B, C (and h0) as in tests/test_models.py's SSD tests, from
    a numpy seed."""
    rng = np.random.default_rng(seed)
    f = np.float32
    out = [rng.standard_normal((b, l, h, p)).astype(f),
           _softplus(rng.standard_normal((b, l, h))).astype(f),
           (-np.exp(rng.standard_normal(h) * 0.5)).astype(f),
           (rng.standard_normal((b, l, g, nstate)) * 0.3).astype(f),
           (rng.standard_normal((b, l, g, nstate)) * 0.3).astype(f)]
    if with_h0:
        out.append((rng.standard_normal((b, h, p, nstate)) * 0.1).astype(f))
    return out


def _t(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype).requires_grad_(True)
            for a in arrays]


@pytest.mark.parametrize("l,chunk", [(64, 16), (100, 32), (128, 128)])
def test_ssd_chunked_matches_recurrent(l, chunk):
    x, dt, a, bm, cm = _t(_ssd_inputs(0, 2, l, 4, 8, 2, 16))
    with torch.no_grad():
        y_chunk, hc = ssm.ssd_chunked(x, dt, a, bm, cm, chunk=chunk,
                                      return_final_state=True)
        y_rec, hr = ssm.ssd_recurrent_ref(x, dt, a, bm, cm)
    np.testing.assert_allclose(n(y_chunk), n(y_rec), **RECURRENT)
    np.testing.assert_allclose(n(hc), n(hr), **RECURRENT)


def test_ssd_chunked_with_initial_state():
    x, dt, a, bm, cm, h0 = _t(_ssd_inputs(1, 1, 32, 2, 4, 1, 8, True))
    with torch.no_grad():
        y_chunk = ssm.ssd_chunked(x, dt, a, bm, cm, chunk=8, h0=h0)
        y_rec, _ = ssm.ssd_recurrent_ref(x, dt, a, bm, cm, h0=h0)
    np.testing.assert_allclose(n(y_chunk), n(y_rec), **RECURRENT)


def _weights(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("l,chunk,with_h0", [(100, 32, False),
                                             (64, 16, True)],
                         ids=["padded", "h0"])
def test_ssd_chunked_matches_reference(l, chunk, with_h0):
    """y and the final state, and the gradients of a weighted sum of both
    with respect to every input, against the reference's `ssd_chunked`."""
    arrays = _ssd_inputs(2, 2, l, 4, 8, 2, 16, with_h0)
    wy, wh = _weights(3, (2, l, 4, 8), (2, 4, 8, 16))

    def jfn(*ins):
        h0 = ins[5] if with_h0 else None
        y, hf = jssm.ssd_chunked(*ins[:5], chunk=chunk, h0=h0,
                                 return_final_state=True)
        return jnp.sum(y * wy) + jnp.sum(hf * wh), (y, hf)

    (_, (jy, jh)), jg = jax.jit(jax.value_and_grad(
        jfn, argnums=tuple(range(len(arrays))), has_aux=True))(
        *map(jnp.asarray, arrays))
    ins = _t(arrays)
    y, hf = ssm.ssd_chunked(*ins[:5], chunk=chunk,
                            h0=ins[5] if with_h0 else None,
                            return_final_state=True)
    (torch.sum(y * torch.from_numpy(wy))
     + torch.sum(hf * torch.from_numpy(wh))).backward()
    _close(y, jy, F32["value"], "y")
    _close(hf, jh, F32["value"], "h_final")
    for name, t, g in zip("x dt a b c h0".split(), ins, jg):
        _close(t.grad, g, F32["grad"], f"d{name}")


def test_ssd_recurrent_ref_matches_reference():
    arrays = _ssd_inputs(4, 2, 24, 4, 8, 2, 16, True)
    jy, jh = jssm.ssd_recurrent_ref(*map(jnp.asarray, arrays[:5]),
                                    h0=jnp.asarray(arrays[5]))
    y, hf = ssm.ssd_recurrent_ref(*_t(arrays[:5]), h0=_t(arrays[5:])[0])
    _close(y, jy, F32["value"], "y")
    _close(hf, jh, F32["value"], "h_final")


def _block_params(jcfg):
    """The reference's mixer params at the reduced config, and the port's
    copy (numpy, bits kept)."""
    jp, _ = jssm.init_mamba_params(
        jax.random.PRNGKey(5), jcfg.d_model, expand=jcfg.ssm_expand,
        state=jcfg.ssm_state, head_dim=jcfg.ssm_head_dim,
        groups=jcfg.ssm_groups, dtype=jnp.float32)
    # a nonzero bias and conv bias, so their gradients see real values
    rng = np.random.default_rng(6)
    jp = dict(jp, dt_bias=jnp.asarray(rng.standard_normal(
        jp["dt_bias"].shape).astype(np.float32)),
              conv_b=jnp.asarray(0.1 * rng.standard_normal(
                  jp["conv_b"].shape).astype(np.float32)))
    return jp, {k: np.array(v) for k, v in jp.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_matches_reference(dtype):
    """zamba2-reduced's mixer at 2 x 100 (a padded chunk): the output, the
    decode state it returns, and the gradients of a weighted sum of the
    output with respect to x and every parameter.  Parameters and x in
    `dtype`, as `forward` hands them to the mixer."""
    jcfg = jget_config("zamba2-1.2b", reduced=True)
    cfg = get_config("zamba2-1.2b", reduced=True)
    jp, npp = _block_params(jcfg)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 100, jcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 100, jcfg.d_model)).astype(np.float32)

    def jfn(p, xin):
        out, st = jssm.mamba_block(p, xin, jcfg, return_state=True)
        return jnp.sum(out.astype(jnp.float32) * w), (out, st)

    jcast = {k: jnp.asarray(v, jdt) for k, v in npp.items()}
    (_, (jout, jst)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(jcast, jnp.asarray(x, jdt))
    tp = {k: torch.from_numpy(v).to(tdt).requires_grad_(True)
          for k, v in npp.items()}
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    out, st = ssm.mamba_block(tp, tx, cfg, return_state=True)
    torch.sum(out.float() * torch.from_numpy(w)).backward()
    tol = F32 if dtype == "float32" else BF16
    _close(out.float(), np.asarray(jout, np.float32), tol["value"], "out")
    _close(st["conv"].float(), np.asarray(jst["conv"], np.float32),
           tol["value"], "state conv")
    _close(st["ssm"], jst["ssm"], tol["value"], "state ssm")
    assert st["ssm"].dtype == torch.float32
    _close(tx.grad.float(), np.asarray(jgx, np.float32), tol["grad"], "dx")
    for k in npp:
        _close(tp[k].grad.float(), np.asarray(jgp[k], np.float32),
               tol["grad"], f"d{k}")


def test_softplus_matches_reference():
    """`F.softplus` returns its input above 20 where the reference computes
    logaddexp(x, 0): the two agree to two float32 ulps everywhere (the
    reference adds log1p(exp(-|x|)) to max(x, 0), PyTorch takes
    log1p(exp(x))), exactly at 0 (a zero `dt_bias`) and across the
    threshold."""
    xs = np.concatenate([np.linspace(-30, 30, 6001),
                         [0.0, 19.999998, 20.0, 20.000002]]).astype(
        np.float32)
    got = F.softplus(torch.from_numpy(xs)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(xs)))
    np.testing.assert_array_max_ulp(got, want, maxulp=2)
    assert got[xs == 0.0][0] == want[xs == 0.0][0] == np.float32(np.log(2))
