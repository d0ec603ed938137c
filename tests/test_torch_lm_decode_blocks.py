"""The port's one-token decode blocks: `decode_attention`, the Mamba-2
step (`mamba_init_state`, `mamba_decode_step`) and the mLSTM step
(`mlstm_init_state`, `mlstm_decode_step`), against the port's own
full-sequence forms and against the reference's (`repro/models/
attention.py:281`, `ssm.py:216-260`, `xlstm.py:234-272`) on the same numpy
inputs.  Mirrors `tests/test_models.py:148` (decode attention against the
full attention's last position) and `:213` (the recurrence carries on
from the chunked scan's state).

Tolerances, relative to each tensor's largest entry unless named: the
port against itself 2e-5 (the attention's sums in another order), and
2e-4 absolute and relative where a chunked scan meets the per-token
recurrence (`tests/test_models.py`'s pair); against the reference float32
1e-5 (the LM tests' F32) and bfloat16 2e-2 (the block tests' bfloat16
output tolerance, `tests/test_torch_lm_ssm.py`), the recurrent states
kept in float32 included.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import CPU, n

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import attention as attn
from repro_torch.models import ssm, xlstm

SELF = 2e-5
RECURRENT = dict(atol=2e-4, rtol=2e-4)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
MIXERS = {"mamba": ("zamba2-1.2b", ssm, jssm),
          "mlstm": ("xlstm-1.3b", xlstm, jxlstm)}


def _close(got, want, tol, what=""):
    got = n(got.float() if isinstance(got, torch.Tensor) else got)
    got, want = got.astype(np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= tol, f"{what}: {err:.3g} > {tol}"


def _caches(seed=0, b=2, s=64, h=4, kv=2, dh=16, dv=16):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, 1, h, dh)).astype(f),
            rng.standard_normal((b, s, kv, dh)).astype(f),
            rng.standard_normal((b, s, kv, dv)).astype(f))


@pytest.mark.parametrize("window", [0, 16, 40])
def test_decode_attention_matches_full_last_position(window):
    """At the last position of a causal (windowed) full attention over the
    whole cache."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 64, h, 16))
                                .astype(np.float32)) for h in (4, 2, 2))
    full = attn.full_attention(q, k, v, causal=True, window=window)
    out = attn.decode_attention(q[:, -1:], k, v, 63, window=window)
    assert out.shape == (2, 1, 4, 16)
    _close(out[:, 0], n(full[:, -1]), SELF, f"window {window}")


@pytest.mark.parametrize("dv", [16, 12], ids=["gqa", "mla-value-width"])
@pytest.mark.parametrize("window", [0, 16, 40])
def test_decode_attention_matches_reference(window, dv):
    """Mid-cache (pos 50 of 64: the tail past pos is garbage the mask, or
    here the slice, must keep out), grouped heads, and a value width other
    than the key width, as MLA's."""
    q, k, v = _caches(dv=dv)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(50, jnp.int32),
                                  window=window)
    got = attn.decode_attention(*map(torch.from_numpy, (q, k, v)), 50,
                                window=window)
    assert got.shape == (2, 1, 4, dv)
    _close(got, want, TOL["float32"], f"window {window}")
    # The cache past pos changes nothing.
    k2, v2 = k.copy(), v.copy()
    k2[:, 51:], v2[:, 51:] = 1e3, -1e3
    again = attn.decode_attention(*map(torch.from_numpy, (q, k2, v2)), 50,
                                  window=window)
    assert torch.equal(again, got)


def test_decode_attention_refuses_a_position_past_the_cache():
    q, k, v = map(torch.from_numpy, _caches(s=8))
    with pytest.raises(ValueError, match="outside the cache"):
        attn.decode_attention(q, k, v, 8)


def _mixer(kind, dtype="float32"):
    """A mixer of `kind` at the reduced config's widths in both packages
    (the reference's init), cast to `dtype`."""
    arch, _, jmod = MIXERS[kind]
    jcfg = dataclasses.replace(jget_config(arch, reduced=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype=dtype)
    key = jax.random.PRNGKey(0)
    if kind == "mamba":
        jp, _ = jmod.init_mamba_params(
            key, jcfg.d_model, expand=jcfg.ssm_expand, state=jcfg.ssm_state,
            head_dim=jcfg.ssm_head_dim, groups=jcfg.ssm_groups,
            dtype=jnp.float32)
    else:
        jp, _ = jmod.init_mlstm_params(key, jcfg.d_model,
                                       heads=jcfg.mlstm_heads,
                                       pf=jcfg.mlstm_pf, dtype=jnp.float32)
    leaves = {k: np.asarray(v) for k, v in jp.items()}
    tdt, jdt = DTYPES[dtype]
    tp = {k: torch.from_numpy(np.array(v)).to(tdt) for k, v in leaves.items()}
    jmix = {k: jnp.asarray(v, jdt) for k, v in leaves.items()}
    return jcfg, cfg, jmix, tp


@pytest.mark.parametrize("kind", list(MIXERS))
def test_init_state_matches_reference(kind):
    """The same keys, shapes, dtypes and values as the reference's init
    state (the mLSTM's m at -inf)."""
    _, mod, jmod = MIXERS[kind]
    jcfg, cfg, jmix, tp = _mixer(kind)
    init = "mamba_init_state" if kind == "mamba" else "mlstm_init_state"
    want = getattr(jmod, init)(jmix, 3, jcfg, jcfg.d_model, jnp.bfloat16)
    got = getattr(mod, init)(tp, 3, cfg, cfg.d_model, torch.bfloat16)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).split(".")[1] == str(want[k].dtype), k
        np.testing.assert_array_equal(n(got[k].float()),
                                      np.asarray(want[k], np.float32))


def _block_state(kind, mod, tp, cfg, x):
    block = mod.mamba_block if kind == "mamba" else mod.mlstm_block
    return block(tp, x, cfg, return_state=True)


@pytest.mark.parametrize("kind", list(MIXERS))
def test_decode_continues_the_block(kind):
    """The block over L = 48 steps (across two chunks of 32) with its
    decode state, then four decode steps, against the block over L + 4:
    each step's output, and the final state against the longer block's
    (the mLSTM's C and n up to the stabilizer's gauge, e^m)."""
    _, mod, _ = MIXERS[kind]
    _, cfg, _, tp = _mixer(kind)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 52, cfg.d_model))
                         .astype(np.float32))
    step = mod.mamba_decode_step if kind == "mamba" \
        else mod.mlstm_decode_step
    with torch.no_grad():
        y_all, s_all = _block_state(kind, mod, tp, cfg, x)
        _, state = _block_state(kind, mod, tp, cfg, x[:, :48])
        for i in range(48, 52):
            y, state = step(tp, x[:, i:i + 1], state, cfg)
            np.testing.assert_allclose(n(y[:, 0]), n(y_all[:, i]),
                                       **RECURRENT)
    np.testing.assert_allclose(n(state["conv"]), n(s_all["conv"]),
                               **RECURRENT)
    if kind == "mamba":
        np.testing.assert_allclose(n(state["ssm"]), n(s_all["ssm"]),
                                   **RECURRENT)
    else:
        for k, shape in (("c", (..., None, None)), ("n", (..., None))):
            np.testing.assert_allclose(
                n(state[k] * torch.exp(state["m"])[shape]),
                n(s_all[k] * torch.exp(s_all["m"])[shape]), atol=2e-3,
                rtol=2e-3)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", list(MIXERS))
def test_decode_step_matches_reference(kind, dtype):
    """Two steps from the reference's block state after 40 steps, the
    output and every state leaf against the reference's steps.  bfloat16
    steps against the reference's run one primitive at a time, where each
    of its bfloat16 ops rounds as the port's do."""
    _, mod, jmod = MIXERS[kind]
    jcfg, cfg, jmix, tp = _mixer(kind, dtype)
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((2, 42, cfg.d_model)).astype(np.float32)
    block = jmod.mamba_block if kind == "mamba" else jmod.mlstm_block
    jstep = jmod.mamba_decode_step if kind == "mamba" \
        else jmod.mlstm_decode_step
    step = mod.mamba_decode_step if kind == "mamba" \
        else mod.mlstm_decode_step
    _, jstate = jax.jit(lambda p, x: block(p, x, jcfg, return_state=True))(
        jmix, jnp.asarray(xs[:, :40], jdt))
    state = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if v.dtype == jnp.float32 else tdt)
        for k, v in jstate.items()}
    with jax.disable_jit(dtype == "bfloat16"):
        for i in (40, 41):
            jy, jstate = jstep(jmix, jnp.asarray(xs[:, i:i + 1], jdt),
                               jstate, jcfg)
            with torch.no_grad():
                y, state = step(tp, torch.from_numpy(xs[:, i:i + 1]).to(tdt),
                                state, cfg)
            assert y.dtype == tdt and y.shape == jy.shape
            _close(y, np.asarray(jy, np.float32), TOL[dtype], f"y {i}")
            assert sorted(state) == sorted(jstate)
            for k in jstate:
                assert str(state[k].dtype).split(".")[1] == \
                    str(jstate[k].dtype), k
                _close(state[k], np.asarray(jstate[k], np.float32),
                       TOL[dtype], f"state {k} {i}")


def test_mlstm_recurrence_continues_chunked():
    """The chunked scan's final state seeds the per-token recurrence: the
    next token's output equals the recurrence's over the whole sequence
    (mirrors tests/test_models.py:213)."""
    rng = np.random.default_rng(4)
    b, l, h, dh = 1, 32, 2, 8
    q, v = (torch.from_numpy(rng.standard_normal((b, l + 1, h, dh))
                             .astype(np.float32)) for _ in range(2))
    k = torch.from_numpy((rng.standard_normal((b, l + 1, h, dh))
                          / dh ** 0.5).astype(np.float32))
    logi = torch.from_numpy(rng.standard_normal((b, l + 1, h))
                            .astype(np.float32))
    logf = torch.nn.functional.logsigmoid(torch.from_numpy(
        rng.standard_normal((b, l + 1, h)).astype(np.float32)) + 3.0)
    y_all, _ = xlstm.mlstm_recurrent_ref(q, k, v, logi, logf)
    _, state = xlstm.mlstm_chunked(q[:, :l], k[:, :l], v[:, :l],
                                   logi[:, :l], logf[:, :l], chunk=8,
                                   return_final_state=True)
    y_last, _ = xlstm.mlstm_recurrent_ref(q[:, l:], k[:, l:], v[:, l:],
                                          logi[:, l:], logf[:, l:], state)
    np.testing.assert_allclose(n(y_last[:, 0]), n(y_all[:, l]), **RECURRENT)


def test_cache_crosses_by_tree_path():
    """`lm_cache_to_numpy` / `lm_cache_from_numpy`: bfloat16 and float32
    leaves, a nested recurrent state and `pos`, bits and dtypes kept; the
    numpy side is a copy."""
    cfg = get_config("zamba2-1.2b", reduced=True)
    gen = torch.Generator().manual_seed(0)
    cache = {"pos": 5,
             "mamba": {"conv": torch.randn((2, 1, 3, 4), generator=gen)
                       .to(torch.bfloat16),
                       "ssm": torch.randn((2, 1, 2, 2), generator=gen)},
             "shared_k": torch.randn((1, 1, 4, 2, 2), generator=gen)
             .to(torch.bfloat16)}
    leaves = convert.lm_cache_to_numpy(cache)
    assert sorted(leaves) == ["mamba/conv", "mamba/ssm", "pos", "shared_k"]
    assert leaves["pos"].dtype == np.int32 and int(leaves["pos"]) == 5
    back = convert.lm_cache_from_numpy(leaves, cfg, device=CPU)
    assert back["pos"] == 5
    for k in ("conv", "ssm"):
        assert back["mamba"][k].dtype == cache["mamba"][k].dtype
        assert torch.equal(back["mamba"][k], cache["mamba"][k])
    assert torch.equal(back["shared_k"], cache["shared_k"])
    cache["mamba"]["ssm"].add_(1.0)
    assert not np.array_equal(leaves["mamba/ssm"],
                              n(cache["mamba"]["ssm"]))
