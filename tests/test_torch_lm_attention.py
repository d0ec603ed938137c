"""The port's attention against the reference's (`repro/models/attention.py`)
on the same numpy inputs: full, chunked and banded, causal and windowed,
forward and gradients.  Mirrors `tests/test_models.py:120-147`, and holds
the chunked backward to the reference's recompute (no (S, S) tensor saved).

Tolerances: float32 forward 2e-5 and gradients 1e-4, relative to each
tensor's largest entry (the reference's own equivalence tolerance is
2e-5; the gradients sum over every query of a block in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import n

from repro.models import attention as jattn
from repro_torch.models import attention as attn

FWD = 2e-5
GRAD = 1e-4


def _qkv(b=2, s=256, h=4, kv=2, dh=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in
                 ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh), (b, s, h, dh)))


def _close(got, want, tol):
    got, want = n(got), np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(got - want))) <= tol * scale


def _both(jfn, tfn, q, k, v, cot):
    """Outputs and (dq, dk, dv) of each package for the cotangent `cot`."""
    jout, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(cot))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tout = tfn(tq, tk, tv)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.from_numpy(cot))
    return (jout, jgrads), (tout, tgrads)


def _held(jres, tres):
    (jout, jgrads), (tout, tgrads) = jres, tres
    _close(tout, jout, FWD)
    for want, got in zip(jgrads, tgrads):
        _close(got, want, GRAD)


@pytest.mark.parametrize("window", [0, 32])
@pytest.mark.parametrize("causal", [True, False])
def test_full_attention_matches_reference(causal, window):
    q, k, v, cot = _qkv(s=64)
    _held(*_both(
        lambda a, b, c: jattn.full_attention(a, b, c, causal=causal,
                                             window=window),
        lambda a, b, c: attn.full_attention(a, b, c, causal=causal,
                                            window=window), q, k, v, cot))


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 32)])
def test_chunked_attention_matches_reference(causal, window):
    """Forward and the flash backward, 4 x 4 blocks of 64."""
    q, k, v, cot = _qkv()
    _held(*_both(
        lambda a, b, c: jattn.chunked_attention(
            a, b, c, causal=causal, window=window, q_chunk=64, kv_chunk=64),
        lambda a, b, c: attn.chunked_attention(
            a, b, c, causal=causal, window=window, q_chunk=64, kv_chunk=64),
        q, k, v, cot))


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 32)])
def test_chunked_attention_matches_full(causal, window):
    """The port's chunked form against its own full form (the reference's
    `test_chunked_attention_matches_full`), gradients too."""
    q, k, v, cot = _qkv()
    ts = [tuple(torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
          for _ in range(2)]
    full = attn.full_attention(*ts[0], causal=causal, window=window)
    chunked = attn.chunked_attention(*ts[1], causal=causal, window=window,
                                     q_chunk=64, kv_chunk=64)
    _close(chunked, n(full), FWD)
    g_full = torch.autograd.grad(full, ts[0], torch.from_numpy(cot))
    g_chunk = torch.autograd.grad(chunked, ts[1], torch.from_numpy(cot))
    for a, b in zip(g_chunk, g_full):
        _close(a, n(b), GRAD)


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_mla_widths_match_reference(causal):
    """MLA's widths (query/key 96 = nope 64 + rope 32, value 64) through
    the chunked path at the reference's default 1024-blocks, 2 x 2 of them
    at a sequence past `dispatch_attention`'s full threshold: forward and
    the flash backward, whose dv carries the value width."""
    rng = np.random.default_rng(5)
    b, s, h = 1, 2048, 2
    q, k = (rng.standard_normal((b, s, h, 96)).astype(np.float32)
            for _ in range(2))
    v, cot = (rng.standard_normal((b, s, h, 64)).astype(np.float32)
              for _ in range(2))
    jres, tres = _both(
        lambda a, b_, c: jattn.dispatch_attention(a, b_, c, causal=causal),
        lambda a, b_, c: attn.dispatch_attention(a, b_, c, causal=causal),
        q, k, v, cot)
    assert tuple(tres[0].shape) == (b, s, h, 64)
    assert tuple(tres[1][2].shape) == (b, s, h, 64)
    _held(jres, tres)


def test_chunked_backward_saves_no_score_matrix():
    """The backward recomputes the probabilities from the saved lse: what
    autograd keeps is (q, k, v, out, lse), nothing of size S x S."""
    q, k, v, _ = _qkv(s=256)
    saved = []

    def pack(x):
        saved.append(tuple(x.shape))
        return x

    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        attn.chunked_attention(*ts, causal=True, q_chunk=64, kv_chunk=64)
    assert sorted(saved) == sorted([q.shape, k.shape, v.shape, q.shape,
                                    (2, 2, 2, 256)])


@pytest.mark.parametrize("window", [16, 64, 100])
def test_banded_attention_matches_reference(window):
    q, k, v, cot = _qkv(s=256)
    _held(*_both(
        lambda a, b, c: jattn.banded_attention(a, b, c, window=window,
                                               q_chunk=64),
        lambda a, b, c: attn.banded_attention(a, b, c, window=window,
                                              q_chunk=64), q, k, v, cot))


@pytest.mark.parametrize("window", [16, 100])
def test_banded_attention_matches_masked_full(window):
    q, k, v, _ = _qkv(s=256)
    ts = [torch.from_numpy(a) for a in (q, k, v)]
    full = attn.full_attention(*ts, causal=True, window=window)
    banded = attn.banded_attention(*ts, window=window, q_chunk=64)
    _close(banded, n(full), FWD)


@pytest.mark.parametrize("s,window,threshold", [(64, 0, 1024), (256, 0, 128),
                                                (256, 32, 1024)])
def test_dispatch_attention_matches_reference(s, window, threshold):
    """Full below the threshold, chunked above it, banded past a window."""
    q, k, v, cot = _qkv(s=s)
    _held(*_both(
        lambda a, b, c: jattn.dispatch_attention(
            a, b, c, causal=True, window=window, full_threshold=threshold),
        lambda a, b, c: attn.dispatch_attention(
            a, b, c, causal=True, window=window, full_threshold=threshold),
        q, k, v, cot))


def test_bfloat16_full_attention_near_reference():
    """bfloat16 inputs, float32 scores in both packages: the outputs agree
    to bfloat16's resolution (2^-8 relative, 2e-2 stated)."""
    q, k, v, _ = _qkv(s=64)
    want = jattn.full_attention(*(jnp.asarray(a, jnp.bfloat16)
                                  for a in (q, k, v)), causal=True)
    got = attn.full_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                                for a in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), 2e-2)
