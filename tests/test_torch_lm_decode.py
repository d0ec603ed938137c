"""The port's serving path on its own and at its seams: prefill plus decode
steps against the port's full forward (mirrors `tests/test_models.py:
55-83`), `init_cache` against the reference's keys, shapes and dtypes, the
step builders, and the port's decode started from the reference's
prefill cache through `convert.lm_cache_from_numpy`, which holds the
decode on its own.

Tolerances: the forward's logits at atol / rtol 1e-4, float32, as the
reference's own test; the decode from the reference's cache at the LM
tests' F32, 2e-5 of each tensor's largest entry.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from _torch_port import (CPU, DECODE_ARCHS, SERVE_PROMPT, held_serving,
                         lm_pair, serve_port, serve_reference, serve_tokens)

from repro.configs import get_config as jget_config
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs import REGISTRY
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, logits_from_hidden, prefill)
from repro_torch.training import make_decode_step, make_prefill_step

F32 = 2e-5


def _cfg(arch, **changes):
    return dataclasses.replace(get_config(arch, reduced=True), **changes)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_consistent_with_forward(arch):
    """Prefill of 32 tokens plus three decode steps reproduce the full
    forward's logits over 35 (MoE dropless: a drop pattern depends on the
    row's length)."""
    cfg = _cfg(arch, dtype="float32", capacity_factor=4.0)
    params, _ = init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(serve_tokens(cfg)).long()
    s, total = SERVE_PROMPT, toks.shape[1]
    with torch.no_grad():
        x, _, _ = forward(params, cfg, toks)
        full = logits_from_hidden(params, cfg, x)
        lp, cache = prefill(params, cfg, toks[:, :s], total)
        assert lp.shape == (toks.shape[0], 1, cfg.vocab_padded)
        torch.testing.assert_close(lp[:, 0], full[:, s - 1], atol=1e-4,
                                   rtol=1e-4)
        for i in range(s, total):
            assert cache["pos"] == i
            ld, cache = decode_step(params, cfg, cache, toks[:, i:i + 1])
            torch.testing.assert_close(ld[:, 0], full[:, i], atol=1e-4,
                                       rtol=1e-4)
    assert cache["pos"] == total


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_init_cache_matches_reference(arch):
    """The reference's keys, shapes and dtypes (`jax.eval_shape`), every
    entry zero, `pos` 0, on the params' device."""
    jcfg, cfg = jget_config(arch, reduced=True), get_config(arch,
                                                            reduced=True)
    want = jax.eval_shape(
        lambda: jinit_cache(jinit_params(jcfg, jax.random.PRNGKey(0))[0],
                            jcfg, 3, 40))
    params, _ = init_params(cfg, 0, device="cpu")
    got = init_cache(params, cfg, 3, 40)
    assert got["pos"] == 0
    want = {k: v for k, v in zip(*_names(want))}
    have = dict(zip(*_names(got)))
    assert sorted(have) == sorted(want)
    for k, v in want.items():
        if k == "pos":
            continue
        assert tuple(have[k].shape) == v.shape, k
        assert str(have[k].dtype).split(".")[1] == str(v.dtype), k
        assert have[k].device == CPU and not have[k].any(), k


def _names(tree):
    from repro_torch.checkpoint.store import _flatten_with_paths
    names, leaves, _ = _flatten_with_paths(tree)
    return names, leaves


@pytest.mark.parametrize("arch", ["gemma3-4b", "minicpm3-4b", "zamba2-1.2b",
                                  "xlstm-1.3b"])
def test_step_builders_equal_direct_calls(arch):
    """`make_prefill_step` / `make_decode_step` give the direct calls' bits
    and build no graph, even with params that require grad."""
    cfg = _cfg(arch)
    params, _ = init_params(cfg, 1, device="cpu")
    toks = torch.from_numpy(serve_tokens(cfg, seed=1)).long()
    s = SERVE_PROMPT
    want, wcache = prefill(params, cfg, toks[:, :s], toks.shape[1])
    want_steps = [decode_step(params, cfg, wcache, toks[:, i:i + 1])[0]
                  for i in range(s, toks.shape[1])]
    watched = {k: (v.requires_grad_(True) if k == "final_norm" else v)
               for k, v in params.items()}
    got, cache = make_prefill_step(cfg, toks.shape[1])(watched, toks[:, :s])
    assert torch.equal(got, want) and not got.requires_grad
    step = make_decode_step(cfg)
    for i, w in zip(range(s, toks.shape[1]), want_steps):
        logits, cache = step(watched, cache, toks[:, i:i + 1])
        assert torch.equal(logits, w) and not logits.requires_grad
    assert convert.lm_cache_to_numpy(cache).keys() == \
        convert.lm_cache_to_numpy(wcache).keys()
    for k, v in convert.lm_cache_to_numpy(cache).items():
        assert np.array_equal(v, convert.lm_cache_to_numpy(wcache)[k]), k


@pytest.mark.parametrize("arch", ["granite-3-2b", "granite-moe-3b-a800m",
                                  "minicpm3-4b", "zamba2-1.2b",
                                  "xlstm-1.3b"])
def test_decode_from_reference_prefill_cache(arch):
    """One arch of each block kind (GQA, the MoE feed-forward, MLA's latent
    cache, Mamba-2 with the shared block's slots, mLSTM): the reference's
    prefill cache crosses into the port, whose decode steps then match the
    reference's logits and caches."""
    jcfg, tcfg, jp, tp = lm_pair(arch, dtype="float32", capacity_factor=4.0)
    toks = serve_tokens(jcfg, seed=2)
    want = serve_reference(jcfg, jp, toks, SERVE_PROMPT)
    cache = convert.lm_cache_from_numpy(want[0][1], tcfg, device=CPU)
    assert cache["pos"] == SERVE_PROMPT
    held_serving(serve_port(tcfg, tp, toks, SERVE_PROMPT, cache=cache),
                 want[1:], F32)


def test_serving_refuses_positions_past_the_cache():
    cfg = _cfg("tiny-lm")
    params, _ = init_params(cfg, 0, device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="past max_len"):
        prefill(params, cfg, toks, 7)
    _, cache = prefill(params, cfg, toks, 8)
    with pytest.raises(ValueError, match="outside the cache"):
        decode_step(params, cfg, cache, toks[:, :1])
