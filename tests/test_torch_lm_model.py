"""The port's models against the reference's: the same parameters (the
reference's init, converted by tree path) and the same token (or frame)
batches through both packages; hidden states, logits, the MoE aux loss,
the loss and every parameter's gradient against `jax.value_and_grad`, for
the five dense configs, the two MoE configs, the MLA config, the frames
encoder (hubert), the mamba stack with shared attention (zamba2) and the
mLSTM stack (xlstm) at reduced size.  Mirrors `tests/test_models.py:34-54,
85-118, 273-290` for those archs.

Tolerances, relative to each tensor's largest entry: float32 activations
2e-5 for hidden states and logits, 1e-5 for the loss, 2e-5 for each
gradient leaf (measured: 1e-6-2e-6); bfloat16 activations (the configs'
own dtype) 1e-3 for the loss and 6e-2 for gradients (bfloat16 keeps 8 bits;
measured 4e-4 and 3e-2).

Two ways the reference's bfloat16 run is not the function the port
computes, and how the bfloat16 test holds the port all the same:
- zamba2's jitted reference differs from its own op-by-op run by 0.062 of
  a leaf's largest entry (`d_skip`): XLA keeps float32 between fused
  bfloat16 ops.  zamba2 is held to the op-by-op run (0.053), as the MoE
  archs are.
- The reference's backward sums a leaf broadcast over the tokens (a bias)
  with a bfloat16 `reduce_sum`, the transpose of its broadcast, where the
  port sums in float32; on xlstm-reduced that moves `b_gates`' gradient
  by 0.08 of its largest entry (the port's is nearer the float32 run's).
  There the reference gets `b_gates` widened to one copy per token, which
  leaves its forward bit for bit and hands back its per-token cotangents,
  summed here in float64 (the port then differs by 0.033).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import CPU, jax_state_leaves, n

from repro.configs import get_config as jget_config
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import lm_loss as jlm_loss
from repro.models.common import sinusoidal_positions as jsinusoidal
from repro.models.model import layer_windows as jlayer_windows
from repro.models.model import logits_from_hidden as jlogits
from repro.models.model import num_shared_apps as jnum_shared_apps
from repro.models.model import shared_attn_flags as jshared_attn_flags
from repro.models.model import shared_slots_py as jshared_slots_py
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import forward, init_params, lm_loss
from repro_torch.models.common import sinusoidal_positions
from repro_torch.models.model import (layer_windows, logits_from_hidden,
                                      num_shared_apps, shared_slots)
from repro_torch.training import value_and_grad

DENSE = ("tiny-lm", "granite-3-2b", "deepseek-coder-33b", "gemma3-4b",
         "chameleon-34b")
MOE_MLA = ("granite-moe-3b-a800m", "qwen3-moe-30b-a3b", "minicpm3-4b")
RECURRENT_FRAMES = ("hubert-xlarge", "zamba2-1.2b", "xlstm-1.3b")
BUILT = DENSE + MOE_MLA + RECURRENT_FRAMES
# The leaf each arch's init law is read from: a fan-in d_model projection.
FIRST_PROJ = {arch: ("blocks/attn/wq", ("layers", "embed", "heads"))
              for arch in BUILT}
FIRST_PROJ.update({
    "minicpm3-4b": ("blocks/attn/wdq", ("layers", "embed", "mlp")),
    "zamba2-1.2b": ("blocks/mixer/in_proj", ("layers", "embed", "mlp")),
    "xlstm-1.3b": ("blocks/mixer/up_proj", ("layers", "embed", "mlp"))})
# A leaf only the arch's own kind of tree has.
MARKER = {"granite-moe-3b-a800m": "blocks/moe/wi",
          "qwen3-moe-30b-a3b": "blocks/moe/wi",
          "minicpm3-4b": "blocks/attn/wdkv", "hubert-xlarge": "frame_proj",
          "zamba2-1.2b": "shared_attn/attn/wq",
          "xlstm-1.3b": "blocks/mixer/b_gates"}
# Held to the reference run one primitive at a time in bfloat16, and the
# leaves the reference gets one copy per token of (see the docstring).
OP_BY_OP = ("granite-moe-3b-a800m", "qwen3-moe-30b-a3b", "zamba2-1.2b")
PER_TOKEN = {"xlstm-1.3b": ("blocks/mixer/b_gates",)}
F32 = dict(hidden=2e-5, loss=1e-5, grad=2e-5)
BF16 = dict(loss=1e-3, grad=6e-2)


def _configs(arch, **changes):
    return (dataclasses.replace(jget_config(arch, reduced=True), **changes),
            dataclasses.replace(get_config(arch, reduced=True), **changes))


def _batch(cfg, b=2, s=64, seed=0):
    """Token ids, or for a frames frontend standard normal frames, and
    targets."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "frames":
        inputs = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    else:
        inputs = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return {"inputs": inputs,
            "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def _params(jcfg, seed=0):
    jp, _ = jinit_params(jcfg, jax.random.PRNGKey(seed))
    return jp, convert.lm_params_from_numpy(jax_state_leaves(jp), device=CPU)


def _close(got, want, tol, what=""):
    got, want = n(got).astype(np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= tol, f"{what}: {err:.3g} > {tol}"


def _per_token(jp, leaves, b, s):
    """The reference's tree with each stacked (L, n) leaf of `leaves`
    broadcast to (L, b, s, n): one copy per token, the same forward."""
    jp = jax.tree.map(lambda x: x, jp)
    for path in leaves:
        *head, last = path.split("/")
        node = jp
        for k in head:
            node = node[k]
        x = node[last]
        node[last] = jnp.broadcast_to(x[:, None, None, :],
                                      (x.shape[0], b, s, x.shape[1]))
    return jp


def _loss_and_grads(jcfg, tcfg, jp, tp, batch, op_by_op=False,
                    per_token=()):
    """The reference's loss and gradients, jitted, or with `op_by_op` one
    primitive at a time (`jax.disable_jit`), and the port's.  The leaves
    `per_token` get one copy per token in the reference's tree; their
    per-token gradients are summed in float64."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fn = jax.value_and_grad(lambda p: jlm_loss(p, jcfg, jb), has_aux=True)
    jp = _per_token(jp, per_token, *batch["targets"].shape)
    if op_by_op:
        with jax.disable_jit():
            (jl, jm), jg = fn(jp)
    else:
        (jl, jm), jg = jax.jit(fn)(jp)
    jg = jax_state_leaves(jg)
    for k in per_token:
        jg[k] = jg[k].astype(np.float64).sum(axis=(1, 2))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (tl, tm), tg = value_and_grad(lambda p, b: lm_loss(p, tcfg, b), tp, tb)
    return (jl, jm, jg), (tl, tm, convert.lm_params_to_numpy(tg))


def _held(jres, tres, tol):
    (jl, jm, jg), (tl, tm, tg) = jres, tres
    _close(tl, jl, tol["loss"], "loss")
    _close(tm["ce"], jm["ce"], tol["loss"], "ce")
    _close(tm["aux"], jm["aux"], tol["loss"], "aux")
    assert sorted(tg) == sorted(jg)
    for k in jg:
        _close(tg[k], jg[k], tol["grad"], k)


@pytest.mark.parametrize("arch", BUILT)
def test_init_tree_matches_reference(arch):
    """The same tree paths, shapes and dtypes as the reference's init, and
    the same init laws (unit norms; embedding std 0.02; fan-in dense)."""
    jcfg, tcfg = _configs(arch)
    jp, _ = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp, specs = init_params(tcfg, 0, device="cpu")
    want, got = jax_state_leaves(jp), convert.lm_params_to_numpy(tp)
    assert {k: (v.shape, str(v.dtype)) for k, v in got.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in want.items()}
    assert np.all(got["final_norm"] == 1.0)
    if "embed" in got:
        assert abs(float(got["embed"].std()) - 0.02) < 2e-3
    leaf, axes = FIRST_PROJ[arch]
    wq = got[leaf]
    # truncated normal on [-2, 2] has std 0.8796 before the fan-in scale
    assert abs(float(wq.std()) * np.sqrt(tcfg.d_model) - 0.8796) < 0.05
    assert float(np.abs(wq).max()) * np.sqrt(tcfg.d_model) <= 2.0
    again, _ = init_params(tcfg, 0, device="cpu")
    for k, v in convert.lm_params_to_numpy(again).items():
        assert np.array_equal(v, got[k])
    node = specs
    for k in leaf.split("/"):
        node = node[k]
    assert node == axes


@pytest.mark.parametrize("arch", MOE_MLA + RECURRENT_FRAMES)
def test_trees_cross_both_ways(arch):
    """The reference's params and AdamW state, the `moe` subtree, MLA's,
    the mixers', `frame_proj` and `shared_attn` leaves among them, cross
    into the port by tree path and back, every leaf's bits, shape and dtype
    kept."""
    from repro.optim import OptimizerConfig as JOptimizerConfig
    from repro.optim import init_opt_state as jinit_opt_state
    jcfg, _ = _configs(arch)
    jp, tp = _params(jcfg)
    want = jax_state_leaves(jp)
    assert MARKER[arch] in want
    back = convert.lm_params_to_numpy(tp)
    assert sorted(back) == sorted(want)
    for k in want:
        assert back[k].dtype == want[k].dtype and np.array_equal(back[k],
                                                                 want[k]), k
    jstate = jinit_opt_state(JOptimizerConfig(name="adamw"), jp)
    jstate = jstate._replace(mu=jax.tree.map(lambda x: x + 1.0, jstate.mu))
    swant = jax_state_leaves(jstate._asdict())
    state = convert.opt_state_from_numpy(swant, device=CPU)
    sback = convert.opt_state_to_numpy(state)
    assert sorted(sback) == sorted(swant)
    for k in swant:
        assert np.array_equal(sback[k], swant[k]), k


@pytest.mark.parametrize("arch", BUILT)
def test_forward_and_logits_match_reference(arch):
    jcfg, tcfg = _configs(arch, dtype="float32")
    jp, tp = _params(jcfg)
    toks = _batch(jcfg)["inputs"]
    jx, jaux, _ = jforward(jp, jcfg, jnp.asarray(toks))
    tx, taux, _ = forward(tp, tcfg, torch.from_numpy(toks))
    _close(tx, jx, F32["hidden"], "hidden")
    _close(logits_from_hidden(tp, tcfg, tx), jlogits(jp, jcfg, jx),
           F32["hidden"], "logits")
    if tcfg.is_moe:
        assert float(taux) > 0.0
        np.testing.assert_allclose(float(taux), float(jaux), rtol=F32["loss"])
    else:
        assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("arch", BUILT)
def test_loss_and_grads_match_reference_float32(arch):
    jcfg, tcfg = _configs(arch, dtype="float32")
    jp, tp = _params(jcfg)
    _held(*_loss_and_grads(jcfg, tcfg, jp, tp, _batch(jcfg)), F32)


@pytest.mark.parametrize("arch", BUILT)
def test_loss_and_grads_near_reference_bfloat16(arch):
    """The configs' own activation dtype (bfloat16 but for tiny-lm), with
    remat on as in the full configs, against the jitted reference; the MoE
    archs and zamba2 against the reference run one primitive at a time,
    where every bfloat16 op rounds its output as each of the port's does;
    xlstm's gate bias summed per token (the module docstring).  Jitted,
    XLA's CPU backend may keep float32 between fused ops (excess
    precision), which flips MoE routing decisions: its gradients then
    differ from its own op-by-op run by up to 0.77 of a leaf's largest
    entry (measured at the reduced MoE configs), where the port's differ
    by 0.02."""
    jcfg, tcfg = _configs(arch, remat=True)
    jp, tp = _params(jcfg)
    _held(*_loss_and_grads(jcfg, tcfg, jp, tp, _batch(jcfg),
                           op_by_op=arch in OP_BY_OP,
                           per_token=PER_TOKEN.get(arch, ())),
          F32 if tcfg.dtype == "float32" else BF16)


@pytest.mark.parametrize("changes", [dict(vocab_size=200),
                                     dict(tie_embeddings=True),
                                     dict(remat=True)],
                         ids=["padded-vocab", "tied", "remat"])
def test_variants_match_reference(changes):
    """The padded vocabulary's rows masked at -1e30, a tied head, and
    remat through torch.utils.checkpoint."""
    jcfg, tcfg = _configs("tiny-lm", **changes)
    jp, tp = _params(jcfg)
    batch = _batch(jcfg)
    if "vocab_size" in changes:
        assert tcfg.vocab_padded == 256 != tcfg.vocab_size
    _held(*_loss_and_grads(jcfg, tcfg, jp, tp, batch), F32)


def test_remat_keeps_loss_and_grads():
    """torch.utils.checkpoint recomputes each block in the backward: the
    same loss and gradients, bit for bit, as without it."""
    _, tcfg = _configs("granite-3-2b", dtype="float32")
    tp, _ = init_params(tcfg, 3, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    outs = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        (loss, _), grads = value_and_grad(lambda p, b: lm_loss(p, cfg, b),
                                          tp, batch)
        outs.append((loss, convert.lm_params_to_numpy(grads)))
    assert torch.equal(outs[0][0], outs[1][0])
    for k, v in outs[0][1].items():
        assert np.array_equal(v, outs[1][1][k]), k


def test_layer_windows_match_reference():
    for arch in DENSE:
        jcfg, tcfg = _configs(arch)
        assert layer_windows(tcfg) == np.asarray(jlayer_windows(jcfg)).tolist()
    _, gemma = _configs("gemma3-4b")
    assert layer_windows(gemma) == [8, 0, 8, 0]


def test_causal_arch_is_causal():
    _, cfg = _configs("granite-3-2b", dtype="float32")
    params, _ = init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(_batch(cfg, b=1, s=16)["inputs"])
    x1, _, _ = forward(params, cfg, toks)
    toks2 = toks.clone()
    toks2[:, -1] = (toks2[:, -1] + 1) % cfg.vocab_size
    x2, _, _ = forward(params, cfg, toks2)
    torch.testing.assert_close(x1[:, :-1], x2[:, :-1], atol=1e-5, rtol=0)
    assert float((x1[:, -1] - x2[:, -1]).abs().max()) > 1e-6


def test_banded_layers_see_only_their_window():
    """gemma3 (reduced): a token outside every local window and before the
    global layers' reach changes nothing; within reach it does."""
    _, cfg = _configs("gemma3-4b", dtype="float32",
                      global_every=0)           # every layer local, window 8
    params, _ = init_params(cfg, 1, device="cpu")
    toks = torch.from_numpy(_batch(cfg, b=1, s=64)["inputs"])
    x1, _, _ = forward(params, cfg, toks)
    toks2 = toks.clone()
    toks2[:, 0] = (toks2[:, 0] + 1) % cfg.vocab_size
    x2, _, _ = forward(params, cfg, toks2)
    reach = cfg.num_layers * (cfg.sliding_window - 1)   # 4 layers x 7
    torch.testing.assert_close(x1[:, reach + 1:], x2[:, reach + 1:],
                               atol=1e-5, rtol=0)
    assert float((x1[:, 1] - x2[:, 1]).abs().max()) > 1e-6


def test_encoder_arch_is_bidirectional():
    """hubert: perturbing the last frame changes the first position's
    hidden state (tests/test_models.py:85)."""
    _, cfg = _configs("hubert-xlarge")
    params, _ = init_params(cfg, 0, device="cpu")
    frames = torch.from_numpy(_batch(cfg, b=1, s=16)["inputs"])
    x1, _, _ = forward(params, cfg, frames)
    frames2 = frames.clone()
    frames2[:, -1] += 1.0
    x2, _, _ = forward(params, cfg, frames2)
    assert float((x1[:, 0] - x2[:, 0]).abs().max()) > 1e-6


@pytest.mark.parametrize("seq,d", [(64, 64), (256, 1280), (7, 10)])
def test_sinusoidal_positions_match_reference(seq, d):
    """To 2e-5: the angles reach 255 rad, where a float32 ulp is 1.5e-5, and
    the two packages' float32 `pow` may differ by an ulp (measured 3.8e-6
    at 256 x 1280)."""
    np.testing.assert_allclose(n(sinusoidal_positions(seq, d)),
                               np.asarray(jsinusoidal(seq, d)),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_shared_slots_match_reference(reduced):
    """zamba2's shared block fires after every `shared_attn_every`-th layer
    (layers 5, 11, ..., 35 of the full config; 1 and 3 of the reduced), the
    k-th time with slot k, as the reference's flags say."""
    jcfg = jget_config("zamba2-1.2b", reduced=reduced)
    cfg = get_config("zamba2-1.2b", reduced=reduced)
    slots = shared_slots(cfg)
    assert slots == jshared_slots_py(jcfg) == \
        np.asarray(jshared_attn_flags(jcfg)).tolist()
    assert num_shared_apps(cfg) == jnum_shared_apps(jcfg) == max(slots)
    fired = [i for i, k in enumerate(slots) if k]
    assert fired == ([5, 11, 17, 23, 29, 35] if not reduced else [1, 3])
    for arch in DENSE + ("xlstm-1.3b",):
        assert shared_slots(get_config(arch)) == [0] * get_config(
            arch).num_layers


def test_remat_keeps_shared_block_grads():
    """zamba2 (reduced, float32): with remat each layer's body, the shared
    block's application after it included, is recomputed in its own
    checkpoint; the shared leaves' gradients, summed over the two
    applications, are bit for bit those without remat."""
    _, tcfg = _configs("zamba2-1.2b", dtype="float32")
    tp, _ = init_params(tcfg, 3, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    outs = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        (loss, _), grads = value_and_grad(lambda p, b: lm_loss(p, cfg, b),
                                          tp, batch)
        outs.append((loss, convert.lm_params_to_numpy(grads)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert any(k.startswith("shared_attn/") for k in outs[0][1])
    for k, v in outs[0][1].items():
        assert np.array_equal(v, outs[1][1][k]), k
