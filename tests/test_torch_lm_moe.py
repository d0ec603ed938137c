"""The port's MoE feed-forward (`repro_torch/models/moe.py`) against the
reference's single-device path (`repro/models/moe.py`) on the same numpy
inputs: capacity, the two position forms, routing (ties included), the
dispatch and combine primitives with their custom backward passes, and
`moe_ffn`'s output, aux loss and gradients at the reduced MoE configs'
shapes (padded expert tables 4 -> 16 and 8 -> 16).  Mirrors
`tests/test_models.py:235-271`.

Tolerances: integer results (capacity, positions, slots) and the
primitives (copies of rows) are exact; float32 gates, aux and dropped 1e-6
relative; `moe_ffn`'s output and gradients 2e-5 relative to each tensor's
largest entry (the expert products sum in another order; measured 2e-7 to
4e-7).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import n

from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.models import init_params, lm_loss
from repro_torch.models import moe
from repro_torch.training import value_and_grad

TOL = 2e-5
MOE_ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-30b-a3b")


def _close(got, want, tol, what=""):
    got, want = n(got).astype(np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= tol, f"{what}: {err:.3g} > {tol}"


def _params(d, f, e, e_pad, seed=0):
    """The reference's MoE init as numpy, and the same in the port."""
    jp, _ = jmoe.init_moe_params(jax.random.PRNGKey(seed), d, f, e,
                                 jnp.float32, num_experts_padded=e_pad)
    npp = {k: np.asarray(v) for k, v in jp.items()}
    return jp, {k: torch.from_numpy(v.copy()) for k, v in npp.items()}


def _jroute(x, router, top_k, capacity, dispatch):
    return jax.vmap(lambda xr: jmoe._route_row(
        xr, router, top_k, capacity, dispatch))(jnp.asarray(x))


@pytest.mark.parametrize("cf", [0.25, 1.0, 1.25, 2.0, 8.0])
@pytest.mark.parametrize("top_k", [1, 2, 8])
def test_capacity_matches_reference(top_k, cf):
    for seq in (1, 7, 8, 64, 100, 256, 4096):
        for e in (2, 4, 8, 40, 128):
            assert moe._capacity(seq, top_k, e, cf) == \
                jmoe._capacity(seq, top_k, e, cf), (seq, e)
    # granite-moe at the chip phase's shape: 64 per expert per row
    assert moe._capacity(256, 8, 40, 1.25) == 64


@pytest.mark.parametrize("crowded", [False, True], ids=["spread", "crowded"])
def test_positions_match_reference(crowded):
    """Both forms equal, and equal the reference's, row by row; `crowded`
    sends most choices of every row to one expert."""
    rng = np.random.default_rng(1)
    b, s, k, e = 3, 48, 4, 8
    idx = rng.integers(0, e, (b, s, k))
    if crowded:
        idx[:, :, :3] = np.where(rng.random((b, s, 3)) < 0.8, 5,
                                 idx[:, :, :3])
    t = torch.from_numpy(idx)
    by_sort = moe._positions_sort(t, e)
    by_cumsum = moe._positions_cumsum(t, e)
    assert torch.equal(by_sort, by_cumsum)
    for row in range(b):
        want_s = np.asarray(jmoe._positions_sort(jnp.asarray(idx[row]), e))
        want_c = np.asarray(jmoe._positions_cumsum(jnp.asarray(idx[row]), e))
        assert np.array_equal(n(by_sort[row]), want_s)
        assert np.array_equal(want_s, want_c)
    if crowded:
        assert int(by_sort.max()) >= 3 * s * 0.8 - 1


@pytest.mark.parametrize("dispatch", ["sort", "cumsum"])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_routing_matches_reference(tied, dispatch):
    """Slots, gates, aux and dropped of every row at float32, with a
    capacity that drops; `tied` makes router columns 1 and 2 copies of
    column 0, so three experts tie on every token and the lower index must
    win as in `jax.lax.top_k`."""
    rng = np.random.default_rng(2)
    b, s, d, e, k = 3, 32, 16, 6, 2
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    router = rng.standard_normal((d, e)).astype(np.float32)
    if tied:
        router[:, 1] = router[:, 0]
        router[:, 2] = router[:, 0]
    cap = moe._capacity(s, k, e, 0.5)
    want = _jroute(x, jnp.asarray(router), k, cap, dispatch)
    got = moe._route_row(torch.from_numpy(x), torch.from_numpy(router), k,
                         cap, dispatch)
    assert np.array_equal(n(got[0]), np.asarray(want[0]))
    for g, w, what in zip(got[1:], want[1:], ("gates", "aux", "dropped")):
        np.testing.assert_allclose(n(g), np.asarray(w), rtol=1e-6,
                                   atol=1e-7, err_msg=what)
    assert float(got[3].max()) > 0.0                    # some choices drop
    if tied:
        probs, _, idx = moe.router_top_k(torch.from_numpy(x),
                                          torch.from_numpy(router), k)
        assert torch.equal(probs[..., 0], probs[..., 1])
        assert torch.equal(probs[..., 0], probs[..., 2])
        top0 = probs[..., :3].amax(-1) >= probs.amax(-1)
        # where the tied trio leads, experts 0 and 1 are the two picks
        assert bool(top0.any())
        assert torch.equal(idx[top0], torch.tensor([0, 1]).expand(
            int(top0.sum()), 2))


def test_routing_ties_in_bfloat16():
    """A bfloat16 router product with duplicated columns: the tied
    probabilities resolve to the lower index in both packages."""
    rng = np.random.default_rng(3)
    b, s, d, e, k = 2, 64, 32, 8, 3
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    router = rng.standard_normal((d, e)).astype(np.float32)
    router[:, 5] = router[:, 2]
    cap = moe._capacity(s, k, e, 1.25)
    want = _jroute(jnp.asarray(x, jnp.bfloat16),
                   jnp.asarray(router, jnp.bfloat16), k, cap, "sort")
    got = moe._route_row(torch.from_numpy(x).to(torch.bfloat16),
                         torch.from_numpy(router).to(torch.bfloat16), k, cap)
    slots = n(got[0])
    assert np.array_equal(slots, np.asarray(want[0]))
    experts = slots // cap
    both = (experts == 2).any(-1) & (experts == 5).any(-1)
    assert both.any()       # tokens where the tied pair is picked together
    np.testing.assert_allclose(n(got[1].float()),
                               np.asarray(want[1], np.float32), rtol=1e-2)


def test_scatter_and_gather_rows_match_reference():
    """The primitives and their backward passes against the reference's
    custom VJPs, vmapped over rows, with the sentinel row written by every
    dropped choice."""
    rng = np.random.default_rng(4)
    b, n_rows, m, d = 2, 9, 6, 5
    idx = np.stack([rng.permutation(n_rows - 1)[:m] for _ in range(b)])
    idx[:, -2:] = n_rows - 1                           # two dropped choices
    buf = rng.standard_normal((b, n_rows, d)).astype(np.float32)
    rows = rng.standard_normal((b, m, d)).astype(np.float32)
    cot = rng.standard_normal((b, n_rows, d)).astype(np.float32)
    cot[:, -1] = 0.0                                   # the sentinel's

    def jscatter(bu, ro):
        return jax.vmap(jmoe.scatter_rows)(bu, jnp.asarray(idx), ro)

    jout, vjp = jax.vjp(jscatter, jnp.asarray(buf), jnp.asarray(rows))
    jdbuf, jdrows = vjp(jnp.asarray(cot))
    tb, tr = (torch.from_numpy(a).requires_grad_(True) for a in (buf, rows))
    tout = moe.scatter_rows(tb, torch.from_numpy(idx), tr)
    tdbuf, tdrows = torch.autograd.grad(tout, (tb, tr), torch.from_numpy(cot))
    assert np.array_equal(n(tout)[:, :-1], np.asarray(jout)[:, :-1])
    assert np.array_equal(n(tdbuf), np.asarray(jdbuf))
    assert np.array_equal(n(tdrows), np.asarray(jdrows))

    gcot = rng.standard_normal((b, m, d)).astype(np.float32)
    jg, gvjp = jax.vjp(lambda f: jax.vmap(jmoe.gather_rows)(
        f, jnp.asarray(idx)), jnp.asarray(buf))
    (jdflat,) = gvjp(jnp.asarray(gcot))
    tf = torch.from_numpy(buf).requires_grad_(True)
    tg = moe.gather_rows(tf, torch.from_numpy(idx))
    (tdflat,) = torch.autograd.grad(tg, tf, torch.from_numpy(gcot))
    assert np.array_equal(n(tg), np.asarray(jg))
    _close(tdflat, jdflat, 1e-7, "dflat")   # the sentinel sums two reads


def test_init_moe_params_tree():
    """The reference's leaves, shapes and axes; the tables drawn at the
    padded expert count with the reference's fan-in law."""
    gen = torch.Generator().manual_seed(0)
    p, specs = moe.init_moe_params(gen, 64, 32, 40, torch.float32,
                                   num_experts_padded=48)
    jp, jspecs = jmoe.init_moe_params(jax.random.PRNGKey(0), 64, 32, 40,
                                      jnp.float32, num_experts_padded=48)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: v.shape for k, v in jp.items()}
    assert specs == jspecs
    # fan-in is the leading dim, as the reference's init_dense reads it
    assert abs(float(p["wi"].std()) * np.sqrt(48) - 0.8796) < 0.02
    assert float(p["wi"][40:].abs().min()) < float(p["wi"][40:].abs().max())


def _ffn_both(arch, b=2, s=64, seed=0, **cfg_changes):
    """moe_ffn at a reduced config's shapes in both packages, float32:
    (jax out, aux, grads), (torch out, aux, grads), grads of
    sum(out * cot) + 0.3 aux with respect to x and every leaf."""
    cfg = dataclasses.replace(get_config(arch, reduced=True), **cfg_changes)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    jp, tp = _params(d, f, e, cfg.num_experts_padded, seed)
    rng = np.random.default_rng(seed + 10)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    cot = rng.standard_normal((b, s, d)).astype(np.float32)
    kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
              dispatch=cfg.moe_dispatch)

    def jloss(p, xx):
        out, aux = jmoe.moe_ffn(p, xx, **kw)
        return jnp.sum(out * cot) + 0.3 * aux, (out, aux)

    (_, (jout, jaux)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    leaves = {k: v.requires_grad_(True) for k, v in tp.items()}
    tout, taux = moe.moe_ffn(leaves, tx, **kw)
    loss = torch.sum(tout * torch.from_numpy(cot)) + 0.3 * taux
    names = sorted(leaves)
    tg = torch.autograd.grad(loss, [leaves[k] for k in names] + [tx])
    jgrads = {**{k: np.asarray(jg[0][k]) for k in names},
              "x": np.asarray(jg[1])}
    tgrads = dict(zip(names + ["x"], tg))
    return cfg, (jout, jaux, jgrads), (tout, taux, tgrads)


@pytest.mark.parametrize("dispatch", ["sort", "cumsum"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_reference(arch, dispatch):
    """Output, aux and the gradient of every leaf and of x, float32."""
    cfg, (jout, jaux, jg), (tout, taux, tg) = _ffn_both(
        arch, moe_dispatch=dispatch)
    assert cfg.num_experts_padded == 16 > cfg.num_experts
    _close(tout, jout, TOL, "out")
    np.testing.assert_allclose(float(taux.detach()), float(jaux), rtol=1e-6)
    assert taux.dtype == torch.float32
    for k in jg:
        _close(tg[k], jg[k], TOL, k)
    # the dummy experts' rows receive no gradient
    for k in ("wi", "wg", "wo"):
        assert float(tg[k][cfg.num_experts:].abs().max()) == 0.0


def test_moe_ffn_bfloat16_near_reference():
    """bfloat16 activations and weights (the configs' dtype): output and aux
    to bfloat16's resolution (2e-2 stated)."""
    cfg = get_config("qwen3-moe-30b-a3b", reduced=True)
    jp, tp = _params(cfg.d_model, cfg.d_ff, cfg.num_experts,
                     cfg.num_experts_padded, seed=5)
    x = np.random.default_rng(6).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
    jout, jaux = jmoe.moe_ffn({k: v.astype(jnp.bfloat16) for k, v in
                               jp.items()}, jnp.asarray(x, jnp.bfloat16), **kw)
    tout, taux = moe.moe_ffn({k: v.to(torch.bfloat16) for k, v in tp.items()},
                             torch.from_numpy(x).to(torch.bfloat16), **kw)
    assert tout.dtype == torch.bfloat16
    _close(tout.float(), np.asarray(jout, np.float32), 2e-2, "out")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_moe_no_drop_matches_dense_combination():
    """With capacity >= tokens, the output is sum_k gate_k * expert_k(x),
    and the reference gives the same from the same params."""
    d, e, ff = 16, 4, 8
    jp, tp = _params(d, ff, e, e)
    x = np.random.default_rng(7).standard_normal((1, 8, d)).astype(np.float32)
    tx = torch.from_numpy(x)
    out, aux = moe.moe_ffn(tp, tx, top_k=2, capacity_factor=8.0)
    xf = tx.reshape(-1, d)
    probs = torch.softmax(xf @ tp["router"], -1)
    gv, ei = torch.topk(probs, 2)
    gv = gv / gv.sum(-1, keepdim=True)
    want = torch.zeros((8, d))
    for t in range(8):
        for j in range(2):
            ex = int(ei[t, j])
            h = (torch.nn.functional.silu(xf[t] @ tp["wg"][ex])
                 * (xf[t] @ tp["wi"][ex]))
            want[t] += gv[t, j] * (h @ tp["wo"][ex])
    torch.testing.assert_close(out[0], want, atol=1e-4, rtol=1e-3)
    assert float(aux) > 0.0
    jout, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), top_k=2, capacity_factor=8.0)
    _close(out, jout, TOL, "out")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_moe_capacity_drops_tokens_to_residual():
    """A tight capacity drops choices (their output is 0 from the sentinel
    row), as in the reference, which drops the same ones."""
    d, e, ff = 8, 2, 8
    jp, tp = _params(d, ff, e, e)
    x = np.random.default_rng(8).standard_normal((1, 64, d)).astype(np.float32)
    tx = torch.from_numpy(x)
    tight, _ = moe.moe_ffn(tp, tx, top_k=2, capacity_factor=0.25)
    loose, _ = moe.moe_ffn(tp, tx, top_k=2, capacity_factor=8.0)
    assert float((tight - loose).abs().max()) > 1e-6
    cap = moe._capacity(64, 2, e, 0.25)
    slots, _, _, dropped = moe._route_row(tx, tp["router"], 2, cap)
    rows_out = (slots == e * cap).all(-1)[0]           # both choices dropped
    assert bool(rows_out.any()) and float(dropped) > 0.5
    assert float(tight[0, rows_out].abs().max()) == 0.0
    jtight, _ = jmoe.moe_ffn(jp, jnp.asarray(x), top_k=2, capacity_factor=0.25)
    _close(tight, jtight, TOL, "tight")


def test_remat_recomputes_the_same_routing():
    """torch.utils.checkpoint recomputes each MoE block in the backward: the
    routing comes out the same, so the loss and every gradient are bit for
    bit those without remat (bfloat16, where ties are common)."""
    cfg = get_config("granite-moe-3b-a800m", reduced=True)
    params, _ = init_params(cfg, 3, device="cpu")
    rng = np.random.default_rng(9)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
             for k in ("inputs", "targets")}
    outs = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        (loss, metrics), grads = value_and_grad(
            lambda p, b: lm_loss(p, c, b), params, batch)
        outs.append((loss, metrics["aux"], grads["blocks"]["moe"]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    for k in outs[0][2]:
        assert torch.equal(outs[0][2][k], outs[1][2][k]), k

