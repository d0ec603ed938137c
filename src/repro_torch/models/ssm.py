"""Mamba-2 (SSD) blocks, the chunked training scan (counterpart of
`repro/models/ssm.py`, its train path).

The state-space-duality algorithm of Mamba-2 [arXiv:2405.21060]: within a
chunk the recurrence is computed in its quadratic "attention-like" form;
across chunks a (heads, head_dim, state) carry, in float32, propagates
through a Python loop over the chunks (the reference's `lax.scan`).
`ssd_recurrent_ref`, the literal per-token recurrence, is the oracle the
tests hold the chunked scan to.

The casts follow the reference's one for one, so a bfloat16 run rounds
where the reference's does: the decay exponents and the intra-chunk
scores are float32, the scores and `dt * decay` are cast to the input's
dtype before their products with `x`, and so are the carried states and
the decay from a chunk's start.  The reference's three-operand einsum is
two products here, in the order its contraction path takes.

The decode state (`mamba_init_state`: the conv's last width - 1 inputs in
the activation dtype and the (heads, head_dim, state) carry in float32)
and `mamba_decode_step`, the recurrence at one token, which rounds where
the reference's does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import (causal_conv, conv_step, init_dense,
                                       rms_norm, silu_stepwise, split_tree)

Tensor = torch.Tensor


def init_mamba_params(gen: torch.Generator, d_model: int, *, expand: int,
                      state: int, head_dim: int, groups: int,
                      dtype: torch.dtype, conv_width: int = 4):
    din = expand * d_model
    nheads = din // head_dim
    proj_out = 2 * din + 2 * groups * state + nheads
    conv_dim = din + 2 * groups * state
    tree = {
        "in_proj": init_dense(gen, (d_model, proj_out), ("embed", "mlp"),
                              dtype),
        "conv_w": init_dense(gen, (conv_width, conv_dim),
                             ("layers_none", "mlp"), dtype, scale=0.5),
        "conv_b": (torch.zeros((conv_dim,), dtype=dtype), ("mlp",)),
        "a_log": (torch.log(torch.linspace(1.0, 16.0, nheads)).to(dtype),
                  ("heads",)),
        "dt_bias": (torch.zeros((nheads,), dtype=dtype), ("heads",)),
        "d_skip": (torch.ones((nheads,), dtype=dtype), ("heads",)),
        "norm_scale": (torch.ones((din,), dtype=dtype), ("mlp",)),
        "out_proj": init_dense(gen, (din, d_model), ("mlp", "embed"), dtype),
    }
    return split_tree(tree)


def _segsum(a: Tensor) -> Tensor:
    """Lower-triangular pairwise decay exponents: out[t, s] = sum_{s<u<=t}
    a[u].  a: (..., Q).  Returns (..., Q, Q) with -inf above the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]          # sum_(s, t]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -math.inf)


def ssd_chunked(x: Tensor, dt: Tensor, a: Tensor, b_mat: Tensor,
                c_mat: Tensor, *, chunk: int, h0: Tensor | None = None,
                return_final_state: bool = False):
    """SSD scan.  x: (B, L, H, P); dt: (B, L, H); a: (H,) (negative);
    b_mat / c_mat: (B, L, G, N) with H % G == 0; h0: (B, H, P, N).

    Returns y (B, L, H, P) [and the final state (B, H, P, N), float32]."""
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    chunk = min(chunk, l)
    l_orig = l
    if l % chunk:
        # Zero-pad to a chunk multiple: dt = 0 gives decay 1 and zero input,
        # so padded steps are exact no-ops for the outputs and the state.
        pad = chunk - l % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
        l = l + pad
    nc = l // chunk

    # Broadcast groups to heads.
    bh = torch.repeat_interleave(b_mat, rep, dim=2)     # (B, L, H, N)
    ch = torch.repeat_interleave(c_mat, rep, dim=2)

    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bc = bh.reshape(bsz, nc, chunk, h, n)
    cc = ch.reshape(bsz, nc, chunk, h, n)
    ac = (dtc * a[None, None, None, :]).float()         # (B, nc, Q, H)

    acs = torch.cumsum(ac, dim=2)                       # inclusive cumsum
    seg = _segsum(ac.transpose(2, 3))                   # (B, nc, H, Q, Q)
    decay_mat = torch.exp(seg)

    # Intra-chunk (quadratic) term: scores accumulate in float32.
    scores = torch.einsum("bzqhn,bzshn->bzhqs", cc.float(), bc.float())
    scores = scores * decay_mat * dtc.transpose(2, 3)[:, :, :, None, :]
    y_intra = torch.einsum("bzhqs,bzshp->bzqhp", scores.to(x.dtype), xc)

    # Per-chunk final state: sum_s exp(acs[Q-1] - acs[s]) dt_s B_s x_s,
    # with dt folded into x first, as the reference's contraction path does.
    decay_to_end = torch.exp(acs[:, :, -1:, :] - acs)   # (B, nc, Q, H)
    dtb = (dtc * decay_to_end).to(x.dtype)
    chunk_states = torch.einsum("bzshn,bzshp->bzhpn", bc,
                                xc * dtb[..., None])
    chunk_decay = torch.exp(acs[:, :, -1, :])           # (B, nc, H)

    # Inter-chunk recurrence, the carry in float32.
    hprev = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if h0 is None else h0.float())
    h_prevs = []
    for z in range(nc):
        h_prevs.append(hprev)
        hprev = (hprev * chunk_decay[:, z, :, None, None]
                 + chunk_states[:, z].float())
    h_final = hprev
    h_prevs = torch.stack(h_prevs, dim=1)               # (B, nc, H, P, N)

    # Inter-chunk output: C_t . h_prev, decayed from the chunk's start to t.
    decay_from_start = torch.exp(acs)                   # (B, nc, Q, H)
    y_inter = torch.einsum("bzqhn,bzhpn->bzqhp", cc, h_prevs.to(cc.dtype))
    y_inter = y_inter * decay_from_start[..., None].to(x.dtype)

    y = (y_intra + y_inter).reshape(bsz, l, h, p)[:, :l_orig]
    if return_final_state:
        return y, h_final
    return y


def ssd_recurrent_ref(x: Tensor, dt: Tensor, a: Tensor, b_mat: Tensor,
                      c_mat: Tensor, h0: Tensor | None = None):
    """Naive per-token recurrence (the oracle of the tests).  Returns
    (y (B, L, H, P) in x's dtype, final state (B, H, P, N) float32)."""
    bsz, l, h, p = x.shape
    n = b_mat.shape[3]
    rep = h // b_mat.shape[2]
    bh = torch.repeat_interleave(b_mat, rep, dim=2)
    ch = torch.repeat_interleave(c_mat, rep, dim=2)
    hstate = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                          device=x.device) if h0 is None else h0.float())
    ys = []
    for t in range(l):
        dtt = dt[:, t]                                  # (B, H)
        decay = torch.exp(dtt * a[None, :])
        hstate = (hstate * decay[..., None, None]
                  + dtt[..., None, None] * x[:, t, ..., None]
                  * bh[:, t, :, None, :])
        ys.append(torch.einsum("bhn,bhpn->bhp", ch[:, t].to(hstate.dtype),
                               hstate))
    return torch.stack(ys, dim=1).to(x.dtype), hstate


# ---------------------------------------------------------------------------
# Block-level forward (train / prefill) and decode step
# ---------------------------------------------------------------------------

def _split_proj(proj: Tensor, din: int, groups: int, state: int,
                nheads: int):
    """(z, x, B, C, dt) of the input projection."""
    return torch.split(proj, [din, din, groups * state, groups * state,
                              nheads], dim=-1)


def mamba_block(params, x: Tensor, cfg, *, return_state: bool = False):
    """Full-sequence Mamba-2 mixer.  x: (B, L, D) -> (B, L, D).

    With return_state=True also returns the decode state (the conv tail and
    the final SSD carry)."""
    bsz, l, d = x.shape
    din = cfg.ssm_expand * d
    nheads = din // cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state

    proj = x @ params["in_proj"]
    z, xin, b, c, dt_raw = _split_proj(proj, din, g, n, nheads)
    conv_in = torch.cat([xin, b, c], dim=-1)
    conv_out = silu_stepwise(causal_conv(conv_in, params["conv_w"],
                                   params["conv_b"]))
    xin, b, c = torch.split(conv_out, [din, g * n, g * n], dim=-1)

    # F.softplus returns its input above 20 where the reference computes
    # logaddexp(x, 0); the two differ there by less than exp(-20), below
    # float32's resolution at 20.
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    a = -torch.exp(params["a_log"].float())
    xh = xin.reshape(bsz, l, nheads, cfg.ssm_head_dim)
    bm = b.reshape(bsz, l, g, n)
    cm = c.reshape(bsz, l, g, n)
    y, h_final = ssd_chunked(xh, dt, a, bm, cm, chunk=cfg.ssm_chunk,
                             return_final_state=True)
    y = y + xh * params["d_skip"][None, None, :, None]
    y = y.reshape(bsz, l, din)
    y = rms_norm(y * silu_stepwise(z), params["norm_scale"], cfg.norm_eps)
    out = y @ params["out_proj"]
    if return_state:
        width = params["conv_w"].shape[0]
        return out, {"conv": conv_in[:, l - (width - 1):, :], "ssm": h_final}
    return out


def mamba_init_state(params, batch: int, cfg, d_model: int,
                     dtype: torch.dtype):
    """Zero decode state on the params' device: `conv` (B, width - 1,
    conv_dim) in `dtype`, `ssm` (B, H, P, N) in float32."""
    din = cfg.ssm_expand * d_model
    nheads = din // cfg.ssm_head_dim
    conv_dim = din + 2 * cfg.ssm_groups * cfg.ssm_state
    width = params["conv_w"].shape[0]
    dev = params["conv_w"].device
    return {"conv": torch.zeros((batch, width - 1, conv_dim), dtype=dtype,
                                device=dev),
            "ssm": torch.zeros((batch, nheads, cfg.ssm_head_dim,
                                cfg.ssm_state), dtype=torch.float32,
                               device=dev)}


def mamba_decode_step(params, x: Tensor, state: dict, cfg):
    """One-token recurrence.  x: (B, 1, D) -> (y (B, 1, D), new state); the
    state given is not written."""
    bsz, _, d = x.shape
    din = cfg.ssm_expand * d
    nheads = din // cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state

    proj = x[:, 0] @ params["in_proj"]
    z, xin, b, c, dt_raw = _split_proj(proj, din, g, n, nheads)
    conv_in = torch.cat([xin, b, c], dim=-1)            # (B, conv_dim)
    hist = torch.cat([state["conv"], conv_in[:, None, :]], dim=1)
    conv_out = silu_stepwise(conv_step(hist, params["conv_w"],
                                       params["conv_b"]))
    xin, b, c = torch.split(conv_out, [din, g * n, g * n], dim=-1)

    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())   # (B, H)
    a = -torch.exp(params["a_log"].float())
    xh = xin.reshape(bsz, nheads, cfg.ssm_head_dim)
    bm = torch.repeat_interleave(b.reshape(bsz, g, n), nheads // g, dim=1)
    cm = torch.repeat_interleave(c.reshape(bsz, g, n), nheads // g, dim=1)

    decay = torch.exp(dt * a[None, :])                  # (B, H)
    h = (state["ssm"] * decay[..., None, None]
         + dt[..., None, None] * xh[..., None] * bm[:, :, None, :])
    y = torch.einsum("bhn,bhpn->bhp", cm.float(), h).to(x.dtype)
    y = y + xh * params["d_skip"][None, :, None]
    y = y.reshape(bsz, din)
    y = rms_norm(y * silu_stepwise(z), params["norm_scale"], cfg.norm_eps)
    out = (y @ params["out_proj"])[:, None, :]
    return out, {"conv": hist[:, 1:], "ssm": h}
