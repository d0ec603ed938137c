"""xLSTM mLSTM blocks [arXiv:2405.04517], the chunkwise-parallel training
scan (counterpart of `repro/models/xlstm.py`, its train path).

The mLSTM cell keeps a matrix memory C (dh x dh), a normalizer n (dh) and
a log-space stabilizer m per head, with exponential input gates and
sigmoid forget gates:

  m_t = max(log f_t + m_{t-1}, log i_t)
  C_t = e^{log f_t + m_{t-1} - m_t} C_{t-1} + e^{log i_t - m_t} v_t k_t^T
  n_t = (same decays) n_{t-1} + e^{log i_t - m_t} k_t
  h_t = (C_t q_t) / max(|n_t^T q_t|, e^{-m_t})

The chunkwise form evaluates the intra-chunk part as a decay-masked
attention-like product and carries (C, n, m), in float32, across chunks
through a Python loop (the reference's `lax.scan`).  From the scores on
everything is float32; `y` is cast back at the end.  The stabilizer's
maxima are `amax` and `torch.maximum`, which spread the gradient evenly
over ties as the reference's reductions do.  The per-token recurrence
(`mlstm_recurrent_ref`) is the oracle the tests hold the chunked scan to.
The reference's three-operand einsums are two products here, in the order
their contraction paths take; none makes an intermediate larger than its
operands.

The decode state (`mlstm_init_state`: the conv's last width - 1 inputs in
the activation dtype, and (C, n, m) in float32, m from -inf) and
`mlstm_decode_step`, which runs the recurrence on one token.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import (causal_conv, conv_step, init_dense,
                                       rms_norm, silu_stepwise, split_tree)

Tensor = torch.Tensor


def init_mlstm_params(gen: torch.Generator, d_model: int, *, heads: int,
                      pf: float, dtype: torch.dtype, conv_width: int = 4):
    dv = int(pf * d_model)
    tree = {
        "up_proj": init_dense(gen, (d_model, 2 * dv), ("embed", "mlp"),
                              dtype),
        "conv_w": init_dense(gen, (conv_width, dv), ("layers_none", "mlp"),
                             dtype, scale=0.5),
        "conv_b": (torch.zeros((dv,), dtype=dtype), ("mlp",)),
        "wq": init_dense(gen, (dv, dv), ("mlp", "heads"), dtype),
        "wk": init_dense(gen, (dv, dv), ("mlp", "heads"), dtype),
        "wv": init_dense(gen, (dv, dv), ("mlp", "heads"), dtype),
        "w_gates": init_dense(gen, (dv, 2 * heads), ("mlp", "heads"), dtype,
                              scale=0.01),
        "b_gates": (torch.cat([torch.zeros((heads,)),
                               torch.linspace(3.0, 6.0, heads)]).to(dtype),
                    ("heads",)),
        "norm_scale": (torch.ones((dv,), dtype=dtype), ("mlp",)),
        "down_proj": init_dense(gen, (dv, d_model), ("mlp", "embed"), dtype),
    }
    return split_tree(tree)


def _k_scale(dh: int, like: Tensor) -> Tensor:
    """sqrt(dh) as a 0-d tensor in `like`'s dtype and on its device: the
    reference divides k by its weak-typed Python scale, which JAX rounds to
    the activation dtype first (sqrt(512) is 22.625 in bfloat16).  A fill,
    not a copy from the host, so a decode step stays free of syncs."""
    return torch.full((), dh ** 0.5, dtype=like.dtype, device=like.device)


def _qkv_gates(params, x_up: Tensor, heads: int):
    """x_up: (B, L, dv) (post-conv for q / k and the gates, raw for v)."""
    b, l, dv = x_up.shape
    dh = dv // heads
    conv = silu_stepwise(causal_conv(x_up, params["conv_w"],
                                     params["conv_b"]))
    q = (conv @ params["wq"]).reshape(b, l, heads, dh)
    k = (conv @ params["wk"]).reshape(b, l, heads, dh) / _k_scale(dh, x_up)
    v = (x_up @ params["wv"]).reshape(b, l, heads, dh)
    gates = conv @ params["w_gates"] + params["b_gates"]
    logi = gates[..., :heads].float()                          # (B, L, H)
    logf = F.logsigmoid(gates[..., heads:].float())
    return q, k, v, logi, logf


def mlstm_chunked(q: Tensor, k: Tensor, v: Tensor, logi: Tensor,
                  logf: Tensor, *, chunk: int, state=None,
                  return_final_state: bool = False):
    """Chunkwise-parallel stabilized mLSTM.

    q / k / v: (B, L, H, dh); logi / logf: (B, L, H).  state: (C, n, m)
    with C (B, H, dh, dh), n (B, H, dh), m (B, H)."""
    bsz, l, h, dh = q.shape
    chunk = min(chunk, l)
    l_orig = l
    if l % chunk:
        # Pad with no-op steps: f = 1 (logf = 0), i = exp(-1e30) = 0, zero
        # q / k / v.
        pad = chunk - l % chunk
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        logf = F.pad(logf, (0, 0, 0, pad))
        logi = F.pad(logi, (0, 0, 0, pad), value=-1e30)
        l = l + pad
    nc = l // chunk

    qc = q.reshape(bsz, nc, chunk, h, dh)
    kc = k.reshape(bsz, nc, chunk, h, dh)
    vc = v.reshape(bsz, nc, chunk, h, dh)
    lic = logi.reshape(bsz, nc, chunk, h)
    lfc = logf.reshape(bsz, nc, chunk, h)

    fcs = torch.cumsum(lfc, dim=2)                       # inclusive (B,nc,Q,H)
    # intra decay exponent: D[t, s] = fcs[t] - fcs[s] + logi[s], s <= t
    dmat = (fcs[:, :, :, None, :] - fcs[:, :, None, :, :]
            + lic[:, :, None, :, :])                     # (B,nc,Q,S,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))[None, None, :, :, None]
    dmat = torch.where(tri, dmat, -math.inf)
    intra_max = torch.amax(dmat, dim=3)                  # (B,nc,Q,H)

    if state is None:
        c_prev = torch.zeros((bsz, h, dh, dh), dtype=torch.float32,
                             device=q.device)
        n_prev = torch.zeros((bsz, h, dh), dtype=torch.float32,
                             device=q.device)
        m_prev = torch.full((bsz, h), -math.inf, dtype=torch.float32,
                            device=q.device)
    else:
        c_prev, n_prev, m_prev = (s.float() for s in state)

    # --- inter-chunk carry: a loop over the chunks ------------------------
    # end-of-chunk contributions: sum_s exp(fcs[Q-1]-fcs[s]+logi[s]-m_new) kv
    c_prevs, n_prevs, m_prevs = [], [], []
    for z in range(nc):
        c_prevs.append(c_prev)
        n_prevs.append(n_prev)
        m_prevs.append(m_prev)
        kb = kc[:, z].float()                                  # (B, Q, H, dh)
        vb = vc[:, z].float()
        fcs_b = fcs[:, z]                                      # (B, Q, H)
        fend = fcs_b[:, -1, :]                                 # (B, H)
        to_end = fend[:, None, :] - fcs_b + lic[:, z]          # (B, Q, H)
        m_local = torch.amax(to_end, dim=1)                    # (B, H)
        m_new = torch.maximum(fend + m_prev, m_local)
        decay_carry = torch.exp(fend + m_prev - m_new)         # (B, H)
        w = torch.exp(to_end - m_new[:, None, :])              # (B, Q, H)
        kw = kb * w[..., None]
        c_prev = (c_prev * decay_carry[..., None, None]
                  + torch.einsum("bqhv,bqhk->bhvk", vb, kw))
        n_prev = n_prev * decay_carry[..., None] + kw.sum(dim=1)
        m_prev = m_new
    c_prevs = torch.stack(c_prevs, dim=1)                # (B,nc,H,dh,dh)
    n_prevs = torch.stack(n_prevs, dim=1)                # (B,nc,H,dh)
    m_prevs = torch.stack(m_prevs, dim=1)                # (B,nc,H)

    # --- combine intra + inter with a joint stabilizer --------------------
    inter_exp = fcs + m_prevs[:, :, None, :]             # (B,nc,Q,H)
    m_t = torch.maximum(intra_max, inter_exp)            # per-position stab
    m_t = torch.where(torch.isfinite(m_t), m_t, 0.0)

    w_intra = torch.exp(dmat - m_t[:, :, :, None, :])    # (B,nc,Q,S,H)
    w_intra = torch.where(tri, w_intra, 0.0)
    scores = torch.einsum("bzqhd,bzshd->bzqsh", qc.float(), kc.float())
    sw = scores * w_intra
    num_intra = torch.einsum("bzqsh,bzshd->bzqhd", sw, vc.float())
    den_intra = sw.sum(dim=3)

    w_inter = torch.exp(inter_exp - m_t)                 # (B,nc,Q,H)
    qf = qc.float()
    num_inter = torch.einsum("bzqhd,bzhvd->bzqhv", qf, c_prevs)
    num_inter = num_inter * w_inter[..., None]
    den_inter = torch.einsum("bzqhd,bzhd->bzqh", qf, n_prevs) * w_inter

    num = num_intra + num_inter
    den = den_intra + den_inter
    denom = torch.maximum(torch.abs(den), torch.exp(-m_t))
    y = (num / denom[..., None]).reshape(bsz, l, h, dh)[:, :l_orig]
    y = y.to(q.dtype)
    if return_final_state:
        return y, (c_prev, n_prev, m_prev)
    return y


def mlstm_recurrent_ref(q: Tensor, k: Tensor, v: Tensor, logi: Tensor,
                        logf: Tensor, state=None):
    """Per-token recurrence (the oracle of the tests, and the decode step).
    Returns (y in q's dtype, (C, n, m) float32).  v k^T is formed in the
    inputs' dtype and then widened, as the reference forms it."""
    bsz, l, h, dh = q.shape
    if state is None:
        c = torch.zeros((bsz, h, dh, dh), dtype=torch.float32,
                        device=q.device)
        n = torch.zeros((bsz, h, dh), dtype=torch.float32, device=q.device)
        m = torch.full((bsz, h), -math.inf, dtype=torch.float32,
                       device=q.device)
    else:
        c, n, m = state
    ys = []
    for t in range(l):
        qt, kt, vt = q[:, t].float(), k[:, t], v[:, t]
        li, lf = logi[:, t], logf[:, t]
        m_new = torch.maximum(lf + m, li)
        fdec = torch.exp(lf + m - m_new)
        iexp = torch.exp(li - m_new)
        c = c * fdec[..., None, None] + iexp[..., None, None] * (
            vt[..., :, None] * kt[..., None, :]).float()
        n = n * fdec[..., None] + iexp[..., None] * kt.float()
        num = torch.einsum("bhvd,bhd->bhv", c, qt)
        den = torch.einsum("bhd,bhd->bh", n, qt)
        denom = torch.maximum(torch.abs(den), torch.exp(-m_new))
        ys.append(num / denom[..., None])
        m = m_new
    return torch.stack(ys, dim=1).to(q.dtype), (c, n, m)


# ---------------------------------------------------------------------------
# Block-level forward (train / prefill) and decode step
# ---------------------------------------------------------------------------

def mlstm_block(params, x: Tensor, cfg, *, return_state: bool = False):
    """x: (B, L, D) -> (B, L, D).  Optionally returns the decode state."""
    heads = cfg.mlstm_heads or cfg.num_heads
    up = x @ params["up_proj"]
    dv = up.shape[-1] // 2
    u, z = up[..., :dv], up[..., dv:]
    q, k, v, logi, logf = _qkv_gates(params, u, heads)
    y, (c, n, m) = mlstm_chunked(q, k, v, logi, logf,
                                 chunk=cfg.ssm_chunk or 128,
                                 return_final_state=True)
    y = y.reshape(*x.shape[:2], dv)
    y = rms_norm(y, params["norm_scale"], cfg.norm_eps) * silu_stepwise(z)
    out = y @ params["down_proj"]
    if return_state:
        width = params["conv_w"].shape[0]
        return out, {"conv": u[:, x.shape[1] - (width - 1):, :],
                     "c": c, "n": n, "m": m}
    return out


def mlstm_init_state(params, batch: int, cfg, d_model: int,
                     dtype: torch.dtype):
    """Decode state on the params' device: `conv` (B, width - 1, dv) in
    `dtype`; `c` (B, H, dh, dh), `n` (B, H, dh) zero and `m` (B, H) -inf,
    in float32."""
    heads = cfg.mlstm_heads or cfg.num_heads
    dv = int(cfg.mlstm_pf * d_model)
    dh = dv // heads
    width = params["conv_w"].shape[0]
    f32 = dict(dtype=torch.float32, device=params["conv_w"].device)
    return {"conv": torch.zeros((batch, width - 1, dv), dtype=dtype,
                                device=f32["device"]),
            "c": torch.zeros((batch, heads, dh, dh), **f32),
            "n": torch.zeros((batch, heads, dh), **f32),
            "m": torch.full((batch, heads), -math.inf, **f32)}


def mlstm_decode_step(params, x: Tensor, state: dict, cfg):
    """x: (B, 1, D) -> (y (B, 1, D), new state); the state given is not
    written."""
    heads = cfg.mlstm_heads or cfg.num_heads
    b = x.shape[0]
    up = x[:, 0] @ params["up_proj"]
    dv = up.shape[-1] // 2
    u, z = up[..., :dv], up[..., dv:]
    dh = dv // heads

    hist = torch.cat([state["conv"], u[:, None, :]], dim=1)
    conv = silu_stepwise(conv_step(hist, params["conv_w"], params["conv_b"]))
    q = (conv @ params["wq"]).reshape(b, 1, heads, dh)
    k = ((conv @ params["wk"]) / _k_scale(dh, u)).reshape(b, 1, heads, dh)
    v = (u @ params["wv"]).reshape(b, 1, heads, dh)
    gates = conv @ params["w_gates"] + params["b_gates"]
    logi = gates[..., :heads].float()[:, None, :]
    logf = F.logsigmoid(gates[..., heads:].float())[:, None, :]

    y, (c, n, m) = mlstm_recurrent_ref(
        q, k, v, logi, logf, (state["c"], state["n"], state["m"]))
    y = y.reshape(b, dv)
    y = rms_norm(y, params["norm_scale"], cfg.norm_eps) * silu_stepwise(z)
    out = (y @ params["down_proj"])[:, None, :]
    return out, {"conv": hist[:, 1:], "c": c, "n": n, "m": m}
