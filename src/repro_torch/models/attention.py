"""Attention variants of the GQA and MLA blocks: full, chunked, banded and
decode (counterpart of `repro/models/attention.py`).

Memory regimes (chosen by `dispatch_attention` from the sequence length):
  * full     — one masked einsum; scores materialize.
  * chunked  — flash-style online softmax over Q blocks and KV blocks,
               O(S * block) live memory both ways: a `torch.autograd.Function`
               whose backward recomputes each block's probabilities from the
               saved log-sum-exp, as the reference's custom VJP does.
  * banded   — sliding-window attention through explicit KV window slices;
               exact and O(S * (window + chunk)) compute (gemma3 local layers).
  * decode   — one-token query against a KV cache (`decode_step`).

GQA never materializes repeated KV heads: Q is reshaped to
(batch, seq, kv_heads, q_per_kv, ...) and contracted group-wise.  Scores
and the flash accumulators are float32 whatever the activation dtype (the
reference's `preferred_element_type=jnp.float32`).  The value width may
differ from the query/key width (MLA: 96 and 64).  Everything here is plain
tensor ops.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

NEG_INF = -1e30


def _group(q: Tensor, kv_heads: int) -> Tensor:
    """(B, S, H, d) -> (B, S, kv, g, d)."""
    b, s, h, d = q.shape
    return q.reshape(b, s, kv_heads, h // kv_heads, d)


def _scale(dh: int) -> float:
    return 1.0 / (dh ** 0.5)


def _scores(q: Tensor, k: Tensor) -> Tensor:
    """(B, Q, kv, g, d) x (B, S, kv, d) -> (B, kv, g, Q, S) in float32."""
    return torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float())


# ---------------------------------------------------------------------------
# Full (masked-einsum) attention
# ---------------------------------------------------------------------------

def full_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                   window: int = 0) -> Tensor:
    """q: (B,S,H,dh); k/v: (B,S,KV,dh).  Returns (B,S,H,dh)."""
    b, s, h, dh = q.shape
    kv = k.shape[2]
    qg = _group(q, kv) * _scale(dh)
    scores = _scores(qg, k)                                 # (B, kv, g, Sq, Sk)
    qi = torch.arange(s, device=q.device)[:, None]
    kj = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window > 0:
        mask &= kj > qi - window
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, s, h, v.shape[-1])


# ---------------------------------------------------------------------------
# Chunked flash-style attention (online softmax) with a flash BACKWARD: the
# forward saves only (q, k, v, out, lse); the backward recomputes each
# block's probabilities from lse.
# ---------------------------------------------------------------------------

def _block_mask(qi: int, ki: int, q_chunk: int, kv_chunk: int, causal: bool,
                window: int, device) -> Tensor:
    qpos = qi * q_chunk + torch.arange(q_chunk, device=device)[:, None]
    kpos = ki * kv_chunk + torch.arange(kv_chunk, device=device)[None, :]
    mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def _flash_fwd_impl(q, k, v, causal, window, q_chunk, kv_chunk):
    b, s, h, dh = q.shape
    kv_heads = k.shape[2]
    g = h // kv_heads
    dv = v.shape[-1]
    nq, nk = s // q_chunk, s // kv_chunk
    qg = (_group(q, kv_heads) * _scale(dh)).to(q.dtype)
    qg = qg.reshape(b, nq, q_chunk, kv_heads, g, dh)
    kc = k.reshape(b, nk, kv_chunk, kv_heads, dh)
    vc = v.reshape(b, nk, kv_chunk, kv_heads, dv)
    f32 = dict(dtype=torch.float32, device=q.device)

    outs, lses = [], []
    for qi in range(nq):
        q_blk = qg[:, qi]
        m = torch.full((b, kv_heads, g, q_chunk), NEG_INF, **f32)
        l = torch.zeros((b, kv_heads, g, q_chunk), **f32)
        acc = torch.zeros((b, q_chunk, kv_heads, g, dv), **f32)
        for ki in range(nk):
            kb, vb = kc[:, ki], vc[:, ki]
            scores = _scores(q_blk, kb)
            mask = _block_mask(qi, ki, q_chunk, kv_chunk, causal, window,
                               q.device)
            scores = torch.where(mask, scores, NEG_INF)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            p = torch.exp(scores - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + torch.einsum(
                "bkgqs,bskd->bqkgd", p.to(q.dtype).float(), vb.float())
            m = m_new
        l = torch.clamp_min(l, 1e-30)
        outs.append((acc / l.permute(0, 3, 1, 2)[..., None]).to(q.dtype))
        lses.append(m + torch.log(l))                     # (b, kv, g, q_chunk)

    out = torch.stack(outs, dim=1).reshape(b, s, h, dv)
    lse = torch.stack(lses, dim=3).reshape(b, kv_heads, g, s)
    return out, lse


def _flash_bwd_impl(q, k, v, out, lse, dout, causal, window, q_chunk,
                    kv_chunk):
    b, s, h, dh = q.shape
    kv_heads = k.shape[2]
    g = h // kv_heads
    dv = v.shape[-1]
    nq, nk = s // q_chunk, s // kv_chunk
    scale = _scale(dh)
    qg = _group(q, kv_heads).reshape(b, nq, q_chunk, kv_heads, g, dh)
    kc = k.reshape(b, nk, kv_chunk, kv_heads, dh)
    vc = v.reshape(b, nk, kv_chunk, kv_heads, dv)
    dog = _group(dout, kv_heads).reshape(b, nq, q_chunk, kv_heads, g, dv)
    lseg = lse.reshape(b, kv_heads, g, nq, q_chunk)
    # delta_i = rowsum(dout * out), (b, nq, q_chunk, kv, g)
    delta = torch.sum(dout.float() * out.float(), dim=-1)
    delta = delta.reshape(b, nq, q_chunk, kv_heads, g)
    f32 = dict(dtype=torch.float32, device=q.device)

    dqs = []
    dk = torch.zeros((b, nk, kv_chunk, kv_heads, dh), **f32)
    dvv = torch.zeros((b, nk, kv_chunk, kv_heads, dv), **f32)
    for qi in range(nq):
        q_blk = qg[:, qi]                                   # (b,Q,kv,g,dh)
        do_blk = dog[:, qi]
        lse_blk = lseg[:, :, :, qi]                         # (b,kv,g,Q)
        dlt_blk = delta[:, qi].permute(0, 2, 3, 1)[..., None]   # (b,kv,g,Q,1)
        dq_acc = torch.zeros((b, q_chunk, kv_heads, g, dh), **f32)
        for ki in range(nk):
            kb, vb = kc[:, ki], vc[:, ki]
            scores = _scores(q_blk, kb) * scale
            mask = _block_mask(qi, ki, q_chunk, kv_chunk, causal, window,
                               q.device)
            p = torch.where(mask, torch.exp(scores - lse_blk[..., None]), 0.0)
            # dv_j += p^T do
            dvv[:, ki] += torch.einsum("bkgqs,bqkgd->bskd",
                                       p.to(dout.dtype).float(),
                                       do_blk.float())
            # dp = do v^T ; ds = p * (dp - delta) * scale
            dp = _scores(do_blk, vb)
            dsq = (p * (dp - dlt_blk) * scale).to(q.dtype).float()
            dq_acc += torch.einsum("bkgqs,bskd->bqkgd", dsq, kb.float())
            dk[:, ki] += torch.einsum("bkgqs,bqkgd->bskd", dsq,
                                      q_blk.float())
        dqs.append(dq_acc)
    # ds already carries the scale factor; dq = ds @ k needs no extra scale.
    dq = torch.stack(dqs, dim=1).reshape(b, s, h, dh)
    return (dq.to(q.dtype), dk.reshape(b, s, kv_heads, dh).to(k.dtype),
            dvv.reshape(b, s, kv_heads, dv).to(v.dtype))


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_chunk, kv_chunk):
        out, lse = _flash_fwd_impl(q, k, v, causal, window, q_chunk, kv_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.static = (causal, window, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(q, k, v, out, lse, dout, *ctx.static)
        return dq, dk, dv, None, None, None, None


def chunked_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                      window: int = 0, q_chunk: int = 1024,
                      kv_chunk: int = 1024) -> Tensor:
    """Flash attention in plain tensor ops: O(S * block) live memory forward
    AND backward (probabilities recomputed from the saved lse).  Masked
    blocks are still computed, as in the reference."""
    s = q.shape[1]
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, s)
    if s % q_chunk or s % kv_chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunks "
                         f"({q_chunk}, {kv_chunk})")
    return _Flash.apply(q, k, v, causal, window, q_chunk, kv_chunk)


# ---------------------------------------------------------------------------
# Banded (sliding-window) attention via window slices — exact, no waste.
# ---------------------------------------------------------------------------

def banded_attention(q: Tensor, k: Tensor, v: Tensor, *, window: int,
                     q_chunk: int = 1024) -> Tensor:
    """Causal sliding-window attention, O(S * (window + chunk)) compute.

    For each Q chunk, slice the KV band [start - window, start + chunk) once
    (padding the front), so no block beyond the band edges is computed.
    """
    b, s, h, dh = q.shape
    kv_heads = k.shape[2]
    dv = v.shape[-1]
    q_chunk = min(q_chunk, s)
    if s % q_chunk:
        raise ValueError(f"sequence {s} is not a multiple of {q_chunk}")
    nq = s // q_chunk
    band = window + q_chunk

    kp = F.pad(k, (0, 0, 0, 0, window, 0))
    vp = F.pad(v, (0, 0, 0, 0, window, 0))
    qg = _group(q, kv_heads) * _scale(dh)
    qg = qg.reshape(b, nq, q_chunk, kv_heads, h // kv_heads, dh)

    outs = []
    for qi in range(nq):
        start = qi * q_chunk            # position in padded coords
        kb = kp[:, start:start + band]
        vb = vp[:, start:start + band]
        scores = _scores(qg[:, qi], kb)
        qpos = start + torch.arange(q_chunk, device=q.device)[:, None]
        kpos = (start + torch.arange(band, device=q.device)[None, :]
                - window)                                   # global k idx
        mask = (kpos <= qpos) & (kpos > qpos - window) & (kpos >= 0)
        scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bkgqs,bskd->bqkgd", probs, vb)
        outs.append(out.reshape(b, q_chunk, h, dv))
    return torch.stack(outs, dim=1).reshape(b, s, h, dv)


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor, pos: int,
                     window: int = 0) -> Tensor:
    """q: (B,1,H,dh); caches: (B,S,KV,dh) (the value width may differ);
    pos: the current write index, a Python int.  Returns (B,1,H,dv).

    Attends to cache positions [0, pos], or with `window` > 0 to the
    trailing `window` of them, as the reference's mask `kj <= pos` and
    `kj > pos - window` does.  Only those positions are read: the masked
    rest would add exact zeros to the softmax.
    """
    b, _, h, dh = q.shape
    if not 0 <= pos < k_cache.shape[1]:
        raise ValueError(f"decode position {pos} outside the cache's "
                         f"{k_cache.shape[1]}")
    lo = max(0, pos - window + 1) if window > 0 else 0
    k, v = k_cache[:, lo:pos + 1], v_cache[:, lo:pos + 1]
    qg = _group(q, k.shape[2]) * _scale(dh)
    probs = torch.softmax(_scores(qg, k), dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, 1, h, v.shape[-1])


def dispatch_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                       window: int = 0, full_threshold: int = 1024) -> Tensor:
    """Pick the cheapest exact implementation for the sequence length:
    banded past the window, full up to `full_threshold`, chunked above."""
    s = q.shape[1]
    if window > 0 and s > window:
        return banded_attention(q, k, v, window=window,
                                q_chunk=min(1024, s))
    if s <= full_threshold:
        return full_attention(q, k, v, causal=causal, window=window)
    return chunked_attention(q, k, v, causal=causal, window=window)
