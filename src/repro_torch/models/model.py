"""Model assembly for the attention stacks: blocks, the layer stack, the LM
head and the loss (counterpart of `repro/models/model.py`, train path).

Params keep the reference's tree: `blocks` holds every layer's leaves
stacked on a leading layer axis (`blocks/attn/wq` is (L, d, H * dh)), beside
`embed`, `final_norm` and, unless `tie_embeddings`, `lm_head`.  The
reference's `lax.scan` over the stacked layers is a Python loop here; a
layer's window (gemma3's 5:1 local:global pattern) is a Python int, so each
layer dispatches statically, as the reference does when unrolled.  `remat`
recomputes each block in the backward through `torch.utils.checkpoint`
(both of the reference's policies give the same values).

A block's attention is GQA (full, banded or chunked) or multi-head latent
attention (MLA: low-rank query and key/value projections, per-head keys
and values materialized on the train path); its feed-forward is a dense
SwiGLU or a top-k routed MoE (`models/moe.py`), whose load-balance loss
`forward` sums over the layers and `lm_loss` weighs by
`router_aux_weight`.

Mamba, mLSTM, shared attention, the frames frontend and the serving paths
(`prefill`, `decode_step`, `init_cache`, MLA's latent decode) are not
ported yet: building or running such a model raises `NotImplementedError`
naming its ROADMAP.md entry.  The configs themselves are all data
(`repro_torch.configs`).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.gp import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (apply_rope, cast_tree, init_dense,
                                       init_embed, init_scale, not_ported,
                                       rms_norm, split_tree,
                                       stack_layer_params, stacked_specs,
                                       tree_map)
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


def check_ported(cfg: ModelConfig) -> None:
    """Raise for any part of `cfg` the port does not build yet: the attention
    stacks (GQA or MLA, dense or MoE feed-forward) are ported."""
    if cfg.frontend == "frames":
        raise not_ported(f"{cfg.name}: the frames frontend", "frames/encoder")
    if cfg.block_pattern == "mamba" or cfg.shared_attn_every > 0:
        raise not_ported(f"{cfg.name}: mamba blocks and shared attention",
                         "mamba and shared attention")
    if cfg.block_pattern == "mlstm":
        raise not_ported(f"{cfg.name}: mLSTM blocks", "mLSTM")


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------

def _init_attn_params(gen: torch.Generator, cfg: ModelConfig):
    d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    dt = cfg.parameter_dtype
    if cfg.attention == "mla":
        qdim = cfg.qk_nope_dim + cfg.qk_rope_dim
        return {
            "wdq": init_dense(gen, (d, cfg.q_lora_rank), ("embed", "mlp"), dt),
            "q_norm": init_scale(cfg.q_lora_rank, dt),
            "wuq": init_dense(gen, (cfg.q_lora_rank, h * qdim),
                              ("mlp", "heads"), dt),
            "wdkv": init_dense(gen, (d, cfg.kv_lora_rank + cfg.qk_rope_dim),
                               ("embed", "mlp"), dt),
            "kv_norm": init_scale(cfg.kv_lora_rank, dt),
            "wuk": init_dense(gen, (cfg.kv_lora_rank, h * cfg.qk_nope_dim),
                              ("mlp", "heads"), dt),
            "wuv": init_dense(gen, (cfg.kv_lora_rank, h * cfg.v_head_dim),
                              ("mlp", "heads"), dt),
            "wo": init_dense(gen, (h * cfg.v_head_dim, d),
                             ("heads", "embed"), dt),
        }
    tree = {
        "wq": init_dense(gen, (d, h * dh), ("embed", "heads"), dt),
        "wk": init_dense(gen, (d, kv * dh), ("embed", "kv_heads"), dt),
        "wv": init_dense(gen, (d, kv * dh), ("embed", "kv_heads"), dt),
        "wo": init_dense(gen, (h * dh, d), ("heads", "embed"), dt),
    }
    if cfg.qk_norm:
        tree["qn"] = init_scale(dh, dt)
        tree["kn"] = init_scale(dh, dt)
    return tree


def _init_mlp_params(gen: torch.Generator, cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.parameter_dtype
    return {
        "wi": init_dense(gen, (d, f), ("embed", "mlp"), dt),
        "wg": init_dense(gen, (d, f), ("embed", "mlp"), dt),
        "wo": init_dense(gen, (f, d), ("mlp", "embed"), dt),
    }


def _init_block_params(gen: torch.Generator, cfg: ModelConfig):
    dt = cfg.parameter_dtype
    params, specs = split_tree({
        "ln1": init_scale(cfg.d_model, dt),
        "attn": _init_attn_params(gen, cfg),
        "ln2": init_scale(cfg.d_model, dt),
    })
    if cfg.is_moe:
        params["moe"], specs["moe"] = moe_mod.init_moe_params(
            gen, cfg.d_model, cfg.d_ff, cfg.num_experts, dt,
            num_experts_padded=cfg.num_experts_padded)
    else:
        params["mlp"], specs["mlp"] = split_tree(_init_mlp_params(gen, cfg))
    return params, specs


def block_kind(cfg: ModelConfig) -> str:
    return {"attn": "attn", "mamba": "mamba", "mlstm": "mlstm"}[
        cfg.block_pattern]


def layer_windows(cfg: ModelConfig) -> list[int]:
    """Per-layer sliding window (0 = full/global attention), as Python ints:
    each layer dispatches statically."""
    if cfg.sliding_window <= 0:
        return [0] * cfg.num_layers
    if cfg.global_every <= 0:
        return [cfg.sliding_window] * cfg.num_layers
    return [0 if (i % cfg.global_every) == (cfg.global_every - 1)
            else cfg.sliding_window for i in range(cfg.num_layers)]


def init_params(cfg: ModelConfig, seed: int | torch.Generator, *,
                device: str | torch.device = "cuda"):
    """Returns (params, logical-axis specs), params on `device`.  The draws
    come from a CPU generator (`seed`, or the generator given), so a seed
    gives the same tree on every device."""
    check_ported(cfg)
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) \
        else torch.Generator().manual_seed(int(seed))
    per_layer = [_init_block_params(gen, cfg) for _ in range(cfg.num_layers)]
    tree = {"blocks": (stack_layer_params([p for p, _ in per_layer]),
                       stacked_specs(per_layer[0][1])),
            "embed": init_embed(gen, cfg.vocab_padded, cfg.d_model,
                                cfg.parameter_dtype),
            "final_norm": init_scale(cfg.d_model, cfg.parameter_dtype)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = init_dense(gen, (cfg.d_model, cfg.vocab_padded),
                                     ("embed", "vocab"), cfg.parameter_dtype)
    params, specs = split_tree(tree)
    return tree_map(lambda x: x.to(dev), params), specs


# ---------------------------------------------------------------------------
# Attention and MLP sublayers
# ---------------------------------------------------------------------------

def _gqa_qkv(p, cfg: ModelConfig, x: Tensor, positions: Tensor):
    b, s, _ = x.shape
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q = (x @ p["wq"]).reshape(b, s, h, dh)
    k = (x @ p["wk"]).reshape(b, s, kv, dh)
    v = (x @ p["wv"]).reshape(b, s, kv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["qn"], cfg.norm_eps)
        k = rms_norm(k, p["kn"], cfg.norm_eps)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_block_forward(p, cfg: ModelConfig, x: Tensor, window: int,
                       positions: Tensor):
    """Full-sequence attention sublayer (GQA or MLA).  `window` is the
    layer's (0: a global layer of a local:global stack).  Returns (out,
    (k, v)), or for MLA (out, (c_kv, k_rope)), the latent pair."""
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.attention == "mla":
        out, latent = _mla_forward(p["attn"], cfg, xn, positions)
        return x + out, latent
    q, k, v = _gqa_qkv(p["attn"], cfg, xn, positions)
    if cfg.sliding_window > 0 and cfg.global_every > 0:
        if window <= 0:
            out = attn_mod.dispatch_attention(q, k, v, causal=cfg.causal)
        elif x.shape[1] <= cfg.sliding_window:
            out = attn_mod.full_attention(q, k, v, causal=cfg.causal,
                                          window=cfg.sliding_window)
        else:
            out = attn_mod.banded_attention(q, k, v,
                                            window=cfg.sliding_window)
    elif cfg.sliding_window > 0:
        out = attn_mod.dispatch_attention(q, k, v, causal=cfg.causal,
                                          window=cfg.sliding_window)
    else:
        out = attn_mod.dispatch_attention(q, k, v, causal=cfg.causal)
    out = out.reshape(*x.shape[:2], cfg.num_heads * cfg.head_dim_)
    return x + out @ p["attn"]["wo"], (k, v)


def _mla_forward(p, cfg: ModelConfig, xn: Tensor, positions: Tensor):
    """MLA train path: per-head keys and values materialized from the
    latent; returns (out, (c_kv, k_rope)), the latent pair a decode cache
    would hold."""
    b, s, _ = xn.shape
    h = cfg.num_heads
    nope, rdim, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    cq = rms_norm(xn @ p["wdq"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["wuq"]).reshape(b, s, h, nope + rdim)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    ckv_full = xn @ p["wdkv"]                              # (b,s,kvr+rdim)
    c_kv = rms_norm(ckv_full[..., :cfg.kv_lora_rank], p["kv_norm"],
                    cfg.norm_eps)
    k_rope = apply_rope(ckv_full[..., cfg.kv_lora_rank:][:, :, None, :],
                        positions, cfg.rope_theta)          # (b,s,1,rdim)
    k_nope = (c_kv @ p["wuk"]).reshape(b, s, h, nope)
    v = (c_kv @ p["wuv"]).reshape(b, s, h, vdim)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, rdim)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    out = attn_mod.dispatch_attention(q_full, k, v, causal=cfg.causal)
    out = out.reshape(b, s, h * vdim) @ p["wo"]
    return out, (c_kv, k_rope[:, :, 0, :])


def mlp_forward(p, cfg: ModelConfig, x: Tensor):
    """Feed-forward sublayer: SwiGLU, or the routed MoE.  Returns (out, aux),
    aux the MoE's load-balance loss (0 when dense)."""
    xn = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.is_moe:
        out, aux = moe_mod.moe_ffn(p["moe"], xn, top_k=cfg.top_k,
                                   capacity_factor=cfg.capacity_factor,
                                   dispatch=cfg.moe_dispatch)
        return x + out, aux
    h = F.silu(xn @ p["mlp"]["wg"]) * (xn @ p["mlp"]["wi"])
    return (x + h @ p["mlp"]["wo"],
            torch.zeros((), dtype=torch.float32, device=x.device))


# ---------------------------------------------------------------------------
# Full-sequence forward (train)
# ---------------------------------------------------------------------------

def _block(cfg: ModelConfig, window: int, positions: Tensor, x: Tensor,
           layer_p):
    layer_p = cast_tree(layer_p, cfg.activation_dtype)
    x, _ = attn_block_forward(layer_p, cfg, x, window, positions)
    return mlp_forward(layer_p, cfg, x)


def forward(params, cfg: ModelConfig, tokens: Tensor,
            collect_cache: bool = False):
    """tokens: (B, S) integer ids.  Returns (hidden (B,S,D), aux_loss, None)."""
    check_ported(cfg)
    if collect_cache:
        raise not_ported("the KV cache of a forward", "prefill/decode")
    act = cfg.activation_dtype
    x = params["embed"].to(act)[tokens.long()]
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    # One unbind per stacked leaf: its backward builds one stack, where an
    # index per layer would add L full-size zero-filled gradients.
    unbound = tree_map(lambda a: a.unbind(0), params["blocks"])
    for i, window in enumerate(layer_windows(cfg)):
        layer_p = tree_map(lambda _, u: u[i], params["blocks"], unbound)
        body = functools.partial(_block, cfg, window, positions)
        if cfg.remat and torch.is_grad_enabled():
            x, aux = checkpoint(body, x, layer_p, use_reentrant=False)
        else:
            x, aux = body(x, layer_p)
        aux_total = aux_total + aux
    x = rms_norm(x, params["final_norm"].to(act), cfg.norm_eps)
    return x, aux_total, None


def logits_from_hidden(params, cfg: ModelConfig, x: Tensor) -> Tensor:
    act = cfg.activation_dtype
    if cfg.tie_embeddings:
        head = params["embed"].to(act).T
    else:
        head = params["lm_head"].to(act)
    return x @ head


def lm_loss(params, cfg: ModelConfig, batch) -> tuple[Tensor, dict]:
    """Next-token cross entropy (+ the weighted MoE aux term, 0 when dense);
    the padded vocabulary rows are masked out at -1e30."""
    targets = batch["targets"].long()
    mask = batch.get("mask")
    x, aux, _ = forward(params, cfg, batch["inputs"])
    logits = logits_from_hidden(params, cfg, x).float()
    if cfg.vocab_padded != cfg.vocab_size:
        pad_mask = torch.arange(cfg.vocab_padded,
                                device=logits.device) < cfg.vocab_size
        logits = torch.where(pad_mask, logits, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        mask = torch.ones_like(nll)
    denom = torch.clamp_min(mask.sum(), 1.0)
    ce = (nll * mask).sum() / denom
    loss = ce + cfg.router_aux_weight * aux
    acc = ((logits.argmax(-1) == targets) * mask).sum() / denom
    return loss, {"ce": ce, "aux": aux, "accuracy": acc}


# ---------------------------------------------------------------------------
# Serving: not ported yet
# ---------------------------------------------------------------------------

def init_cache(params, cfg: ModelConfig, batch: int, max_len: int):
    raise not_ported("the decode cache", "prefill/decode")


def prefill(params, cfg: ModelConfig, tokens: Tensor, max_len: int):
    raise not_ported("prefill", "prefill/decode")


def decode_step(params, cfg: ModelConfig, cache, token: Tensor):
    raise not_ported("decode_step", "prefill/decode")
