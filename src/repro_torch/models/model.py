"""Model assembly: blocks, the layer stack, the LM head, the loss and the
serving paths (counterpart of `repro/models/model.py`).

Params keep the reference's tree: `blocks` holds every layer's leaves
stacked on a leading layer axis (`blocks/attn/wq` is (L, d, H * dh)), beside
`embed` (or `frame_proj` for a frames frontend), `final_norm`, unless
`tie_embeddings` `lm_head`, and zamba2's `shared_attn`.  The reference's
`lax.scan` over the stacked layers is a Python loop here; a layer's window
(gemma3's 5:1 local:global pattern) and whether the shared block fires
after it are Python ints, so each layer dispatches statically, as the
reference does when unrolled.  `remat` recomputes each layer's body (the
shared block's application after it included) in the backward through
`torch.utils.checkpoint` (both of the reference's policies give the same
values).

Block kinds:
  * "attn": GQA (full, banded or chunked) or multi-head latent attention
    (MLA: low-rank query and key/value projections, per-head keys and
    values materialized on the train path), then a dense SwiGLU or a top-k
    routed MoE (`models/moe.py`), whose load-balance loss `forward` sums
    over the layers and `lm_loss` weighs by `router_aux_weight`;
  * "mamba": a Mamba-2 mixer (`models/ssm.py`) behind a norm;
  * "mlstm": an mLSTM block (`models/xlstm.py`) behind a norm.
zamba2's shared attention block is ONE parameter set (an attention block
with a dense MLP) applied after every `shared_attn_every`-th layer; the
gradients of its applications add up in its one leaf.  A frames frontend
(hubert) projects the input frames with `frame_proj` and adds sinusoidal
positions; its attention is bidirectional.

Serving: `forward(..., collect_cache=True)` also returns each layer's
cache part (K/V, MLA's latent pair, a recurrent block's decode state,
the shared block's K/V), stacked on a leading layer axis; `prefill` lays
them into a preallocated cache (`init_cache`, the reference's keys,
shapes and dtypes) and `decode_step` runs one token through every layer,
writing the new position's K/V (or latents) and the recurrent states
into that cache in place.  The cache's `pos` is a Python int, so a step
reads no device value back: the windows and zamba2's shared slots are
Python ints too.  MLA decodes in the latent space with W_uk folded into
the query (`_mla_decode`).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.gp import resolve_device
from repro_torch.launch.sharding import (bound, constrain, gather_local,
                                         heads_local, replicate_except)
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import (apply_rope, cast_tree, init_dense,
                                       init_embed, init_scale, rms_norm,
                                       sinusoidal_positions, split_tree,
                                       stack_layer_params, stacked_specs,
                                       tree_map)
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


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


def _init_block_params(gen: torch.Generator, cfg: ModelConfig, kind: str):
    dt = cfg.parameter_dtype
    if kind == "mamba":
        params, specs = split_tree({"ln": init_scale(cfg.d_model, dt)})
        params["mixer"], specs["mixer"] = ssm_mod.init_mamba_params(
            gen, cfg.d_model, expand=cfg.ssm_expand, state=cfg.ssm_state,
            head_dim=cfg.ssm_head_dim, groups=cfg.ssm_groups, dtype=dt)
        return params, specs
    if kind == "mlstm":
        params, specs = split_tree({"ln": init_scale(cfg.d_model, dt)})
        params["mixer"], specs["mixer"] = xlstm_mod.init_mlstm_params(
            gen, cfg.d_model, heads=cfg.mlstm_heads or cfg.num_heads,
            pf=cfg.mlstm_pf, dtype=dt)
        return params, specs
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


def shared_slots(cfg: ModelConfig) -> list[int]:
    """zamba2: per layer, 0, or k > 0 when the shared attention block fires
    after the layer for the k-th time (every `shared_attn_every`-th
    layer), as Python ints."""
    if cfg.shared_attn_every <= 0:
        return [0] * cfg.num_layers
    out, count = [], 0
    for i in range(cfg.num_layers):
        fire = (i % cfg.shared_attn_every) == (cfg.shared_attn_every - 1)
        count += int(fire)
        out.append(count if fire else 0)
    return out


def num_shared_apps(cfg: ModelConfig) -> int:
    if cfg.shared_attn_every <= 0:
        return 0
    return cfg.num_layers // cfg.shared_attn_every


def init_params(cfg: ModelConfig, seed: int | torch.Generator, *,
                device: str | torch.device = "cuda"):
    """Returns (params, logical-axis specs), params on `device`.  The draws
    come from a CPU generator (`seed`, or the generator given), so a seed
    gives the same tree on every device."""
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) \
        else torch.Generator().manual_seed(int(seed))
    dt = cfg.parameter_dtype
    kind = block_kind(cfg)
    per_layer = [_init_block_params(gen, cfg, kind)
                 for _ in range(cfg.num_layers)]
    tree = {"blocks": (stack_layer_params([p for p, _ in per_layer]),
                       stacked_specs(per_layer[0][1]))}
    if cfg.frontend == "frames":
        tree["frame_proj"] = init_dense(gen, (cfg.d_model, cfg.d_model),
                                        ("embed", "mlp"), dt)
    else:
        tree["embed"] = init_embed(gen, cfg.vocab_padded, cfg.d_model, dt)
    tree["final_norm"] = init_scale(cfg.d_model, dt)
    if not cfg.tie_embeddings:
        tree["lm_head"] = init_dense(gen, (cfg.d_model, cfg.vocab_padded),
                                     ("embed", "vocab"), dt)
    if num_shared_apps(cfg) > 0:
        shared_cfg = dataclasses.replace(cfg, block_pattern="attn",
                                         num_experts=0)
        tree["shared_attn"] = _init_block_params(gen, shared_cfg, "attn")
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
    q = constrain(q, ("batch", "seq", "heads", None))
    k = constrain(k, ("batch", "seq", "kv_heads", None))
    v = constrain(v, ("batch", "seq", "kv_heads", None))
    out = heads_local(functools.partial(_gqa_attention, cfg, window), q, k, v)
    out = out.reshape(*x.shape[:2], cfg.num_heads * cfg.head_dim_)
    return x + out @ p["attn"]["wo"], (k, v)


def _gqa_attention(cfg: ModelConfig, window: int, q: Tensor, k: Tensor,
                   v: Tensor) -> Tensor:
    """The GQA attention core of a layer with window `window`."""
    if cfg.sliding_window > 0 and cfg.global_every > 0:
        if window <= 0:
            return attn_mod.dispatch_attention(q, k, v, causal=cfg.causal)
        if q.shape[1] <= cfg.sliding_window:
            return attn_mod.full_attention(q, k, v, causal=cfg.causal,
                                           window=cfg.sliding_window)
        return attn_mod.banded_attention(q, k, v, window=cfg.sliding_window)
    if cfg.sliding_window > 0:
        return attn_mod.dispatch_attention(q, k, v, causal=cfg.causal,
                                           window=cfg.sliding_window)
    return attn_mod.dispatch_attention(q, k, v, causal=cfg.causal)


def _mla_forward(p, cfg: ModelConfig, xn: Tensor, positions: Tensor):
    """MLA train / prefill path: per-head keys and values materialized
    from the latent; returns (out, (c_kv, k_rope)), the latent pair the
    decode cache holds."""
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
    out = heads_local(functools.partial(attn_mod.dispatch_attention,
                                        causal=cfg.causal),
                      q_full, k, v, kv_axis="heads")
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
    h = constrain(h, ("batch", "seq", "mlp"))
    return (x + h @ p["mlp"]["wo"],
            torch.zeros((), dtype=torch.float32, device=x.device))


# ---------------------------------------------------------------------------
# Full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------

def _shared_block(cfg: ModelConfig, positions: Tensor, x: Tensor, shared_p):
    """zamba2's shared attention block: attention then the dense MLP, with
    the one parameter set every application uses.  Returns (x, (k, v))."""
    sp = cast_tree(shared_p, cfg.activation_dtype)
    x, kv = attn_block_forward(sp, cfg, x, 0, positions)
    x, _ = mlp_forward(sp, cfg, x)
    return x, kv


def _block(cfg: ModelConfig, kind: str, window: int, shared_slot: int,
           collect: bool, positions: Tensor, x: Tensor, layer_p, shared_p):
    """One layer's body: its block, then the shared block where it fires.
    Returns (x, aux, part): with `collect` the layer's cache part (its
    block's state, the shared block's (k, v) or None), else None."""
    layer_p = cast_tree(layer_p, cfg.activation_dtype)
    if kind == "attn":
        x, state = attn_block_forward(layer_p, cfg, x, window, positions)
        x, aux = mlp_forward(layer_p, cfg, x)
    else:
        mixer = ssm_mod.mamba_block if kind == "mamba" \
            else xlstm_mod.mlstm_block
        xn = rms_norm(x, layer_p["ln"], cfg.norm_eps)
        if collect:
            y, state = mixer(layer_p["mixer"], xn, cfg, return_state=True)
        else:
            y, state = mixer(layer_p["mixer"], xn, cfg), None
        x = x + y
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    skv = None
    if shared_slot > 0:
        x, skv = _shared_block(cfg, positions, x, shared_p)
    x = constrain(x, ("batch", "seq", "embed"))
    return x, aux, ((state, skv) if collect else None)


def forward(params, cfg: ModelConfig, tokens: Tensor,
            collect_cache: bool = False):
    """tokens: (B, S) integer ids, or (B, S, D) frames for
    `frontend="frames"`.  Returns (hidden (B,S,D), aux_loss, cache parts
    or None).

    With `collect_cache` the cache parts are (states, shared_kv), each
    stacked on a leading layer axis: states are (k, v) for GQA, (c_kv,
    k_rope) for MLA, or a recurrent block's decode-state dict; shared_kv
    is zamba2's shared block's (k, v) where it fires and zeros elsewhere,
    or None without a shared block."""
    act = cfg.activation_dtype
    if cfg.frontend == "frames":
        x = tokens.to(act) @ params["frame_proj"].to(act)
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                     x.device).to(act)
    else:
        x = gather_local(params["embed"].to(act), tokens.long())
    b, s = x.shape[:2]
    x = constrain(x, ("batch", "seq", "embed"))
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    kind = block_kind(cfg)
    shared_p = params.get("shared_attn")
    # One unbind per stacked leaf: its backward builds one stack, where an
    # index per layer would add L full-size zero-filled gradients.
    unbound = tree_map(lambda a: a.unbind(0), params["blocks"])
    parts = []
    for i, (window, slot) in enumerate(zip(layer_windows(cfg),
                                           shared_slots(cfg))):
        layer_p = tree_map(lambda _, u: u[i], params["blocks"], unbound)
        body = bound(functools.partial(_block, cfg, kind, window, slot,
                                       collect_cache, positions))
        if cfg.remat and torch.is_grad_enabled():
            x, aux, part = checkpoint(body, x, layer_p, shared_p,
                                      use_reentrant=False)
        else:
            x, aux, part = body(x, layer_p, shared_p)
        aux_total = aux_total + aux
        parts.append(part)
    x = rms_norm(x, params["final_norm"].to(act), cfg.norm_eps)
    if not collect_cache:
        return x, aux_total, None
    states = tree_map(lambda *xs: torch.stack(xs, dim=0),
                      *(state for state, _ in parts))
    shared_kv = None
    if shared_p is not None:
        zero = torch.zeros((b, s, cfg.num_kv_heads, cfg.head_dim_),
                           dtype=act, device=x.device)
        shared_kv = tuple(torch.stack([zero if skv is None else skv[j]
                                       for _, skv in parts], dim=0)
                          for j in range(2))
    return x, aux_total, (states, shared_kv)


def logits_from_hidden(params, cfg: ModelConfig, x: Tensor) -> Tensor:
    act = cfg.activation_dtype
    if cfg.tie_embeddings:
        head = params["embed"].to(act).T
    else:
        head = params["lm_head"].to(act)
    return constrain(x @ head, ("batch", "seq", "vocab"))


def lm_loss(params, cfg: ModelConfig, batch) -> tuple[Tensor, dict]:
    """Next-token (or frame-label) cross entropy (+ the weighted MoE aux
    term, 0 when dense); the padded vocabulary rows are masked out at
    -1e30."""
    targets = batch["targets"].long()
    mask = batch.get("mask")
    x, aux, _ = forward(params, cfg, batch["inputs"])
    logits = logits_from_hidden(params, cfg, x).float()
    if cfg.vocab_padded != cfg.vocab_size:
        pad_mask = torch.arange(cfg.vocab_padded,
                                device=logits.device) < cfg.vocab_size
        logits = torch.where(pad_mask, logits, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    # DTensor's gather from a vocab-sharded dim fails in its masked
    # partial reduce: the gold logits are read from the rows replicated
    # over vocab (sharding.py lists the site).
    gold = torch.gather(replicate_except(logits, ("batch", "seq")), -1,
                        targets[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        mask = torch.ones_like(nll)
    denom = torch.clamp_min(mask.sum(), 1.0)
    ce = (nll * mask).sum() / denom
    loss = ce + cfg.router_aux_weight * aux
    acc = ((logits.argmax(-1) == targets) * mask).sum() / denom
    return loss, {"ce": ce, "aux": aux, "accuracy": acc}


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(params, cfg: ModelConfig, batch: int, max_len: int):
    """The decode cache, zero, on the params' device: `pos` (a Python int,
    0), then by block kind `k` / `v` (L, B, max_len, KV, dh), MLA's `c_kv`
    (L, B, max_len, kv_lora_rank) and `k_rope` (L, B, max_len, rope dim),
    or the `mamba` / `mlstm` decode state stacked on L (every leaf zero,
    the mLSTM's m too, as the reference stacks it); zamba2's `shared_k` /
    `shared_v` (applications, B, max_len, KV, dh).  Activations in the
    config's dtype, the recurrent carries in float32."""
    act = cfg.activation_dtype
    kind = block_kind(cfg)
    nl = cfg.num_layers
    # Allocated like a parameter leaf: on its device, and as its kind of
    # tensor (a DTensor under a mesh, a fake tensor in the dry run).
    like = params["final_norm"]
    zeros = functools.partial(like.new_zeros, dtype=act)
    kv, dh = cfg.num_kv_heads, cfg.head_dim_
    cache: dict = {"pos": 0}
    if kind == "attn":
        if cfg.attention == "mla":
            cache["c_kv"] = zeros((nl, batch, max_len, cfg.kv_lora_rank))
            cache["k_rope"] = zeros((nl, batch, max_len, cfg.qk_rope_dim))
        else:
            cache["k"] = zeros((nl, batch, max_len, kv, dh))
            cache["v"] = zeros((nl, batch, max_len, kv, dh))
    else:
        init = ssm_mod.mamba_init_state if kind == "mamba" \
            else xlstm_mod.mlstm_init_state
        mixer0 = tree_map(lambda a: a[0], params["blocks"]["mixer"])
        one = init(mixer0, batch, cfg, cfg.d_model, act)
        cache[kind] = tree_map(
            lambda z: like.new_zeros((nl,) + tuple(z.shape), dtype=z.dtype),
            one)
    napps = num_shared_apps(cfg)
    if napps > 0:
        cache["shared_k"] = zeros((napps, batch, max_len, kv, dh))
        cache["shared_v"] = zeros((napps, batch, max_len, kv, dh))
    return cache


def prefill(params, cfg: ModelConfig, tokens: Tensor, max_len: int):
    """Process the prompt; returns (last-position logits (B, 1, V), cache).

    The cache's parts fall out of the forward (`collect_cache`): K/V or
    MLA's latents at positions [0, S), the recurrent stacks' final
    states, and zamba2's shared K/V in slots 0..apps-1, in the order of
    the layers where the block fires."""
    b, s = tokens.shape[:2]
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens past max_len {max_len}")
    x, _, (states, shared_kv) = forward(params, cfg, tokens,
                                        collect_cache=True)
    logits = logits_from_hidden(params, cfg, x[:, -1:, :])
    cache = init_cache(params, cfg, b, max_len)
    cache["pos"] = s
    kind = block_kind(cfg)
    if kind == "attn":
        names = ("c_kv", "k_rope") if cfg.attention == "mla" else ("k", "v")
        for name, part in zip(names, states):
            cache[name][:, :, :s] = part
    else:
        cache[kind] = states
    if shared_kv is not None:
        fired = [i for i, slot in enumerate(shared_slots(cfg)) if slot > 0]
        for name, part in zip(("shared_k", "shared_v"), shared_kv):
            cache[name][:, :, :s] = part[fired]
    return logits, cache


def _gqa_decode(p, cfg: ModelConfig, x: Tensor, k_c: Tensor, v_c: Tensor,
                pos: int, positions: Tensor, window: int) -> Tensor:
    """A GQA attention sublayer at one token: the new K/V written into the
    layer's cache (B, max_len, KV, dh) at `pos`, in place."""
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k1, v1 = _gqa_qkv(p["attn"], cfg, xn, positions)
    k_c[:, pos] = k1[:, 0]
    v_c[:, pos] = v1[:, 0]
    out = attn_mod.decode_attention(q, k_c, v_c, pos, window=window)
    out = out.reshape(x.shape[0], 1, cfg.num_heads * cfg.head_dim_)
    return x + out @ p["attn"]["wo"]


def _mla_decode(p, cfg: ModelConfig, x: Tensor, ckv_c: Tensor,
                krope_c: Tensor, pos: int, positions: Tensor) -> Tensor:
    """Absorbed-projection MLA decode: attention in the latent space.  The
    new latents are written into the layer's cache, (B, max_len, r) and
    (B, max_len, rope dim), at `pos`, in place; W_uk is folded into the
    query, the float32 scores divided by sqrt(nope + rope), the latent
    output taken through W_uv, then wo."""
    b = x.shape[0]
    h = cfg.num_heads
    nope, rdim = cfg.qk_nope_dim, cfg.qk_rope_dim
    r = cfg.kv_lora_rank
    ap = p["attn"]
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)

    cq = rms_norm(xn @ ap["wdq"], ap["q_norm"], cfg.norm_eps)
    q = (cq @ ap["wuq"]).reshape(b, 1, h, nope + rdim)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    ckv_full = xn @ ap["wdkv"]
    ckv_c[:, pos] = rms_norm(ckv_full[:, 0, :r], ap["kv_norm"], cfg.norm_eps)
    krope_c[:, pos] = apply_rope(ckv_full[..., r:][:, :, None, :], positions,
                                 cfg.rope_theta)[:, 0, 0, :]
    # Positions past `pos` would enter the softmax at exactly zero.
    ckv, krope = ckv_c[:, :pos + 1], krope_c[:, :pos + 1]

    wuk = ap["wuk"].reshape(r, h, nope)
    q_abs = torch.einsum("bqhn,rhn->bqhr", q_nope, wuk)
    scores = (torch.einsum("bqhr,bsr->bhqs", q_abs.float(), ckv.float())
              + torch.einsum("bqhd,bsd->bhqs", q_rope.float(),
                             krope.float()))
    scores = scores / ((nope + rdim) ** 0.5)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    o_latent = torch.einsum("bhqs,bsr->bqhr", probs, ckv)
    wuv = ap["wuv"].reshape(r, h, cfg.v_head_dim)
    o = torch.einsum("bqhr,rhv->bqhv", o_latent, wuv)
    return x + o.reshape(b, 1, h * cfg.v_head_dim) @ ap["wo"]


def decode_step(params, cfg: ModelConfig, cache, token: Tensor):
    """One decode step.  token: (B, 1) ids (or (B, 1, D) frames).

    Returns (logits (B, 1, V), cache).  The cache's tensors are updated in
    place (the new position's K/V or latents at `pos`, the recurrent
    states, zamba2's shared K/V) and its `pos` advanced: the cache
    returned is the one given.  The token is embedded by gathering its
    rows and then casting them, which gives the bits of casting the table
    first."""
    act = cfg.activation_dtype
    if cfg.frontend == "frames":
        x = token.to(act) @ params["frame_proj"].to(act)
    else:
        x = params["embed"][token.long()].to(act)
    b = x.shape[0]
    pos = cache["pos"]
    for name in ("k", "c_kv", "shared_k"):
        if name in cache and pos >= cache[name].shape[2]:
            raise ValueError(f"decode position {pos} outside the cache's "
                             f"{cache[name].shape[2]}")
    positions = torch.full((b, 1), pos, device=x.device)
    kind = block_kind(cfg)
    shared_p = params.get("shared_attn")
    if shared_p is not None:
        shared_p = cast_tree(shared_p, act)
    for i, (window, slot) in enumerate(zip(layer_windows(cfg),
                                           shared_slots(cfg))):
        layer_p = cast_tree(tree_map(lambda a: a[i], params["blocks"]), act)
        if kind == "attn":
            if cfg.attention == "mla":
                x = _mla_decode(layer_p, cfg, x, cache["c_kv"][i],
                                cache["k_rope"][i], pos, positions)
            else:
                x = _gqa_decode(layer_p, cfg, x, cache["k"][i],
                                cache["v"][i], pos, positions, window)
            x, _ = mlp_forward(layer_p, cfg, x)
        else:
            step = ssm_mod.mamba_decode_step if kind == "mamba" \
                else xlstm_mod.mlstm_decode_step
            state = tree_map(lambda a: a[i], cache[kind])
            xn = rms_norm(x, layer_p["ln"], cfg.norm_eps)
            y, new = step(layer_p["mixer"], xn, state, cfg)
            tree_map(lambda dst, src: dst.copy_(src), state, new)
            x = x + y
        if slot > 0:
            x = _gqa_decode(shared_p, cfg, x, cache["shared_k"][slot - 1],
                            cache["shared_v"][slot - 1], pos, positions, 0)
            x, _ = mlp_forward(shared_p, cfg, x)
    x = rms_norm(x, params["final_norm"].to(act), cfg.norm_eps)
    cache["pos"] = pos + 1
    return logits_from_hidden(params, cfg, x), cache
