"""Shared building blocks: norms, RoPE, initializers, parameter trees
(counterpart of `repro/models/common.py`).

Params are nested dicts of tensors with the reference's keys, so a tree
crosses between the packages (and through a checkpoint) by tree path.
Every initializer returns a (tensor, logical axes) pair, the axes the
reference's sharding rules read; `split_tree` separates the two.  Random
initializers draw from an explicit CPU `torch.Generator`, so one seed gives
the same tree on every device.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Sequence

import torch

Tensor = torch.Tensor
Params = Any
Specs = Any


def tree_map(fn: Callable, tree, *rest):
    """`fn` over the leaves of `tree` (and the matching leaves of `rest`):
    dicts, lists and tuples are nodes, None is an empty subtree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in the reference's order: dict keys sorted, sequences by
    index, None skipped."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [] if tree is None else [tree]


def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-5) -> Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * scale


def silu_stepwise(x: Tensor) -> Tensor:
    """x * sigmoid(x), the sigmoid as 1 / (1 + exp(-x)) with every step in
    x's dtype, as XLA expands the reference's `jax.nn.silu` op by op.  In
    bfloat16 each step rounds; a fused `F.silu` rounds once and differs by
    an ulp on about 40% of the elements: enough to flip the MoE's routing
    in the next layer, and to move the gradients of the recurrent blocks,
    whose jitted reference rounds as its op-by-op run does."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv1d (the Mamba-2 and mLSTM blocks' short
    convolution), its taps added one at a time in x's dtype as the
    reference adds them.  x: (B, L, C); w: (W, C); b: (C,)."""
    width = w.shape[0]
    xp = torch.nn.functional.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + xp[:, i:i + x.shape[1], :] * w[i]
    return out + b


def conv_step(hist: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """The causal conv at one new position (a decode step), from the window
    of its last W inputs, oldest first: hist (B, W, C); w (W, C); b (C,).
    The taps sum as the reference's `einsum("bwc,wc->bc", hist, w)`: in
    float32, rounded once to hist's dtype; then the bias is added."""
    return torch.einsum("bwc,wc->bc", hist.float(), w.float()).to(
        hist.dtype) + b


def truncated_normal(gen: torch.Generator, shape: Sequence[int]) -> Tensor:
    """Standard normal truncated to [-2, 2], float32, by the inverse CDF
    (the reference draws the same law from JAX's bits)."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32)
    out = math.sqrt(2.0) * torch.erfinv(lo + (hi - lo) * u)
    edge = torch.nextafter(torch.tensor(2.0), torch.tensor(0.0)).item()
    return out.clamp(-edge, edge)


def init_dense(gen: torch.Generator, shape: Sequence[int],
               axes: Sequence[str], dtype: torch.dtype,
               scale: float | None = None):
    """Truncated-normal fan-in init + logical axes."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (truncated_normal(gen, shape) * std).to(dtype), tuple(axes)


def init_embed(gen: torch.Generator, vocab: int, d: int, dtype: torch.dtype):
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32) * 0.02
    return w.to(dtype), ("vocab", "embed")


def init_scale(d: int, dtype: torch.dtype):
    return torch.ones((d,), dtype=dtype), ("norm",)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str = "cpu") -> Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """Half-split rotation, angles in float32.  x: (..., seq, heads,
    head_dim); positions: (..., seq)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # (half,)
    angles = positions[..., :, None].float() * freqs             # (..., s, half)
    cos = torch.cos(angles)[..., :, None, :]                     # (..., s, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.cat([o1, o2], dim=-1).to(x.dtype)


def sinusoidal_positions(seq: int, d: int,
                         device: torch.device | str = "cpu") -> Tensor:
    """Fixed sinusoidal embeddings (encoder stacks without RoPE), float32
    (seq, d): sines in the even columns, cosines in the odd."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, dim / d)
    out = torch.zeros((seq, d), dtype=torch.float32, device=device)
    out[:, 0::2] = torch.sin(angle)
    out[:, 1::2] = torch.cos(angle[:, : (d - d // 2)])
    return out


# ---------------------------------------------------------------------------
# Param-tree utilities
# ---------------------------------------------------------------------------

def split_tree(d: dict) -> tuple[dict, dict]:
    """Split a dict-of-(value, axes) into (params, specs), recursively."""
    params, specs = {}, {}
    for k, v in d.items():
        if isinstance(v, dict):
            params[k], specs[k] = split_tree(v)
        else:
            params[k], specs[k] = v
    return params, specs


def stack_layer_params(per_layer: list[Params]) -> Params:
    """Stack a list of identical param trees along a leading 'layers' axis."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *per_layer)


def stacked_specs(specs: Specs) -> Specs:
    """Prepend the (unsharded) 'layers' logical axis to every leaf spec."""
    if isinstance(specs, dict):
        return {k: stacked_specs(v) for k, v in specs.items()}
    return ("layers",) + tuple(specs)


def cast_tree(tree: Params, dtype: torch.dtype) -> Params:
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


def count_params(tree: Params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(tree))
