"""Mixture-of-Experts FFN: top-k token-choice routing, capacity-bounded
(counterpart of `repro/models/moe.py`, its single-device path).

  * routing and dispatch are per sequence row: capacity, positions and the
    aux statistics of one row never see another row's tokens, as under the
    reference's `vmap`.  Here the rows are batched in one set of tensor ops.
  * dispatch uses scatter-by-slot (slot = expert * C + position) into a
    buffer of E * C + 1 rows; a (token, choice) past its expert's capacity
    goes to the sentinel slot E * C, whose row is dropped before the expert
    products and reads zero in the combine (Switch-style drop to the
    residual path, counted in `dropped`).
  * capacity C = ceil(S * top_k / E * capacity_factor), lane-aligned.
  * the load-balance auxiliary loss (Switch eq. 4) is returned alongside.

The reference's expert-parallel path (`_moe_shard_map`) needs a device mesh
and the LM side's sharding rules (`launch/{mesh,sharding}.py`), which the
port does not have yet: `moe_ffn` always takes the single-device path.
The expert products are plain batched matrix products.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import init_dense, silu_stepwise, split_tree

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Dispatch / combine primitives with the reference's backward passes: the
# exact gradients when every kept slot is written and read once, with the
# cotangents in the activation dtype.  Both take a leading batch axis (one
# buffer per sequence row) and indices inside the buffer.
# ---------------------------------------------------------------------------

def _flat_index(idx: Tensor, n: int) -> Tensor:
    """(B, M) row indices into B buffers of n rows -> indices into the
    (B * n) rows of the flattened buffers."""
    offsets = torch.arange(idx.shape[0], device=idx.device)[:, None] * n
    return (idx + offsets).reshape(-1)


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, idx, rows):
        b, n, d = buf.shape
        flat = _flat_index(idx, n)
        out = buf.clone()
        out.view(b * n, d)[flat] = rows.reshape(-1, d).to(buf.dtype)
        ctx.save_for_backward(flat)
        return out

    @staticmethod
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        b, n, d = g.shape
        g_flat = g.reshape(b * n, d)
        g_rows = g_flat[flat].reshape(b, -1, d)
        if not ctx.needs_input_grad[0]:
            return None, None, g_rows
        # slots written by rows contribute nothing to dbuf
        dbuf = g_flat.clone()
        dbuf[flat] = 0
        return dbuf.reshape(b, n, d), None, g_rows


def scatter_rows(buf: Tensor, idx: Tensor, rows: Tensor) -> Tensor:
    """`buf[b, idx[b, m]] = rows[b, m]` for every row b, out of place.
    buf: (B, N, d); idx: (B, M) in [0, N); rows: (B, M, d).  Indices must
    be unique but for a discarded sentinel row, whose value is then any of
    the rows written there."""
    return _ScatterRows.apply(buf, idx, rows)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flat, idx):
        b, n, d = flat.shape
        fidx = _flat_index(idx, n)
        ctx.save_for_backward(fidx)
        ctx.n = n
        return flat.reshape(b * n, d)[fidx].reshape(b, -1, d)

    @staticmethod
    def backward(ctx, g):
        (fidx,) = ctx.saved_tensors
        b, m, d = g.shape
        dflat = torch.zeros((b * ctx.n, d), dtype=g.dtype, device=g.device)
        # the combine reads each kept slot once; a scatter-add resolves the
        # sentinel's repeated reads
        dflat.index_add_(0, fidx, g.reshape(b * m, d))
        return dflat.reshape(b, ctx.n, d), None


def gather_rows(flat: Tensor, idx: Tensor) -> Tensor:
    """`flat[b, idx[b, m]]`: (B, N, d) and (B, M) in [0, N) -> (B, M, d)."""
    return _GatherRows.apply(flat, idx)


def init_moe_params(gen: torch.Generator, d_model: int, d_ff: int,
                    num_experts: int, dtype: torch.dtype,
                    num_experts_padded: int | None = None):
    """Router covers `num_experts`; the weight tables are drawn at
    `num_experts_padded` rows (dummy experts that never receive tokens), as
    the reference draws them.  Returns (params, logical-axis specs)."""
    e_pad = num_experts_padded or num_experts
    tree = {
        "router": init_dense(gen, (d_model, num_experts),
                             ("embed", "expert"), dtype),
        "wi": init_dense(gen, (e_pad, d_model, d_ff),
                         ("expert", "embed", "mlp"), dtype),
        "wg": init_dense(gen, (e_pad, d_model, d_ff),
                         ("expert", "embed", "mlp"), dtype),
        "wo": init_dense(gen, (e_pad, d_ff, d_model),
                         ("expert", "mlp", "embed"), dtype),
    }
    return split_tree(tree)


def _capacity(seq: int, top_k: int, num_experts: int, cf: float) -> int:
    c = max(1, -(-seq * top_k * cf // num_experts).__int__())
    # lane-align when large enough to matter
    return min(seq, ((c + 7) // 8) * 8) if c > 8 else c


def _positions_cumsum(expert_idx: Tensor, e: int) -> Tensor:
    """Position of each (token, choice) within its expert, row by row, via
    the GShard one-hot cumsum.  expert_idx: (B, S, k) -> (B, S * k)."""
    flat = expert_idx.reshape(expert_idx.shape[0], -1)         # (B, S*k)
    onehot = F.one_hot(flat, e)                                # (B, S*k, E)
    pos = torch.cumsum(onehot, dim=1) - onehot
    return torch.gather(pos, 2, flat[..., None])[..., 0]


def _positions_sort(expert_idx: Tensor, e: int) -> Tensor:
    """The same positions via a stable sort of each row:
    rank within expert = sorted position - start offset of the expert."""
    flat = expert_idx.reshape(expert_idx.shape[0], -1)         # (B, S*k)
    b, n = flat.shape
    order = torch.sort(flat, dim=1, stable=True).indices
    counts = torch.zeros((b, e), dtype=flat.dtype, device=flat.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, dim=1) - counts              # (B, E)
    ranks = (torch.arange(n, device=flat.device)[None, :]
             - torch.gather(starts, 1, torch.gather(flat, 1, order)))
    return torch.zeros_like(flat).scatter_(1, order, ranks)


def router_top_k(x: Tensor, router: Tensor, top_k: int):
    """Router probabilities (float32) and the top-k (values, experts) of
    each token, ties to the lower expert index as `jax.lax.top_k` breaks
    them (a stable descending sort: a bfloat16 router product makes exact
    ties common).  x: (B, S, d); router: (d, E)."""
    # Router matmul in the activation dtype, softmax in float32.
    logits = (x @ router.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                      # (B, S, E)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, vals[..., :top_k], idx[..., :top_k]


def _route_row(x: Tensor, router: Tensor, top_k: int, capacity: int,
               dispatch: str = "sort"):
    """Routing of each sequence row on its own, batched over the rows:
    x (B, S, d) -> slots (B, S, k), gates (B, S, k) in x's dtype, and the
    aux statistics aux (B,), dropped (B,)."""
    b, s, _ = x.shape
    e = router.shape[1]
    probs, gate_vals, expert_idx = router_top_k(x, router, top_k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)

    pos_fn = _positions_sort if dispatch == "sort" else _positions_cumsum
    pos = pos_fn(expert_idx, e).reshape(b, s, top_k)
    keep = pos < capacity
    slots = torch.where(keep, expert_idx * capacity + pos, e * capacity)

    density = F.one_hot(expert_idx[..., 0], e).float().mean(1)  # (B, E)
    aux = e * torch.sum(density * probs.mean(1), dim=-1)
    dropped = 1.0 - keep.float().mean((1, 2))
    return slots, gate_vals.to(x.dtype), aux, dropped


def moe_ffn(params, x: Tensor, *, top_k: int, capacity_factor: float,
            dispatch: str = "sort") -> tuple[Tensor, Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux load-balance loss (), float32)."""
    b, s, d = x.shape
    e = params["router"].shape[1]
    capacity = _capacity(s, top_k, e, capacity_factor)

    slots, gates, aux, dropped = _route_row(x, params["router"], top_k,
                                            capacity, dispatch)
    buf = torch.zeros((b, e * capacity + 1, d), dtype=x.dtype,
                      device=x.device)
    # Each kept (token, choice) owns a unique slot: one write of all S * k.
    buf = scatter_rows(buf, slots.reshape(b, -1),
                       x[:, :, None].expand(b, s, top_k, d).reshape(b, -1, d))
    buf = buf[:, :-1].reshape(b, e, capacity, d)

    hidden = torch.einsum("becd,edf->becf", buf, params["wi"][:e])
    gate_h = torch.einsum("becd,edf->becf", buf, params["wg"][:e])
    hidden = silu_stepwise(gate_h) * hidden
    expert_out = torch.einsum("becf,efd->becd", hidden, params["wo"][:e])

    flat = torch.cat([expert_out.reshape(b, e * capacity, d),
                      torch.zeros((b, 1, d), dtype=expert_out.dtype,
                                  device=x.device)], dim=1)
    picked = gather_rows(flat, slots.reshape(b, -1)).reshape(b, s, top_k, d)
    out = (picked * gates[..., None]).sum(2)
    aux_loss = aux.mean() + 0.0 * dropped.mean()
    return out.to(x.dtype), aux_loss.float()
