"""Mixture-of-Experts FFN: top-k token-choice routing, capacity-bounded
(counterpart of `repro/models/moe.py`).

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
The expert products are plain batched matrix products.

Under a sharding context (`launch/sharding.use_rules`) with DTensor
activations, `moe_ffn` takes one of the reference's two sharded paths:
  * expert-parallel (`_moe_expert_parallel`, the reference's
    `_moe_shard_map`) when the mesh's "model" axis is larger than 1 and
    divides the padded expert count: on local tensors, every model rank
    routes all tokens of its data shard, scatters only the slots of its
    own e_pad / model experts, runs their products locally and sums the
    combine's partial outputs over the model group;
  * otherwise the constrained path (granite-moe's 40 experts: the capacity
    dim carries the sharding), routing and combine on each data shard's
    rows and the expert products on DTensors.
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


EP_CALLS = 0   # expert-parallel calls (`_moe_expert_parallel`) made


def _dispatch(x: Tensor, router: Tensor, top_k: int, capacity: int,
              dispatch: str, e: int, offset: int = 0, span: int | None = None):
    """Route each row of x (B, S, d) and scatter its kept (token, choice)s
    into a (B, span, d) buffer: slots [offset, offset + span) of the E * C
    slot space (all of it by default), every other slot and every dropped
    (token, choice) to the sentinel row `span`.  Returns (buf, slots in
    the buffer (B, S, k), gates, aux (B,), dropped (B,))."""
    b, s, d = x.shape
    span = e * capacity if span is None else span
    slots, gates, aux, dropped = _route_row(x, router, top_k, capacity,
                                            dispatch)
    if offset or span != e * capacity:
        # A dropped choice's slot is E * C, which lies inside the last
        # rank's span when the tables are padded past E experts: it must
        # go to the sentinel too, not to a padded expert's first row.
        mine = (slots >= offset) & (slots < min(offset + span, e * capacity))
        slots = torch.where(mine, slots - offset, span)
    buf = torch.zeros((b, span + 1, d), dtype=x.dtype, device=x.device)
    # Each kept (token, choice) owns a unique slot: one write of all S * k.
    buf = scatter_rows(buf, slots.reshape(b, -1),
                       x[:, :, None].expand(b, s, top_k, d).reshape(b, -1, d))
    return buf[:, :-1], slots, gates, aux, dropped


def _experts(buf: Tensor, wi: Tensor, wg: Tensor, wo: Tensor,
             constrain=lambda t, axes: t) -> Tensor:
    """SwiGLU of every expert on its (B, E, C, d) slice of the buffer."""
    hidden = torch.einsum("becd,edf->becf", buf, wi)
    gate_h = torch.einsum("becd,edf->becf", buf, wg)
    hidden = constrain(silu_stepwise(gate_h) * hidden,
                       ("batch", "expert", "capacity", "mlp"))
    return constrain(torch.einsum("becf,efd->becd", hidden, wo),
                     ("batch", "expert", "capacity", None))


def _combine(expert_out: Tensor, slots: Tensor, gates: Tensor,
             dtype: torch.dtype | None = None) -> Tensor:
    """Each token's gate-weighted sum of its choices' expert outputs (the
    products in the activation dtype, the sum in `dtype` if given); a
    slot past the buffer (the sentinel) reads zero."""
    b, s, k = slots.shape
    d = expert_out.shape[-1]
    flat = torch.cat([expert_out.reshape(b, -1, d),
                      torch.zeros((b, 1, d), dtype=expert_out.dtype,
                                  device=expert_out.device)], dim=1)
    picked = gather_rows(flat, slots.reshape(b, -1)).reshape(b, s, k, d)
    return (picked * gates[..., None]).sum(2, dtype=dtype)


class _SumOverGroup(torch.autograd.Function):
    """The sum over a process group of each rank's partial.  The output is
    a replicated DTensor whose gradient reaches every rank whole
    (`DTensor.from_local`'s backward), and that is each partial's gradient
    too: the backward is the identity.  (`torch.distributed.nn`'s
    all-reduce sums the gradient again in its backward, which would count
    it once for each rank of the group.)"""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _moe_expert_parallel(params, x: Tensor, *, top_k: int, capacity: int,
                         dispatch: str, ctx) -> tuple[Tensor, Tensor]:
    """The reference's `_moe_shard_map` on DTensor: x (B, S, D), a DTensor
    whose batch goes over the data axes, on a mesh whose "model" axis
    divides the padded expert count.  Each model rank works on local
    tensors: the router whole, its e_pad / model experts' weights gathered
    over their FSDP axes, all tokens of its data shard routed, only its
    own slots scattered (the others to the sentinel), its experts'
    products, the combine from its local buffer; the partial outputs are
    summed over the model group.  The local tensors' gradients are
    declared as the placements they are: partial over the model group
    (and over the data axes for the weights, which see one data shard's
    rows each)."""
    global EP_CALLS
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.launch import sharding
    mesh, rules = ctx.mesh, ctx.rules
    names = sharding.axis_names(mesh)
    mi = names.index("model")
    b, s, d = x.shape
    e = params["router"].shape[1]
    e_pad = params["wi"].shape[0]
    n_model = sharding.axis_size(mesh, "model")
    e_local = e_pad // n_model
    px = sharding.placements(sharding.logical_to_spec(("batch", None, None),
                                                      rules), mesh, x.shape)
    rows = [i for i, p in enumerate(px) if p == Shard(0)]
    batch_axes = sharding.logical_to_spec(("batch",), rules)[0]
    if sharding.divisible_spec((batch_axes,), mesh, (b,)) != (batch_axes,):
        raise ValueError(f"expert-parallel MoE: batch {b} does not divide "
                         f"over the data axes {batch_axes}")

    def partial_over(*dims):
        return lambda i, p: Partial() if i in dims else p

    def local(t, place, grad):
        """t's local tensor at `place`, its gradient declared `grad`."""
        return t.redistribute(mesh, place).to_local(grad_placements=[
            grad(i, p) for i, p in enumerate(place)])

    xl = local(x, px, partial_over(mi))
    rep = [Replicate()] * len(names)
    router = local(params["router"], rep, partial_over(mi, *rows))
    pw = [Shard(0) if i == mi else Replicate() for i in range(len(names))]
    wi, wg, wo = (local(params[k], pw, partial_over(*rows))
                  for k in ("wi", "wg", "wo"))
    span = e_local * capacity
    offset = mesh.get_local_rank("model") * span
    buf, slots, gates, aux, _ = _dispatch(xl, router, top_k, capacity,
                                          dispatch, e, offset, span)
    b_loc = xl.shape[0]
    expert_out = _experts(buf.reshape(b_loc, e_local, capacity, d),
                          wi, wg, wo)
    # The partial sums stay in float32 through the group's sum and round
    # once, as the one-device combine's sum does (the reference sums them
    # in the activation dtype: two roundings, which flip routing decisions
    # of the next layer in bfloat16).
    partial = _combine(expert_out, slots, gates, torch.float32)
    out = _SumOverGroup.apply(partial, mesh.get_group("model"))
    EP_CALLS += 1
    out = DTensor.from_local(out.to(x.dtype), mesh, px, run_check=False)
    # One mean a (data shard, model rank), as the reference's out_specs
    # P(batch, "model") lay them out; their mean is the aux loss.
    pa = [Shard(1) if i == mi else (Shard(0) if i in rows else Replicate())
          for i in range(len(names))]
    aux = DTensor.from_local(aux.mean().reshape(1, 1), mesh, pa,
                             run_check=False)
    return out, aux.mean().float()


def _moe_constrained(params, x: Tensor, *, top_k: int, capacity: int,
                     dispatch: str, ctx) -> tuple[Tensor, Tensor]:
    """The reference's constrained path on DTensor (no expert-parallel
    mesh; granite-moe's 40 experts: the capacity dim carries the
    sharding).  DTensor has no sharding rule for routing's sort and
    scatter_add_, nor for the dispatch scatter and the combine gather, so
    those run on each rank's rows of x, replicated over every axis but
    the batch's (the reference also gathers the sequence first); the
    expert products run on DTensors under the buffer's constraints."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.launch import sharding
    mesh = ctx.mesh
    e = params["router"].shape[1]
    d = x.shape[-1]
    x = sharding.constrain(x, ("batch", None, None))
    px = list(x.placements)
    rows = [i for i, p in enumerate(px) if p == Shard(0)]
    xl = x.to_local(grad_placements=px)
    router = sharding.replicated(params["router"]).to_local(grad_placements=[
        Partial() if i in rows else Replicate() for i in range(len(px))])
    buf, slots, gates, aux, dropped = _dispatch(xl, router, top_k, capacity,
                                                dispatch, e)
    b_loc = xl.shape[0]
    buf = DTensor.from_local(buf.reshape(b_loc, e, capacity, d), mesh, px,
                             run_check=False)
    buf = sharding.constrain(buf, ("batch", "expert", "capacity", None))
    expert_out = _experts(buf, params["wi"][:e], params["wg"][:e],
                          params["wo"][:e], sharding.constrain)
    expert_out = expert_out.redistribute(mesh, px).to_local(
        grad_placements=px)
    out = DTensor.from_local(_combine(expert_out, slots, gates).to(x.dtype),
                             mesh, px, run_check=False)
    stats = [DTensor.from_local(t, mesh, px, run_check=False)
             for t in (aux, dropped)]
    return out, (stats[0].mean() + 0.0 * stats[1].mean()).float()


def moe_ffn(params, x: Tensor, *, top_k: int, capacity_factor: float,
            dispatch: str = "sort") -> tuple[Tensor, Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux load-balance loss (), float32)."""
    from repro_torch.launch import sharding
    b, s, d = x.shape
    e = params["router"].shape[1]
    e_pad = params["wi"].shape[0]
    capacity = _capacity(s, top_k, e, capacity_factor)

    ctx = sharding.current()
    if ctx is not None and sharding.is_dtensor(x):
        names = sharding.axis_names(ctx.mesh)
        n_model = sharding.axis_size(ctx.mesh, "model") \
            if "model" in names else 1
        if n_model > 1 and e_pad % n_model == 0:
            return _moe_expert_parallel(params, x, top_k=top_k,
                                        capacity=capacity, dispatch=dispatch,
                                        ctx=ctx)
        return _moe_constrained(params, x, top_k=top_k, capacity=capacity,
                                dispatch=dispatch, ctx=ctx)

    buf, slots, gates, aux, dropped = _dispatch(x, params["router"], top_k,
                                                capacity, dispatch, e)
    expert_out = _experts(buf.reshape(b, e, capacity, d), params["wi"][:e],
                          params["wg"][:e], params["wo"][:e])
    out = _combine(expert_out, slots, gates)
    aux_loss = aux.mean() + 0.0 * dropped.mean()
    return out.to(x.dtype), aux_loss.float()
