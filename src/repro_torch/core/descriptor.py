"""Type descriptor for mixed (float / int / categorical / conditional) spaces.

Counterpart of `repro/core/descriptor.py`, with the stacked `(S, d)`
descriptors of a batched engine (`stack_descriptors`, `index_descriptor`:
one type layout a study, studies of different layouts side by side).  The
GP always sees the
encoded unit cube: every search-space dimension contributes one or more
unit-cube coordinates (floats and ints one each, categoricals a one-hot
block).  The `TypeDescriptor` records per coordinate which coordinates take
gradient steps (continuous block), which form one-hot blocks (the
categorical factor of the mixed kernel), the integer lattice resolution,
and the parent gating of conditional dimensions.

`project_units` is the round-and-repair projection the acquisition ascent
applies after every gradient step: masked tensor arithmetic with no host
copy and no Python branch on values, so on the card it queues its launches
behind the ascent step and never waits for the device.
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TypeDescriptor:
    """Per-coordinate typing of an encoded search space (all fields `(d,)`).

    Invariants (established by `repro_torch.hpo.space.SearchSpace.descriptor`):
      * `cont_mask + cat_mask` is 1 everywhere;
      * `levels > 0` only on integer coordinates (the lattice size, so
        `levels == 1` pins the coordinate to 0);
      * `group[c]` is the index of the first coordinate of c's one-hot
        block, or -1 off the categorical block;
      * `parent[c]` is the one-hot coordinate whose value gates c, or -1
        for unconditional coordinates.  Parents are unconditional, so one
        gating pass suffices.
    `group` and `parent` are int64 (torch's index type); the reference
    keeps them as int32, and `convert.descriptor_to_numpy` writes int32.
    """

    cont_mask: Tensor   # (d,) f32: 1.0 on gradient (float + int) coordinates
    cat_mask: Tensor    # (d,) f32: 1.0 on one-hot (categorical) coordinates
    levels: Tensor      # (d,) f32: integer lattice size (0.0 = not an int)
    group: Tensor       # (d,) i64: one-hot segment id (-1 = not categorical)
    parent: Tensor      # (d,) i64: gating coordinate index (-1 = always on)

    @property
    def dim(self) -> int:
        return self.cont_mask.shape[-1]

    @property
    def is_batched(self) -> bool:
        """Stacked `(S, d)` leaves, one row a study."""
        return self.cont_mask.ndim == 2

    @property
    def has_discrete(self) -> bool:
        """Host-side: any int / categorical / conditional coordinate?  Reads
        the fields back to the host, so it decides which closures a driver
        builds, never anything inside the ascent."""
        return bool((self.cat_mask > 0).any() or (self.levels > 0).any()
                    or (self.parent >= 0).any())

    def to(self, device) -> "TypeDescriptor":
        """The same descriptor with its fields on `device`."""
        return TypeDescriptor(*(getattr(self, f).to(device) for f in FIELDS))


FIELDS = tuple(f.name for f in dataclasses.fields(TypeDescriptor))


def all_continuous(dim: int) -> TypeDescriptor:
    """The degenerate all-float descriptor (projection is the identity), on
    the CPU like `SearchSpace.descriptor()`."""
    return TypeDescriptor(
        cont_mask=torch.ones((dim,), dtype=torch.float32),
        cat_mask=torch.zeros((dim,), dtype=torch.float32),
        levels=torch.zeros((dim,), dtype=torch.float32),
        group=torch.full((dim,), -1, dtype=torch.int64),
        parent=torch.full((dim,), -1, dtype=torch.int64),
    )


def stack_descriptors(descs: "list[TypeDescriptor]") -> TypeDescriptor:
    """Stack per-study descriptors into `(S, d)` leaves (one shared width),
    on the first descriptor's device."""
    widths = {d.dim for d in descs}
    if len(widths) != 1:
        raise ValueError(f"descriptors must share one width, got {widths}")
    dev = descs[0].cont_mask.device
    return TypeDescriptor(*(torch.stack([getattr(d, f).to(dev) for d in descs])
                            for f in FIELDS))


def index_descriptor(desc: TypeDescriptor, i: int) -> TypeDescriptor:
    """Study i of a stacked descriptor (views of its rows, no copy)."""
    return TypeDescriptor(*(getattr(desc, f)[i] for f in FIELDS))


def project_units(u: Tensor, desc: TypeDescriptor) -> Tensor:
    """Round-and-repair projection onto the feasible lattice.

    Three masked passes over the last axis of `u` (`(d,)` or `(n, d)`, rows
    projected independently; with a stacked `(S, d)` descriptor, `u` is
    `(S, n, d)` and study s's rows take row s of the descriptor, in the
    same launches as one study):

      1. **int snap**: coordinates with `levels = L > 0` round to the
         uniform lattice `{k / (L-1)}` (L = 1 pins to 0); `torch.round`
         rounds half to even, as `jnp.round` does;
      2. **one-hot argmax**: each categorical block keeps a single 1 at its
         largest coordinate, the first index winning ties (`scatter_reduce`
         "amax" then "amin" over the group ids, in place of the reference's
         `segment_max` / `segment_min`);
      3. **parent gating**: conditional coordinates multiply by their
         parent choice's (now 0/1) coordinate.

    Continuous coordinates pass through untouched.
    """
    d = u.shape[-1]
    # A stacked descriptor's (S, d) rows against (S, n, d) points.
    row = ((lambda v: v[..., None, :]) if desc.is_batched
           else (lambda v: v))
    # 1. integer lattice snap
    lev = row(desc.levels)
    snapped = torch.round(u * (lev - 1.0)) / torch.clamp(lev - 1.0, min=1.0)
    u = torch.where(lev > 0, snapped, u)
    # 2. per-group one-hot argmax (group ids are first-coordinate indices,
    # so d segments cover every group)
    gid = row(desc.group)
    is_cat = gid >= 0
    seg = torch.where(is_cat, gid, 0).expand(u.shape)
    scores = torch.where(is_cat, u, -torch.inf)
    gmax = torch.full_like(u, -torch.inf).scatter_reduce(
        -1, seg, scores, "amax")
    at_max = is_cat & (u >= torch.gather(gmax, -1, seg))
    idx = torch.arange(d, device=u.device)
    cand = torch.where(at_max, idx, d)
    first = torch.full(u.shape, d, dtype=idx.dtype, device=u.device) \
        .scatter_reduce(-1, seg, cand, "amin")
    onehot = (idx == torch.gather(first, -1, seg)).to(u.dtype)
    u = torch.where(is_cat, onehot, u)
    # 3. conditional gating by the (projected) parent coordinate
    par = row(desc.parent)
    if desc.is_batched:     # each study's own parent ids
        gate = torch.gather(u, -1, torch.clamp(par, 0, d - 1).expand(u.shape))
    else:
        gate = torch.index_select(u, -1, torch.clamp(par, 0, d - 1))
    return torch.where(par >= 0, u * gate, u)
