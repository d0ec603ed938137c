"""Blocked triangular solves: `csrc/trsv.cu` on the card.

Counterpart of `repro/kernels/trsv.py`.  `trsv(l, b, trans=...)` solves
L q = b or L^T q = b for a lower-triangular L (..., n, n) and b (..., n, r),
with optional leading batch dimensions.  It is an `autograd.Function` with
the reference's textbook VJP (`_trsv_bwd`), whose backward solve reruns the
same kernel with `trans` flipped:

    q = L^{-1} b :  b_bar = L^{-T} q_bar,  L_bar = -tril(b_bar q^T)
    q = L^{-T} b :  b_bar = L^{-1} q_bar,  L_bar = -tril(q b_bar^T)

On the card the general solve (`repro_trsv`) is one launch in one of two
regimes (`launch_plan`): a narrow b (r <= `NARROW_MAX_R`: the append, the
posterior's vectors) spreads its row blocks over the card as a wavefront
of CTAs that hand solved blocks on through scratch kept per device and
stream (`_SCRATCH`, left at 0 by the kernel); a wide b gives each CTA a
panel of 8 columns.  L q = b keeps the earlier kernel's bits; L^T q = b sums
in the order the rows are solved (csrc/trsv.cu).  It counts its launches
in `LAUNCHES_GENERAL`.

`tri_inverse(l)` is the solve at b = I, X = L^{-1}, on its own kernel
(`repro_tri_inverse`), which skips the zero half of X and takes no b; it
holds a panel of X in shared memory, so beyond `MAX_N` the card takes the
general kernel at b = I instead (`inverse_entry`, the same bits).  Its
VJP is the one above at b = I: L_bar = -tril(L^{-T} X_bar X^T).  It counts
its launches in `LAUNCHES`.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.kernels import _build, ref

Tensor = torch.Tensor

SOURCE = "trsv"
LAUNCHES = 0          # repro_tri_inverse launches since the caller set it to 0
LAUNCHES_GENERAL = 0  # repro_trsv launches, counted apart
_SIGNATURES = {"repro_trsv": (_build.ptr,) * 4 + (_build.cint,) * 8
               + (_build.ptr,),
               "repro_tri_inverse": (_build.ptr,) * 2 + (_build.cint,) * 2
               + (_build.ptr,)}
# csrc/trsv.cu, repro_tri_inverse: 8 columns of X per CTA; a CTA holds
# 2 staged 128 x 36 tiles of L and its panel of X (32 bytes a row, rows
# rounded up to 32) in at most 227 KB of shared memory.
PANEL = 8
_STAGE_BYTES = 2 * 128 * 36 * 4
_MAX_SHARED = 232448
MAX_N = (_MAX_SHARED - _STAGE_BYTES) // (4 * PANEL) // 32 * 32

# csrc/trsv.cu, repro_trsv (namespace gen): a CTA owns a panel of 8 columns
# of q and walks tiles of 32 columns of L (row stride 36 floats) through a
# cp.async ring; after the ring and its window of q's rows it keeps 16 bytes
# of control words.  Narrow: one CTA per block of rows, 8 stages; wide: one
# CTA per panel, 128-row blocks, 4 stages; both keep a window of two blocks
# of q's rows.  The narrow regime is the faster for every dense b of up to
# 512 columns at n = 1024 and 4096, the wide one at 1024 columns
# (`chip_smoke.general_solves`' `regimes_by_r`, PERF.md); the wide one
# skips the zero rows of b, which makes it the faster at b = I.
# `launch_plan` reads the switch at each call.
NARROW_MAX_R = 512
TILE_LD = 36              # row stride of a staged 32-column tile of L
NARROW_STAGES, WIDE_STAGES = 8, 4
WIDE_ROWS = 128
CTRL_BYTES = 16
SCRATCH_HEAD = 2          # ticket, CTAs done; then a word per (matrix, panel)
REGIMES = ("narrow", "wide")
_GRID_MAX = 2**31 - 1
# (device index, stream) -> the narrow regime's scratch, kept across calls.
_SCRATCH: dict[tuple[int, int], Tensor] = {}


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call of `repro_trsv` is cut."""
    regime: str            # "narrow" (blocks of rows over CTAs) or "wide"
    rows: int              # rows of q a CTA solves per block
    stages: int            # depth of the cp.async ring of tiles of L
    cols: int              # columns of q a CTA owns (a panel)
    grid: int              # CTAs
    shared_bytes: int      # dynamic shared memory of one CTA
    scratch_ints: int      # narrow: ticket, done, a word per (matrix, panel)


def narrow_rows(n: int) -> int:
    """Rows per block of the narrow regime: 128, or fewer so that a matrix
    of n >= 64 rows still spreads over at least two CTAs."""
    return 32 if n <= 64 else 64 if n <= 128 else 128


def launch_plan(n: int, r: int, batch: int, trans: bool = False) -> LaunchPlan:
    """The regime, rows per block, columns per CTA, grid, dynamic shared
    bytes and scratch of one call on `batch` systems of n rows and r
    right-hand sides: the single source of these numbers for the wrapper
    and the C entry, which checks them.  The regime is narrow up to
    `NARROW_MAX_R` columns; the geometry does not depend on `trans`."""
    if min(n, r, batch) < 1:
        raise ValueError(f"trsv launch plan needs n, r, batch >= 1, got "
                         f"{n}, {r}, {batch}")
    return _plan(n, r, batch, r <= NARROW_MAX_R)


@functools.lru_cache(maxsize=256)
def _plan(n: int, r: int, batch: int, narrow: bool) -> LaunchPlan:
    panels = -(-r // PANEL)
    if narrow:
        rows, stages = narrow_rows(n), NARROW_STAGES
        grid = batch * panels * -(-n // rows)
        scratch = SCRATCH_HEAD + batch * panels
    else:
        rows, stages = WIDE_ROWS, WIDE_STAGES
        grid, scratch = batch * panels, 0
    if grid > _GRID_MAX or scratch > _GRID_MAX:
        raise ValueError(f"trsv kernel: {batch} systems of n = {n}, r = {r} "
                         f"need more CTAs than one grid holds")
    # The ring, the window of two blocks of q's rows, the control words.
    smem = 4 * (stages * rows * TILE_LD + 2 * rows * PANEL) + CTRL_BYTES
    return LaunchPlan(regime=REGIMES[not narrow], rows=rows, stages=stages,
                      cols=PANEL, grid=grid, shared_bytes=smem,
                      scratch_ints=scratch)


def narrow_order(n: int, r: int, batch: int, trans: bool = False
                 ) -> list[tuple[int, int, int]]:
    """(matrix, panel, block) of each ticket of the narrow regime, as the
    kernel maps them: block by block in solve order (top down for L,
    bottom up for L^T), matrix then panel fastest."""
    if min(n, r, batch) < 1:
        raise ValueError(f"trsv narrow order needs n, r, batch >= 1, got "
                         f"{n}, {r}, {batch}")
    plan = _plan(n, r, batch, True)
    nblk, per = -(-n // plan.rows), plan.grid // -(-n // plan.rows)
    order = []
    for ticket in range(plan.grid):
        step, rem = divmod(ticket, per)
        order.append((rem % batch, rem // batch,
                      nblk - 1 - step if trans else step))
    return order


def _scratch(dev: torch.device, stream: int, ints: int) -> Tensor:
    """This device and stream's scratch, grown to `ints`.  Zeroed when it is
    allocated; the kernel leaves it 0, so calls in stream order share it."""
    key = (dev.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < ints:
        buf = torch.zeros(ints, dtype=torch.int32, device=dev)
        _SCRATCH[key] = buf
    return buf


def trsv_cuda(l: Tensor, b: Tensor, *, trans: bool = False) -> Tensor:
    """Launch the kernel: l (..., n, n), b (..., n, r) float32 CUDA."""
    global LAUNCHES_GENERAL
    if l.device.type != "cuda" or b.device != l.device:
        raise ValueError(f"trsv kernel needs CUDA tensors on one device, "
                         f"got {l.device} and {b.device}")
    if l.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"trsv kernel takes float32, got {l.dtype}, {b.dtype}")
    n = l.shape[-1]
    if (l.ndim < 2 or b.ndim != l.ndim or l.shape[-2] != n
            or b.shape[:-1] != l.shape[:-1]):
        raise ValueError(f"trsv kernel takes (..., n, n) and (..., n, r), got "
                         f"{tuple(l.shape)} and {tuple(b.shape)}")
    l, b = l.contiguous(), b.contiguous()
    q = torch.empty_like(b)
    batch, r = math.prod(l.shape[:-2]), b.shape[-1]
    if batch == 0 or n == 0 or r == 0:
        return q
    plan = launch_plan(n, r, batch, trans)
    lib = _build.load(SOURCE, _SIGNATURES)
    # The current stream's handle without building a Python Stream object.
    stream = torch._C._cuda_getCurrentRawStream(l.device.index)
    scratch = (_scratch(l.device, stream, plan.scratch_ints).data_ptr()
               if plan.scratch_ints else None)
    status = lib.repro_trsv(l.data_ptr(), b.data_ptr(), q.data_ptr(), scratch,
                            batch, n, r, int(trans), REGIMES.index(plan.regime),
                            plan.rows, plan.stages, plan.shared_bytes, stream)
    LAUNCHES_GENERAL += 1
    _build.check(lib, status, "trsv")
    return q


def shared_bytes(n: int) -> int:
    """Dynamic shared memory of one `repro_tri_inverse` CTA at size n."""
    return _STAGE_BYTES + 4 * PANEL * (-(-n // 32) * 32)


def launch_order(n: int, batch: int) -> list[tuple[int, int]]:
    """(matrix, first column) of each CTA of `repro_tri_inverse`, in grid
    order, as the kernel maps them: panel p of every matrix before panel
    p + 1 of any, so the heaviest panels (the leftmost) start first."""
    if n < 1 or batch < 1:
        raise ValueError(f"launch order needs n, batch >= 1, got {n}, {batch}")
    return [(idx % batch, idx // batch * PANEL)
            for idx in range(batch * -(-n // PANEL))]


def tri_inverse_cuda(l: Tensor) -> Tensor:
    """Launch X = L^{-1} for a contiguous float32 CUDA l (..., n, n)."""
    global LAUNCHES
    if l.device.type != "cuda":
        raise ValueError(f"tri_inverse kernel needs a CUDA tensor, got {l.device}")
    if l.dtype != torch.float32:
        raise TypeError(f"tri_inverse kernel takes float32, got {l.dtype}")
    if l.ndim < 2 or l.shape[-1] != l.shape[-2]:
        raise ValueError(f"tri_inverse kernel takes (..., n, n), got {tuple(l.shape)}")
    if not l.is_contiguous():
        raise ValueError("tri_inverse kernel takes a contiguous tensor")
    n = l.shape[-1]
    if n > MAX_N:
        raise ValueError(f"tri_inverse kernel keeps a panel of X in shared "
                         f"memory: n at most {MAX_N}, got {n}")
    batch = l.numel() // (n * n) if n else 0
    if batch * -(-n // PANEL) > 2**31 - 1:
        raise ValueError(f"tri_inverse kernel: {batch} matrices of n = {n} "
                         f"need more CTAs than one grid holds")
    x = torch.empty_like(l)
    if batch == 0:
        return x
    lib = _build.load(SOURCE, _SIGNATURES)
    status = lib.repro_tri_inverse(l.data_ptr(), x.data_ptr(), batch, n,
                                   torch.cuda.current_stream(l.device).cuda_stream)
    LAUNCHES += 1
    _build.check(lib, status, "tri_inverse")
    return x


def _solve(l: Tensor, b: Tensor, trans: bool) -> Tensor:
    if l.device.type == "cuda":
        return trsv_cuda(l, b, trans=trans)
    if l.device.type == "cpu":
        return ref.trsv(l, b, trans=trans)
    raise ValueError(f"no trsv for device {l.device}")


class _Trsv(torch.autograd.Function):

    @staticmethod
    def forward(ctx, l, b, trans):
        q = _solve(l, b, trans)
        ctx.trans = trans
        ctx.save_for_backward(l, q)
        return q

    @staticmethod
    def backward(ctx, g):
        l, q = ctx.saved_tensors
        db = _solve(l, g.contiguous(), not ctx.trans)
        outer = (q @ db.transpose(-1, -2) if ctx.trans
                 else db @ q.transpose(-1, -2))
        return -torch.tril(outer), db, None


def trsv(l: Tensor, b: Tensor, *, trans: bool = False) -> Tensor:
    """Solve L q = b (trans=False) or L^T q = b (trans=True); b is a
    vector (..., n) or a matrix (..., n, r).  Differentiable in l and b;
    where no gradient is wanted the solve runs without the autograd node
    (the appends call it once a row)."""
    vector = b.ndim == l.ndim - 1
    rhs = b[..., None] if vector else b
    if torch.is_grad_enabled() and (l.requires_grad or b.requires_grad):
        q = _Trsv.apply(l, rhs, trans)
    else:
        q = _solve(l, rhs, trans)
    return q[..., 0] if vector else q


def inverse_entry(n: int) -> str:
    """The kernel that computes L X = I at size n on the card: the L X = I
    kernel up to `MAX_N`, beyond it the general solve at B = I, which has
    no size limit and gives the same bits."""
    return "tri_inverse" if n <= MAX_N else "trsv"


def _inverse(l: Tensor) -> Tensor:
    if l.device.type == "cuda":
        n = l.shape[-1]
        if inverse_entry(n) == "tri_inverse":
            return tri_inverse_cuda(l)
        eye = torch.eye(n, dtype=l.dtype, device=l.device)
        return trsv_cuda(l, eye.expand(l.shape).contiguous())
    if l.device.type == "cpu":
        return ref.tri_inverse(l)
    raise ValueError(f"no tri_inverse for device {l.device}")


class _TriInverse(torch.autograd.Function):

    @staticmethod
    def forward(ctx, l):
        x = _inverse(l)
        ctx.save_for_backward(l, x)
        return x

    @staticmethod
    def backward(ctx, g):
        l, x = ctx.saved_tensors
        db = _solve(l, g.contiguous(), True)
        return -torch.tril(db @ x.transpose(-1, -2))


def tri_inverse(l: Tensor) -> Tensor:
    """X = L^{-1} of a lower-triangular l (..., n, n), i.e. L X = I.
    Differentiable in l."""
    return _TriInverse.apply(l)
