"""Fused EI value + gradient for the acquisition ascent: `csrc/acq.cu`.

Counterpart of `repro/kernels/acq.py`, in its float and its mixed form.
One ascent iteration for the whole (r, d) restart batch:

    K       = kern(X, x_buf) * amask          (r, n)   cross-gram
    gamma   = K alpha + shift                 (r,)     shift = ymean - f_best - xi
    U       = K A                             (r, n)   A = li_buf^T li_buf (hoisted)
    var     = max(sigma2 - rowsum(U o K), VAR_FLOOR)
    EI      = gamma Phi(Z) + sigma phi(Z),    Z = gamma / sigma
    dEI/dx  = analytic, with dEI/dvar zeroed where var hit VAR_FLOOR

The mixed form (a search space with categorical coordinates) splits each
row by the space's 0/1 type masks, (d,) for the whole batch or (..., d)
one pair a study, xc = x * cont_mask and
xk = x * cat_mask, takes K and the gradient over xc, and multiplies K and
the gradient's radial factor by cat = exp(-|xk - xbk|^2 / 2 rho), which is
never differentiated: the gradient is zero on the categorical coordinates.

`ei_grad_torch` is the plain version, a line-for-line port of the
reference's `_fused_ei_grad_math` (pre-split operands, `xk` / `xbk` for the
mixed form); `fused_ei_grad` runs a CUDA kernel for CUDA tensors (the
float or the mixed instantiation of `csrc/acq.cu`, each with its own
launch counter; the mixed kernel splits the rows as it loads them) and
`ei_grad_torch` for CPU tensors.  Not differentiable: the gradient is an
output.

On the card a call is one launch: each CTA owns a tile of 8 candidate rows
x 64 columns of U and a slice of k for one study (`launch_plan`), writes
its partial row sums to scratch, and the last CTA of each row block sums
them in a fixed order and finishes the rows.  The scratch (partials and one
ticket counter per row block) is kept per device and stream and grows as
needed; the kernel leaves the counters at 0, so a call allocates nothing
but its outputs.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.kernels import _build, ref

Tensor = torch.Tensor

SOURCE = "acq"
LAUNCHES = 0        # float-form launches since the caller last set it to 0
LAUNCHES_MIXED = 0  # mixed-form launches, counted apart
_SIGNATURES = {
    "repro_fused_ei_grad": (_build.ptr,) * 12 + (_build.cint,) * 7
    + (_build.ptr,),
    "repro_fused_ei_grad_mixed": (_build.ptr,) * 14 + (_build.cint,) * 8
    + (_build.ptr,),
}
# csrc/acq.cu: a CTA of 128 threads owns ROWS candidate rows x 512 / ROWS
# columns of U (the compiled tile, kRows) and walks its k-slice in tiles of
# 32 rows, staged 4 deep.
WARPS, TILE_OUTPUTS, TK, STAGES = 4, 512, 32, 4
ROWS = 8
TARGET_CTAS = 512          # about 4 CTAs an SM on an H100's 132
MIN_SLICE_TILES = 4
MAX_SHARED = 232448 - 1024     # opt-in shared memory less the static part
# (device index, stream) -> (partials, counters), kept across calls.
_SCRATCH: dict[tuple[int, int], tuple[Tensor, Tensor]] = {}

# Variance clamp shared with `gp.posterior`: the fused gradient mirrors
# autodiff of this exact floor.
VAR_FLOOR = 1e-12
_SQRT5 = 2.23606797749979
_SQRT2 = 1.4142135623730951
_INV_SQRT_2PI = 0.3989422804014327


def _col(v: Tensor) -> Tensor:
    """Scalars with leading batch dims (...,) -> (..., 1, 1)."""
    return v[..., None, None]


def ei_grad_torch(x: Tensor, x_buf: Tensor, amask: Tensor, alpha: Tensor,
                  a_buf: Tensor, sigma2, rho, shift, xk: Tensor | None = None,
                  xbk: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Fused EI value + gradient in plain torch.

    x (..., r, d), x_buf (..., n, d), amask / alpha (..., n),
    a_buf (..., n, n); sigma2, rho, shift scalars or (...,) tensors.
    Mixed form: x / x_buf are the continuous blocks and xk (..., r, d) /
    xbk (..., n, d) the categorical blocks (`split_rows`).
    Returns (ei (..., r), grad (..., r, d)), the gradient with respect to x.
    """
    like = x_buf[..., 0, 0]
    sigma2, rho, shift = (_col(torch.as_tensor(v, dtype=x.dtype, device=x.device)
                               .expand_as(like)) for v in (sigma2, rho, shift))
    amask, alpha = amask[..., None, :], alpha[..., None, :]
    aa = torch.sum(x * x, dim=-1)[..., :, None]
    bb = torch.sum(x_buf * x_buf, dim=-1)[..., None, :]
    sq = torch.clamp(aa + bb - 2.0 * (x @ x_buf.transpose(-1, -2)), min=0.0)
    dist = torch.sqrt(sq + 1e-36)
    z = _SQRT5 * dist / rho
    ez = torch.exp(-z)
    k = sigma2 * (1.0 + z + z * z / 3.0) * ez
    if xk is not None:
        ak = torch.sum(xk * xk, dim=-1)[..., :, None]
        bk = torch.sum(xbk * xbk, dim=-1)[..., None, :]
        sqk = torch.clamp(ak + bk - 2.0 * (xk @ xbk.transpose(-1, -2)),
                          min=0.0)
        cat = torch.exp(-0.5 * sqk / rho)
        k = k * cat
    else:
        cat = 1.0
    km = k * amask                                             # (r, n)
    gam = km @ alpha.transpose(-1, -2) + shift                 # (r, 1)
    u = km @ a_buf                                             # (r, n)
    raw_var = sigma2 - torch.sum(u * km, dim=-1)[..., None]    # (r, 1)
    var = torch.clamp(raw_var, min=VAR_FLOOR)
    sig = torch.sqrt(var)
    zs = gam / torch.clamp(sig, min=1e-12)
    # erfc keeps Phi's lower tail: 1 + erf(z / sqrt2) cancels to 0 in
    # float32 below z ~ -5.5, which drops the mean term of the gradient.
    cdf = 0.5 * torch.erfc(-zs / _SQRT2)
    pdf = torch.exp(-0.5 * zs * zs) * _INV_SQRT_2PI
    ei = torch.clamp(gam * cdf + sig * pdf, min=0.0)           # (r, 1)
    # dEI/dvar = phi(Z) / 2 sigma, dead where the raw variance hit the
    # clamp (autodiff of the clamp routes no cotangent past the floor).
    dvar = torch.where(raw_var > VAR_FLOOR, pdf / (2.0 * sig),
                       torch.zeros_like(sig))
    c = cdf * (alpha * amask) - 2.0 * dvar * u                 # dEI/dK (r, n)
    s = (-sigma2 * (5.0 / (3.0 * rho * rho))) * (1.0 + z) * ez * cat
    w = c * s * amask                                          # (r, n)
    grad = torch.sum(w, dim=-1)[..., None] * x - w @ x_buf
    return ei[..., 0], grad


def split_rows(x: Tensor, x_buf: Tensor, cont_mask: Tensor,
               cat_mask: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The mixed form's operands (xc, xbc, xk, xbk) for `ei_grad_torch`;
    the masks are (d,), or (..., d) one pair a study."""
    cm, km = (ref.per_row(m.to(x.dtype)) for m in (cont_mask, cat_mask))
    return x * cm, x_buf * cm, x * km, x_buf * km


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call of `csrc/acq.cu` is cut: each CTA owns `rows` candidate
    rows x `cols` columns of U for one study and a slice of
    `tiles_per_slice` k-tiles of 32 rows."""
    rows: int                      # R, candidate rows per CTA
    cols: int                      # C = TILE_OUTPUTS / R, columns of U per CTA
    tiles_per_slice: int           # k-tiles a CTA walks
    slices: int                    # k-slices per column block
    grid: tuple[int, int, int]     # (slices x column blocks, row blocks, studies)
    shared_bytes: int              # dynamic shared memory of one CTA
    partial_floats: int            # scratch: every CTA's (R, 2 d + 4) sums
    counters: int                  # scratch: one int per (study, row block)


def shared_bytes(d: int, mixed: bool) -> int:
    """Dynamic shared memory of one CTA: `layout` in `csrc/acq.cu` (each
    block rounded up to 16 bytes).  Independent of n."""
    def r4(v):
        return -(-v // 4) * 4
    p = 2 * d + 4
    floats = (STAGES * TK * (TILE_OUTPUTS // ROWS) + STAGES * r4(TK * d)
              + STAGES * TK + ROWS * TK + r4(ROWS * d)
              + (r4(ROWS * d) + 2 * r4(d) if mixed else 0)
              + WARPS * 4 * p + ROWS * p)
    return 4 * floats


@functools.lru_cache(maxsize=256)
def launch_plan(batch: int, r: int, n: int, d: int, mixed: bool,
                plan_rows: int | None = None) -> LaunchPlan:
    """The tile, grid, shared bytes and scratch of one call on `batch`
    studies of r candidates against n train rows of width d: the single
    source of these numbers for the wrapper and the C entry.  k is split
    until one study's grid of `plan_rows` candidates (default r) has about
    `TARGET_CTAS` CTAs, with at least `MIN_SLICE_TILES` k-tiles a slice;
    the studies then lie along the grid's z axis.  The split is a function
    of (plan_rows, n, d) alone, so every output of a study is summed in the
    same order whatever the batch: a lane of an S-study launch is bit for
    bit the launch on that study alone.  A restart shard launches r of a
    study's R candidates with `plan_rows=R`: the k-split is the unsharded
    launch's, so each of its rows is summed as in that launch, and only
    the grid's row blocks and the scratch follow the local r."""
    if min(batch, r, n, d) < 1 or (plan_rows is not None and plan_rows < r):
        raise ValueError(f"fused EI launch plan needs batch, r, n, d >= 1 "
                         f"and plan_rows >= r, got {batch}, {r}, {n}, {d}, "
                         f"{plan_rows}")
    rows, cols = ROWS, TILE_OUTPUTS // ROWS
    col_blocks, row_blocks, k_tiles = -(-n // cols), -(-r // rows), -(-n // TK)
    if row_blocks > 65535 or batch > 65535:
        raise ValueError(f"fused EI kernel: r = {r} in tiles of {rows} rows and "
                         f"{batch} studies exceed the grid")
    plan_blocks = -(-(plan_rows or r) // rows)
    slices = min(-(-TARGET_CTAS // (col_blocks * plan_blocks)),
                 max(1, k_tiles // MIN_SLICE_TILES))
    tps = -(-k_tiles // slices)
    slices = -(-k_tiles // tps)          # no empty slice
    smem = shared_bytes(d, mixed)
    if smem > MAX_SHARED:
        raise ValueError(f"fused EI kernel: d = {d} needs {smem} bytes of "
                         f"shared memory, more than {MAX_SHARED}")
    grid = (slices * col_blocks, row_blocks, batch)
    return LaunchPlan(rows=rows, cols=cols, tiles_per_slice=tps, slices=slices,
                      grid=grid, shared_bytes=smem,
                      partial_floats=grid[0] * row_blocks * batch * rows * (2 * d + 4),
                      counters=row_blocks * batch)


def _scratch(dev: torch.device, stream: int, plan: LaunchPlan
             ) -> tuple[Tensor, Tensor]:
    """This device and stream's scratch (partials, counters), grown to the
    plan's size.  The counters are zeroed when they are allocated and the
    kernel leaves them 0, so calls in stream order share them."""
    key = (dev.index, stream)
    part, counters = _SCRATCH.get(key, (None, None))
    if part is None or part.numel() < plan.partial_floats:
        part = torch.empty(plan.partial_floats, dtype=torch.float32, device=dev)
    if counters is None or counters.numel() < plan.counters:
        counters = torch.zeros(plan.counters, dtype=torch.int32, device=dev)
    _SCRATCH[key] = (part, counters)
    return part, counters


def _scalar(v, lead: tuple, dev: torch.device) -> Tensor:
    """A per-study scalar operand as a contiguous float32 (*lead) tensor on
    `dev`: a device tensor of that shape is used as it is (no copy)."""
    if isinstance(v, Tensor) and v.device == dev:
        if v.dtype == torch.float32 and v.shape == lead and v.is_contiguous():
            return v
        return v.to(torch.float32).expand(lead).contiguous()
    if isinstance(v, Tensor):
        return v.to(dev, torch.float32).expand(lead).contiguous()
    return torch.full(lead, float(v), dtype=torch.float32, device=dev)


def _launch(entry: str, x: Tensor, x_buf: Tensor, amask: Tensor,
            alpha: Tensor, a_buf: Tensor, sigma2, rho, shift,
            masks: tuple[Tensor, ...], plan_rows: int | None = None
            ) -> tuple[tuple[Tensor, Tensor], bool]:
    """Check the operands and launch C entry `entry` (the masks, if any,
    go right after x_buf: (d,) for the batch, or (*lead, d) one pair a
    study, read at a step of d floats) on `launch_plan(..., plan_rows)`.
    Returns ((ei, grad), whether it launched)."""
    dev = x.device
    ops_ = (x, x_buf, amask, alpha, a_buf, *masks)
    for t in ops_:
        if t.device != dev or dev.type != "cuda":
            raise ValueError("fused EI kernel needs CUDA tensors on one device")
        if t.dtype != torch.float32:
            raise TypeError("fused EI kernel takes float32")
    lead = x_buf.shape[:-2]
    r, d = x.shape[-2:]
    n = x_buf.shape[-2]
    if (x.shape[:-2] != lead or x_buf.shape[-1] != d
            or amask.shape != (*lead, n) or alpha.shape != (*lead, n)
            or a_buf.shape != (*lead, n, n) or n < 1 or d < 1
            or any(m.shape not in ((d,), (*lead, d)) for m in masks)
            or len({m.shape for m in masks}) > 1):
        raise ValueError(
            f"fused EI kernel shapes: x {tuple(x.shape)}, x_buf "
            f"{tuple(x_buf.shape)}, amask {tuple(amask.shape)}, alpha "
            f"{tuple(alpha.shape)}, a_buf {tuple(a_buf.shape)}, masks "
            f"{[tuple(m.shape) for m in masks]}")
    batch = math.prod(lead)
    # ei and grad share one allocation (two contiguous views).
    out = torch.empty(batch * r * (d + 1), dtype=torch.float32, device=dev)
    ei = out[:batch * r].view(*lead, r)
    grad = out[batch * r:].view(*lead, r, d)
    if batch == 0 or r == 0:
        return (ei, grad), False
    plan = launch_plan(batch, r, n, d, bool(masks), plan_rows)
    lib = _build.load(SOURCE, _SIGNATURES)
    scal = [_scalar(v, lead, dev) for v in (sigma2, rho, shift)]
    x, x_buf, amask, alpha, a_buf, *masks = (t.contiguous() for t in ops_)
    mask_step = d if masks and masks[0].ndim > 1 else 0
    # The current stream's handle, without building a Python Stream object
    # (the public `torch.cuda.current_stream(dev)` costs several us a call).
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    part, counters = _scratch(dev, stream, plan)
    status = getattr(lib, entry)(
        x.data_ptr(), x_buf.data_ptr(), *(m.data_ptr() for m in masks),
        amask.data_ptr(), alpha.data_ptr(), a_buf.data_ptr(),
        *(s.data_ptr() for s in scal), ei.data_ptr(), grad.data_ptr(),
        part.data_ptr(), counters.data_ptr(), batch, r, n, d, plan.rows,
        plan.tiles_per_slice, plan.shared_bytes,
        *((mask_step,) if masks else ()), stream)
    _build.check(lib, status, entry)
    return (ei, grad), True


def fused_ei_grad_cuda(x: Tensor, x_buf: Tensor, amask: Tensor, alpha: Tensor,
                       a_buf: Tensor, sigma2, rho, shift, *,
                       plan_rows: int | None = None) -> tuple[Tensor, Tensor]:
    """Launch the float form; shapes as `ei_grad_torch`, float32 CUDA;
    `plan_rows` as `launch_plan`'s (a restart shard's full R)."""
    global LAUNCHES
    out, launched = _launch("repro_fused_ei_grad", x, x_buf, amask, alpha,
                            a_buf, sigma2, rho, shift, (), plan_rows)
    LAUNCHES += launched
    return out


def fused_ei_grad_mixed_cuda(x: Tensor, x_buf: Tensor, amask: Tensor,
                             alpha: Tensor, a_buf: Tensor, sigma2, rho, shift,
                             cont_mask: Tensor, cat_mask: Tensor, *,
                             plan_rows: int | None = None
                             ) -> tuple[Tensor, Tensor]:
    """Launch the mixed form on the unsplit x (r, d) / x_buf (n, d) and the
    type masks, (d,) or (*lead, d); float32 CUDA.  Computes `ei_grad_torch`
    of `split_rows(x, x_buf, cont_mask, cat_mask)`; `plan_rows` as in the
    float form."""
    global LAUNCHES_MIXED
    out, launched = _launch("repro_fused_ei_grad_mixed", x, x_buf, amask,
                            alpha, a_buf, sigma2, rho, shift,
                            (cont_mask, cat_mask), plan_rows)
    LAUNCHES_MIXED += launched
    return out


def fused_ei_grad(x: Tensor, x_buf: Tensor, amask: Tensor, alpha: Tensor,
                  a_buf: Tensor, sigma2, rho, shift, *,
                  cont_mask: Tensor | None = None,
                  cat_mask: Tensor | None = None,
                  plan_rows: int | None = None) -> tuple[Tensor, Tensor]:
    """Fused EI value + gradient: a kernel for CUDA tensors, the plain
    version for CPU tensors; the mixed form when the type masks are given.
    `plan_rows` is the unsharded candidate count of a restart shard's
    launch (`launch_plan`); the plain version does not use it."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no fused EI for device {x.device}")
    if cont_mask is None:
        if x.device.type == "cuda":
            return fused_ei_grad_cuda(x, x_buf, amask, alpha, a_buf, sigma2,
                                      rho, shift, plan_rows=plan_rows)
        return ei_grad_torch(x, x_buf, amask, alpha, a_buf, sigma2, rho, shift)
    if x.device.type == "cuda":
        return fused_ei_grad_mixed_cuda(x, x_buf, amask, alpha, a_buf, sigma2,
                                        rho, shift, cont_mask.to(x.dtype),
                                        cat_mask.to(x.dtype),
                                        plan_rows=plan_rows)
    xc, xbc, xk, xbk = split_rows(x, x_buf, cont_mask, cat_mask)
    return ei_grad_torch(xc, xbc, amask, alpha, a_buf, sigma2, rho, shift,
                         xk=xk, xbk=xbk)
