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

On the card a call is one launch: each CTA owns a tile of R candidate rows
x 512 / R columns of U (R = 4, 8 or 16) and a slice of k for one study
(`launch_plan`).  With k split, the slices of a column block meet in
scratch and the last to arrive adds their partial U in slice order, so
that every column sum is taken of the whole U, as the reference's one dot
gives it; that CTA writes the block's row sums to scratch, and the last
CTA of each row block sums them in a fixed order and finishes the rows.  The
tile and the k-split are the call's `AcqTileConfig` (`acq_tile_config`):
the plan raced off line on the card for (R of the unsharded launch, n, d,
form) and committed in `acq_plans.json` (`tune_acq`), or the R = 8
heuristic for a key the table lacks.  The scratch (row sums, partial U
tiles and the ticket counters) is kept per device and stream and grows as
needed; the kernel leaves the counters at 0, so a call allocates nothing
but its outputs.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import json
import math
import os
from pathlib import Path

import torch

from repro_torch.kernels import _build, ref

Tensor = torch.Tensor

SOURCE = "acq"
LAUNCHES = 0        # float-form launches since the caller last set it to 0
LAUNCHES_MIXED = 0  # mixed-form launches, counted apart
_SIGNATURES = {
    "repro_fused_ei_grad": (_build.ptr,) * 13 + (_build.cint,) * 7
    + (_build.ptr,),
    "repro_fused_ei_grad_mixed": (_build.ptr,) * 15 + (_build.cint,) * 8
    + (_build.ptr,),
}
# csrc/acq.cu: a CTA of 128 threads owns R candidate rows x 512 / R
# columns of U (R one of COMPILED_ROWS) and walks its k-slice in tiles of
# 32 rows, staged 4 deep.
WARPS, TILE_OUTPUTS, TK, STAGES = 4, 512, 32, 4
COMPILED_ROWS = (4, 8, 16)
ROWS = 8                   # the heuristic's R
TARGET_CTAS = 512          # about 4 CTAs an SM on an H100's 132
MIN_SLICE_TILES = 4
MAX_SHARED = 232448 - 1024     # opt-in shared memory less the static part
# The committed plan table (`python -m repro_torch.kernels.tune_acq`).
PLANS_PATH = Path(__file__).with_name("acq_plans.json")
MISSES = 0          # CUDA launches on the heuristic plan: the key was not
# in the table and no race ran (counted apart from LAUNCHES)
# CUDA launches that looked their plan up, by (plan_rows, n, d, form,
# studies): the traffic `tune_acq` weights its race by.
KEY_LAUNCHES: collections.Counter = collections.Counter()
# (device index, stream) -> (partials, U tiles, counters), kept across calls.
_SCRATCH: dict[tuple[int, int], tuple[Tensor, Tensor, Tensor]] = {}

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
    partial_floats: int            # scratch: (R, 2 d + 4) sums a column block
    u_floats: int                  # scratch: every CTA's R x C partial U, if
    # k is split (else 0)
    counters: int                  # scratch: one int per (study, row block),
    # and one per (study, row block, column block) if k is split


@dataclasses.dataclass(frozen=True)
class AcqTileConfig:
    """The tile and k-split of a fused-EI call (`launch_plan`): `rows`
    candidate rows a CTA (one of COMPILED_ROWS; 512 / rows columns of U)
    and `tiles_per_slice` k-tiles of 32 rows a k-slice.  `measured` tells
    a raced plan (the committed table's, or an injected `measure_fn`'s)
    from the heuristic."""
    rows: int
    tiles_per_slice: int
    measured: bool


# Cache key: (plan_rows, n, d, mixed).  Lifecycle = process lifetime; every
# key a process resolves with autotuning on is kept here (raced, tabled or
# heuristic).  Tests reset it directly.
_ACQ_TUNE_CACHE: dict[tuple, AcqTileConfig] = {}
_TABLE: dict[tuple, AcqTileConfig] | None = None


def next_power_of_2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def _acq_autotune_enabled() -> bool:
    """`REPRO_ACQ_AUTOTUNE=off|0|false` pins the heuristic config (and
    bypasses the cache and the table entirely), read at every call."""
    return os.environ.get("REPRO_ACQ_AUTOTUNE", "on").strip().lower() \
        not in ("off", "0", "false")


def heuristic_config(plan_rows: int, n: int) -> AcqTileConfig:
    """R = 8, and k split until one study's grid of `plan_rows` candidates
    has about `TARGET_CTAS` CTAs, with at least `MIN_SLICE_TILES` k-tiles
    a slice."""
    col_blocks = -(-n // (TILE_OUTPUTS // ROWS))
    k_tiles, plan_blocks = -(-n // TK), -(-plan_rows // ROWS)
    slices = min(-(-TARGET_CTAS // (col_blocks * plan_blocks)),
                 max(1, k_tiles // MIN_SLICE_TILES))
    return AcqTileConfig(rows=ROWS, tiles_per_slice=-(-k_tiles // slices),
                         measured=False)


def candidates(plan_rows: int, n: int, d: int, mixed: bool
               ) -> list[AcqTileConfig]:
    """The plans a race tries for a key, the heuristic first: every
    compiled R whose shared memory fits, times 1 to k_tiles /
    `MIN_SLICE_TILES` k-slices (as k-tiles a slice, each split once)."""
    heur = heuristic_config(plan_rows, n)
    k_tiles = -(-n // TK)
    out = [(heur.rows, heur.tiles_per_slice)]
    for rows in COMPILED_ROWS:
        if shared_bytes(d, mixed, rows) > MAX_SHARED:
            continue
        for slices in range(1, max(1, k_tiles // MIN_SLICE_TILES) + 1):
            if (rows, -(-k_tiles // slices)) not in out:
                out.append((rows, -(-k_tiles // slices)))
    return [AcqTileConfig(rows, tps, measured=True) for rows, tps in out]


def _table() -> dict[tuple, AcqTileConfig]:
    """The committed plans by (plan_rows, n, d, mixed), read once."""
    global _TABLE
    if _TABLE is None:
        table = {}
        for e in json.loads(PLANS_PATH.read_text())["entries"]:
            if e["rows"] not in COMPILED_ROWS or e["tiles_per_slice"] < 1:
                raise ValueError(f"{PLANS_PATH.name}: plan {e} is not one "
                                 f"the kernel takes")
            table[(e["plan_rows"], e["n"], e["d"], e["form"] == "mixed")] = \
                AcqTileConfig(e["rows"], e["tiles_per_slice"], measured=True)
        _TABLE = table
    return _TABLE


def acq_tile_config(plan_rows: int, n: int, d: int, mixed: bool, *,
                    measure_fn=None) -> AcqTileConfig:
    """The fused EI's tile and k-split for a `(plan_rows, n, d, mixed)` key:
    the counterpart of `repro/kernels/ops.py:acq_tile_config`.

    In order: `REPRO_ACQ_AUTOTUNE=off|0|false` gives `heuristic_config`
    and touches no cache; a key already resolved in this process gives
    its cached config; an injected `measure_fn(config, plan_rows, n, d,
    mixed) -> seconds` races `candidates` once (the smallest time wins,
    the heuristic on a tie); otherwise the committed table
    (`acq_plans.json`, raced off line on the card by `tune_acq`) gives
    the key's plan, and a key it lacks the heuristic.  `measure_fn` is
    the reference's hook, kept for the tests that mirror its autotuner
    tests: a serving or training process must not inject it, since a plan
    drawn from one process's timings breaks the bit contracts below.

    The key holds no study count: a lane of an S-study launch takes the
    one-study plan, so its bits are the one-study launch's.  `plan_rows`
    is the unsharded launch's R, so a restart shard reads the plan of the
    launch it is cut from.  The reference keys on (n_pad, d, S,
    substrate) and also picks `d_pad` and a 128-row default: those are
    the TPU's lane width and matrix unit, with no counterpart here (the
    kernel reads rows of d floats, and its tiles are 4-16 rows)."""
    if not _acq_autotune_enabled():
        return heuristic_config(plan_rows, n)
    key = (plan_rows, n, d, bool(mixed))
    hit = _ACQ_TUNE_CACHE.get(key)
    if hit is not None:
        return hit
    if measure_fn is not None:
        best, best_t = None, math.inf
        for cfg in candidates(*key):
            t = measure_fn(cfg, *key)
            if t < best_t:
                best, best_t = cfg, t
        cfg = best
    else:
        cfg = _table().get(key) or heuristic_config(plan_rows, n)
    _ACQ_TUNE_CACHE[key] = cfg
    return cfg


def shared_bytes(d: int, mixed: bool, rows: int = ROWS) -> int:
    """Dynamic shared memory of one CTA of the R = `rows` tile: `layout` in
    `csrc/acq.cu` (each block rounded up to 16 bytes).  Independent of n."""
    def r4(v):
        return -(-v // 4) * 4
    p = 2 * d + 4
    floats = (STAGES * TK * (TILE_OUTPUTS // rows) + STAGES * r4(TK * d)
              + STAGES * TK + rows * TK + r4(rows * d)
              + (r4(rows * d) + 2 * r4(d) if mixed else 0)
              + WARPS * 4 * p + rows * p)
    return 4 * floats


@functools.lru_cache(maxsize=256)
def launch_plan(batch: int, r: int, n: int, d: int, mixed: bool,
                plan_rows: int | None = None,
                config: AcqTileConfig | None = None) -> LaunchPlan:
    """The tile, grid, shared bytes and scratch of one call on `batch`
    studies of r candidates against n train rows of width d: the single
    source of these numbers for the wrapper and the C entry.  The tile and
    the k-tiles a slice are `config`'s (default: `heuristic_config` of
    `plan_rows`, default r); the studies lie along the grid's z axis.  The
    split is a function of (config, n) alone, so every output of a study
    is summed in the same order whatever the batch: a lane of an S-study
    launch is bit for bit the launch on that study alone.  A restart shard
    launches r of a study's R candidates with `plan_rows=R` (and R's
    config): the k-split is the unsharded launch's, so each of its rows is
    summed as in that launch, and only the grid's row blocks and the
    scratch follow the local r.  This is the single source of the scratch
    sizes: the row sums of each (study, row block, column block), and,
    when k is split, each CTA's partial U tile and a ticket counter per
    (study, row block, column block) after those of the row blocks."""
    if min(batch, r, n, d) < 1 or (plan_rows is not None and plan_rows < r):
        raise ValueError(f"fused EI launch plan needs batch, r, n, d >= 1 "
                         f"and plan_rows >= r, got {batch}, {r}, {n}, {d}, "
                         f"{plan_rows}")
    cfg = config or heuristic_config(plan_rows or r, n)
    if cfg.rows not in COMPILED_ROWS or cfg.tiles_per_slice < 1:
        raise ValueError(f"fused EI kernel: R = {cfg.rows} (compiled: "
                         f"{COMPILED_ROWS}), {cfg.tiles_per_slice} k-tiles "
                         f"a slice")
    rows, cols = cfg.rows, TILE_OUTPUTS // cfg.rows
    col_blocks, row_blocks, k_tiles = -(-n // cols), -(-r // rows), -(-n // TK)
    if row_blocks > 65535 or batch > 65535:
        raise ValueError(f"fused EI kernel: r = {r} in tiles of {rows} rows and "
                         f"{batch} studies exceed the grid")
    tps = cfg.tiles_per_slice
    slices = -(-k_tiles // tps)          # no empty slice
    smem = shared_bytes(d, mixed, rows)
    if smem > MAX_SHARED:
        raise ValueError(f"fused EI kernel: d = {d} needs {smem} bytes of "
                         f"shared memory at R = {rows}, more than {MAX_SHARED}")
    grid = (slices * col_blocks, row_blocks, batch)
    blocks = col_blocks * row_blocks * batch
    split = slices > 1
    return LaunchPlan(rows=rows, cols=cols, tiles_per_slice=tps, slices=slices,
                      grid=grid, shared_bytes=smem,
                      partial_floats=blocks * rows * (2 * d + 4),
                      u_floats=split * slices * blocks * TILE_OUTPUTS,
                      counters=row_blocks * batch + split * blocks)


def call_plan(batch: int, r: int, n: int, d: int, mixed: bool,
              plan_rows: int | None = None) -> LaunchPlan:
    """The plan a CUDA call of these shapes takes: `launch_plan` under
    `acq_tile_config` of its key."""
    return launch_plan(batch, r, n, d, mixed, plan_rows, acq_tile_config(
        plan_rows or r, n, d, mixed))


def _scratch(dev: torch.device, stream: int, plan: LaunchPlan
             ) -> tuple[Tensor, Tensor, Tensor]:
    """This device and stream's scratch (row sums, U tiles, counters),
    grown to the plan's size.  The counters are zeroed when they are
    allocated and the kernel leaves them 0, so calls in stream order share
    them."""
    key = (dev.index, stream)
    part, utile, counters = _SCRATCH.get(key, (None, None, None))
    if part is None or part.numel() < plan.partial_floats:
        part = torch.empty(plan.partial_floats, dtype=torch.float32, device=dev)
    if utile is None or utile.numel() < max(plan.u_floats, 1):
        utile = torch.empty(max(plan.u_floats, 1), dtype=torch.float32,
                            device=dev)
    if counters is None or counters.numel() < plan.counters:
        counters = torch.zeros(plan.counters, dtype=torch.int32, device=dev)
    _SCRATCH[key] = (part, utile, counters)
    return part, utile, counters


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
            masks: tuple[Tensor, ...], plan_rows: int | None = None,
            config: AcqTileConfig | None = None
            ) -> tuple[tuple[Tensor, Tensor], bool]:
    """Check the operands and launch C entry `entry` (the masks, if any,
    go right after x_buf: (d,) for the batch, or (*lead, d) one pair a
    study, read at a step of d floats) on `launch_plan(..., plan_rows,
    config)`, the config by default `acq_tile_config` of the call's key
    (a heuristic one counts in MISSES; the key and study count in
    KEY_LAUNCHES).  Returns ((ei, grad), whether it
    launched)."""
    global MISSES
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
    if config is None:
        config = acq_tile_config(plan_rows or r, n, d, bool(masks))
        MISSES += not config.measured
        KEY_LAUNCHES[(plan_rows or r, n, d, "mixed" if masks else "float",
                      batch)] += 1
    plan = launch_plan(batch, r, n, d, bool(masks), plan_rows, config)
    lib = _build.load(SOURCE, _SIGNATURES)
    scal = [_scalar(v, lead, dev) for v in (sigma2, rho, shift)]
    x, x_buf, amask, alpha, a_buf, *masks = (t.contiguous() for t in ops_)
    mask_step = d if masks and masks[0].ndim > 1 else 0
    # The current stream's handle, without building a Python Stream object
    # (the public `torch.cuda.current_stream(dev)` costs several us a call).
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    part, utile, counters = _scratch(dev, stream, plan)
    status = getattr(lib, entry)(
        x.data_ptr(), x_buf.data_ptr(), *(m.data_ptr() for m in masks),
        amask.data_ptr(), alpha.data_ptr(), a_buf.data_ptr(),
        *(s.data_ptr() for s in scal), ei.data_ptr(), grad.data_ptr(),
        part.data_ptr(), utile.data_ptr(), counters.data_ptr(), batch, r, n,
        d, plan.rows, plan.tiles_per_slice, plan.shared_bytes,
        *((mask_step,) if masks else ()), stream)
    _build.check(lib, status, entry)
    return (ei, grad), True


def fused_ei_grad_cuda(x: Tensor, x_buf: Tensor, amask: Tensor, alpha: Tensor,
                       a_buf: Tensor, sigma2, rho, shift, *,
                       plan_rows: int | None = None,
                       config: AcqTileConfig | None = None
                       ) -> tuple[Tensor, Tensor]:
    """Launch the float form; shapes as `ei_grad_torch`, float32 CUDA;
    `plan_rows` as `launch_plan`'s (a restart shard's full R); `config`
    overrides the key's `acq_tile_config` (the tuner's race)."""
    global LAUNCHES
    out, launched = _launch("repro_fused_ei_grad", x, x_buf, amask, alpha,
                            a_buf, sigma2, rho, shift, (), plan_rows, config)
    LAUNCHES += launched
    return out


def fused_ei_grad_mixed_cuda(x: Tensor, x_buf: Tensor, amask: Tensor,
                             alpha: Tensor, a_buf: Tensor, sigma2, rho, shift,
                             cont_mask: Tensor, cat_mask: Tensor, *,
                             plan_rows: int | None = None,
                             config: AcqTileConfig | None = None
                             ) -> tuple[Tensor, Tensor]:
    """Launch the mixed form on the unsplit x (r, d) / x_buf (n, d) and the
    type masks, (d,) or (*lead, d); float32 CUDA.  Computes `ei_grad_torch`
    of `split_rows(x, x_buf, cont_mask, cat_mask)`; `plan_rows` and
    `config` as in the float form."""
    global LAUNCHES_MIXED
    out, launched = _launch("repro_fused_ei_grad_mixed", x, x_buf, amask,
                            alpha, a_buf, sigma2, rho, shift,
                            (cont_mask, cat_mask), plan_rows, config)
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
    launch (`launch_plan`); the plain version does not use it, nor the
    tile config."""
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
