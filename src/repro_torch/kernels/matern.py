"""Matérn-2.5 covariance build: `csrc/matern.cu` on the card.

Counterpart of `repro/kernels/matern.py`, with the study axis the
reference gets from `pallas_call`'s batching rule.  `matern52_gram` is an
`autograd.Function`: its forward launches the CUDA kernel for a CUDA tensor
and runs the plain version (`ref.matern52_gram`) for a CPU tensor; its
backward is the analytic Matérn-2.5 gradient in plain torch, as the
reference's `_matern_bwd` is plain jnp, over the batch axis as the
reference's custom VJP vmaps:

    k = sigma2 g(z) e^{-z},  z = sqrt5 |x - y| / rho,  g = 1 + z + z^2/3
    dk/dx_i = -sigma2 (5 / 3 rho^2) e^{-z} (1 + z) (x_i - y_j)

(the apparent 1/|x - y| singularity cancels analytically).  `masked_gram`
is the identity-padded K + noise2 I of a refactor or a lag event, one
launch of the kernel's masked form on the card.

Operands: x (n, d) or (B, n, d), y (m, d) or (B, m, d), sigma2 and rho
scalars or (B,); the result is (n, m) when nothing is batched, else
(B, n, m).  The kernel reads x and y through their strides, so an
expanded buffer (`x_buf.expand(G, n, d)`, batch stride 0) is never
copied: a batch that shares x computes each distance once for all its
matrices.  The shared pieces of both gram wrappers (`launch_plan`,
`launch`) live here; `mixed.py` adds its masks, (d,) for the batch or
(B, d), one pair a matrix.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.kernels import _build, ref

Tensor = torch.Tensor

SOURCE = "matern"
LAUNCHES = 0      # kernel launches since the caller last set it to 0
_GEOMETRY = ((_build.cint,) * 4 + (_build.clonglong,) * 4
             + (_build.cint,) * 11 + (_build.ptr,))
_SIGNATURES = {"repro_matern52_gram": (_build.ptr,) * 7 + _GEOMETRY}

# csrc/gram.cuh: a CTA of 256 threads owns a TILE x TILE tile; the column
# layout takes COL_THREADS rows of x a CTA for y of at most COL_MAX_M rows.
TILE = 64
THREADS = 256
COL_THREADS = 128
COL_MAX_M = 8
TARGET_CTAS = 1056         # about 8 CTAs an SM on an H100's 132
MAX_GRID_Y = 65535
MAX_GRID_X = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class GramPlan:
    """How one call of the gram kernel is cut."""
    layout: str                # "tile" (64 x 64 tiles) or "column"
    tiles_n: int               # tile rows and columns of one matrix
    tiles_m: int
    symmetric: bool            # tile layout: lower tile pairs + mirrors
    per_group: int             # matrices a CTA stores
    grid: tuple[int, int]      # (tile pairs or row blocks, batch groups)
    threads: int


@functools.lru_cache(maxsize=256)
def launch_plan(n: int, m: int, d: int, batch: int, symmetric: bool,
                shared_x: bool) -> GramPlan:
    """Tile, grid and layout of one call on `batch` (n, d) x (m, d) Grams:
    the single source of the geometry for the wrapper and the C entry.
    `symmetric`: y is x (n == m), so only tile pairs bi >= bj run and each
    off-diagonal tile also stores its mirror.  `shared_x`: x and y are one
    buffer for the whole batch, so a CTA stores a group of matrices from
    one set of distances, with groups sized to fill about `TARGET_CTAS`.
    y of at most `COL_MAX_M` rows takes the column layout."""
    if min(n, m, batch) < 1 or d < 0:
        raise ValueError(f"gram launch plan needs n, m, batch >= 1 and "
                         f"d >= 0, got {n}, {m}, {batch}, {d}")
    if symmetric and n != m:
        raise ValueError(f"a symmetric gram is square, got {n} x {m}")
    tiles_n, tiles_m = -(-n // TILE), -(-m // TILE)
    if m <= COL_MAX_M:
        layout, threads, grid_x = "column", COL_THREADS, -(-n // COL_THREADS)
    else:
        layout, threads = "tile", THREADS
        grid_x = (tiles_n * (tiles_n + 1) // 2 if symmetric
                  else tiles_n * tiles_m)
    if grid_x > MAX_GRID_X:
        raise ValueError(f"gram kernel: {n} x {m} exceeds the grid")
    per_group = 1
    if shared_x:
        groups = min(batch, max(1, -(-TARGET_CTAS // grid_x)))
        per_group = -(-batch // groups)
    groups = -(-batch // per_group)
    if groups > MAX_GRID_Y:
        raise ValueError(f"gram kernel: a batch of {batch} distinct x "
                         f"exceeds the grid ({MAX_GRID_Y})")
    return GramPlan(layout=layout, tiles_n=tiles_n, tiles_m=tiles_m,
                    symmetric=symmetric and layout == "tile",
                    per_group=per_group, grid=(grid_x, groups),
                    threads=threads)


def tile_pair(plan: GramPlan, p: int) -> tuple[int, int]:
    """(bi, bj) of the tile-layout CTA with blockIdx.x = p, as the kernel
    decodes it: row-major over the lower triangle when symmetric, over
    every tile otherwise."""
    if not plan.symmetric:
        return divmod(p, plan.tiles_m)
    bi = int((math.sqrt(8.0 * p + 1.0) - 1.0) * 0.5)
    while bi > 0 and bi * (bi + 1) // 2 > p:
        bi -= 1
    while (bi + 1) * (bi + 2) // 2 <= p:
        bi += 1
    return bi, p - bi * (bi + 1) // 2


def scalar_on(v, like: Tensor) -> Tensor:
    """`v` as a tensor of `like`'s dtype and device (the same tensor, with
    no copy, when it already is one; strides kept)."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _per_matrix(v, dev: torch.device, dtype: torch.dtype, name: str
                ) -> tuple[Tensor, int, int]:
    """A per-matrix operand as (device tensor, batch length or 0, element
    step): a 0-d tensor or a length-1 vector is one value for every matrix
    (step 0); a (B,) vector is read through its stride, with no copy when
    it already has `dtype`."""
    v = torch.as_tensor(v, dtype=dtype, device=dev)
    if v.ndim > 1:
        raise ValueError(f"gram kernel: {name} must be a scalar or (B,), got "
                         f"{tuple(v.shape)}")
    length = v.shape[0] if v.ndim == 1 else 0
    return v, length, (v.stride(0) if length > 1 else 0)


def _layout(t: Tensor, name: str) -> tuple[int, int]:
    """(row stride, batch stride) of a (rows, d) or (B, rows, d) operand;
    raises unless each row's features are contiguous."""
    if t.ndim not in (2, 3):
        raise ValueError(f"gram kernel: {name} must be (rows, d) or "
                         f"(B, rows, d), got {tuple(t.shape)}")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"gram kernel: {name}'s features must be contiguous, "
                         f"got strides {t.stride()}")
    return t.stride(-2), (t.stride(0) if t.ndim == 3 and t.shape[0] > 1 else 0)


def launch(lib_name: str, signatures: dict, entry: str, x: Tensor, y: Tensor,
           sigma2, rho, masks: tuple[Tensor, ...] = (), noise2=None,
           n_active=None) -> tuple[Tensor, bool]:
    """Check the operands of one gram call and launch C entry `entry` of
    library `lib_name` (the masks, (d,) or (B, d), and their step go right
    after y).  `noise2` selects the masked form, with `n_active` an int or
    a (B,) int tensor.  Returns (out, whether it launched)."""
    dev = x.device
    tensors = (x, y, *masks)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"gram kernel needs CUDA tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"gram kernel takes float32, got "
                        f"{[t.dtype for t in tensors]}")
    (x_row, x_batch), (y_row, y_batch) = _layout(x, "x"), _layout(y, "y")
    n, d = x.shape[-2:]
    m = y.shape[-2]
    if y.shape[-1] != d or any(k.shape[-1:] != (d,) or k.ndim > 2
                               or k.shape != masks[0].shape for k in masks):
        raise ValueError(f"gram kernel takes (.., n, d) x (.., m, d) with (d,) "
                         f"or (B, d) masks, got "
                         f"{[tuple(t.shape) for t in tensors]}")
    masks = [k.contiguous() for k in masks]
    # Masks per matrix: a (B, d) pair read at a step of d floats (one matrix
    # a CTA); a (d,) or (1, d) pair is shared by the batch (step 0).
    mask_rows = masks[0].shape[0] if masks and masks[0].ndim == 2 else 0
    mask_step = d if mask_rows > 1 else 0
    per = [_per_matrix(sigma2, dev, torch.float32, "sigma2"),
           _per_matrix(rho, dev, torch.float32, "rho")]
    masked = noise2 is not None
    n_fixed, n_per = n, (None, 0, 0)
    if masked:
        per.append(_per_matrix(noise2, dev, torch.float32, "noise2"))
        if isinstance(n_active, Tensor):
            n_per = _per_matrix(n_active, dev, torch.int32, "n")
        else:
            n_fixed = int(n_active)
    lengths = ({t.shape[0] for t in (x, y) if t.ndim == 3}
               | {length for _, length, _ in (*per, n_per)} | {mask_rows}) \
        - {0, 1}
    if len(lengths) > 1:
        raise ValueError(f"gram kernel: batch lengths {sorted(lengths)} differ")
    batch = lengths.pop() if lengths else 1
    batched = x.ndim == 3 or y.ndim == 3 or mask_rows > 0 or any(
        v is not None and v.ndim == 1 for v, _, _ in (*per, n_per))
    out = torch.empty((batch, n, m) if batched else (n, m), dtype=torch.float32,
                      device=dev)
    if n == 0 or m == 0 or batch == 0:
        return out, False
    symmetric = (x.data_ptr() == y.data_ptr() and n == m and x_row == y_row
                 and x_batch == y_batch)
    plan = launch_plan(n, m, d, batch, symmetric,
                       x_batch == 0 and y_batch == 0 and mask_step == 0)
    (s2, _, s2_step), (rh, _, rho_step) = per[:2]
    noise, _, noise_step = per[2] if masked else (None, 0, 0)
    n_t, _, n_step = n_per
    lib = _build.load(lib_name, signatures)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    status = getattr(lib, entry)(
        x.data_ptr(), y.data_ptr(), *(k.data_ptr() for k in masks),
        *((mask_step,) if masks else ()), s2.data_ptr(), rh.data_ptr(),
        None if noise is None else noise.data_ptr(),
        None if n_t is None else n_t.data_ptr(), out.data_ptr(),
        batch, n, m, d, x_row, x_batch, y_row, y_batch, s2_step, rho_step,
        noise_step, n_step, n_fixed, int(plan.symmetric),
        0 if plan.layout == "tile" else 1, plan.per_group, plan.tiles_m,
        plan.grid[0], plan.grid[1], stream)
    _build.check(lib, status, entry)
    return out, True


def matern52_gram_cuda(x: Tensor, y: Tensor, sigma2, rho) -> Tensor:
    """Launch the kernel: x (n, d) or (B, n, d), y (m, d) or (B, m, d),
    float32 CUDA, sigma2 / rho scalars or (B,) -> (n, m) or (B, n, m)."""
    global LAUNCHES
    out, launched = launch(SOURCE, _SIGNATURES, "repro_matern52_gram", x, y,
                           sigma2, rho)
    LAUNCHES += launched
    return out


def masked_gram_cuda(x_buf: Tensor, n, sigma2, rho, noise2) -> Tensor:
    """Launch the masked form on x_buf (n_max, d) or (B, n_max, d): the
    identity-padded K + noise2 I with n an int or a (B,) int tensor, and
    sigma2 / rho / noise2 scalars or (B,)."""
    global LAUNCHES
    out, launched = launch(SOURCE, _SIGNATURES, "repro_matern52_gram", x_buf,
                           x_buf, sigma2, rho, noise2=noise2, n_active=n)
    LAUNCHES += launched
    return out


def _gram(x: Tensor, y: Tensor, sigma2: Tensor, rho: Tensor) -> Tensor:
    if x.device.type == "cuda":
        return matern52_gram_cuda(x, y, sigma2, rho)
    if x.device.type == "cpu":
        return ref.matern52_gram(x, y, sigma2, rho)
    raise ValueError(f"no matern52 gram for device {x.device}")


def wants_grad(*vs) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(v, Tensor) and v.requires_grad for v in vs)


def reduce_to(g: Tensor, like: Tensor) -> Tensor:
    """The gradient of a broadcast operand: `g` summed to `like`'s shape."""
    return g.sum_to_size(like.shape).to(like.dtype)


class _Matern52Gram(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, y, sigma2, rho):
        ctx.save_for_backward(x, y, sigma2, rho)
        return _gram(x, y, sigma2, rho)

    @staticmethod
    def backward(ctx, g):
        x, y, sigma2, rho = ctx.saved_tensors
        x32, y32, g32 = x.float(), y.float(), g.float()
        sig, rho32 = ref.per_matrix(sigma2.float()), ref.per_matrix(rho.float())
        xx = torch.sum(x32 * x32, dim=-1)[..., :, None]
        yy = torch.sum(y32 * y32, dim=-1)[..., None, :]
        sq = torch.clamp(xx + yy - 2.0 * (x32 @ y32.transpose(-1, -2)), min=0.0)
        dist = torch.sqrt(sq + 1e-36)
        z = ref.SQRT5 * dist / rho32
        ez = torch.exp(-z)
        poly = 1.0 + z + z * z / 3.0
        dsigma2 = torch.sum(g32 * poly * ez, dim=(-2, -1))
        # dk/dz = -sigma2 e^{-z} z (1 + z) / 3 ;  dz/drho = -z / rho
        drho = torch.sum(g32 * sig * ez * z * z * (1.0 + z) / (3.0 * rho32),
                         dim=(-2, -1))
        # s_ij = g_ij dk_ij/d(x_i - y_j) / (x_i - y_j): the d-cancelled factor
        s = -g32 * sig * ez * (1.0 + z) * (5.0 / (3.0 * rho32 * rho32))
        dx = torch.sum(s, dim=-1)[..., None] * x32 - s @ y32
        dy = torch.sum(s, dim=-2)[..., None] * y32 - s.transpose(-1, -2) @ x32
        return (reduce_to(dx, x), reduce_to(dy, y), reduce_to(dsigma2, sigma2),
                reduce_to(drho, rho))


def matern52_gram(x: Tensor, y: Tensor, sigma2, rho) -> Tensor:
    """(.., n, d) x (.., m, d) Matérn-2.5 covariance under scalar or (B,)
    sigma2 / rho; differentiable in x, y, sigma2 and rho through the
    analytic backward above."""
    return _Matern52Gram.apply(x, y, scalar_on(sigma2, x), scalar_on(rho, x))


def masked_gram(x_buf: Tensor, n, sigma2, rho, noise2) -> Tensor:
    """Identity-padded K + noise2 I over x_buf (n_max, d) or (B, n_max, d):
    rows and columns at or past n (an int or a (B,) int tensor) are the
    identity.  One launch on the card; on the CPU, or where a gradient is
    asked for, the gram above padded by `ref.pad_identity`."""
    if x_buf.device.type == "cuda" and not wants_grad(x_buf, sigma2, rho,
                                                      noise2):
        return masked_gram_cuda(x_buf, n, sigma2, rho, noise2)
    return ref.pad_identity(matern52_gram(x_buf, x_buf, sigma2, rho), n,
                            noise2)
