"""Blocked triangular solves: `csrc/trsv.cu` on the card.

Counterpart of `repro/kernels/trsv.py`.  `trsv(l, b, trans=...)` solves
L q = b or L^T q = b for a lower-triangular L (..., n, n) and b (..., n, r),
with optional leading batch dimensions (the kernel's blockIdx.z).  It is an
`autograd.Function` with the reference's textbook VJP (`_trsv_bwd`), whose
backward solve reruns the same kernel with `trans` flipped:

    q = L^{-1} b :  b_bar = L^{-T} q_bar,  L_bar = -tril(b_bar q^T)
    q = L^{-T} b :  b_bar = L^{-1} q_bar,  L_bar = -tril(q b_bar^T)

`tri_inverse(l)` is the solve at b = I, X = L^{-1}, on its own kernel
(`repro_tri_inverse`), which skips the zero half of X and takes no b; it
holds a panel of X in shared memory, so beyond `MAX_N` the card takes the
general kernel at b = I instead (`inverse_entry`, the same bits).  Its
VJP is the one above at b = I: L_bar = -tril(L^{-T} X_bar X^T).  Both
kernels count their launches in `LAUNCHES`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

Tensor = torch.Tensor

SOURCE = "trsv"
LAUNCHES = 0      # kernel launches since the caller last set it to 0
_SIGNATURES = {"repro_trsv": (_build.ptr,) * 3 + (_build.cint,) * 4
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


def trsv_cuda(l: Tensor, b: Tensor, *, trans: bool = False) -> Tensor:
    """Launch the kernel: l (..., n, n), b (..., n, r) float32 CUDA."""
    global LAUNCHES
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
    batch = l[..., 0, 0].numel()
    if batch > 65535:
        raise ValueError(f"trsv kernel takes at most 65535 systems, got {batch}")
    l, b = l.contiguous(), b.contiguous()
    q = torch.empty_like(b)
    lib = _build.load(SOURCE, _SIGNATURES)
    status = lib.repro_trsv(l.data_ptr(), b.data_ptr(), q.data_ptr(), batch, n,
                            b.shape[-1], int(trans),
                            torch.cuda.current_stream(l.device).cuda_stream)
    LAUNCHES += 1
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
    vector (..., n) or a matrix (..., n, r).  Differentiable in l and b."""
    if b.ndim == l.ndim - 1:
        return _Trsv.apply(l, b[..., None], trans)[..., 0]
    return _Trsv.apply(l, b, trans)


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
