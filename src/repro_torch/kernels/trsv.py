"""Blocked triangular solve: `csrc/trsv.cu` on the card.

Counterpart of `repro/kernels/trsv.py`.  `trsv(l, b, trans=...)` solves
L q = b or L^T q = b for a lower-triangular L (..., n, n) and b (..., n, r),
with optional leading batch dimensions (the kernel's blockIdx.z).  It is an
`autograd.Function` with the reference's textbook VJP (`_trsv_bwd`), whose
backward solve reruns the same kernel with `trans` flipped:

    q = L^{-1} b :  b_bar = L^{-T} q_bar,  L_bar = -tril(b_bar q^T)
    q = L^{-T} b :  b_bar = L^{-1} q_bar,  L_bar = -tril(q b_bar^T)
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

Tensor = torch.Tensor

SOURCE = "trsv"
LAUNCHES = 0      # kernel launches since the caller last set it to 0
_SIGNATURES = {"repro_trsv": (_build.ptr,) * 3 + (_build.cint,) * 4
               + (_build.ptr,)}


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
