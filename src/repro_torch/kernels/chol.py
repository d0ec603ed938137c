"""Blocked right-looking Cholesky: `csrc/chol.cu` on the card.

Counterpart of `repro/kernels/chol.py`.  `cholesky(k)` factors (..., n, n)
into its lower factor with the reference's diagonal clamp
`sqrt(max(., 1e-12))`, so it returns finite values where
`torch.linalg.cholesky` would raise.  Not differentiable, like the
reference kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

Tensor = torch.Tensor

SOURCE = "chol"
LAUNCHES = 0      # wrapper calls that launched the kernel chain since reset
_SIGNATURES = {"repro_cholesky": (_build.ptr,) * 2 + (_build.cint,) * 2
               + (_build.ptr,)}
_BLOCK = 32       # diagonal-block width in csrc/chol.cu


def cholesky_cuda(k: Tensor) -> Tensor:
    """Launch the factorization of k (..., n, n) float32 CUDA.  One call is
    3 n / 32 launches on the stream (diagonal, panel, trailing update per
    block column) and counts once."""
    global LAUNCHES
    if k.device.type != "cuda":
        raise ValueError(f"cholesky kernel needs a CUDA tensor, got {k.device}")
    if k.dtype != torch.float32:
        raise TypeError(f"cholesky kernel takes float32, got {k.dtype}")
    if k.ndim < 2 or k.shape[-1] != k.shape[-2]:
        raise ValueError(f"cholesky kernel takes (..., n, n), got {tuple(k.shape)}")
    n = k.shape[-1]
    batch = k[..., 0, 0].numel()
    if batch > 65535:
        raise ValueError(f"cholesky kernel takes at most 65535 matrices, got {batch}")
    out = torch.empty_like(k, memory_format=torch.contiguous_format)
    out.copy_(k)          # factored in place: `out` is this call's own buffer
    scratch = torch.empty((batch, _BLOCK, _BLOCK), dtype=k.dtype, device=k.device)
    lib = _build.load(SOURCE, _SIGNATURES)
    status = lib.repro_cholesky(out.data_ptr(), scratch.data_ptr(), batch, n,
                                torch.cuda.current_stream(k.device).cuda_stream)
    LAUNCHES += 1
    _build.check(lib, status, "cholesky")
    return out


def cholesky(k: Tensor) -> Tensor:
    """Lower Cholesky factor of (..., n, n): the kernel for a CUDA tensor,
    the plain blocked loop for a CPU tensor."""
    if k.device.type == "cuda":
        return cholesky_cuda(k)
    if k.device.type == "cpu":
        return ref.cholesky(k)
    raise ValueError(f"no cholesky for device {k.device}")
