"""Blocked right-looking Cholesky: `csrc/chol.cu` on the card.

Counterpart of `repro/kernels/chol.py`.  `cholesky(k)` factors (..., n, n)
into its lower factor with the reference's diagonal clamp
`sqrt(max(., 1e-12))`, so it returns finite values where
`torch.linalg.cholesky` would raise.  Not differentiable, like the
reference kernel.

On the card a call is one cooperative launch of every CTA the card holds at
once, split into groups by `launch_plan`; each group factors its own
matrices and synchronizes on its own counter in the call's scratch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

Tensor = torch.Tensor

SOURCE = "chol"
LAUNCHES = 0      # wrapper calls that launched the kernel since reset
_SIGNATURES = {
    "repro_cholesky": (_build.ptr,) * 2 + (_build.cint,) * 4 + (_build.ptr,),
    "repro_cholesky_resident": (ctypes.POINTER(ctypes.c_int),),
}
_BLOCK = 32           # diagonal-block width in csrc/chol.cu
_SYNC_INTS = 64       # per group in csrc/chol.cu: barrier counter and flag
MAX_BATCH = 65535
_RESIDENT: dict[int, int] = {}   # device index -> CTAs it holds at once


def launch_plan(batch: int, resident: int) -> tuple[int, int]:
    """(groups, CTAs per group) for `batch` matrices on a card that holds
    `resident` CTAs of the kernel at once.  One matrix gets every CTA; a
    batch shares them evenly, one group per matrix; a batch larger than
    `resident` gets one CTA per group, and group g factors matrices g,
    g + groups, ...  groups * CTAs never exceeds `resident`, so the
    cooperative launch can hold the whole grid."""
    if batch < 1 or resident < 1:
        raise ValueError(f"launch plan needs batch >= 1 and resident >= 1, "
                         f"got {batch}, {resident}")
    groups = min(batch, resident)
    return groups, resident // groups


def scratch_floats(groups: int) -> int:
    """Scratch of one call: each group's barrier counter and flag, then each
    group's inverse of its current diagonal block."""
    return groups * (_SYNC_INTS + _BLOCK * _BLOCK)


def resident_ctas(device: torch.device) -> int:
    """CTAs of the kernel that `device` holds at once (occupancy x SMs)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _RESIDENT:
        lib = _build.load(SOURCE, _SIGNATURES)
        ctas = ctypes.c_int(0)
        with torch.cuda.device(index):
            status = lib.repro_cholesky_resident(ctypes.byref(ctas))
        _build.check(lib, status, "cholesky occupancy")
        _RESIDENT[index] = ctas.value
    return _RESIDENT[index]


def cholesky_cuda(k: Tensor) -> Tensor:
    """Launch the factorization of k (..., n, n) float32 CUDA: one device
    launch (after a memset of the barrier counters), counted once."""
    global LAUNCHES
    if k.device.type != "cuda":
        raise ValueError(f"cholesky kernel needs a CUDA tensor, got {k.device}")
    if k.dtype != torch.float32:
        raise TypeError(f"cholesky kernel takes float32, got {k.dtype}")
    if k.ndim < 2 or k.shape[-1] != k.shape[-2]:
        raise ValueError(f"cholesky kernel takes (..., n, n), got {tuple(k.shape)}")
    n = k.shape[-1]
    batch = k.numel() // (n * n) if n else 0
    if batch > MAX_BATCH:
        raise ValueError(f"cholesky kernel takes at most {MAX_BATCH} matrices, got {batch}")
    # Factored in place: `out` is this call's own buffer.
    out = k.clone(memory_format=torch.contiguous_format)
    if batch == 0:
        return out
    lib = _build.load(SOURCE, _SIGNATURES)
    groups, ctas = launch_plan(batch, resident_ctas(k.device))
    scratch = torch.empty(scratch_floats(groups), dtype=torch.float32,
                          device=k.device)
    status = lib.repro_cholesky(out.data_ptr(), scratch.data_ptr(), batch, n,
                                groups, ctas,
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
