"""Synthetic objectives: the d-dimensional Levy function (paper Sec. 4.1).

Counterpart of `repro/core/levy.py`.  The paper maximizes the *negative*
Levy function on [-10, 10]^d; the global maximum is 0 at x* = (1, ..., 1).
The functions take tensors or arrays and return tensors.
"""
from __future__ import annotations

import math

import numpy as np
import torch

Tensor = torch.Tensor


def levy(x) -> Tensor:
    """Levy function (paper Eq. 19). x: (..., d)."""
    x = torch.as_tensor(np.array(x) if isinstance(x, np.ndarray) else x)
    w = 1.0 + (x - 1.0) / 4.0
    term1 = torch.sin(math.pi * w[..., 0]) ** 2
    wi = w[..., :-1]
    term2 = torch.sum((wi - 1.0) ** 2
                      * (1.0 + 10.0 * torch.sin(math.pi * wi + 1.0) ** 2), dim=-1)
    wd = w[..., -1]
    term3 = (wd - 1.0) ** 2 * (1.0 + torch.sin(2.0 * math.pi * wd) ** 2)
    return term1 + term2 + term3


def neg_levy(x) -> Tensor:
    """The paper's maximization target: max_x -f_L(x), optimum 0 at 1-vector."""
    return -levy(x)


def levy_bounds(dim: int) -> tuple[Tensor, Tensor]:
    return torch.full((dim,), -10.0), torch.full((dim,), 10.0)


def levy_1d(x) -> Tensor:
    """1-D special case used in the paper's Fig. 2/3 illustration (Eq. 7)."""
    w = 1.0 + (torch.as_tensor(x) - 1.0) / 4.0
    return torch.sin(math.pi * w) ** 2 + (w - 1.0) ** 2 * (
        1.0 + torch.sin(2.0 * math.pi * w) ** 2)
