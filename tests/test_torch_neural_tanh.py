"""The neural-basis tier's tanh (`core/neural_basis._tanh`) on the CPU.

The tier's MLP takes tanh of float32 pre-activations, evaluated in
float64 and rounded to float32, forward and backward, on every device:
the card's own float32 tanh is 1.8 ulp off.  On a seeded grid that spans
the linear part, the knee and the saturated tails, the value and its
derivative are within 0.5 ulp of float64's tanh and 1 - tanh^2, where an
ulp is the spacing of float32 in the binade of the float64 value.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import neural_basis as nb


def _grid(seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    parts = [rng.uniform(-1.0, 1.0, 4096),          # near linear
             rng.standard_normal(4096) * 3.0,        # the knee
             rng.uniform(8.0, 20.0, 1024),           # saturated tails
             -rng.uniform(8.0, 20.0, 1024),
             rng.uniform(-1e-3, 1e-3, 1024),         # tiny
             np.array([0.0, -0.0, 9.0109, -9.0109, 40.0, -40.0])]
    return torch.from_numpy(np.concatenate(parts).astype(np.float32))


def _ulps(got: torch.Tensor, exact: torch.Tensor) -> torch.Tensor:
    """|got - exact| over float32's spacing in the binade of |exact|."""
    _, e = torch.frexp(exact.abs())            # |exact| in [2^(e-1), 2^e)
    spacing = torch.ldexp(torch.ones_like(exact), (e - 24).clamp(min=-149))
    return (got.double() - exact).abs() / spacing


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tanh_within_half_an_ulp(seed):
    x = _grid(seed)
    got = nb._tanh(x)
    assert got.dtype == torch.float32
    assert float(_ulps(got, torch.tanh(x.double())).max()) <= 0.5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tanh_gradient_within_half_an_ulp(seed):
    x = _grid(seed).requires_grad_(True)
    (g,) = torch.autograd.grad(nb._tanh(x).sum(), x)
    assert g.dtype == torch.float32
    t = torch.tanh(x.detach().double())
    assert float(_ulps(g, 1.0 - t * t).max()) <= 0.5


def test_float64_takes_torch_tanh():
    x = _grid(3).double()
    assert torch.equal(nb._tanh(x), torch.tanh(x))
