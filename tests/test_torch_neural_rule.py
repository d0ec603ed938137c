"""The neural phases' float64 check in `chip_smoke.py` (`held_f64_rule`):
a float32 value of the card's refit state within twice the worst float64
error of CPU float32 replays that differ only in the order their GEMMs
sum (`ContractionOrder`, `NEURAL_ORDERS`), or within the head's float32
perturbation bound 2 kappa 2^-24 max|x|.

A refit's Adam steps amplify round-off, so one replay's error is one
draw: on the card's float engine trajectories the CPU's own orders spread
up to 40-fold (PERF.md, PR 35).  Here, on a seeded Levy-5d ledger (256
rows, 40 absorbs, 20 Adam steps a refit, the head's kappa near the float
engine's 1e5), a replay in an order outside the set holds the rule with
room to spare, and the replay with every GEMM operand rounded to TF32
(`Tf32Operands`, the negative control) fails it.  The kappa bound admits
that replay on chol, s2 and the posterior: only the weights carry the
control's failure.  All on the CPU."""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from repro_torch.core import neural_basis as nb

NCFG = nb.NeuralConfig(refit_steps=20)


@pytest.fixture(scope="module")
def ledger():
    rng = np.random.default_rng(35)
    d, n0 = 5, 256
    objective = cs.levy_unit(d)
    xs = rng.uniform(size=(n0, d)).astype(np.float32)
    logcs = np.log(1.0 + 2.0 * rng.uniform(size=n0)).astype(np.float32)
    gen = torch.Generator()
    gen.manual_seed(41)
    init = nb.nb_init(d, NCFG.cap0, NCFG, generator=gen, device="cpu")
    start = (torch.from_numpy(xs), torch.from_numpy(objective(xs)),
             torch.from_numpy(logcs),
             {k: getattr(init, k) for k in nb.PARAMS})
    absorbs = []
    for _ in range(40):
        x = rng.uniform(size=d).astype(np.float32)
        absorbs.append((torch.from_numpy(x), float(objective(x[None])[0]),
                        float(np.float32(np.log(1 + 2 * rng.uniform())))))
    exact = cs.neural_replay(start, absorbs, NCFG, torch.float64)
    cpu32s = cs.cpu32_replays(start, absorbs, NCFG)
    probes = torch.rand((cs.NEURAL_PROBES, d), generator=gen)
    return start, absorbs, exact, cpu32s, probes


def _held(state, ledger) -> dict:
    _, _, exact, cpu32s, probes = ledger
    return cs.held_neural_state(state, cpu32s, exact, probes, NCFG)


def test_one_chunk_is_the_plain_replay(ledger):
    start, absorbs, _, cpu32s, _ = ledger
    plain = cs.neural_replay(start, absorbs, NCFG, torch.float32)
    assert all(torch.equal(getattr(plain, k), getattr(cpu32s[0], k))
               for k in nb.FIELDS)
    assert len(cpu32s) == len(cs.NEURAL_ORDERS)


@pytest.mark.parametrize("chunks", [2, 3, 8])
def test_contraction_order_is_a_float32_product(chunks):
    rng = np.random.default_rng(chunks)
    a = torch.from_numpy(rng.standard_normal((64, 2048)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2048, 17)).astype(np.float32))
    v = b[:, 0].contiguous()
    exact = a.double() @ b.double()
    with cs.ContractionOrder(chunks):
        mm, mv = a @ b, a @ v
    bound = 2048 * 2.0 ** -24 * (a.double().abs() @ b.double().abs())
    assert ((mm.double() - exact).abs() <= bound).all()
    assert ((mv.double() - exact[:, 0]).abs() <= bound[:, 0]).all()
    assert not torch.equal(mm, a @ b)     # another order, other bits


def test_another_order_holds_the_rule(ledger):
    start, absorbs, *_ = ledger
    other = cs.neural_replay(start, absorbs, NCFG, torch.float32,
                             mode=cs.ContractionOrder(3))
    held = _held(other, ledger)
    assert 5e4 < held["kappa"] < 2e5             # the float engine's regime
    assert {k: h["held_by"] for k, h in held["held"].items()
            if not h["held_by"]} == {}


def test_tf32_operands_fail_the_rule(ledger):
    start, absorbs, *_ = ledger
    perturbed = cs.neural_replay(start, absorbs, NCFG, torch.float32,
                                 mode=cs.Tf32Operands())
    held = _held(perturbed, ledger)["held"]
    assert not held["w_c"]["held_by"]
    # every key leaves the 2x part; the kappa bound admits the others
    for k, h in held.items():
        assert h["card_err"] > 2.0 * max(h["cpu32_errs"]), k


def test_the_rule_takes_the_worst_replay():
    exact = torch.zeros(4, dtype=torch.float64)
    card = torch.tensor([0.0, 3.0, 0.0, 0.0])
    replays = [torch.tensor([0.0, 1.0, 0.0, 0.0]),
               torch.tensor([0.0, 0.0, 2.0, 0.0])]
    held = cs.held_f64_rule(card, replays, exact, kappa=1.0)
    assert held["cpu32_errs"] == [1.0, 2.0] and held["held_by"] == "2x"
    held = cs.held_f64_rule(card, replays[:1], exact, kappa=1.0)
    assert held["held_by"] is None           # 3 > 2 x 1, bound 0
    big = torch.full((4,), 1e7, dtype=torch.float64)
    held = cs.held_f64_rule(card.double() + big, [r.double() + big
                                                  for r in replays[:1]],
                            big, kappa=4.0)
    assert held["held_by"] == "kappa bound"  # 3 <= 2 x 4 x 2^-24 x 1e7


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11,
                      1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -11 + 2.0 ** -20,
                      -3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0,   # a tie: to even
                         1.0 + 2.0 ** -9,              # a tie: to even
                         1.0 + 2.0 ** -10, -3.0, 0.0])
    assert torch.equal(cs.Tf32Operands.round_tf32(x), want)
    d = torch.ones(3, dtype=torch.float64)
    assert cs.Tf32Operands.round_tf32(d) is d
