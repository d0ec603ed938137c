"""A lane of the batched suggest starts from the single-study path's
operands: `acquisition.hoist` on a stacked state is, lane by lane and bit
for bit, the hoist a routed suggest computes on that lane (`A = li^T li`,
the active mask, the shift `ymean - f_best - xi`).  (The fused EI's plain
version, which the CPU runs, is not lane-exact itself: a batched product
sums in another order.  The card's kernel is, `chip_smoke.ei_at_seeds`.)"""
import numpy as np
import pytest
import torch
from _torch_port import scaled_levy

from repro_torch.core import acquisition as acqm
from repro_torch.hpo import engine as tengine
from repro_torch.hpo import pool as tpool
from repro_torch.hpo.space import Categorical, Dim, Int, SearchSpace

S, N_MAX, RESTARTS, STEPS = 4, 32, 8, 4
MIXED = SearchSpace((Dim("a", 0.0, 1.0), Int("k", 0, 3),
                     Categorical("c", ("p", "q"))))


def _engine(mixed: bool):
    cfg = tpool.SchedulerConfig(n_max=N_MAX, lag=5, acq=acqm.AcqConfig(
        restarts=RESTARTS, ascent_steps=STEPS))
    dim = MIXED.dim if mixed else 3
    descs = [MIXED.descriptor()] * S if mixed else None
    eng = tengine.StudyEngine(dim, cfg, S, descs, device="cpu")
    rng = np.random.default_rng(5)
    # ragged n, a lag refit or two on the way
    for r in range(12):
        flags = np.arange(S) <= r % (S + 1)
        xs = (MIXED.sample(rng, S) if mixed
              else rng.uniform(size=(S, dim)).astype(np.float32))
        eng.absorb_round(flags, xs, scaled_levy(xs))
    return eng


@pytest.mark.parametrize("mixed", [False, True], ids=["float", "mixed"])
def test_stacked_hoist_is_the_routed_hoist_lane_by_lane(mixed):
    eng = _engine(mixed)
    counts = [eng.n(s) for s in range(S)]
    assert len(set(counts)) > 1, "want ragged n"
    stacked = acqm.hoist(eng.state, eng.cfg.acq, eng._n_host)
    from_device = acqm.hoist(eng.state, eng.cfg.acq)
    for s in range(S):
        lane = acqm.hoist(eng._lane(s), eng.cfg.acq)
        snap = acqm.hoist(eng.study_state(s), eng.cfg.acq)
        for got, dev, want, own in zip(stacked, from_device, lane, snap):
            assert torch.equal(got[s], want), f"lane {s}"
            assert torch.equal(dev[s], want), f"lane {s} (device counts)"
            assert torch.equal(own, want), f"lane {s} (snapshot)"


@pytest.mark.parametrize("mixed", [False, True], ids=["float", "mixed"])
def test_batched_suggest_hoists_from_the_host_mirrors(mixed, monkeypatch):
    """The engine's batched suggest hoists with its host counts (no read
    of the device), once a suggest."""
    eng = _engine(mixed)
    seen = []
    real = acqm.hoist

    def spy(state, cfg, counts=None):
        seen.append(None if counts is None else [int(c) for c in counts])
        return real(state, cfg, counts)

    monkeypatch.setattr(acqm, "hoist", spy)
    units, vals = eng.suggest_all()
    assert seen == [[eng.n(s) for s in range(S)]]
    assert units.shape == (S, 1, eng.dim) and torch.isfinite(vals).all()


def test_draw_helpers_are_the_ascents_own_draws():
    """`draw_seeds` / `draw_jitter` consume a generator exactly as the
    ascent does when it draws for itself."""
    lo, hi = torch.zeros(2), torch.ones(2)
    cfg = acqm.AcqConfig(restarts=5, ascent_steps=2)
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    seeds = acqm.draw_seeds(lo, hi, 5, g2, (2,))
    acqm.draw_jitter(lo, 3, g2, (2,))
    calls = []

    def eval_batch(x):
        calls.append(x.clone())
        return torch.zeros(x.shape[:-1]), torch.zeros_like(x)

    acqm.ascend_acquisition(eval_batch, lo, hi, cfg, 3, generator=g1,
                            batch=(2,))
    assert torch.equal(calls[0], seeds)
    assert torch.equal(g1.get_state(), g2.get_state())


@pytest.mark.parametrize("mixed", [False, True], ids=["float", "mixed"])
def test_batched_append_is_the_single_append_lane_by_lane(mixed):
    """A round's append writes each flagged lane as `gp.append` writes the
    lane's snapshot: the points, factor, inverse and alpha bit for bit
    (given the same covariance column: on the card a lane of the batched
    gram is its single launch; on the CPU the test hands the single path
    the batched column), the counters and clamp counts equal, unflagged
    lanes untouched."""
    from repro_torch.core import gp as gp_mod
    from repro_torch.kernels import ops
    eng = _engine(mixed)
    # the lanes whose absorb triggers no lag refit (the single path has none)
    flags = np.array([eng.since_refit(s) + 1 < eng.cfg.lag for s in range(S)])
    assert 1 < flags.sum() < S
    rng = np.random.default_rng(11)
    xs = (MIXED.sample(rng, S) if mixed
          else rng.uniform(size=(S, eng.dim)).astype(np.float32))
    ys = scaled_levy(xs)
    before = [eng.study_state(s) for s in range(S)]
    cols = ops.kernel_gram(eng.kernel, eng.state.x_buf,
                           torch.from_numpy(xs)[:, None, :],
                           eng.state.params)[..., 0]
    real = ops.kernel_gram
    for s in range(S):
        if not flags[s]:
            continue
        kern = eng._kernel_for(s)

        def column(kernel, x, y, params, s=s):
            return cols[s][:, None]

        ops.kernel_gram = column
        try:
            want = gp_mod.append(before[s], kern, torch.from_numpy(xs[s]),
                                 float(ys[s]))
        finally:
            ops.kernel_gram = real
        before[s] = want
    eng.absorb_round(flags, xs, ys)
    for s in range(S):
        got, want = eng.study_state(s), before[s]
        for a, b in zip(gp_mod._leaves(got), gp_mod._leaves(want)):
            assert torch.equal(a, b), f"lane {s}"
        assert (got.n, got.since_refit) == (want.n, want.since_refit)
