"""Property test of the port pool's fantasy rollback, mirrored from
tests/test_properties.py: any interleaving of q-asks, out-of-order tells,
foreign tells and releases ends, once every pending row is drained, in a
slot bit for bit equal to a control pool that took the same real
observations and never fantasized.  It holds every script, including
['ask1', 'release', 'tell'] (nothing left to tell after the release),
because the port's engine keeps alpha's pre-fantasy copy."""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core import gp as gp_mod
from repro_torch.core.acquisition import AcqConfig
from repro_torch.hpo.pool import SchedulerConfig, StudyPool, Trial
from repro_torch.hpo.space import RESNET_SPACE

# Built once per process: pool A serves through the fantasy path, pool B is
# the never-fantasized control fed the same real observations.
_FANTASY_POOLS: list = []


def _fantasy_pools():
    if not _FANTASY_POOLS:
        cfg = SchedulerConfig(n_max=48, seed=0, ckpt_every=10_000,
                              acq=AcqConfig(restarts=8, ascent_steps=4))
        _FANTASY_POOLS.extend(StudyPool([RESNET_SPACE], cfg, device="cpu")
                              for _ in range(2))
    pa, pb = _FANTASY_POOLS
    pa.reset_study(0)
    pb.reset_study(0)
    return pa, pb


def _run(script, seed):
    pa, pb = _fantasy_pools()
    rng = np.random.RandomState(seed)

    def value(u):
        return float(-np.sum((np.asarray(u) - 0.3) ** 2))

    pending: list = []           # trials awaiting their real tell, pool A
    for _ in range(2):
        u = rng.rand(pa.dim).astype(np.float32)
        v = value(u)
        pa.absorb(0, Trial(10_000, u, {}), v)
        pb.absorb(0, Trial(10_000, u, {}), v)
    for op in script:
        if op.startswith("ask"):
            q = int(op[3:])
            if pa.n_real(0) + pa.fantasy_active(0) + q > 40:
                continue
            pending.extend(pa.ask_q(0, q))
        elif op == "tell" and pending:
            tr = pending.pop(rng.randint(len(pending)))
            v = value(tr.unit)
            pa.absorb(0, tr, v)
            pb.absorb(0, Trial(10_000, np.asarray(tr.unit), {}), v)
        elif op == "foreign":
            u = rng.rand(pa.dim).astype(np.float32)
            v = value(u)
            pa.absorb(0, Trial(10_000, u, {}), v)
            pb.absorb(0, Trial(10_000, u, {}), v)
        elif op == "release" and pending:
            tr = pending.pop(rng.randint(len(pending)))
            assert pa.release_fantasies(0, [np.asarray(tr.unit)]) == 1
    while pending:
        tr = pending.pop(rng.randint(len(pending)))
        v = value(tr.unit)
        pa.absorb(0, tr, v)
        pb.absorb(0, Trial(10_000, np.asarray(tr.unit), {}), v)

    assert pa.fantasy_active(0) == 0
    assert pa.engine.n(0) == pb.engine.n(0) == pa.n_real(0)
    a, b = pa.engine.study_state(0), pb.engine.study_state(0)
    assert (a.n, a.since_refit) == (b.n, b.since_refit)
    for name, la, lb in zip(("x_buf", "y_buf", "l_buf", "li_buf", "alpha",
                             "clamp_count", "sigma2", "rho", "noise2"),
                            gp_mod._leaves(a), gp_mod._leaves(b)):
        assert la.numpy().tobytes() == lb.numpy().tobytes(), \
            f"{name} differs after drain"


@settings(max_examples=8, deadline=None)
@given(script=st.lists(st.sampled_from(["ask1", "ask2", "ask3",
                                        "tell", "foreign", "release"]),
                       min_size=3, max_size=10),
       seed=st.integers(0, 2 ** 31 - 1))
def test_fantasy_rollback_bitwise_under_random_interleavings(script, seed):
    _run(script, seed)


@pytest.mark.parametrize("script", [["ask1", "release", "tell"],
                                    ["ask2", "release", "release"],
                                    ["ask3", "tell", "release", "foreign"]])
def test_fantasy_rollback_bitwise_on_release_scripts(script):
    """The reference's falsifying example and its kin: a release with
    nothing left to tell leaves no real append after the rollback."""
    _run(script, 0)
