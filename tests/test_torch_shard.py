"""The port's (study x restart) mesh (`repro_torch.hpo.mesh`): mirrors of
tests/test_shard.py on logical CPU devices (`devices=["cpu"] * k`).

The contract: every mesh spec is the SAME computation as `mesh="none"`.
The port holds it bit for bit: the restart seeds are drawn once at full R
from one stream and sliced, every study shard makes the unsharded
engine's calls on its lanes, and each restart shard's rows are summed as
in the unsharded launch.  `"none"` and `"1x1"` are also held to the JAX
package's pools at tests/test_shard.py's tolerances, with the reference's
own draws; the reference runs on its one CPU device only.
"""
import numpy as np
import pytest
import torch
from _torch_port import mirror_pool_draws, mixed_space4

from repro.core.acquisition import AcqConfig as JAcqConfig
from repro.hpo import pool as jpool
from repro.hpo import space as jspace
from repro_torch.core import gp as gp_mod
from repro_torch.core.acquisition import AcqConfig
from repro_torch.hpo import mesh as mesh_mod
from repro_torch.hpo.engine import StudyEngine
from repro_torch.hpo.pool import SchedulerConfig, StudyPool
from repro_torch.hpo.scheduler import TrialScheduler
from repro_torch.hpo.space import RESNET_SPACE, Dim, SearchSpace

SPECS = ["2x1", "1x2", "2x2", "4x2"]
SUGGEST_TOL = dict(atol=2e-5)                 # tests/test_shard.py:107
L_TOL = dict(rtol=1e-5, atol=1e-6)            # tests/test_shard.py:111
ALPHA_TOL = dict(rtol=1e-4, atol=1e-5)        # tests/test_shard.py:114
CPUS = ["cpu"] * 8
FLOAT4 = SearchSpace(tuple(Dim(f"x{i}", 0.0, 1.0) for i in range(4)))
LEAVES = ("x_buf", "y_buf", "l_buf", "li_buf", "alpha", "n", "since_refit",
          "clamp_count")


def _cfg(mesh: str, **kw) -> SchedulerConfig:
    kw.setdefault("n_max", 16)
    kw.setdefault("acq", AcqConfig(restarts=8, ascent_steps=4))
    return SchedulerConfig(seed=0, mesh=mesh, **kw)


def _spaces(kind: str, n_studies: int) -> list:
    if kind == "float":
        return [RESNET_SPACE] * n_studies
    return [mixed_space4() if s % 2 else FLOAT4 for s in range(n_studies)]


def _pool(mesh: str, n_studies: int = 8, kind: str = "float",
          **kw) -> StudyPool:
    return StudyPool(_spaces(kind, n_studies), _cfg(mesh, **kw),
                     device="cpu", devices=CPUS)


def _events(pool, out):
    """`tests/test_shard.py::_drive`'s deterministic objective."""
    return [(s, out[s][0], float(-np.sum((out[s][0].unit - 0.3 - 0.1 * s)
                                         ** 2)))
            for s in range(pool.n_studies)]


def _leaves(pool) -> dict:
    st = pool.engine.state
    out = {k: getattr(st, k).clone() for k in LEAVES}
    out.update({f"params.{k}": getattr(st.params, k).clone()
                for k in ("sigma2", "rho", "noise2")})
    return out


def _drive(pool, rounds: int = 3) -> list:
    """Fused advance rounds; every round's units and state leaves."""
    seen = []
    out = pool.advance_round([])                       # seeds every study
    for _ in range(rounds):
        out = pool.advance_round(_events(pool, out))
        seen.append((np.stack([out[s][0].unit for s in range(pool.n_studies)]),
                     _leaves(pool)))
    return seen


def _assert_same_bits(got: list, want: list) -> None:
    for (ua, la), (ub, lb) in zip(got, want):
        np.testing.assert_array_equal(ua, ub)
        for k in la:
            assert torch.equal(la[k], lb[k]), k


def _assert_pools_equal(a, b) -> None:
    la, lb = _leaves(a), _leaves(b)
    for k in la:
        assert torch.equal(la[k], lb[k]), k


# ---------------------------------------------------------------------------
# Spec parsing and mesh construction
# ---------------------------------------------------------------------------
def test_parse_spec():
    assert mesh_mod.parse_spec("none") is None
    assert mesh_mod.parse_spec("") is None
    assert mesh_mod.parse_spec("auto") == "auto"
    assert mesh_mod.parse_spec("4x2") == (4, 2)
    assert mesh_mod.parse_spec("8") == (8, 1)
    with pytest.raises(ValueError, match="mesh spec"):
        mesh_mod.parse_spec("4x2x1")
    with pytest.raises(ValueError, match="mesh spec"):
        mesh_mod.parse_spec("fast")


def test_build_none_and_auto_single_device():
    assert mesh_mod.build("none", 4, 8) is None
    assert mesh_mod.build("none", 4, 8, devices=CPUS) is None
    # auto on one device degenerates to the unsharded path
    assert mesh_mod.build("auto", 4, 8, devices=["cpu"]) is None


def test_build_explicit_1x1():
    m = mesh_mod.build("1x1", 4, 8, devices=["cpu"])
    assert m is not None and m.n_devices == 1
    assert m.axis_names == (mesh_mod.STUDY_AXIS, mesh_mod.RESTART_AXIS)
    assert m.lanes == (range(0, 4),)
    assert m.home(0) == torch.device("cpu")


def test_build_rejects_non_divisible_and_oversized():
    with pytest.raises(ValueError, match="divide n_studies"):
        mesh_mod.build("3x1", 4, 8, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="divide acq.restarts"):
        mesh_mod.build("1x3", 4, 8, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="devices"):
        mesh_mod.build("2x1", 4, 8, devices=["cpu"])
    with pytest.raises(ValueError, match="devices"):
        mesh_mod.build("3x3", 9, 9, devices=CPUS)
    with pytest.raises(ValueError, match=">= 1"):
        mesh_mod.build("0x1", 4, 8, devices=CPUS)


def test_build_auto_factors_devices():
    """Eight listed devices: S = 4 takes four study shards, R = 8 the two
    that remain; the cells are the devices in row-major order."""
    devs = [torch.device("cuda", i) for i in range(8)]
    m = mesh_mod.build("auto", 4, 8, devices=devs)
    assert (m.study_shards, m.restart_shards) == (4, 2)
    assert 4 % m.study_shards == 0 and 8 % m.restart_shards == 0
    assert m.n_devices <= 8
    assert m.lanes == tuple(range(i, i + 1) for i in range(4))
    assert [m.cell(i, j).index for i in range(4) for j in range(2)] == \
        list(range(8))
    assert m.row(1) == [devs[2], devs[3]] and m.home(3) == devs[6]
    # S = 3 leaves two devices over; R = 8 takes none of them
    m = mesh_mod.build("auto", 3, 8, devices=devs)
    assert (m.study_shards, m.restart_shards) == (3, 2)
    m = mesh_mod.build("auto", 1, 8, devices=devs)
    assert (m.study_shards, m.restart_shards) == (1, 8)


def test_default_devices_are_the_engine_type():
    assert mesh_mod.default_devices("cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="devices"):
        StudyEngine(3, _cfg("2x1"), 4, device="cpu")      # one CPU device
    with pytest.raises(ValueError, match="engine's type"):
        StudyEngine(3, _cfg("2x1"), 4, device="cpu",
                    devices=["cuda:0"] * 2)


# ---------------------------------------------------------------------------
# "none" and "1x1" against the reference's pools
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec", ["none", "1x1"])
def test_unsharded_specs_match_the_reference(spec):
    """The reference's pool at `mesh=spec` (on its one device) and the
    port's, with the reference's EI draws and the same tells."""
    jcfg = jpool.SchedulerConfig(seed=0, mesh=spec, n_max=16,
                                 implementation="xla",
                                 acq=JAcqConfig(restarts=8, ascent_steps=4))
    jp = jpool.StudyPool([jspace.RESNET_SPACE] * 4, jcfg)
    tp = _pool(spec, 4)
    mirror_pool_draws(tp, 0)
    jo, to = jp.advance_round([]), tp.advance_round([])
    for _ in range(3):
        for s in range(4):
            np.testing.assert_allclose(to[s][0].unit, jo[s][0].unit,
                                       **SUGGEST_TOL)
            to[s][0].unit = np.asarray(jo[s][0].unit, np.float32).copy()
        jo = jp.advance_round(_events(jp, jo))
        to = tp.advance_round(_events(tp, to))
    for s in range(4):
        np.testing.assert_allclose(to[s][0].unit, jo[s][0].unit,
                                   **SUGGEST_TOL)
    np.testing.assert_allclose(tp.engine.state.l_buf.numpy(),
                               np.asarray(jp.engine.state.l_buf), **L_TOL)
    np.testing.assert_allclose(tp.engine.state.alpha.numpy(),
                               np.asarray(jp.engine.state.alpha),
                               **ALPHA_TOL)


# ---------------------------------------------------------------------------
# Every spec: the bits of mesh="none"
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["float", "mixed"])
@pytest.mark.parametrize("spec", SPECS)
def test_specs_match_none_bit_for_bit(spec, kind):
    _assert_same_bits(_drive(_pool(spec, kind=kind)),
                      _drive(_pool("none", kind=kind)))


@pytest.mark.parametrize("spec", SPECS)
def test_top_t_suggestions_match_none_bit_for_bit(spec):
    """top_t = 2: the engine's own stream (drawn at full (S, R), then the
    jitter), and the pool's per-study streams."""
    a, b = _pool("none"), _pool(spec)
    _drive(a, 2)
    _drive(b, 2)
    ua, va = a.engine.suggest_all(top_t=2)
    ub, vb = b.engine.suggest_all(top_t=2)
    assert ua.shape == (8, 2, 3)
    assert torch.equal(ua, ub) and torch.equal(va, vb)
    sa, sb = a.suggest_all(t=2), b.suggest_all(t=2)
    for s in range(8):
        for ta, tb in zip(sa[s], sb[s]):
            np.testing.assert_array_equal(ta.unit, tb.unit)


def test_study_shards_hold_only_their_lanes():
    pool = _pool("4x2")
    eng = pool.engine
    assert eng.mesh.study_shards == 4 and eng.mesh.restart_shards == 2
    ptrs = set()
    for i, sh in enumerate(eng._shards):
        assert sh.lanes == range(2 * i, 2 * i + 2)
        for leaf in (sh.state.x_buf, sh.state.l_buf, sh.state.li_buf,
                     sh.state.alpha, sh.state.n):
            assert leaf.shape[0] == 2
            assert leaf.untyped_storage().nbytes() == \
                leaf.numel() * leaf.element_size()
            ptrs.add(leaf.data_ptr())
        # both restart shards sit on the home's device: one copy
        assert len(sh.replicas) == 2
        assert all(rep is sh.state for rep in sh.replicas)
    assert len(ptrs) == 4 * 5
    assert eng.state.x_buf.shape == (8, 16, 3)


def test_state_reads_joined_and_writes_split():
    a, b = _pool("none"), _pool("2x2")
    _drive(a, 2)
    _drive(b, 2)
    b.engine.state = a.engine.state
    assert [sh.state.l_buf.shape[0] for sh in b.engine._shards] == [4, 4]
    _assert_pools_equal(a, b)
    assert [b.engine.n(s) for s in range(8)] == a.engine.state.n.tolist()
    np.testing.assert_array_equal(b.engine.clamp_counts(),
                                  a.engine.clamp_counts())


@pytest.mark.parametrize("src,dst", [("none", "2x2"), ("4x2", "none"),
                                     ("2x1", "1x2")])
def test_checkpoint_restore_onto_a_mesh(tmp_path, src, dst):
    """A snapshot restores onto another mesh and continues in the same
    bits as the pool that wrote it."""
    a = _pool(src, ckpt_dir=str(tmp_path))
    out = a.advance_round([])
    a.advance_round(_events(a, out))
    a.checkpoint()
    b = _pool(dst, ckpt_dir=str(tmp_path))
    assert b.restore()
    _assert_pools_equal(a, b)
    assert [b.engine.n(s) for s in range(8)] == [1] * 8
    sa, sb = a.suggest_all(t=1), b.suggest_all(t=1)
    for s in range(8):
        np.testing.assert_array_equal(sa[s][0].unit, sb[s][0].unit)
    a.absorb_many(_events(a, sa))
    b.absorb_many(_events(b, sb))
    _assert_pools_equal(a, b)


@pytest.mark.parametrize("spec", ["2x2", "4x2"])
def test_lag_refit_through_advance_round(spec):
    """lag = 2: every study's refit fires inside the fused rounds, routed
    to its shard, with the bits of mesh="none"."""
    def run(mesh):
        pool = _pool(mesh, lag=2, acq=AcqConfig(restarts=8, ascent_steps=2))
        seen = _drive(pool, 3)
        return pool, seen
    a, got_a = run("none")
    b, got_b = run(spec)
    _assert_same_bits(got_b, got_a)
    assert all(b.engine.since_refit(s) < 2 for s in range(8))
    assert b.engine.state.since_refit.tolist() == \
        [b.engine.since_refit(s) for s in range(8)]
    assert any(not torch.equal(b.engine.state.params.rho[s],
                               torch.tensor(0.25)) for s in range(8))


@pytest.mark.parametrize("spec", ["2x1", "4x2"])
def test_ask_q_and_truncate_in_the_second_study_shard(spec):
    """A q-ask, its fantasy rows and their rollback on a slot of the
    second study shard: the bits of mesh="none", and the other shard's
    lanes untouched."""
    a, b = _pool("none"), _pool(spec)
    _drive(a, 2)
    _drive(b, 2)
    slot = 5
    before = _leaves(b)
    qa, qb = a.ask_q(slot, 2), b.ask_q(slot, 2)
    for ta, tb in zip(qa, qb):
        np.testing.assert_array_equal(ta.unit, tb.unit)
    assert b.engine.n(slot) == 2 + 2
    _assert_pools_equal(a, b)
    after = _leaves(b)
    for k in after:
        assert torch.equal(after[k][:4], before[k][:4]), k
    a.release_fantasies(slot, [qa[0].unit, qa[1].unit])
    b.release_fantasies(slot, [qb[0].unit, qb[1].unit])
    _assert_pools_equal(a, b)
    restored = _leaves(b)
    for k in restored:
        assert torch.equal(restored[k], before[k]), k
    a.engine.ask_q(slot, 1)
    b.engine.ask_q(slot, 1)
    a.engine.truncate_slot(slot, 2)
    b.engine.truncate_slot(slot, 2)
    _assert_pools_equal(a, b)


def test_routed_suggest_and_absorb_go_to_the_shard():
    a, b = _pool("none"), _pool("2x2")
    _drive(a, 1)
    _drive(b, 1)
    for slot in (1, 6):
        ta, tb = a.suggest(slot, 1), b.suggest(slot, 1)
        np.testing.assert_array_equal(ta[0].unit, tb[0].unit)
        a.absorb(slot, ta[0], 0.5)
        b.absorb(slot, tb[0], 0.5)
    _assert_pools_equal(a, b)
    for slot in range(8):
        ga, gb = a.engine.study_state(slot), b.engine.study_state(slot)
        assert torch.equal(ga.li_buf, gb.li_buf) and ga.n == gb.n


def test_neural_tier_promotes_on_the_shard():
    """promote and the escalated suggest of a slot in the second shard."""
    a, b = _pool("none"), _pool("2x1")
    _drive(a, 2)
    _drive(b, 2)
    for pool in (a, b):
        pool.promote(6)
    assert b.engine.tier(6) == 1 and b.engine.tier(1) == 0
    ta, tb = a.suggest(6, 1), b.suggest(6, 1)
    np.testing.assert_array_equal(ta[0].unit, tb[0].unit)
    sa, sb = a.suggest_all(t=1), b.suggest_all(t=1)
    out_a = a.advance_round(_events(a, sa))
    out_b = b.advance_round(_events(b, sb))
    for s in range(8):
        np.testing.assert_array_equal(out_a[s][0].unit, out_b[s][0].unit)
    _assert_pools_equal(a, b)


def test_scheduler_splits_its_restarts():
    """The one-study scheduler on a 1x2 mesh: restart shards only."""
    def run(mesh):
        sched = TrialScheduler(RESNET_SPACE, _cfg(mesh), device="cpu",
                               devices=["cpu"] * 2)
        units = []
        for k in range(4):
            trs = sched.suggest(1)
            units.append(trs[0].unit)
            sched.absorb(trs[0], float(-np.sum((trs[0].unit - 0.4) ** 2)))
        return sched, np.stack(units)
    a, ua = run("none")
    b, ub = run("1x2")
    assert b.pool.engine.mesh.restart_shards == 2
    np.testing.assert_array_equal(ua, ub)
    assert torch.equal(a.pool.engine.state.li_buf, b.pool.engine.state.li_buf)


def test_bad_mesh_spec_rejected_at_pool_construction():
    # restarts = 8 not divisible by 3 (or too few devices): either way the
    # pool refuses the spec up front
    with pytest.raises(ValueError, match="divide|devices"):
        _pool("1x3")
    with pytest.raises(ValueError, match="divide|devices"):
        StudyPool([RESNET_SPACE] * 4, _cfg("2x1"), device="cpu")


def test_engine_counter_mirrors_track_the_shards():
    pool = _pool("2x2", n_studies=4)
    out = pool.advance_round([])
    pool.advance_round([(s, out[s][0], 0.1) for s in range(4)])
    pool.absorb(3, pool.seed_trials(3, 1)[0], 0.2)
    eng = pool.engine
    assert eng.state.n.tolist() == [eng.n(s) for s in range(4)] == [1, 1, 1, 2]
    assert eng.state.since_refit.tolist() == \
        [eng.since_refit(s) for s in range(4)]
    eng.state = eng.state
    assert eng.n(3) == 2
    gp_mod.ensure_capacity(eng.n(3), 16)
