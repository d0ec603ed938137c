"""Fault contracts of the port's StudyGateway on the CPU, mirrored from
the gateway tests of tests/test_faults.py: a trial raising mid-round, a
capacity overflow mid-drain (all or nothing), eviction-store write
failures, malformed tells, IO faults at parked asks, kill and restore (no
pre-crash batch replayed, the snapshot step never regresses, an n_max
mismatch refused), and the fantasy pins: an export refuses a
fantasy-active slot, a gateway killed with fantasies out recovers to its
real ledger bit for bit, and a failed q trial releases its row."""
import asyncio
import tempfile

import numpy as np
import pytest
from _torch_port import slot_bytes

from repro_torch import checkpoint as ckpt_mod
from repro_torch.checkpoint import store as store_mod
from repro_torch.core import GPCapacityError
from repro_torch.core.acquisition import AcqConfig
from repro_torch.hpo import (GatewayConfig, SchedulerConfig, StudyGateway,
                             StudyPool, Trial)
from repro_torch.hpo.space import RESNET_SPACE


def _gw(space, cfg, gw=None):
    return StudyGateway(space, cfg, gw, device="cpu")


def _cfg(d, n_max=16, **kw):
    """tests/_traffic.py's make_cfg: small acquisition budget, the pool's
    own per-absorb snapshot cadence off unless a test asks."""
    kw.setdefault("acq", AcqConfig(restarts=8, ascent_steps=4))
    kw.setdefault("ckpt_every", 10_000)
    kw.setdefault("seed", 0)
    return SchedulerConfig(n_max=n_max, ckpt_dir=d, **kw)


def obj(sid, unit):
    """Deterministic per-study objective (tests/_traffic.py)."""
    c = 0.15 + 0.7 * ((sid * 0.37) % 1.0)
    return float(-np.sum((np.asarray(unit) - c) ** 2))


def _foreign_trial(unit) -> Trial:
    """An observation told out of band (never asked)."""
    return Trial(10_000, np.asarray(unit, np.float32), {})


# ---------------------------------------------------------------------------
# Trials raising mid-round
# ---------------------------------------------------------------------------
def test_trial_raising_mid_round_penalizes_and_isolates():
    """A client whose training run throws reports tell_failure: the trial
    ledger records the fault, the penalty pseudo-observation rides the same
    coalesced absorb path, and neighbors advance undisturbed."""
    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d, failure_penalty=-9.0),
                          GatewayConfig(slots=2))
        bad, good = gw.create_study(), gw.create_study()
        t_bad, t_good = await asyncio.gather(gw.ask(bad), gw.ask(good))
        gw.tell_failure(bad, t_bad, "OOM: node lost")
        gw.tell(good, t_good, 0.7)
        await gw.drain()
        assert t_bad.status == "failed" and "OOM" in t_bad.error
        # penalty absorbed into the owning study only
        slot_bad = gw._studies[bad].slot
        assert gw._studies[bad].n_obs == 1
        assert float(gw.pool.state(slot_bad).y_buf[0]) == pytest.approx(-9.0)
        assert gw._studies[good].n_obs == 1
        # a penalty pseudo-observation is never reported as the best
        assert gw.study_info(bad)["best_value"] is None
        assert gw.study_info(good)["best_value"] == pytest.approx(0.7)
        # the failed study keeps serving
        t2 = await gw.ask(bad)
        gw.tell(bad, t2, 0.1)
        await gw.drain()
        assert gw._studies[bad].n_obs == 2
        await gw.aclose()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))


def test_trial_failure_without_penalty_is_ledger_only():
    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d), GatewayConfig(slots=1))
        s = gw.create_study()
        tr = await gw.ask(s)
        gw.tell_failure(s, tr, "SIGKILL")
        await gw.drain()
        assert tr.status == "failed" and gw._studies[s].n_obs == 0
        await gw.aclose()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))


# ---------------------------------------------------------------------------
# Capacity overflow mid-drain (gateway layer over absorb_many's contract)
# ---------------------------------------------------------------------------
def test_capacity_overflow_mid_drain_absorbs_nothing_then_recovers():
    """A tick whose tell queue overflows a study must absorb NOTHING
    (advance_round capacity-checks the whole round first); the absorbable
    prefix requeues and lands next tick, the rest dead-letters."""
    with tempfile.TemporaryDirectory() as d:
        gw = _gw(RESNET_SPACE, _cfg(d, n_max=2),
                          GatewayConfig(slots=2, max_inflight=8))
        s = gw.create_study()
        rng = np.random.default_rng(0)
        gw.tell(s, _foreign_trial(rng.uniform(size=3)), 0.5)
        gw.tick()
        assert gw._studies[s].n_obs == 1
        a, b = (_foreign_trial(rng.uniform(size=3)) for _ in range(2))
        gw.tell(s, a, 0.1)
        gw.tell(s, b, 0.2)           # 1 + 2 > n_max=2: the round must abort
        with pytest.raises(GPCapacityError):
            gw.tick()
        # all-or-nothing: neither observation entered the GP or the ledger
        assert gw._studies[s].n_obs == 1
        slot = gw._studies[s].slot
        assert gw.pool.engine.n(slot) == 1
        # the fitting tell requeued; the unfittable one dead-lettered
        assert len(gw._tells) == 1 and gw._tells[0][1] is a
        assert len(gw.dead_tells) == 1 and gw.dead_tells[0][1] is b
        assert b.status == "failed" and "capacity" in b.error
        gw.tick()                    # recovery: the requeued tell absorbs
        assert gw._studies[s].n_obs == 2 and a.status == "done"


def test_capacity_abort_fails_coalesced_asks_but_spares_neighbors():
    """Asks coalesced into an aborted round get the error at their future;
    a neighbor study keeps serving on the next tick."""
    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d, n_max=1),
                          GatewayConfig(slots=2, max_inflight=8))
        full, ok = gw.create_study(), gw.create_study()
        gw.tell(full, _foreign_trial(np.full(3, 0.5)), 0.4)
        await asyncio.sleep(0)       # no ticker yet: queue is still cold
        gw.tick()
        assert gw._studies[full].n_obs == 1
        # overflow tell + a concurrent ask for the healthy neighbor
        gw.tell(full, _foreign_trial(np.full(3, 0.25)), 0.1)
        ask = asyncio.ensure_future(gw.ask(ok))
        with pytest.raises(GPCapacityError):
            await ask
        # neighbor recovers with a plain re-ask
        tr = await gw.ask(ok)
        gw.tell(ok, tr, 0.3)
        await gw.drain()
        assert gw._studies[ok].n_obs == 1
        await gw.aclose()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))


# ---------------------------------------------------------------------------
# Checkpoint / eviction write failures
# ---------------------------------------------------------------------------
def test_eviction_write_failure_keeps_study_resident(monkeypatch):
    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d), GatewayConfig(slots=1))
        a, b = gw.create_study(), gw.create_study()
        tr = await gw.ask(a)
        gw.tell(a, tr, 0.5)
        await gw.drain()

        def boom(*args, **kw):
            raise OSError("evict store down")
        monkeypatch.setattr(store_mod.np, "savez", boom)
        # b's ask needs a's slot; the eviction snapshot fails to commit →
        # the tick surfaces the IO error, requeues the ask untouched, and
        # a stays resident and serving
        gw.ask_nowait(b)
        with pytest.raises(OSError):
            gw.tick()
        monkeypatch.undo()
        log_a = gw._studies[a]
        assert log_a.slot is not None and log_a.version == 0
        assert not ckpt_mod.list_studies(d)
        # store back up: the deferred ask now succeeds via a real eviction
        gw.tick()
        assert gw._studies[b].slot is not None
        assert log_a.slot is None and log_a.version == 1
        await gw.aclose()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))


def test_tell_with_malformed_unit_rejected_at_caller():
    """A wrong-dim unit must fail the offending tell() immediately — inside
    the fused dispatch it would abort the whole coalesced tick, losing the
    round's tells and stranding every other study's futures."""
    with tempfile.TemporaryDirectory() as d:
        gw = _gw(RESNET_SPACE, _cfg(d), GatewayConfig(slots=2))
        s = gw.create_study()
        with pytest.raises(ValueError, match="unit shape"):
            gw.tell(s, _foreign_trial(np.zeros(5)), 0.1)
        with pytest.raises(ValueError, match="finite"):
            gw.tell(s, _foreign_trial(np.full(3, np.nan)), 0.1)
        with pytest.raises(ValueError, match="finite"):
            gw.tell(s, _foreign_trial(np.full(3, 5.0)), 0.1)
        assert not gw._tells and gw._studies[s].pending_tells == 0


def test_io_fault_fails_parked_asks_instead_of_hanging(monkeypatch):
    """An eviction-store IO fault during an async tick must surface at the
    parked ask() futures, not silently kill the ticker with the clients
    still awaiting (regression: the ticker died, the asks were requeued
    unresolved, and the gateway hung forever).  Queued tells survive and
    the gateway keeps serving once the store recovers."""
    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d), GatewayConfig(slots=1))
        a, b = gw.create_study(), gw.create_study()
        tr = await gw.ask(a)
        gw.tell(a, tr, 0.5)
        await gw.drain()

        def boom(*args, **kw):
            raise OSError("evict store down")
        monkeypatch.setattr(store_mod.np, "savez", boom)
        # b's ask forces an eviction of a; the snapshot write fails → the
        # error lands on b's future instead of hanging it
        with pytest.raises(OSError, match="evict store down"):
            await asyncio.wait_for(gw.ask(b), timeout=30)
        monkeypatch.undo()
        assert gw._studies[a].slot is not None   # a stayed resident
        # store back up: a fresh ask re-creates the ticker and serves
        tb = await asyncio.wait_for(gw.ask(b), timeout=30)
        gw.tell(b, tb, 0.2)
        await gw.drain()
        assert gw.study_info(b)["n_obs"] == 1
        await gw.aclose()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))


# ---------------------------------------------------------------------------
# Kill / restore
# ---------------------------------------------------------------------------
def test_gateway_restore_replays_no_pre_crash_batch():
    """The pool's stream persistence, through the gateway and eviction:
    nothing suggested before the crash is ever suggested again after
    restore, and the restored run re-derives post-checkpoint work
    identically to an uninterrupted gateway."""
    async def drive(gw, sids, rounds, streams):
        for _ in range(rounds):
            for s in sids:
                tr = await gw.ask(s)
                streams[s].append(tuple(np.asarray(tr.unit).tolist()))
                gw.tell(s, tr, obj(s, tr.unit))
                await gw.drain()

    async def main(d_ref, d_crash):
        # uninterrupted reference
        ref = _gw(RESNET_SPACE, _cfg(d_ref), GatewayConfig(slots=2))
        ref_sids = [ref.create_study() for _ in range(3)]
        ref_streams = {s: [] for s in ref_sids}
        await drive(ref, ref_sids, 4, ref_streams)
        await ref.aclose()

        gw = _gw(RESNET_SPACE, _cfg(d_crash), GatewayConfig(slots=2))
        sids = [gw.create_study() for _ in range(3)]
        pre = {s: [] for s in sids}
        await drive(gw, sids, 2, pre)
        gw.checkpoint()              # quiescent snapshot
        await drive(gw, sids, 1, {s: [] for s in sids})  # lost to the crash
        await gw.aclose()            # CRASH (post-checkpoint work discarded)

        gw2 = _gw(RESNET_SPACE, _cfg(d_crash), GatewayConfig(slots=2))
        assert gw2.restore()
        post = {s: [] for s in sids}
        await drive(gw2, sids, 2, post)
        await gw2.aclose()

        for s in sids:
            assert set(pre[s]).isdisjoint(post[s]), \
                "restored gateway replayed a pre-crash suggestion"
            # restored == uninterrupted, bitwise, through eviction churn
            assert pre[s] + post[s] == ref_streams[s]
    with tempfile.TemporaryDirectory() as d_ref, \
            tempfile.TemporaryDirectory() as d_crash:
        asyncio.run(main(d_ref, d_crash))


def test_restored_gateway_checkpoints_never_regress_step():
    """The pool's snapshot step must resume from the restored snapshot's
    own step, not from the resident ledgers: with studies evicted, the
    absorbed observations live in partial snapshots, so a ledger count
    under-counts and a post-restore checkpoint written at a LOWER step
    would be shadowed forever by the pre-crash one (restore_latest picks
    the max) — silently losing the whole resumed run."""
    async def drive(gw, s, rounds):
        for _ in range(rounds):
            tr = await gw.ask(s)
            gw.tell(s, tr, obj(s, tr.unit))
            await gw.drain()

    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d), GatewayConfig(slots=1))
        a, b = gw.create_study(), gw.create_study()
        await drive(gw, a, 2)
        await drive(gw, b, 2)        # evicts a: its 2 obs leave the ledgers
        gw.checkpoint()
        step1 = ckpt_mod.latest_step(d)
        await gw.aclose()

        gw2 = _gw(RESNET_SPACE, _cfg(d), GatewayConfig(slots=1))
        assert gw2.restore()
        await drive(gw2, a, 1)       # restores a on demand (evicting b)
        gw2.checkpoint()
        assert ckpt_mod.latest_step(d) > step1, \
            "post-restore checkpoint regressed the snapshot step"
        await gw2.aclose()

        # the run-2 checkpoint is the recovery point and is self-consistent
        gw3 = _gw(RESNET_SPACE, _cfg(d), GatewayConfig(slots=1))
        assert gw3.restore()
        assert gw3._studies[a].n_obs == 3 and gw3._studies[b].n_obs == 2
        # its registry's study versions survived the commit-time prune:
        # restore-on-demand of the evicted tenant must still succeed
        evicted = a if gw3._studies[a].slot is None else b
        await drive(gw3, evicted, 1)
        await gw3.aclose()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))


def test_restore_with_mismatched_n_max_raises():
    """A checkpoint taken at one n_max must not load into a pool built with
    another: the buffers are fixed-size, and a silent load would let the
    capacity guards (reading the new cfg) drive appends past the restored
    rows — JAX clamps the out-of-bounds index and overwrites the last row
    (regression: only the study COUNT was validated, not the shapes)."""
    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d, n_max=10),
                          GatewayConfig(slots=2))
        s = gw.create_study()
        tr = await gw.ask(s)
        gw.tell(s, tr, 0.5)
        await gw.drain()
        gw.checkpoint()
        await gw.aclose()
        gw2 = _gw(RESNET_SPACE, _cfg(d, n_max=13),
                           GatewayConfig(slots=2))
        with pytest.raises(ValueError, match="shape mismatch"):
            gw2.restore()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))


def test_export_refuses_fantasy_active_slot_and_eviction_pins():
    """Eviction snapshots must see only real state: `export_study` refuses
    a fantasy-active slot, and the gateway never selects one for LRU
    eviction (fantasy-pinned) even with its counters artificially idle."""
    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d, n_max=32),
                          GatewayConfig(slots=2, max_inflight=8))
        a, b, c = (gw.create_study() for _ in range(3))
        for sid in (a, b):
            tr = await gw.ask(sid)
            gw.tell(sid, tr, obj(sid, tr.unit))
        await gw.drain()
        batch = await gw.ask(a, q=2)
        slot_a = gw._studies[a].slot
        with pytest.raises(RuntimeError, match="fantasy"):
            gw.pool.export_study(slot_a)
        # white-box: even with in-flight bookkeeping zeroed, the fantasy
        # rows alone pin the study
        log = gw._studies[a]
        saved = log.inflight
        log.inflight = 0
        assert not gw._evictable(log)
        log.inflight = saved
        # study c's first ask must evict b (idle), never a
        tr_c = await gw.ask(c)
        assert gw._studies[a].slot == slot_a
        assert gw._studies[b].slot is None and gw._studies[b].evicted_ever
        for tr in batch:
            gw.tell(a, tr, obj(a, tr.unit))
        gw.tell(c, tr_c, obj(c, tr_c.unit))
        await gw.drain()
        assert gw.summary()["fantasy_active"] == 0
        await gw.aclose()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))


def test_gateway_kill_recover_with_fantasies_equals_real_ledger():
    """Kill/recover through the GATEWAY with q-ask fantasies outstanding:
    the recovered gateway serves from the real ledger only — bitwise the
    state of a twin pool that absorbed the same real observations."""
    async def main(d, d2):
        gw = _gw(RESNET_SPACE, _cfg(d, n_max=48),
                          GatewayConfig(slots=1, max_inflight=8))
        sid = gw.create_study()
        pb = StudyPool([RESNET_SPACE], _cfg(d2, n_max=48), device="cpu")
        for _ in range(3):
            tr = await gw.ask(sid)
            v = obj(sid, tr.unit)
            gw.tell(sid, tr, v)
            await gw.drain()
            pb.absorb(0, _foreign_trial(tr.unit), v)
        batch = await gw.ask(sid, q=3)
        told = batch[1]
        v = obj(sid, told.unit)
        gw.tell(sid, told, v)
        await gw.drain()
        pb.absorb(0, _foreign_trial(told.unit), v)
        assert gw.pool.fantasy_active(0) == 2
        gw.checkpoint()     # rolls back around the snapshot
        await gw.aclose()   # crash: 2 suggestions die with their clients

        gw2 = _gw(RESNET_SPACE, _cfg(d, n_max=48),
                           GatewayConfig(slots=1, max_inflight=8))
        assert gw2.restore()
        assert gw2.study_info(sid)["n_obs"] == 4
        assert gw2.summary()["fantasy_active"] == 0
        # lifetime q telemetry survived
        assert gw2.summary()["q_width_hist"].get("3") == 1
        tr = await gw2.ask(sid)   # slot re-residency replays real state
        a, b = slot_bytes(gw2.pool, 0), slot_bytes(pb, 0)
        for leaf in a:
            assert a[leaf] == b[leaf], f"{leaf} differs after recovery"
        gw2.tell(sid, tr, obj(sid, tr.unit))
        await gw2.drain()
        await gw2.aclose()
    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as d2:
        asyncio.run(main(d, d2))


def test_failed_q_trial_releases_its_fantasy_row():
    """tell_failure without a penalty must release the failed trial's
    fantasy row (no tell will ever come), unpinning the study."""
    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d, n_max=32),
                          GatewayConfig(slots=1, max_inflight=8))
        sid = gw.create_study()
        tr = await gw.ask(sid)
        gw.tell(sid, tr, obj(sid, tr.unit))
        await gw.drain()
        batch = await gw.ask(sid, q=3)
        assert gw.pool.fantasy_active(0) == 3
        gw.tell_failure(sid, batch[0], "diverged")
        assert gw.pool.fantasy_active(0) == 2
        for tr in batch[1:]:
            gw.tell(sid, tr, obj(sid, tr.unit))
        await gw.drain()
        assert gw.pool.fantasy_active(0) == 0
        assert gw.study_info(sid)["n_obs"] == 3   # the failure absorbed no row
        assert gw._evictable(gw._studies[sid])
        await gw.aclose()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))


# ---------------------------------------------------------------------------
# A staged round's readback waits for that round alone
# ---------------------------------------------------------------------------
class _Event:
    """A stand-in for the CUDA event `pool._to_host` records: it logs its
    waits."""

    def __init__(self, waits):
        self.waits = waits

    def synchronize(self):
        self.waits.append(self)


def _emulated_to_host(monkeypatch, events, waits):
    """Route `pool._to_host` through its card form on the CPU: each output
    copied into a tensor of its own (the pinned copy), one event a
    round."""
    import repro_torch.hpo.pool as pool_mod

    def to_host(tensors):
        ev = _Event(waits)
        events.append(ev)
        return {k: None if t is None else pool_mod._HostCopy(t.clone(), ev)
                for k, t in tensors.items()}
    monkeypatch.setattr(pool_mod, "_to_host", to_host)


def test_to_host_leaves_cpu_tensors_alone():
    import torch

    import repro_torch.hpo.pool as pool_mod
    t = torch.arange(3.0)
    out = pool_mod._to_host({"units": t, "clamps": None})
    assert out["units"] is t and out["clamps"] is None


def test_finish_waits_on_its_own_round_and_reads_what_begin_staged(
        monkeypatch):
    """Two staged rounds in the pipelined order (begin t, begin t + 1,
    finish t, finish t + 1), their outputs on the way to the host as on
    the card: finishing round t waits on round t's event only, and each
    round's trials are bit for bit the serial twin's."""
    events, waits = [], []
    with tempfile.TemporaryDirectory() as d:
        pa = StudyPool([RESNET_SPACE] * 2, _cfg(d), device="cpu")
        pb = StudyPool([RESNET_SPACE] * 2, _cfg(None), device="cpu")
        for pool in (pa, pb):
            first = pool.suggest_all()
            pool.absorb_many([(s, trs[0], obj(s, trs[0].unit))
                              for s, trs in first.items()])
        sa, sb = pa.suggest_all(), pb.suggest_all()
        _emulated_to_host(monkeypatch, events, waits)
        p1 = pa.advance_round_begin([(0, sa[0][0], obj(0, sa[0][0].unit))],
                                    studies=[0])
        p2 = pa.advance_round_begin([(1, sa[1][0], obj(1, sa[1][0].unit))],
                                    studies=[1])
        assert len(events) == 2 and not waits
        out1 = p1.finish()
        assert set(waits) == {events[0]}
        out2 = p2.finish()
        assert set(waits) == set(events)
        want1 = pb.advance_round([(0, sb[0][0], obj(0, sb[0][0].unit))],
                                 studies=[0])
        want2 = pb.advance_round([(1, sb[1][0], obj(1, sb[1][0].unit))],
                                 studies=[1])
    for got, want in ((out1, want1), (out2, want2)):
        assert got.keys() == want.keys()
        for s in got:
            assert np.array_equal(got[s][0].unit, want[s][0].unit)
    assert sa[0][0].status == sa[1][0].status == "done"
    assert sa[0][0].clamp_count == sb[0][0].clamp_count


def test_materialize_is_the_fault_hook_of_a_staged_copy(monkeypatch):
    """With the outputs staged as on the card, a device error surfacing at
    `_materialize` still comes before any ledger flip, and the gateway
    fails exactly that tick's futures."""
    import repro_torch.hpo.pool as pool_mod
    events, waits = [], []

    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d, n_max=24), GatewayConfig(slots=2))
        a = gw.create_study()
        loop = asyncio.get_running_loop()
        f = loop.create_future()
        gw._studies[a].pending_asks += 1
        gw._asks.append((a, f, 1))
        gw.tick()
        tr = f.result()
        gw.tell(a, tr, obj(a, tr.unit))
        f2 = loop.create_future()
        gw._studies[a].pending_asks += 1
        gw._asks.append((a, f2, 1))
        _emulated_to_host(monkeypatch, events, waits)

        def boom(x):
            raise RuntimeError("device fault")
        real = pool_mod._materialize
        monkeypatch.setattr(pool_mod, "_materialize", boom)
        with pytest.raises(RuntimeError, match="device fault"):
            gw.tick()
        assert tr.status == "told" and gw.study_info(a)["n_obs"] == 0
        assert isinstance(f2.exception(), RuntimeError)
        monkeypatch.setattr(pool_mod, "_materialize", real)
        gw.tick()                       # the requeued tell lands
        assert tr.status == "done" and gw.study_info(a)["n_obs"] == 1
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))
