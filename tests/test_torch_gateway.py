"""The port's StudyGateway on the CPU, mirrored from tests/test_gateway.py
(coalescing ticks, admission control, LRU eviction and restore on demand
bit for bit, gateway checkpoints, q-asks, pipelined ticks bitwise the
serial ones), the gateway tests of tests/test_tier.py (escalation past
n_max, the capacity taxonomy, costs) and of tests/test_mixed.py (mixed
tenants), at the reference's small sizes.  Every gateway runs with
`device="cpu"`."""
import asyncio
import dataclasses
import tempfile

import numpy as np
import pytest
import torch
from _torch_port import assert_slots_equal, slot_bytes

from repro_torch import checkpoint as ckpt_mod
from repro_torch.core import (BackpressureError, GPCapacityError,
                              NeuralConfig, StudySaturatedError)
from repro_torch.core.acquisition import AcqConfig
from repro_torch.core.levy import levy_bounds, neg_levy
from repro_torch.hpo import (GatewayConfig, SchedulerConfig, StudyGateway,
                             Trial)
from repro_torch.hpo.space import (LENET_SPACE, MIXED_DEMO_SPACE,
                                   RESNET_SPACE, Categorical, Dim,
                                   SearchSpace)


def _gw(space, cfg, gw=None):
    return StudyGateway(space, cfg, gw, device="cpu")


def _cfg(d, n_max=16, **kw):
    kw.setdefault("acq", AcqConfig(restarts=8, ascent_steps=4))
    kw.setdefault("ckpt_every", 10_000)   # cadence off unless a test wants it
    return SchedulerConfig(n_max=n_max, seed=0, ckpt_dir=d, **kw)


def obj(sid, unit):
    c = 0.2 + 0.12 * (sid % 5)
    return float(-np.sum((np.asarray(unit) - c) ** 2))


async def _loop(gw, sid, rounds, out=None):
    for _ in range(rounds):
        tr = await gw.ask(sid)
        if out is not None:
            out.append(np.asarray(tr.unit).copy())
        gw.tell(sid, tr, obj(sid, tr.unit))
    await gw.drain()


def test_gateway_requires_ckpt_dir():
    with pytest.raises(ValueError, match="ckpt_dir"):
        _gw(RESNET_SPACE, SchedulerConfig(n_max=8, ckpt_dir=None))


def test_concurrent_asks_coalesce_into_one_tick():
    """N clients asking at once must be served by ONE fused dispatch."""
    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d), GatewayConfig(slots=6))
        sids = [gw.create_study() for _ in range(6)]
        trials = await asyncio.gather(*(gw.ask(s) for s in sids))
        assert len({id(t) for t in trials}) == 6
        assert gw.summary()["ticks"] == 1
        assert gw.stats[-1]["width"] == 6
        for s, tr in zip(sids, trials):
            gw.tell(s, tr, obj(s, tr.unit))
        await gw.drain()
        # the tells coalesced too: one absorb round
        assert gw.summary()["ticks"] == 2
        assert gw.stats[-1]["absorbed"] == 6
        await gw.aclose()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))


def test_coalesce_window_gathers_staggered_asks():
    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d),
                          GatewayConfig(slots=2, coalesce_ms=150))
        a, b = gw.create_study(), gw.create_study()

        async def late_ask(sid):
            await asyncio.sleep(0.01)
            return await gw.ask(sid)

        t1, t2 = await asyncio.gather(gw.ask(a), late_ask(b))
        assert gw.summary()["ticks"] == 1     # both landed in one window
        gw.tell(a, t1, 0.1)
        gw.tell(b, t2, 0.2)
        await gw.drain()
        await gw.aclose()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))


def test_max_batch_caps_tick_width():
    with tempfile.TemporaryDirectory() as d:
        gw = _gw(RESNET_SPACE, _cfg(d),
                          GatewayConfig(slots=4, max_batch=2))
        sids = [gw.create_study() for _ in range(4)]
        for s in sids:
            gw.ask_nowait(s)
        assert gw.tick() == 2 and gw.stats[-1]["width"] == 2
        assert gw.tick() == 2
        assert gw.tick() == 0


def test_one_ask_per_study_per_tick():
    """A second queued ask for the same study waits for the next round."""
    with tempfile.TemporaryDirectory() as d:
        gw = _gw(RESNET_SPACE, _cfg(d),
                          GatewayConfig(slots=2, max_inflight=4))
        s = gw.create_study()
        gw.ask_nowait(s)
        gw.ask_nowait(s)
        assert gw.tick() == 1
        assert gw.tick() == 1


def test_admission_rejects_inflight_and_queue_overflow():
    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d),
                          GatewayConfig(slots=2, max_inflight=2, max_queue=3))
        s = gw.create_study()
        t1 = await gw.ask(s)
        t2 = await gw.ask(s)
        with pytest.raises(GPCapacityError, match="in flight"):
            await gw.ask(s)
        gw.tell(s, t1, 0.1)
        gw.tell(s, t2, 0.2)
        await gw.drain()
        await gw.aclose()
        # queue bound (sync path; ticker never runs)
        gw2 = _gw(RESNET_SPACE, _cfg(d + "/q"),
                           GatewayConfig(slots=2, max_queue=3,
                                         max_inflight=8))
        q = gw2.create_study()
        for _ in range(3):
            gw2.ask_nowait(q)
        with pytest.raises(GPCapacityError, match="queue full"):
            gw2.ask_nowait(q)
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))


def test_capacity_aware_ask_reject_before_training():
    """An ask whose eventual tell cannot fit n_max is refused up front."""
    with tempfile.TemporaryDirectory() as d:
        gw = _gw(RESNET_SPACE, _cfg(d, n_max=3),
                          GatewayConfig(slots=1, max_inflight=8,
                                        escalate=False))
        s = gw.create_study()
        for _ in range(3):
            gw.ask_nowait(s)
            gw.tick()
        # 3 suggestions out == n_max committed: a 4th can never be absorbed
        with pytest.raises(GPCapacityError, match="n_max"):
            gw.ask_nowait(s)


def test_eviction_restore_is_exact_bitwise():
    """THE serving-layer contract: a study evicted to its partial snapshot
    and restored on demand produces bitwise-identical suggestions to the
    same study in a gateway with enough slots to never evict."""
    async def probe(d, slots):
        gw = _gw(RESNET_SPACE, _cfg(d), GatewayConfig(slots=slots))
        sids = [gw.create_study(name=f"t{i}") for i in range(3)]
        out = []
        for _ in range(5):
            tr = await gw.ask(sids[0])
            out.append(np.asarray(tr.unit).copy())
            gw.tell(sids[0], tr, obj(0, tr.unit))
            await gw.drain()
            for s in sids[1:]:    # churn: forces sids[0] out when slots=2
                tr2 = await gw.ask(s)
                gw.tell(s, tr2, obj(s, tr2.unit))
                await gw.drain()
        log = gw._studies[sids[0]]
        await gw.aclose()
        return out, log

    async def main(d1, d2):
        resident, log_a = await probe(d1, slots=3)
        churned, log_b = await probe(d2, slots=2)
        assert not log_a.evicted_ever
        assert log_b.evicted_ever and log_b.version >= 2
        for k, (x, y) in enumerate(zip(resident, churned)):
            assert np.array_equal(x, y), \
                f"suggestion {k} diverged after eviction/restore"
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        asyncio.run(main(d1, d2))


def test_more_logical_studies_than_slots():
    """The pool serves S_logical > slots via LRU eviction; every study
    makes progress and eviction traffic shows up in the telemetry."""
    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d), GatewayConfig(slots=2))
        sids = [gw.create_study() for _ in range(5)]
        await asyncio.gather(*(_loop(gw, s, 3) for s in sids))
        for s in sids:
            assert gw._studies[s].n_obs == 3
        assert gw.summary()["evictions"] >= 3
        # best_value is residency-independent: evicted tenants keep theirs
        for s in sids:
            assert gw.study_info(s)["best_value"] is not None
        # an evicted study transparently restores on its next ask
        evicted = next(s for s in sids if gw._studies[s].slot is None
                       and gw._studies[s].evicted_ever)
        await _loop(gw, evicted, 1)
        assert gw.summary()["restores"] >= 1
        assert gw._studies[evicted].n_obs == 4
        await gw.aclose()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))


def test_asks_defer_when_all_slots_pinned():
    """Asks beyond the slot count wait (backpressure), not fail: they are
    served as soon as a tell frees a study."""
    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d), GatewayConfig(slots=2))
        a, b, c = (gw.create_study() for _ in range(3))
        ta = await gw.ask(a)
        tb = await gw.ask(b)
        # both slots pinned by in-flight work: c's ask must defer
        ask_c = asyncio.ensure_future(gw.ask(c))
        await asyncio.sleep(0.05)
        assert not ask_c.done()
        gw.tell(a, ta, 0.5)             # frees study a at the next tick
        tc = await asyncio.wait_for(ask_c, timeout=30)
        assert tc is not None
        gw.tell(b, tb, 0.1)
        gw.tell(c, tc, 0.2)
        await gw.drain()
        await gw.aclose()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))


def test_tell_failure_without_penalty_unblocks_deferred_ask():
    """tell_failure with failure_penalty=None (the default) frees the
    study's in-flight budget; a deferred ask waiting on that study must be
    re-woken (regression: the wake was only set on the penalty path, so
    the ticker parked forever and the deferred ask hung)."""
    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d), GatewayConfig(slots=1))
        a, b = gw.create_study(), gw.create_study()
        ta = await gw.ask(a)
        ask_b = asyncio.ensure_future(gw.ask(b))
        await asyncio.sleep(0.05)
        assert not ask_b.done()      # a's in-flight work pins the only slot
        gw.tell_failure(a, ta, "node lost")   # no penalty tell is queued
        tb = await asyncio.wait_for(ask_b, timeout=30)
        gw.tell(b, tb, 0.1)
        await gw.drain()
        await gw.aclose()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))


def test_cancelled_ask_does_not_leak_inflight():
    """A client that cancels its ask before delivery must not pin the
    study: the drawn suggestion is abandoned (ledger-marked failed), not
    counted in flight — a leak would eat max_inflight and make the study
    permanently non-evictable."""
    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d),
                          GatewayConfig(slots=2, max_inflight=1))
        s = gw.create_study()
        task = asyncio.ensure_future(gw.ask(s))
        await asyncio.sleep(0)       # ask enqueued; the tick has not fired
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        await gw.drain()
        log = gw._studies[s]
        assert log.inflight == 0 and log.pending_asks == 0
        # the max_inflight=1 budget is intact: a fresh ask is admitted
        tr = await asyncio.wait_for(gw.ask(s), timeout=30)
        gw.tell(s, tr, 0.2)
        await gw.drain()
        assert log.n_obs == 1
        await gw.aclose()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))


def test_tell_rejects_nonfinite_and_replayed_results():
    """Bad tells fail at the caller, never inside the fused round: NaN
    values (a poisoned posterior would silently stop optimizing) and
    replays of an already-resolved trial (the duplicate row would eat
    n_max budget and double-weight the point)."""
    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d), GatewayConfig(slots=1))
        s = gw.create_study()
        tr = await gw.ask(s)
        with pytest.raises(ValueError, match="non-finite"):
            gw.tell(s, tr, float("nan"))
        gw.tell(s, tr, 0.3)
        with pytest.raises(RuntimeError, match="one tell"):
            gw.tell(s, tr, 0.3)          # same-window replay
        await gw.drain()
        with pytest.raises(RuntimeError, match="one tell"):
            gw.tell(s, tr, 0.3)          # replay after absorption
        assert gw._studies[s].n_obs == 1
        await gw.aclose()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))


def test_restore_cancels_parked_asks():
    """restore() discards in-flight work; clients parked on pre-restore
    asks must be cancelled, not left awaiting futures nobody will ever
    resolve."""
    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d), GatewayConfig(slots=1))
        a, b = gw.create_study(), gw.create_study()
        ta = await gw.ask(a)
        gw.tell(a, ta, 0.1)
        await gw.drain()
        gw.checkpoint()
        ta2 = await gw.ask(a)            # pins the only slot again
        ask_b = asyncio.ensure_future(gw.ask(b))
        await asyncio.sleep(0.05)
        assert not ask_b.done()          # parked, deferred
        assert gw.restore()
        with pytest.raises(asyncio.CancelledError):
            await asyncio.wait_for(ask_b, timeout=10)
        assert ta2 is not None
        await gw.aclose()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))


def test_close_study_frees_slot_and_refuses_inflight():
    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d), GatewayConfig(slots=2))
        a, b = gw.create_study(), gw.create_study()
        tr = await gw.ask(a)
        with pytest.raises(RuntimeError, match="in flight"):
            gw.close_study(a)
        gw.tell(a, tr, 0.3)
        await gw.drain()
        gw.close_study(a)
        with pytest.raises(RuntimeError, match="closed"):
            await gw.ask(a)
        # the freed slot serves a new tenant
        tr_b = await gw.ask(b)
        gw.tell(b, tr_b, 0.1)
        await gw.drain()
        await gw.aclose()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))


def test_closed_studies_leave_registry_and_store():
    """Tenant churn must not grow the registry or the eviction store:
    close_study tombstones the id, drops the record, and the next
    checkpoint COMMIT deletes its snapshot dirs (never before — a crash
    must restore a registry whose studies are all on disk).  Lifetime
    telemetry totals ride the registry across restores."""
    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d), GatewayConfig(slots=1))
        a, b = gw.create_study(), gw.create_study()
        await _loop(gw, a, 1)
        await _loop(gw, b, 1)           # evicts a to the store
        assert ckpt_mod.list_studies(d)
        gw.close_study(a)
        assert ckpt_mod.list_studies(d)  # snapshots survive until commit
        gw.checkpoint()
        assert not ckpt_mod.list_studies(d)
        await gw.aclose()

        gw2 = _gw(RESNET_SPACE, _cfg(d), GatewayConfig(slots=1))
        assert gw2.restore()
        assert gw2.study_ids() == [b]
        with pytest.raises(RuntimeError, match="closed"):
            await gw2.ask(a)
        s = gw2.summary()
        assert s["ticks"] > 0 and s["asks_served"] == 2  # lifetime totals
        await gw2.aclose()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))


def test_mismatched_space_dim_rejected():
    with tempfile.TemporaryDirectory() as d:
        gw = _gw(RESNET_SPACE, _cfg(d))
        with pytest.raises(ValueError, match="dim"):
            gw.create_study(space=LENET_SPACE)


def test_create_study_default_space_survives_slot_churn():
    """create_study()'s default is the constructor template, NOT whatever
    tenant currently occupies slot 0 (regression: a custom-space tenant in
    slot 0 leaked its bounds into later default-space studies)."""
    from repro_torch.hpo.space import Dim, SearchSpace
    custom = SearchSpace((Dim("a", 5.0, 9.0), Dim("b", 5.0, 9.0),
                          Dim("c", 5.0, 9.0)))
    with tempfile.TemporaryDirectory() as d:
        gw = _gw(RESNET_SPACE, _cfg(d), GatewayConfig(slots=1))
        s0 = gw.create_study(space=custom)
        gw.ask_nowait(s0)
        gw.tick()                    # the custom tenant now owns slot 0
        assert gw._studies[s0].slot == 0
        s1 = gw.create_study()
        assert gw._studies[s1].space is RESNET_SPACE


def test_restore_reapplies_custom_space_to_resident_slots():
    """The pool snapshot carries no spaces; gateway.restore() must push
    each logical study's own space back onto its resident slot (regression:
    restored resident studies mapped suggestions through the constructor's
    template bounds)."""
    from repro_torch.hpo.space import Dim, SearchSpace
    custom = SearchSpace((Dim("c0", 100.0, 200.0), Dim("c1", 100.0, 200.0),
                          Dim("c2", 100.0, 200.0)))

    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d), GatewayConfig(slots=2))
        s = gw.create_study(space=custom)
        tr = await gw.ask(s)
        gw.tell(s, tr, 0.1)
        await gw.drain()
        gw.checkpoint()
        await gw.aclose()

        gw2 = _gw(RESNET_SPACE, _cfg(d), GatewayConfig(slots=2))
        assert gw2.restore()
        assert gw2._studies[s].slot is not None     # restored resident
        tr2 = await gw2.ask(s)
        assert set(tr2.hparams) == {"c0", "c1", "c2"}
        assert all(100.0 <= v <= 200.0 for v in tr2.hparams.values())
        gw2.tell(s, tr2, 0.2)
        await gw2.drain()
        await gw2.aclose()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))


def test_gateway_checkpoint_restore_roundtrip():
    """A restored gateway resumes registry, slot map, ledgers, and PRNG
    streams; subsequent suggestions match an uninterrupted gateway."""
    async def main(d_a, d_b):
        streams = {}
        for key, dd, interrupt in (("a", d_a, False), ("b", d_b, True)):
            gw = _gw(RESNET_SPACE, _cfg(dd), GatewayConfig(slots=2))
            sids = [gw.create_study(name=f"t{i}") for i in range(3)]
            out = {s: [] for s in sids}
            for s in sids:
                await _loop(gw, s, 2, out[s])
            if interrupt:
                gw.checkpoint()
                await gw.aclose()
                gw = _gw(RESNET_SPACE, _cfg(dd),
                                  GatewayConfig(slots=2))
                assert gw.restore()
                for s in sids:
                    assert gw._studies[s].n_obs == 2
            for s in sids:
                await _loop(gw, s, 2, out[s])
            await gw.aclose()
            streams[key] = out
        for s in streams["a"]:
            for k, (x, y) in enumerate(zip(streams["a"][s],
                                           streams["b"][s])):
                assert np.array_equal(x, y), \
                    f"study {s} suggestion {k} diverged across restore"
    with tempfile.TemporaryDirectory() as d_a, \
            tempfile.TemporaryDirectory() as d_b:
        asyncio.run(main(d_a, d_b))


def test_summary_counts_are_lifetime_not_windowed():
    """asks_served/absorbed/evictions/restores are run totals; only the
    latency/width distributions roll over with the stats window."""
    with tempfile.TemporaryDirectory() as d:
        gw = _gw(RESNET_SPACE, _cfg(d),
                          GatewayConfig(slots=2, stats_window=2))
        s = gw.create_study()
        for _ in range(4):
            gw.ask_nowait(s)
            gw.tick()
        assert len(gw.stats) == 2            # window capped
        assert gw.summary()["asks_served"] == 4   # lifetime total


def test_telemetry_summary_fields():
    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d), GatewayConfig(slots=3))
        # zero-traffic summary carries the full key set (consumers index
        # these unconditionally)
        empty = gw.summary()
        assert empty["ticks"] == 0 and empty["asks_served"] == 0
        assert empty["mean_coalesce_width"] == 0.0
        sids = [gw.create_study() for _ in range(3)]
        await asyncio.gather(*(_loop(gw, s, 2) for s in sids))
        s = gw.summary()
        assert s["asks_served"] == 6 and s["absorbed"] == 6
        assert s["mean_coalesce_width"] >= 1.0
        assert s["p50_tick_ms"] > 0 and s["p95_tick_ms"] >= s["p50_tick_ms"]
        assert gw.study_ids() == sids
        info = gw.study_info(sids[0])
        assert info["n_obs"] == 2 and info["resident"]
        assert info["best_value"] is not None
        with pytest.raises(KeyError):
            gw.study_info(999)
        await gw.aclose()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))


# ---------------------------------------------------------------------------
# Batched q-suggestion serving (DESIGN.md §12)
# ---------------------------------------------------------------------------
def test_ask_q_serves_batch_coalesced_with_singles():
    """One ask(q=4) returns 4 distinct suggestions, served on the SAME tick
    as the other tenants' q=1 asks; q widths land in the telemetry."""
    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d, n_max=32),
                          GatewayConfig(slots=3, max_inflight=8))
        a, b, c = (gw.create_study() for _ in range(3))
        # seed tenant a so its q-ask runs the fantasy path, not random seeds
        tr = await gw.ask(a)
        gw.tell(a, tr, obj(a, tr.unit))
        await gw.drain()
        t0 = gw.summary()["ticks"]
        batch, tb, tc = await asyncio.gather(
            gw.ask(a, q=4), gw.ask(b), gw.ask(c))
        assert gw.summary()["ticks"] == t0 + 1   # one coalesced tick
        assert isinstance(batch, list) and len(batch) == 4
        units = {np.asarray(t.unit).tobytes() for t in batch}
        assert len(units) == 4                   # jointly diverse
        assert gw.stats[-1]["width"] == 3        # 3 asks...
        assert gw.stats[-1]["suggestions"] == 6  # ...6 suggestions
        assert gw._studies[a].inflight == 4
        assert gw.study_info(a)["fantasy_active"] == 4
        for tr in batch:
            gw.tell(a, tr, obj(a, tr.unit))
        gw.tell(b, tb, obj(b, tb.unit))
        gw.tell(c, tc, obj(c, tc.unit))
        await gw.drain()
        assert gw.summary()["fantasy_active"] == 0
        assert gw.summary()["q_width_hist"] == {"1": 3, "4": 1}
        assert gw.study_info(a)["n_obs"] == 5
        await gw.aclose()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))


def test_ask_q_admission_rejections():
    """q-aware admission: q > max_inflight is unservable (clear error, not
    a hang), inflight + q over the cap rejects, and committed + q beyond
    n_max rejects — all BEFORE any fantasy row is appended."""
    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d, n_max=8),
                          GatewayConfig(slots=1, max_inflight=4,
                                        escalate=False))
        sid = gw.create_study()
        with pytest.raises(GPCapacityError, match="max_inflight"):
            await gw.ask(sid, q=5)     # unservable at any future time
        with pytest.raises(ValueError, match="q"):
            await gw.ask(sid, q=0)
        batch = await gw.ask(sid, q=3)
        with pytest.raises(GPCapacityError, match="in flight"):
            await gw.ask(sid, q=2)     # 3 inflight + 2 > 4
        for tr in batch:
            gw.tell(sid, tr, obj(sid, tr.unit))
        await gw.drain()
        tr = await gw.ask(sid, q=4)    # 3 committed + 4 <= 8: fine
        for t in tr:
            gw.tell(sid, t, obj(sid, t.unit))
        await gw.drain()
        with pytest.raises(GPCapacityError, match="n_max"):
            await gw.ask(sid, q=2)     # 7 committed + 2 > 8
        one = await gw.ask(sid)        # the last row still serves q=1
        gw.tell(sid, one, obj(sid, one.unit))
        await gw.drain()
        await gw.aclose()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))


def test_q_telemetry_persists_across_checkpoint_restore():
    """`q_width_hist` and `fantasy_rollbacks` are lifetime totals: they ride
    the checkpoint registry and keep counting after a restore."""
    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d, n_max=32),
                          GatewayConfig(slots=1, max_inflight=8))
        sid = gw.create_study()
        tr = await gw.ask(sid)
        gw.tell(sid, tr, obj(sid, tr.unit))
        await gw.drain()
        for tr in await gw.ask(sid, q=2):
            gw.tell(sid, tr, obj(sid, tr.unit))
        await gw.drain()
        s1 = gw.summary()
        assert s1["q_width_hist"] == {"1": 1, "2": 1}
        assert s1["fantasy_rollbacks"] >= 1
        gw.checkpoint()
        await gw.aclose()

        gw2 = _gw(RESNET_SPACE, _cfg(d, n_max=32),
                           GatewayConfig(slots=1, max_inflight=8))
        assert gw2.restore()
        s2 = gw2.summary()
        assert s2["q_width_hist"] == s1["q_width_hist"]
        assert s2["fantasy_rollbacks"] == s1["fantasy_rollbacks"]
        # counters keep accumulating, not reset-and-overwrite
        for tr in await gw2.ask(sid, q=2):
            gw2.tell(sid, tr, obj(sid, tr.unit))
        await gw2.drain()
        s3 = gw2.summary()
        assert s3["q_width_hist"]["2"] == 2
        assert s3["fantasy_rollbacks"] > s2["fantasy_rollbacks"]
        await gw2.aclose()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))


# ---------------------------------------------------------------------------
# Pipelined ticks: on/off bitwise equivalence + in-flight faults (§13)
# ---------------------------------------------------------------------------
def _enq(gw, loop, sid, q=1):
    """White-box ask enqueue (no ticker): the returned future resolves when
    a manual tick_begin/tick_flush finishes the tick that served it."""
    fut = loop.create_future()
    gw._studies[sid].pending_asks += q
    gw._asks.append((sid, fut, q))
    return fut


async def _scripted_run(d, pipelined, rounds=10):
    """One deterministic TRACE — rotating 2-study ask subsets over 4
    studies on 2 slots (eviction churn every round), a q=3 fantasy batch
    every third round — driven by tick_begin() when pipelined, plain
    tick() otherwise.  The trace is fixed by ENQUEUE round, not by future
    resolution time: a trial asked at round r is told at the start of
    round r+2 in BOTH modes (pipelined futures resolve one round later
    than serial ones; scheduling tells off resolution time would change
    the event order itself, which no scheduler can be expected to hide)."""
    gw = _gw(RESNET_SPACE, _cfg(d, n_max=48),
                      GatewayConfig(slots=2, max_inflight=8))
    sids = [gw.create_study() for _ in range(4)]
    loop = asyncio.get_running_loop()
    streams = {s: [] for s in sids}
    inflight = []                     # (enqueue_round, sid, future)
    to_tell = []                      # (ready_round, sid, trial)
    step = gw.tick_begin if pipelined else gw.tick

    def collect():
        for item in inflight[:]:
            r0, s, f = item
            if f.done():
                res = f.result()
                for tr in (res if isinstance(res, list) else [res]):
                    streams[s].append(tuple(np.asarray(tr.unit).tolist()))
                    to_tell.append((r0 + 2, s, tr))
                inflight.remove(item)

    overlapped = False
    for r in range(rounds):
        for item in [x for x in to_tell if x[0] <= r]:
            _, s, tr = item
            gw.tell(s, tr, obj(s, tr.unit))
            to_tell.remove(item)
        # two studies per round (never three: a deferral would shift the
        # resolution round); the q-batch rides the first study's ask
        a1, a2 = sids[r % 4], sids[(r + 1) % 4]
        inflight.append((r, a1, _enq(gw, loop, a1, q=3 if r % 3 == 2 else 1)))
        inflight.append((r, a2, _enq(gw, loop, a2)))
        step()
        overlapped = overlapped or gw._pending is not None
        collect()
    # land the tail: flush the staged tick, then serial ticks until the
    # last tell absorbs (both modes converge on the same serial sequence)
    gw.tick_flush()
    while True:
        collect()
        for _rr, s, tr in to_tell:
            gw.tell(s, tr, obj(s, tr.unit))
        to_tell = []
        if not (inflight or gw._tells or gw._asks
                or gw._pending is not None):
            break
        gw.tick()
    assert overlapped == pipelined, \
        "pipelined run never actually overlapped ticks"
    reg = {s: (gw._studies[s].n_obs, gw._studies[s].version,
               gw._studies[s].best_value, gw._studies[s].slot is not None)
           for s in sids}
    resident = {s: slot_bytes(gw.pool, gw._studies[s].slot)
                for s in sids if gw._studies[s].slot is not None}
    summary = gw.summary()
    await gw.aclose()
    return streams, reg, resident, summary


def test_pipelined_ticks_bitwise_equal_serial_ticks():
    """Tick pipelining is a SCHEDULING change only: the same scripted
    traffic (eviction churn every round, q=3 fantasy batches outstanding
    across the overlap boundary, tells landing mid-flight) produces
    bitwise-identical suggestion streams, registries, and resident GP
    state with tick_begin/tick_flush as with plain serial tick()."""
    async def main(d1, d2):
        on = await _scripted_run(d1, pipelined=True)
        off = await _scripted_run(d2, pipelined=False)
        assert on[0] == off[0], "suggestion streams diverged"
        assert on[1] == off[1], "study registries diverged"
        assert on[2].keys() == off[2].keys()
        for s in on[2]:
            for leaf in on[2][s]:
                assert on[2][s][leaf] == off[2][s][leaf], \
                    f"study {s} leaf {leaf} differs pipelined vs serial"
        for k in ("ticks", "asks_served", "absorbed", "evictions",
                  "restores", "fantasy_rollbacks", "q_width_hist"):
            assert on[3][k] == off[3][k], f"summary[{k}] diverged"
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        asyncio.run(main(d1, d2))


def test_async_ticker_pipeline_on_off_identical_streams():
    """The asyncio ticker path: the same concurrent client traffic under
    GatewayConfig(pipeline=True) and pipeline=False serves bitwise-equal
    suggestion streams and absorbs the same telemetry."""
    async def run(d, pipeline):
        gw = _gw(RESNET_SPACE, _cfg(d, n_max=24),
                          GatewayConfig(slots=2, pipeline=pipeline))
        sids = [gw.create_study() for _ in range(3)]
        outs = {s: [] for s in sids}
        for _ in range(3):
            await asyncio.gather(*(_loop(gw, s, 2, outs[s]) for s in sids))
        summary = gw.summary()
        await gw.aclose()
        return outs, summary

    async def main(d1, d2):
        on, s_on = await run(d1, True)
        off, s_off = await run(d2, False)
        assert set(on) == set(off)
        for s in on:
            assert len(on[s]) == len(off[s]) == 6
            for x, y in zip(on[s], off[s]):
                np.testing.assert_array_equal(x, y)
        assert s_on["absorbed"] == s_off["absorbed"]
        assert s_on["asks_served"] == s_off["asks_served"]
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        asyncio.run(main(d1, d2))


def test_pipelined_inflight_fault_fails_exactly_that_ticks_futures(
        monkeypatch):
    """A device fault surfacing when the IN-FLIGHT tick materializes must
    fail exactly that tick's futures: the next tick — already staged —
    stays staged and serves once the fault clears."""
    import repro_torch.hpo.pool as pool_mod

    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d, n_max=24),
                          GatewayConfig(slots=2))
        a, b = gw.create_study(), gw.create_study()
        loop = asyncio.get_running_loop()
        for s in (a, b):              # both resident: no residency hazard
            f = _enq(gw, loop, s)
            gw.tick()
            tr = f.result()
            gw.tell(s, tr, obj(s, tr.unit))
        gw.tick()

        fa = _enq(gw, loop, a)
        assert gw.tick_begin() == 1 and gw._pending is not None
        fb = _enq(gw, loop, b)

        def boom(x):
            raise RuntimeError("device fault")
        monkeypatch.setattr(pool_mod, "_materialize", boom)
        # staging B succeeds (dispatch only); finishing A hits the fault
        with pytest.raises(RuntimeError, match="device fault"):
            gw.tick_begin()
        monkeypatch.undo()
        assert fa.done() and isinstance(fa.exception(), RuntimeError), \
            "the in-flight tick's future did not receive the fault"
        assert not fb.done() and gw._pending is not None, \
            "the fault leaked into the staged-but-not-in-flight tick"
        assert gw.tick_flush() == 1   # fault cleared: B lands untouched
        tr = fb.result()
        gw.tell(b, tr, obj(b, tr.unit))
        gw.tick()
        assert gw.study_info(b)["n_obs"] == 2
        assert gw.study_info(a)["n_obs"] == 1   # A's round died with its tick
        await gw.aclose()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))

# ---------------------------------------------------------------------------
# Saturation escalation through the gateway (tests/test_tier.py)
# ---------------------------------------------------------------------------
# tests/test_tier.py's small neural tier and tests/_traffic.py's objective
NB = NeuralConfig(hidden=16, features=8, refit_every=8, refit_steps=40,
                  cap0=16)


def tobj(sid, unit):
    c = 0.15 + 0.7 * ((sid * 0.37) % 1.0)
    return float(-np.sum((np.asarray(unit) - c) ** 2))


def _foreign_trial(unit) -> Trial:
    return Trial(10_000, np.asarray(unit, np.float32), {})


def test_admission_raises_the_right_type():
    """Gateway admission: inflight-cap overrun is retryable backpressure;
    capacity exhaustion (escalation off) is terminal saturation."""
    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d, n_max=4),
                          GatewayConfig(slots=1, max_inflight=2,
                                        escalate=False))
        sid = gw.create_study()
        batch = await gw.ask(sid, q=2)
        with pytest.raises(BackpressureError, match="in flight"):
            await gw.ask(sid)            # 2 inflight + 1 > max_inflight=2
        for tr in batch:
            gw.tell(sid, tr, tobj(sid, tr.unit))
        await gw.drain()
        for _ in range(2):
            tr = await gw.ask(sid)
            gw.tell(sid, tr, tobj(sid, tr.unit))
        await gw.drain()
        with pytest.raises(StudySaturatedError, match="n_max"):
            await gw.ask(sid)            # 4 committed == n_max, no tier
        await gw.aclose()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))


def test_ask_q_boundary_rejects_without_partial_fantasies():
    """n = n_max - k committed with k < q: terminal rejection happens at
    admission — BEFORE any fantasy row is appended.  Bitwise no-leak: the
    rejected gateway's slot is identical to a twin that never asked."""
    async def main(d1, d2):
        def mk(d):
            gw = _gw(RESNET_SPACE, _cfg(d, n_max=8),
                              GatewayConfig(slots=1, max_inflight=8,
                                            escalate=False))
            return gw, gw.create_study()
        (ga, sa), (gb, sb) = mk(d1), mk(d2)
        rng = np.random.RandomState(3)
        for _ in range(6):                   # n = n_max - 2
            u = rng.rand(3).astype(np.float32)
            v = tobj(0, u)
            ga.tell(sa, _foreign_trial(u), v)
            gb.tell(sb, _foreign_trial(u), v)
        ga.tick(), gb.tick()
        with pytest.raises(StudySaturatedError, match="n_max"):
            await ga.ask(sa, q=4)            # k=2 < q=4: can never fit
        slot_a, slot_b = ga._studies[sa].slot, gb._studies[sb].slot
        assert ga.pool.fantasy_active(slot_a) == 0
        assert ga._studies[sa].pending_asks == 0
        assert_slots_equal(ga.pool, slot_a, gb.pool, slot_b,
                           "after q-ask rejection")
        batch = await ga.ask(sa, q=2)        # k=2 == q=2 still serves
        assert len(batch) == 2
        await ga.aclose(), await gb.aclose()
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        asyncio.run(main(d1, d2))


def test_ask_q_boundary_escalates_when_enabled():
    """Same boundary with escalation on: the oversized q-ask promotes the
    study and serves all q suggestions from the neural tier."""
    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d, n_max=8, neural=NB),
                          GatewayConfig(slots=1, max_inflight=8))
        sid = gw.create_study()
        rng = np.random.RandomState(3)
        for _ in range(6):
            u = rng.rand(3).astype(np.float32)
            gw.tell(sid, _foreign_trial(u), tobj(0, u))
        gw.tick()
        batch = await gw.ask(sid, q=4)       # 6 + 4 > 8 -> promote, serve
        assert len(batch) == 4
        assert gw.study_info(sid)["tier"] == 1
        assert gw.study_info(sid)["saturated"] is True
        for tr in batch:
            gw.tell(sid, tr, tobj(0, tr.unit))
        await gw.drain()
        assert gw.pool.n_real(gw._studies[sid].slot) == 10   # past n_max
        await gw.aclose()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))


LEVY_SPACE = SearchSpace(tuple(Dim(f"x{i}", 0.0, 1.0) for i in range(4)))
_LO, _HI = (b.double().numpy() for b in levy_bounds(4))


def _levy_obj(unit) -> float:
    x = _LO + np.asarray(unit, np.float64) * (_HI - _LO)
    return float(neg_levy(torch.from_numpy(x)))


async def _levy_run(d, *, escalate, asks, n_max=10):
    gw = _gw(
        LEVY_SPACE,
        _cfg(d, n_max=n_max, neural=NB,
             acq=AcqConfig(restarts=16, ascent_steps=8)),
        GatewayConfig(slots=1, escalate=escalate))
    sid = gw.create_study()
    best, hist = -np.inf, []
    try:
        for _ in range(asks):
            tr = await gw.ask(sid)
            v = _levy_obj(tr.unit)
            best = max(best, v)
            hist.append(best)
            gw.tell(sid, tr, v)
            await gw.drain()
    except StudySaturatedError:
        pass
    info, summ = gw.study_info(sid), gw.summary()
    await gw.aclose()
    return best, hist, info, summ


def test_levy4d_escalated_no_worse_than_truncated_gp():
    """The acceptance regression: driven to >= 2x n_max through the
    gateway, the escalated study keeps serving and its best value is no
    worse than the lazy GP truncated at n_max.  The first n_max asks are
    the SAME code path in both runs (escalation changes nothing until the
    ask that would overflow), so the comparison is exact, not tolerant."""
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        esc, esc_hist, esc_info, esc_summ = asyncio.run(
            _levy_run(d1, escalate=True, asks=24))
        trunc, trunc_hist, trunc_info, _ = asyncio.run(
            _levy_run(d2, escalate=False, asks=24))
        assert len(trunc_hist) == 10          # terminal at n_max
        assert len(esc_hist) == 24            # kept serving past 2x n_max
        # identical machinery before the promotion point
        assert esc_hist[:10] == trunc_hist
        # best value monotone, never below the truncated baseline
        assert esc >= trunc
        assert esc_info["tier"] == 1 and esc_info["saturated"] is True
        assert trunc_info["tier"] == 0
        assert esc_summ["escalated"] == 1 and esc_summ["saturated"] >= 1


def test_promoted_study_evicts_and_restores_bitwise():
    """A promoted study churned through eviction/restore produces the
    BITWISE-identical suggestion stream (q=1 and q=2 asks interleaved) as
    the same study in a gateway with enough slots to never evict — the
    NB ledger, its cost rows, and the fantasy shadow all travel exactly."""
    async def probe(d, slots):
        gw = _gw(RESNET_SPACE, _cfg(d, n_max=5, neural=NB),
                          GatewayConfig(slots=slots))
        sids = [gw.create_study(name=f"t{i}") for i in range(3)]
        out = []
        for r in range(9):
            res = await gw.ask(sids[0], q=2 if r % 2 else 1)
            for tr in (res if isinstance(res, list) else [res]):
                out.append(np.asarray(tr.unit).copy())
                gw.tell(sids[0], tr, tobj(0, tr.unit), cost=1.0 + 0.1 * r)
            await gw.drain()
            for s in sids[1:]:    # churn: forces sids[0] out when slots=2
                tr2 = await gw.ask(s)
                gw.tell(s, tr2, tobj(s, tr2.unit))
                await gw.drain()
        tier0 = gw.study_info(sids[0])["tier"]
        log = gw._studies[sids[0]]
        n0 = log.n_obs
        await gw.aclose()
        return out, tier0, n0, log
    async def main(d1, d2):
        resident, tier_a, n_a, log_a = await probe(d1, slots=3)
        churned, tier_b, n_b, log_b = await probe(d2, slots=2)
        assert tier_a == 1 and tier_b == 1           # both promoted
        assert n_a == n_b == 13                      # 13 > 2x n_max=10
        assert not log_a.evicted_ever
        assert log_b.evicted_ever
        assert len(resident) == len(churned) == 13
        for k, (x, y) in enumerate(zip(resident, churned)):
            assert np.array_equal(x, y), \
                f"suggestion {k} diverged through eviction churn"
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        asyncio.run(main(d1, d2))


def test_cost_threads_gateway_to_ledger():
    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d, n_max=16),
                          GatewayConfig(slots=1))
        sid = gw.create_study()
        costs = [2.0, 0.5, 1.0]                  # third tell: default
        for i, c in enumerate(costs):
            tr = await gw.ask(sid)
            if i == 2:
                gw.tell(sid, tr, tobj(sid, tr.unit))
            else:
                gw.tell(sid, tr, tobj(sid, tr.unit), cost=c)
            await gw.drain()
        row = gw.pool.engine.cost_row(gw._studies[sid].slot)
        np.testing.assert_array_equal(row[:3],
                                      np.asarray(costs, np.float32))
        for bad in (-1.0, 0.0, float("nan"), float("inf")):
            with pytest.raises(ValueError, match="cost"):
                gw.tell(sid, _foreign_trial(np.full(3, 0.5)), 0.1,
                        cost=bad)
        await gw.aclose()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))


def test_saturation_gauges_persist_across_gateway_restart():
    async def main(d):
        gw = _gw(RESNET_SPACE, _cfg(d, n_max=4, neural=NB),
                          GatewayConfig(slots=1))
        sid = gw.create_study()
        for _ in range(9):                       # past 2x n_max
            tr = await gw.ask(sid)
            gw.tell(sid, tr, tobj(sid, tr.unit))
            await gw.drain()
        assert gw.study_info(sid)["tier"] == 1
        assert gw.summary()["escalated"] == 1
        assert gw.checkpoint() is not None
        await gw.aclose()
        g2 = _gw(RESNET_SPACE, _cfg(d, n_max=4, neural=NB),
                          GatewayConfig(slots=1))
        assert g2.restore()
        info = g2.study_info(sid)
        assert info["tier"] == 1 and info["saturated"] is True
        s = g2.summary()
        assert s["escalated"] == 1 and s["saturated"] >= 1
        tr = await g2.ask(sid)                   # still serving post-restore
        g2.tell(sid, tr, tobj(sid, tr.unit))
        await g2.drain()
        await g2.aclose()
    with tempfile.TemporaryDirectory() as d:
        asyncio.run(main(d))

# ---------------------------------------------------------------------------
# Mixed tenants (tests/test_mixed.py)
# ---------------------------------------------------------------------------
SMALL = SearchSpace((Dim("a", 0.0, 1.0),
                     Categorical("c", ("p", "q", "r"))))  # width 4
FLOAT4 = SearchSpace(tuple(Dim(f"f{i}", 0.0, 1.0) for i in range(4)))


def _mcfg(**kw) -> SchedulerConfig:
    kw.setdefault("n_max", 16)
    kw.setdefault("acq", AcqConfig(restarts=8, ascent_steps=4))
    kw.setdefault("seed", 0)
    return SchedulerConfig(**kw)


def test_gateway_mixed_tenant_eviction_restore(tmp_path):
    cfg = _mcfg(n_max=32, ckpt_dir=str(tmp_path))
    gw = _gw(SMALL, cfg, GatewayConfig(slots=1))

    async def drive():
        mixed_sid = gw.create_study(name="mixed")
        float_sid = gw.create_study(space=FLOAT4, name="float")
        for _ in range(3):
            for sid, space in ((mixed_sid, SMALL), (float_sid, FLOAT4)):
                tr = await gw.ask(sid)       # slot churn: 1 slot, 2 tenants
                u = np.asarray(tr.unit)
                np.testing.assert_allclose(space.project(u), u, atol=1e-6)
                gw.tell(sid, tr, float(-np.sum((u - 0.4) ** 2)))
        await gw.drain()
        return mixed_sid, float_sid

    mixed_sid, float_sid = asyncio.run(drive())
    assert gw.study_info(mixed_sid)["n_obs"] == 3
    assert gw.study_info(float_sid)["n_obs"] == 3
    assert gw.summary()["evictions"] >= 4    # 1 slot, alternating tenants


def test_gateway_rejects_discrete_tenant_without_mixed(tmp_path):
    cfg = _mcfg(n_max=16, ckpt_dir=str(tmp_path))
    gw = _gw(FLOAT4, cfg, GatewayConfig(slots=1))
    with pytest.raises(ValueError, match="mixed"):
        gw.create_study(space=SMALL)


def test_gateway_rejects_off_lattice_tell(tmp_path):
    cfg = _mcfg(n_max=16, ckpt_dir=str(tmp_path))
    gw = _gw(SMALL, cfg, GatewayConfig(slots=1))

    async def drive():
        sid = gw.create_study()
        tr = await gw.ask(sid)
        bad = dataclasses.replace(tr, unit=np.asarray(
            [0.5, 0.4, 0.3, 0.3], np.float32))
        with pytest.raises(ValueError, match="lattice"):
            gw.tell(sid, bad, 0.0)
        gw.tell(sid, tr, 0.0)                # the real one still lands
        await gw.drain()
        return sid

    sid = asyncio.run(drive())
    assert gw.study_info(sid)["n_obs"] == 1


def test_gateway_mixed_registry_restore_round_trip(tmp_path):
    """Typed spaces (incl. conditionals) survive the registry snapshot."""
    cfg = _mcfg(n_max=32, ckpt_dir=str(tmp_path))
    gw = _gw(MIXED_DEMO_SPACE, cfg, GatewayConfig(slots=2))

    async def drive(g, sid=None):
        if sid is None:
            sid = g.create_study(name="t0")
        tr = await g.ask(sid)
        g.tell(sid, tr, 1.25)
        await g.drain()
        return sid

    sid = asyncio.run(drive(gw))
    gw.checkpoint()
    gw2 = _gw(MIXED_DEMO_SPACE, cfg, GatewayConfig(slots=2))
    assert gw2.restore()
    log_space = gw2._studies[sid].space
    assert log_space == MIXED_DEMO_SPACE
    assert gw2.study_info(sid)["best_value"] == 1.25
    asyncio.run(drive(gw2, sid))             # serving continues post-restore
    assert gw2.study_info(sid)["n_obs"] == 2


def test_gateway_restore_reapplies_resident_mixed_descriptor(tmp_path):
    """Regression: a RESIDENT mixed tenant on an all-float template must
    get its type descriptor re-installed by restore() — not just its
    bounds — or post-restore suggestions leave the lattice."""
    cfg = _mcfg(n_max=32, ckpt_dir=str(tmp_path), mixed=True)
    gw = _gw(FLOAT4, cfg, GatewayConfig(slots=2))

    async def one(g, sid):
        tr = await g.ask(sid)
        g.tell(sid, tr, float(-np.sum(np.asarray(tr.unit) ** 2)))
        await g.drain()
        return np.asarray(tr.unit)

    sid = gw.create_study(space=SMALL, name="mixed")   # custom layout
    asyncio.run(one(gw, sid))
    assert gw.study_info(sid)["resident"]
    gw.checkpoint()
    gw2 = _gw(FLOAT4, cfg, GatewayConfig(slots=2))
    assert gw2.restore()
    u = asyncio.run(one(gw2, sid))
    np.testing.assert_allclose(SMALL.project(u), u, atol=1e-6)
