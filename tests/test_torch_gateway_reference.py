"""The port's StudyGateway against the JAX package's, and studies crossing
between the two.

One scripted trace (4 studies on 2 slots, so studies are evicted and
restored; a q = 3 ask every third round) goes through a JAX gateway and a
port gateway on 0.05 x Levy, the port pool drawing from the reference's
key streams (`mirror_pool_draws`, the keys following the logical study
across evictions): suggestions within atol 1e-4, then both gateways take
the reference's points, so the registries, the summary counts and every
resident lane (`assert_engines_match`) agree.

Crossings: a JAX eviction snapshot adopted by a port gateway (and the
reverse) restores bit for bit and serves; a whole gateway checkpoint of
either package restores in the other; two port imports of one JAX export
draw one stream."""
import asyncio

import numpy as np
import pytest
import torch
from _torch_port import (assert_engines_match, jax_state_leaves,
                         mirror_pool_draws, n, scaled_levy)

from repro import checkpoint as jckpt
from repro.core.acquisition import AcqConfig as JAcqConfig
from repro.hpo import gateway as jgateway
from repro.hpo import pool as jpool
from repro.hpo import space as jspace
from repro_torch import checkpoint as tckpt
from repro_torch.core.acquisition import AcqConfig
from repro_torch.hpo import GatewayConfig, SchedulerConfig, StudyGateway
from repro_torch.hpo.space import RESNET_SPACE

SUGGEST_TOL = dict(atol=1e-4)       # tests/test_torch_bayesopt.py:50
N_MAX, LAG, SEED = 32, 4, 0
LEAVES = ("x_buf", "y_buf", "l_buf", "li_buf", "alpha", "clamp_count", "n",
          "since_refit", "params/sigma2", "params/rho", "params/noise2")


def _jgw(d, slots=2):
    return jgateway.StudyGateway(
        jspace.RESNET_SPACE,
        jpool.SchedulerConfig(n_max=N_MAX, lag=LAG, seed=SEED, ckpt_dir=d,
                              ckpt_every=10_000, implementation="xla",
                              acq=JAcqConfig(restarts=8, ascent_steps=4)),
        jgateway.GatewayConfig(slots=slots, max_inflight=8))


def _tgw(d, slots=2, mirror=True):
    gw = StudyGateway(
        RESNET_SPACE,
        SchedulerConfig(n_max=N_MAX, lag=LAG, seed=SEED, ckpt_dir=str(d),
                        ckpt_every=10_000,
                        acq=AcqConfig(restarts=8, ascent_steps=4)),
        GatewayConfig(slots=slots, max_inflight=8), device="cpu")
    if mirror:
        mirror_pool_draws(gw.pool, SEED, owner=lambda slot: gw._owner[slot])
    return gw


def _value(unit) -> float:
    return float(scaled_levy(np.asarray(unit)[None])[0])


def _enq(gw, loop, sid, q=1):
    """White-box ask enqueue (tests/test_gateway.py's `_enq`)."""
    fut = loop.create_future()
    gw._studies[sid].pending_asks += q
    gw._asks.append((sid, fut, q))
    return fut


def _adopt(tgw, sid, ttrials, jtrials):
    """Hold the port's suggestions to the reference's, then give the port
    trials the reference's points (and, for a q-ask, its pending fantasy
    list), so both posteriors see the same observations."""
    slot = tgw._studies[sid].slot
    pend = tgw.pool._fantasies[slot]
    for tt, jt in zip(ttrials, jtrials):
        np.testing.assert_allclose(tt.unit, jt.unit, **SUGGEST_TOL)
        unit = np.asarray(jt.unit, np.float32).copy()
        for i, p in enumerate(pend):
            if np.array_equal(p, tt.unit):
                pend[i] = unit.copy()
        tt.unit = unit
        tt.hparams = RESNET_SPACE.to_hparams(unit)


def _registry(gw, sids):
    return {s: (gw._studies[s].n_obs, gw._studies[s].version,
                gw._studies[s].slot) for s in sids}


SUMMARY_KEYS = ("ticks", "asks_served", "absorbed", "evictions", "restores",
                "fantasy_rollbacks", "q_width_hist", "fantasy_active")


async def _lockstep(jg, tg, sids, rounds):
    """The scripted trace of tests/test_gateway.py's `_scripted_run` with
    serial ticks, on both gateways: each round two of the four studies
    ask (a q = 3 ask every third round), a trial asked at round r is told
    at round r + 1, asks that find every slot pinned defer; then serial
    ticks until every tell is absorbed."""
    loop = asyncio.get_running_loop()
    inflight, to_tell = [], []

    def collect():
        for item in inflight[:]:
            r0, s, fj, ft = item
            assert fj.done() == ft.done()
            if fj.done():
                jres, tres = fj.result(), ft.result()
                jres = jres if isinstance(jres, list) else [jres]
                tres = tres if isinstance(tres, list) else [tres]
                _adopt(tg, s, tres, jres)
                for jt, tt in zip(jres, tres):
                    to_tell.append((r0 + 1, s, jt, tt))
                inflight.remove(item)

    def tell(due):
        for item in [x for x in to_tell if x[0] <= due]:
            _, s, jt, tt = item
            v = _value(jt.unit)
            jg.tell(s, jt, v)
            tg.tell(s, tt, v)
            to_tell.remove(item)

    for r in range(rounds):
        tell(r)
        a1, a2 = sids[r % 4], sids[(r + 1) % 4]
        for s, q in ((a1, 3 if r % 3 == 2 else 1), (a2, 1)):
            inflight.append((r, s, _enq(jg, loop, s, q),
                             _enq(tg, loop, s, q)))
        jg.tick()
        tg.tick()
        collect()
    while True:
        tell(10 ** 9)
        if not (inflight or jg._tells or jg._asks):
            break
        jg.tick()
        tg.tick()
        collect()
    assert not (tg._tells or tg._asks)


def test_gateway_matches_the_reference_gateway(tmp_path):
    """The same trace through both packages' gateways, with eviction churn
    and q-asks: suggestions within atol 1e-4, registries, summary counts
    and resident lanes equal (`assert_engines_match`).  Ten rounds, as
    tests/test_gateway.py's trace: two rounds more, a q-ask's second pick
    reaches EI's underflowing tail (EI 1e-12 against 1e-6), where the two
    packages' ascents differ by design (ROADMAP queue 3, EI underflow)."""
    async def main():
        jg, tg = _jgw(str(tmp_path / "j")), _tgw(tmp_path / "t")
        sids = [jg.create_study() for _ in range(4)]
        assert [tg.create_study() for _ in range(4)] == sids
        await _lockstep(jg, tg, sids, rounds=10)
        assert _registry(tg, sids) == _registry(jg, sids)
        js, ts = jg.summary(), tg.summary()
        for k in SUMMARY_KEYS:
            assert ts[k] == js[k], k
        assert ts["evictions"] >= 4 and ts["restores"] >= 2
        assert ts["q_width_hist"]["3"] == 3
        assert_engines_match(jg.pool.engine, tg.pool.engine)
        for s in sids:
            assert tg.study_info(s)["best_value"] == \
                pytest.approx(jg.study_info(s)["best_value"], abs=1e-6)
    asyncio.run(main())


async def _serve(gw, sid, rounds):
    """`rounds` ask -> tell rounds of one study through `tick()`; returns
    the suggestions."""
    loop = asyncio.get_running_loop()
    out = []
    for _ in range(rounds):
        fut = _enq(gw, loop, sid)
        gw.tick()
        tr = fut.result()
        out.append(np.asarray(tr.unit).copy())
        gw.tell(sid, tr, _value(tr.unit))
        gw.tick()
    return out


def _leaves_of(state) -> dict:
    """A single-study state of either package as {leaf: numpy}."""
    if isinstance(state.x_buf, torch.Tensor):
        p = state.params
        return {"x_buf": n(state.x_buf), "y_buf": n(state.y_buf),
                "l_buf": n(state.l_buf), "li_buf": n(state.li_buf),
                "alpha": n(state.alpha), "clamp_count": n(state.clamp_count),
                "n": np.int32(state.n), "since_refit": np.int32(
                    state.since_refit), "params/sigma2": n(p.sigma2),
                "params/rho": n(p.rho), "params/noise2": n(p.noise2)}
    return {k.replace(".", ""): v
            for k, v in jax_state_leaves(state).items()}


def _assert_bitwise(a: dict, b: dict) -> None:
    for leaf in LEAVES:
        x, y = np.asarray(a[leaf]), np.asarray(b[leaf])
        assert x.shape == y.shape and x.dtype == y.dtype, leaf
        assert x.tobytes() == y.tobytes(), f"{leaf} differs"


async def _evicted(gw, sids):
    """Serve studies `sids` on a 1-slot gateway, each 3 rounds (each later
    study evicts the one before): returns the first study's state just
    before its eviction and its migration record."""
    first = None
    for s in sids:
        await _serve(gw, s, 3)
        if first is None:
            first = _leaves_of(gw.pool.engine.study_state(
                gw._studies[s].slot))
    return first, gw.export_for_migration(sids[0])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_an_evicted_study_crosses_the_packages(tmp_path, direction):
    """A study evicted by one package's gateway, its snapshot copied with
    `copy_study_version`, is adopted by the other's: restored bit for bit
    (every leaf of the snapshot), its registry record intact, and it
    serves 3 more rounds inside the unit cube."""
    async def main():
        src = _jgw(str(tmp_path / "src"), 1) if direction == "jax_to_port" \
            else _tgw(tmp_path / "src", 1, mirror=False)
        dst = _tgw(tmp_path / "dst", 1, mirror=False) \
            if direction == "jax_to_port" else _jgw(str(tmp_path / "dst"), 1)
        sids = [src.create_study() for _ in range(2)]
        before, record = await _evicted(src, sids)
        assert record["evicted_ever"] and record["n_obs"] == 3
        copy = tckpt.copy_study_version if direction == "jax_to_port" \
            else jckpt.copy_study_version
        copy(str(tmp_path / "src"), str(tmp_path / "dst"), record["key"],
             record["version"])
        dst.adopt_study(record, require_snapshot=True)
        slot = dst._ensure_resident(sids[0])
        _assert_bitwise(_leaves_of(dst.pool.engine.study_state(slot)),
                        before)
        assert dst.registry_record(sids[0]) == record
        units = await _serve(dst, sids[0], 3)
        assert dst.study_info(sids[0])["n_obs"] == 6
        assert all(np.isfinite(u).all() and (0 <= u).all() and (u <= 1).all()
                   for u in units)
    asyncio.run(main())


def test_two_port_imports_of_one_jax_export_draw_one_stream(tmp_path):
    """A JAX export has no torch generator state: each port import seeds
    the slot's generator from the study's JAX key, so two imports (one
    into a slot another tenant used before) suggest the same points."""
    async def main():
        src = _jgw(str(tmp_path / "src"), 1)
        sids = [src.create_study() for _ in range(2)]
        _, record = await _evicted(src, sids)
        streams = []
        for k, churn in enumerate((False, True)):
            d = tmp_path / f"dst{k}"
            jckpt.copy_study_version(str(tmp_path / "src"), str(d),
                                     record["key"], record["version"])
            gw = _tgw(d, 1, mirror=False)
            if churn:                     # slot 0 held another tenant first
                other = gw.create_study(sid=100)
                await _serve(gw, other, 2)
            gw.adopt_study(record)
            streams.append(await _serve(gw, sids[0], 3))
        for a, b in zip(*streams):
            np.testing.assert_array_equal(a, b)
    asyncio.run(main())


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_a_whole_gateway_checkpoint_crosses_the_packages(tmp_path,
                                                         direction):
    """One package's gateway checkpoint (the registry in the pool
    snapshot's metadata, evicted studies in their own snapshots) restores
    in the other's: the registry and every resident lane bit for bit, and
    both serve on; the evicted study restores on demand bit for bit."""
    async def main():
        d = str(tmp_path)
        src = _jgw(d) if direction == "jax_to_port" else _tgw(d, mirror=False)
        sids = [src.create_study() for _ in range(3)]
        for s in sids:                    # 3 studies on 2 slots: one evicted
            await _serve(src, s, 2)
        assert src.checkpoint() is not None
        records = {s: src.registry_record(s) for s in sids}
        lanes = {s: _leaves_of(src.pool.engine.study_state(
            src._studies[s].slot)) for s in sids
            if src._studies[s].slot is not None}
        dst = _tgw(d, mirror=False) if direction == "jax_to_port" else _jgw(d)
        assert dst.restore()
        assert {s: dst.registry_record(s) for s in sids} == records
        for k in ("ticks", "asks_served", "absorbed", "evictions"):
            assert dst.summary()[k] == src.summary()[k], k
        for s, leaves in lanes.items():
            assert dst._studies[s].slot == src._studies[s].slot
            _assert_bitwise(_leaves_of(dst.pool.engine.study_state(
                dst._studies[s].slot)), leaves)
        evicted = next(s for s in sids if s not in lanes)
        got = dst.pool.engine.study_state(dst._ensure_resident(evicted))
        want = src.pool.engine.study_state(src._ensure_resident(evicted))
        _assert_bitwise(_leaves_of(got), _leaves_of(want))
        for s in sids:
            await _serve(dst, s, 1)
        assert [dst.study_info(s)["n_obs"] for s in sids] == [3, 3, 3]
    asyncio.run(main())
