"""The port's federation and transport against the JAX package's, and
federation state crossing between the two.

One scripted trace (4 studies over 2 shards of 2 slots, so studies are
evicted and restored; a q = 3 ask every third round; two migrations)
goes through a JAX `FederatedGateway` and a port one on 0.05 x Levy, the
port shards' pools drawing the reference's key streams
(`mirror_pool_draws`, one key dict shared by the shards, so a study's
keys follow it across evictions and migrations): suggestions within atol
1e-4, then both take the reference's points, so the placements, the
registries, the summary counts and every resident lane
(`assert_engines_match`) agree.

Crossings: a whole federation checkpoint of either package restores in
the other; the frame codec writes the same bytes; a port `ShardClient`
drives a JAX `ShardServer` (and the other way round) in one event loop;
a study adopted from a JAX snapshot has the same `study_state_digest` in
both; a JAX-written spec builds a port gateway."""
import asyncio
import json

import numpy as np
import pytest
import torch
from _torch_port import assert_engines_match, mirror_pool_draws
from test_torch_gateway_reference import (SUMMARY_KEYS, _adopt,
                                          _assert_bitwise, _enq, _leaves_of,
                                          _value)

from repro import checkpoint as jckpt
from repro.core.acquisition import AcqConfig as JAcqConfig
from repro.hpo import federation as jfed
from repro.hpo import gateway as jgateway
from repro.hpo import pool as jpool
from repro.hpo import space as jspace
from repro.hpo import transport as jtx
from repro_torch import checkpoint as tckpt
from repro_torch.core.acquisition import AcqConfig
from repro_torch.hpo import (FederatedGateway, FederationConfig,
                             GatewayConfig, SchedulerConfig, StudyGateway)
from repro_torch.hpo import transport as tx
from repro_torch.hpo.pool import Trial
from repro_torch.hpo.space import RESNET_SPACE

N_MAX, LAG, SEED = 32, 4, 0
MIGRATE_AT = (3, 6)      # rounds after whose tick a quiescent study moves


def _jcfg(d):
    return jpool.SchedulerConfig(n_max=N_MAX, lag=LAG, seed=SEED, ckpt_dir=d,
                                 ckpt_every=10_000, implementation="xla",
                                 acq=JAcqConfig(restarts=8, ascent_steps=4))


def _tcfg(d):
    return SchedulerConfig(n_max=N_MAX, lag=LAG, seed=SEED, ckpt_dir=str(d),
                           ckpt_every=10_000,
                           acq=AcqConfig(restarts=8, ascent_steps=4))


def _jfed(d, slots=2):
    return jfed.FederatedGateway(
        jspace.RESNET_SPACE, _jcfg(d),
        jgateway.GatewayConfig(slots=slots, max_inflight=8),
        jfed.FederationConfig(n_shards=2))


def _tfed(d, slots=2, mirror=True):
    fg = FederatedGateway(RESNET_SPACE, _tcfg(d),
                          GatewayConfig(slots=slots, max_inflight=8),
                          FederationConfig(n_shards=2), device="cpu")
    if mirror:
        keys = {}
        for gw in fg.shards:
            mirror_pool_draws(gw.pool, SEED, keys=keys,
                              owner=lambda slot, gw=gw: gw._owner[slot])
    return fg


def _shard(fg, sid):
    return fg.shards[fg.shard_of(sid)]


def _registry(fg):
    return {s: (_shard(fg, s).registry_record(s), fg.shard_of(s),
                _shard(fg, s).study_info(s)["slot"])
            for s in fg.study_ids()}


def _comparable(reg):
    """Registry records without best_value (floats computed from the same
    points, compared apart at 1e-6)."""
    return {s: ({k: v for k, v in rec.items() if k != "best_value"}, sh, sl)
            for s, (rec, sh, sl) in reg.items()}


async def _lockstep(jf, tf, sids, rounds):
    """tests/test_torch_gateway_reference.py's `_lockstep` over two
    federations: each round two of the four studies ask on their shards
    (a q = 3 ask every third round), a trial asked at round r is told at
    round r + 1, every shard ticks; after the ticks of rounds MIGRATE_AT
    the lowest-numbered quiescent study moves to the other shard on
    both; then ticks until every tell is absorbed."""
    loop = asyncio.get_running_loop()
    inflight, to_tell, moved = [], [], []

    def collect():
        for item in inflight[:]:
            r0, s, fj, ft = item
            assert fj.done() == ft.done()
            if fj.done():
                jres, tres = fj.result(), ft.result()
                jres = jres if isinstance(jres, list) else [jres]
                tres = tres if isinstance(tres, list) else [tres]
                _adopt(_shard(tf, s), s, tres, jres)
                for jt, tt in zip(jres, tres):
                    to_tell.append((r0 + 1, s, jt, tt))
                inflight.remove(item)

    def tell(due):
        for item in [x for x in to_tell if x[0] <= due]:
            _, s, jt, tt = item
            v = _value(jt.unit)
            jf.tell(s, jt, v)
            tf.tell(s, tt, v)
            to_tell.remove(item)

    for r in range(rounds):
        tell(r)
        a1, a2 = sids[r % 4], sids[(r + 1) % 4]
        for s, q in ((a1, 3 if r % 3 == 2 else 1), (a2, 1)):
            inflight.append((r, s, _enq(_shard(jf, s), loop, s, q),
                             _enq(_shard(tf, s), loop, s, q)))
        jf.tick()
        tf.tick()
        collect()
        if r in MIGRATE_AT:
            calm = [s for s in sids if _shard(jf, s).is_quiescent(s)]
            assert calm == [s for s in sids
                            if _shard(tf, s).is_quiescent(s)]
            s = calm[0]
            dst = 1 - jf.shard_of(s)
            jf.migrate_study(s, dst)
            tf.migrate_study(s, dst)
            moved.append(s)
    while True:
        tell(10 ** 9)
        if not (inflight or any(gw._tells or gw._asks
                                for gw in jf.shards)):
            break
        jf.tick()
        tf.tick()
        collect()
    assert not any(gw._tells or gw._asks for gw in tf.shards)
    return moved


def test_federation_matches_the_reference_federation(tmp_path):
    """The same trace through both packages' federations, with eviction
    churn, q-asks and two migrations: suggestions within atol 1e-4, then
    placements, registries, summary counts and every resident lane of
    every shard equal (`assert_engines_match`).  Ten rounds, as the
    gateway's lockstep (tests/test_torch_gateway_reference.py)."""
    async def main():
        jf, tf = _jfed(str(tmp_path / "j")), _tfed(tmp_path / "t")
        sids = [jf.create_study() for _ in range(4)]
        assert [tf.create_study() for _ in range(4)] == sids
        assert {jf.shard_of(s) for s in sids} == {0, 1}
        moved = await _lockstep(jf, tf, sids, rounds=10)
        assert len(moved) == 2
        assert {s: tf.shard_of(s) for s in sids} == \
            {s: jf.shard_of(s) for s in sids}
        assert _comparable(_registry(tf)) == _comparable(_registry(jf))
        js, ts = jf.summary(), tf.summary()
        for k in SUMMARY_KEYS + ("epoch", "studies", "dead_shards"):
            assert ts[k] == js[k], k
        assert ts["evictions"] >= 2 and ts["restores"] >= 2
        assert ts["q_width_hist"]["3"] == 3
        for jg, tg in zip(jf.shards, tf.shards):
            assert_engines_match(jg.pool.engine, tg.pool.engine)
        for s in sids:
            assert tf.study_info(s)["best_value"] == \
                pytest.approx(jf.study_info(s)["best_value"], abs=1e-6)
    asyncio.run(main())


async def _serve(fg, sid, rounds):
    """`rounds` ask -> tell rounds of one study of a federation through
    `tick()`; returns the suggestions."""
    loop = asyncio.get_running_loop()
    out = []
    for _ in range(rounds):
        fut = _enq(_shard(fg, sid), loop, sid)
        fg.tick()
        tr = fut.result()
        out.append(np.asarray(tr.unit).copy())
        fg.tell(sid, tr, _value(tr.unit))
        fg.tick()
    return out


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_a_federation_checkpoint_crosses_the_packages(tmp_path, direction):
    """One package's federation checkpoint (the registry epoch under
    `fed/`, each shard's gateway checkpoint, evicted and migrated studies
    in their snapshots) restores in the other's: placements, registries,
    summary counts and every resident lane bit for bit, and every study
    serves on."""
    async def main():
        d = str(tmp_path)
        src = _jfed(d) if direction == "jax_to_port" \
            else _tfed(d, mirror=False)
        sids = [src.create_study() for _ in range(6)]
        for s in sids:                    # 6 studies on 2 x 2 slots
            await _serve(src, s, 2)
        src.migrate_study(sids[0], 1 - src.shard_of(sids[0]))
        assert src.checkpoint() == 1
        reg = _registry(src)
        lanes = {s: _leaves_of(_shard(src, s).pool.engine.study_state(sl))
                 for s, (_, _, sl) in reg.items() if sl is not None}
        dst = _tfed(d, mirror=False) if direction == "jax_to_port" \
            else _jfed(d)
        assert dst.restore()
        assert _registry(dst) == reg
        for k in ("ticks", "asks_served", "absorbed", "evictions",
                  "restores", "epoch", "studies"):
            assert dst.summary()[k] == src.summary()[k], k
        for s, leaves in lanes.items():
            _assert_bitwise(_leaves_of(_shard(dst, s).pool.engine
                                       .study_state(reg[s][2])), leaves)
        for s in sids:
            await _serve(dst, s, 1)
        assert [dst.study_info(s)["n_obs"] for s in sids] == [3] * 6
    asyncio.run(main())


def test_frames_and_trial_wire_forms_are_the_reference_bytes():
    msgs = [{"id": 7, "op": "tell", "args": {
                "sid": 3, "trial": {"unit": [0.25, 1.0]}, "value": -2.5}},
            {"batch": [{"id": 1, "ok": True, "result": None},
                       {"id": 2, "ok": False, "etype": "KeyError",
                        "error": "'unknown study id 9'"}]},
            {"op": "ping", "args": {"name": "ünïcode", "x": 1e-300}}]
    for m in msgs:
        assert tx.encode_frame(m) == jtx.encode_frame(m)
    unit = np.asarray([0.1, 1.0 / 3.0, 0.7, 0.0], np.float32)
    tr = Trial(5, unit, {"lr": 0.1}, cost=2.0)
    jt = jpool.Trial(5, unit, {"lr": 0.1}, cost=2.0)
    assert tx.trial_to_wire(tr) == jtx.trial_to_wire(jt)
    back = tx.trial_from_wire(jtx.trial_to_wire(jt))
    assert back.unit.tobytes() == unit.tobytes() and back.cost == 2.0


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_a_client_of_one_package_is_served_by_the_others_worker(
        tmp_path, client_pkg):
    """A port `ShardClient` drives a JAX `ShardServer` (and a JAX client a
    port server) in one event loop: ping, create, ask, tell, drain,
    summary, the ledger and a state digest that a local twin of the
    server's package computes too."""
    client_tx = tx if client_pkg == "port" else jtx

    def server_gw(d):
        if client_pkg == "port":
            return jgateway.StudyGateway(
                jspace.RESNET_SPACE, _jcfg(d),
                jgateway.GatewayConfig(slots=2, max_inflight=8))
        return StudyGateway(RESNET_SPACE, _tcfg(d),
                            GatewayConfig(slots=2, max_inflight=8),
                            device="cpu")

    async def main():
        server_tx = jtx if client_pkg == "port" else tx
        gw = server_gw(str(tmp_path / "w"))
        server = server_tx.ShardServer(gw)
        host, port = await server.start()
        c = await client_tx.ShardClient.connect(host, port)
        try:
            assert (await c.call("ping"))["studies"] == 0
            sid = await c.call("create_study", name="s", sid=4)
            assert sid == 4
            units = []
            for _ in range(3):
                (w,) = await asyncio.wait_for(c.call("ask", sid=sid), 60)
                tr = client_tx.trial_from_wire(w)
                units.append(tr.unit)
                await c.call("tell", sid=sid, trial=w,
                             value=_value(tr.unit))
                await asyncio.wait_for(c.call("drain"), 60)
            summ = await c.call("summary")
            assert summ["asks_served"] == summ["absorbed"] == 3
            ledger = await c.call("ledger", sid=sid)
            assert [r["unit"] for r in ledger] == \
                [u.tolist() for u in units]
            slot = gw.study_info(sid)["slot"]
            assert await c.call("state_digest", sid=sid) == \
                server_tx.study_state_digest(gw.pool, slot)
            with pytest.raises(KeyError, match="unknown study"):
                await c.call("ask", sid=99)
            assert await c.call("shutdown")
        finally:
            c.close()
            server._server.close()
            await server._server.wait_closed()
            await gw.aclose()
    asyncio.run(main())


def test_a_study_adopted_from_a_jax_snapshot_digests_the_same(tmp_path):
    """`study_state_digest` hashes the reference's leaf names and dtypes:
    a study served by a JAX gateway, evicted, copied and adopted by a
    port gateway digests the same in both packages (and as it did before
    its eviction)."""
    async def main():
        jg = jgateway.StudyGateway(
            jspace.RESNET_SPACE, _jcfg(str(tmp_path / "src")),
            jgateway.GatewayConfig(slots=1, max_inflight=8))
        sid = jg.create_study()
        loop = asyncio.get_running_loop()
        for _ in range(3):
            fut = _enq(jg, loop, sid)
            jg.tick()
            tr = fut.result()
            jg.tell(sid, tr, _value(tr.unit))
            jg.tick()
        before = jtx.study_state_digest(jg.pool, jg.study_info(sid)["slot"])
        record = jg.export_for_migration(sid)
        jckpt.copy_study_version(str(tmp_path / "src"), str(tmp_path / "dst"),
                                 record["key"], record["version"])
        tg = StudyGateway(RESNET_SPACE, _tcfg(tmp_path / "dst"),
                          GatewayConfig(slots=1, max_inflight=8),
                          device="cpu")
        tg.adopt_study(record)
        got = tx.study_state_digest(tg.pool, tg._ensure_resident(sid))
        want = jtx.study_state_digest(jg.pool, jg._ensure_resident(sid))
        assert got == want == before
        # ... and a port study carried to the reference the other way
        tckpt.copy_study_version(str(tmp_path / "dst"), str(tmp_path / "j2"),
                                 record["key"], record["version"])
        jg2 = jgateway.StudyGateway(
            jspace.RESNET_SPACE, _jcfg(str(tmp_path / "j2")),
            jgateway.GatewayConfig(slots=1, max_inflight=8))
        jg2.adopt_study(record)
        assert jtx.study_state_digest(jg2.pool, jg2._ensure_resident(sid)) \
            == got
    asyncio.run(main())


def test_a_jax_spec_builds_a_port_gateway(tmp_path, monkeypatch):
    """A spec written by a JAX front end (with the reference's
    `scheduler.implementation`, without `device`) builds a port gateway:
    the implementation is dropped, the missing device means the card (an
    error without one), and the scheduler and gateway configs are the
    front end's."""
    jspec = jtx.build_spec(
        jspace.RESNET_SPACE, _jcfg(str(tmp_path / "j")),
        jgateway.GatewayConfig(slots=3, max_inflight=2))
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(jspec))
    spec = json.loads(path.read_text())
    assert "implementation" in spec["scheduler"] and "device" not in spec
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tx.gateway_from_spec(spec, str(tmp_path / "t"))
    gw = tx.gateway_from_spec(dict(spec, device="cpu"), str(tmp_path / "t"))
    assert gw.cfg == _tcfg(tmp_path / "t")
    assert gw.gw == GatewayConfig(slots=3, max_inflight=2)
    assert [d.name for d in gw._template_space.dims] == \
        [d.name for d in RESNET_SPACE.dims]
    assert "device" not in jtx.build_spec(
        jspace.RESNET_SPACE, _jcfg(str(tmp_path / "j")))
