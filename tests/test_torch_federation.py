"""The port's shard federation (`repro_torch.hpo.federation`) on the CPU:
the routing properties, single-pool equivalence under random
interleavings of rounds, migrations and shard kills, the federation
faults (kill / revive, parked asks, the all-or-nothing migration and its
retry, a real SIGKILL of a port shard worker, the shard-count guard, the
staging sweep) and the short federation soak — the reference's suites
(tests/test_properties.py, tests/test_faults.py, tests/test_soak.py) on
the port, against a port single pool."""
import asyncio
import hashlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import pytest
from _traffic import (assert_streams_identical, drive_serial, objective,
                      run_traffic)
from _torch_port import assert_slots_equal
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.hpo.federation import rendezvous_shard as ref_rendezvous_shard
from repro_torch import checkpoint as ckpt_mod
from repro_torch.checkpoint import store as store_mod
from repro_torch.core.acquisition import AcqConfig
from repro_torch.hpo import (FederatedGateway, FederationConfig,
                             GatewayConfig, SchedulerConfig, StudyGateway,
                             rendezvous_shard)
from repro_torch.hpo import transport as tx
from repro_torch.hpo.space import RESNET_SPACE

obj = objective


def make_cfg(d, n_max=16, **kw):
    """tests/_traffic.py's `make_cfg` for the port."""
    kw.setdefault("acq", AcqConfig(restarts=8, ascent_steps=4))
    kw.setdefault("ckpt_every", 10_000)
    kw.setdefault("seed", 0)
    return SchedulerConfig(n_max=n_max, ckpt_dir=d, **kw)


def _mk_fed(root, n_shards=2, slots=2, n_max=24):
    return FederatedGateway(RESNET_SPACE, make_cfg(root, n_max=n_max),
                            GatewayConfig(slots=slots),
                            FederationConfig(n_shards=n_shards),
                            device="cpu")


def _mk_gw(d, slots, n_max):
    return StudyGateway(RESNET_SPACE, make_cfg(d, n_max=n_max),
                        GatewayConfig(slots=slots), device="cpu")


# ---------------------------------------------------------------------------
# Routing (tests/test_properties.py:438-466)
# ---------------------------------------------------------------------------
def _route(sid: int, n_shards: int) -> int:
    # route() reads only self.fed — a shim avoids building n_shards pools
    shim = types.SimpleNamespace(fed=FederationConfig(n_shards=n_shards))
    return FederatedGateway.route(shim, sid)


@settings(max_examples=25, deadline=None)
@given(sid=st.integers(0, 100_000), n_shards=st.integers(1, 16))
def test_routing_deterministic_pure_function(sid, n_shards):
    """route(sid) is a pure function of (sid, shard count), the rendezvous
    argmax recomputed from first principles."""
    got = _route(sid, n_shards)
    assert got == _route(sid, n_shards)
    assert 0 <= got < n_shards
    want = max(range(n_shards), key=lambda s: hashlib.sha256(
        f"{s}:{sid}".encode()).digest())
    assert got == want


def test_routing_stable_and_spread_under_fixed_shard_count():
    for n_shards in (2, 3, 4):
        first = [_route(s, n_shards) for s in range(64)]
        assert first == [_route(s, n_shards) for s in range(64)]
        assert set(first) == set(range(n_shards)), \
            f"{n_shards} shards: some shard never routed"


def test_rendezvous_places_every_sid_as_the_reference():
    """Both packages place every sid on the same shard, so a federation
    root written by either restores in the other."""
    for n_shards in range(1, 6):
        got = [rendezvous_shard(s, n_shards) for s in range(1000)]
        assert got == [ref_rendezvous_shard(s, n_shards)
                       for s in range(1000)], f"{n_shards} shards"


# ---------------------------------------------------------------------------
# Single-pool equivalence (tests/test_properties.py:469-541)
# ---------------------------------------------------------------------------
_FED_OPS = st.lists(
    st.one_of(
        st.tuples(st.just("round"), st.integers(0, 3)),
        st.tuples(st.just("migrate"), st.integers(0, 3)),
        st.tuples(st.just("kill"), st.integers(0, 1)),
    ), min_size=4, max_size=12)


@settings(max_examples=5, deadline=None)
@given(script=_FED_OPS)
def test_fed_random_interleavings_equal_single_pool(script):
    """ANY random interleaving of ask/tell rounds, migrations and shard
    kill/revive cycles (checkpointed at the kill point) over a 2-shard
    port federation is a port single-pool run of the same per-study event
    order: suggestion streams, ledgers and absorb counts equal."""
    async def run_fed(root):
        fg = _mk_fed(root)
        sids = [fg.create_study(name=f"s{i}") for i in range(4)]
        streams = {s: [] for s in sids}
        for op in script:
            if op[0] == "round":
                s = sids[op[1]]
                tr = await fg.ask(s)
                streams[s].append(tuple(np.asarray(tr.unit).tolist()))
                fg.tell(s, tr, objective(s, tr.unit))
                await fg.drain()
            elif op[0] == "migrate":
                s = sids[op[1]]
                fg.migrate_study(s, 1 - fg.shard_of(s))
            else:
                fg.checkpoint()
                fg.kill_shard(op[1])
                fg.revive_shard(op[1])
        info = {s: (fg.study_info(s)["n_obs"],
                    fg.study_info(s)["best_value"]) for s in sids}
        absorbed = fg.summary()["absorbed"]
        await fg.aclose()
        return streams, info, absorbed

    async def run_single(d):
        gw = _mk_gw(d, 4, 24)
        sids = [gw.create_study(name=f"s{i}") for i in range(4)]
        streams = {s: [] for s in sids}
        for op in script:
            if op[0] != "round":
                continue             # migrations/kills are fed-internal
            s = sids[op[1]]
            tr = await gw.ask(s)
            streams[s].append(tuple(np.asarray(tr.unit).tolist()))
            gw.tell(s, tr, objective(s, tr.unit))
            await gw.drain()
        info = {s: (gw.study_info(s)["n_obs"],
                    gw.study_info(s)["best_value"]) for s in sids}
        absorbed = gw.summary()["absorbed"]
        await gw.aclose()
        return streams, info, absorbed

    with tempfile.TemporaryDirectory() as root, \
            tempfile.TemporaryDirectory() as d_ref:
        fed = asyncio.run(run_fed(root))
        ref = asyncio.run(run_single(d_ref))
    assert fed[0] == ref[0], "suggestion streams diverged"
    assert fed[1] == ref[1], "study ledgers diverged"
    assert fed[2] == ref[2], "absorb telemetry diverged"


# ---------------------------------------------------------------------------
# Federation faults (tests/test_faults.py:577-881)
# ---------------------------------------------------------------------------
def test_fed_shard_kill_restore_keeps_committed_loses_uncommitted():
    """Kill one shard mid-traffic (no checkpoint at the crash): the
    committed tells survive, the uncommitted round is gone and re-derives
    bitwise from the persisted generator states, nothing pre-crash
    replays, and the surviving shard keeps its uncommitted work."""
    async def main(root):
        fg = _mk_fed(root)
        sids = [fg.create_study(name=f"s{i}") for i in range(4)]
        by_shard = {i: [s for s in sids if fg.shard_of(s) == i]
                    for i in (0, 1)}
        assert by_shard[0] and by_shard[1]
        victim = 0
        pre = await drive_serial(fg, sids, 2)
        fg.checkpoint()
        lost = await drive_serial(fg, sids, 1)
        fg.kill_shard(victim)
        fg.revive_shard(victim)
        for s in sids:
            n = fg.study_info(s)["n_obs"]
            assert n == (2 if fg.shard_of(s) == victim else 3), \
                f"study {s}: {n} obs after revive"
        post = await drive_serial(fg, sids, 2)
        for s in sids:
            assert set(pre[s]).isdisjoint(post[s]), \
                "revived shard replayed a pre-crash suggestion"
            if fg.shard_of(s) == victim:
                assert post[s][0] == lost[s][0]
            else:
                assert set(lost[s]).isdisjoint(post[s])
        await fg.aclose()
    with tempfile.TemporaryDirectory() as root:
        asyncio.run(main(root))


def test_fed_shard_kill_cancels_parked_asks():
    async def main(root):
        fg = _mk_fed(root)
        sids = [fg.create_study(name=f"s{i}") for i in range(4)]
        victim_sid = next(s for s in sids if fg.shard_of(s) == 0)
        await drive_serial(fg, [victim_sid], 1)
        fg.checkpoint()
        fut = asyncio.ensure_future(fg.ask(victim_sid))
        await asyncio.sleep(0)               # parked, tick not yet run
        fg.kill_shard(0)
        with pytest.raises(asyncio.CancelledError):
            await fut
        with pytest.raises(RuntimeError, match="down"):
            await fg.ask(victim_sid)
        fg.revive_shard(0)
        tr = await fg.ask(victim_sid)
        fg.tell(victim_sid, tr, obj(victim_sid, tr.unit))
        await fg.drain()
        assert fg.study_info(victim_sid)["n_obs"] == 2
        await fg.aclose()
    with tempfile.TemporaryDirectory() as root:
        asyncio.run(main(root))


def _boom(*a, **k):
    raise OSError("migration link down")


def test_fed_migration_io_fault_is_all_or_nothing(monkeypatch):
    """A migration whose snapshot copy dies mid-transfer leaves the study
    intact on its source shard — owned, servable, bit for bit the state
    of an unmigrated twin — and nothing committed or half-copied on the
    destination."""
    async def main(d_a, d_b):
        fa, fb = _mk_fed(d_a), _mk_fed(d_b)
        sids = [fa.create_study(name=f"s{i}") for i in range(2)]
        for s in sids:
            assert fb.create_study(name=f"s{s}") == s
        streams_a = await drive_serial(fa, sids, 2)
        streams_b = await drive_serial(fb, sids, 2)
        sid = sids[0]
        src = fa.shard_of(sid)
        dst = 1 - src
        monkeypatch.setattr(store_mod.shutil, "copy2", _boom)
        with pytest.raises(OSError, match="migration link down"):
            fa.migrate_study(sid, dst)
        monkeypatch.undo()
        assert fa.shard_of(sid) == src
        src_gw, dst_gw = fa.shards[src], fa.shards[dst]
        key = src_gw.registry_record(sid)["key"]
        assert not ckpt_mod.study_versions(dst_gw.cfg.ckpt_dir, key)
        sdir = store_mod.study_dir(dst_gw.cfg.ckpt_dir, key)
        if os.path.exists(sdir):
            assert not [f for f in os.listdir(sdir)
                        if f.startswith(".tmp_migrate_")], \
                "aborted migration left debris on the destination"
        await drive_serial(fa, sids, 2, streams=streams_a)
        await drive_serial(fb, sids, 2, streams=streams_b)
        assert_streams_identical(streams_a, streams_b)
        la = fa.shards[src].study_info(sid)["slot"]
        lb = fb.shards[src].study_info(sid)["slot"]
        assert la is not None and lb is not None
        assert_slots_equal(fa.shards[src].pool, la, fb.shards[src].pool, lb,
                           ctx="after aborted migration")
        await fa.aclose()
        await fb.aclose()
    with tempfile.TemporaryDirectory() as d_a, \
            tempfile.TemporaryDirectory() as d_b:
        asyncio.run(main(d_a, d_b))


def test_fed_retried_migration_succeeds_after_io_fault(monkeypatch):
    async def main(root):
        fg = _mk_fed(root)
        sids = [fg.create_study(name=f"s{i}") for i in range(2)]
        await drive_serial(fg, sids, 2)
        sid = sids[0]
        src = fg.shard_of(sid)
        dst = 1 - src
        monkeypatch.setattr(store_mod.shutil, "copy2", _boom)
        with pytest.raises(OSError):
            fg.migrate_study(sid, dst)
        monkeypatch.undo()
        fg.migrate_study(sid, dst)
        assert fg.shard_of(sid) == dst
        info = fg.study_info(sid)
        assert info["n_obs"] == 2 and info["shard"] == dst
        post = await drive_serial(fg, [sid], 1)
        assert len(post[sid]) == 1
        await fg.aclose()
    with tempfile.TemporaryDirectory() as root:
        asyncio.run(main(root))


def test_fed_migration_keeps_the_stream_and_rebalance_evens_shards():
    """A migrated study's next suggestions are those of a twin federation
    that never moved it (its generator state crosses the stores with the
    snapshot), and `rebalance()` moves quiescent studies, lowest sid
    first, until the shard counts differ by at most one."""
    async def main(d_a, d_b):
        fa, fb = _mk_fed(d_a, slots=4), _mk_fed(d_b, slots=4)
        sids = [fa.create_study(name=f"s{i}") for i in range(6)]
        assert [fb.create_study(name=f"s{i}") for i in range(6)] == sids
        sa = await drive_serial(fa, sids, 2)
        sb = await drive_serial(fb, sids, 2)
        sid = sids[0]
        fa.migrate_study(sid, 1 - fa.shard_of(sid))
        for s in sids[1:]:
            fa.migrate_study(s, fa.shard_of(sid))
        moves = fa.rebalance()
        counts = [sum(1 for s in sids if fa.shard_of(s) == i)
                  for i in (0, 1)]
        assert moves and abs(counts[0] - counts[1]) <= 1
        assert [m[0] for m in moves] == sorted(m[0] for m in moves)
        await drive_serial(fa, sids, 2, streams=sa)
        await drive_serial(fb, sids, 2, streams=sb)
        assert_streams_identical(sa, sb)
        for s in sids:
            assert fa.study_info(s)["n_obs"] == fb.study_info(s)["n_obs"]
            assert fa.study_info(s)["best_value"] == \
                fb.study_info(s)["best_value"]
        await fa.aclose()
        await fb.aclose()
    with tempfile.TemporaryDirectory() as d_a, \
            tempfile.TemporaryDirectory() as d_b:
        asyncio.run(main(d_a, d_b))


def _spawn_worker(d):
    """A port shard worker over store `d` on the CPU (the spec's device),
    one torch thread."""
    import repro_torch
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, tx.SPEC_FILE), "w") as f:
        json.dump(tx.build_spec(RESNET_SPACE, make_cfg(d, n_max=16),
                                device="cpu"), f)
    ep = os.path.join(d, tx.ENDPOINT_FILE)
    if os.path.exists(ep):
        os.unlink(ep)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        repro_torch.__file__)) + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.Popen([sys.executable, "-m",
                          "repro_torch.hpo.shard_worker", "--ckpt-dir", d],
                         env=env)
    deadline = time.time() + 120
    while not os.path.exists(ep):
        assert p.poll() is None, \
            f"worker exited rc={p.returncode} during startup"
        if time.time() > deadline:
            p.kill()
            p.wait()
            raise AssertionError("worker never published endpoint")
        time.sleep(0.05)
    with open(ep) as f:
        return p, json.load(f)


async def _worker_round(c, sid):
    (w,) = await asyncio.wait_for(c.call("ask", sid=sid, q=1), 60)
    unit = tx.trial_from_wire(w).unit
    await c.call("tell", sid=sid, trial=w, value=obj(sid, unit))
    await asyncio.wait_for(c.call("drain"), 60)
    return tuple(unit)


def test_crossproc_shard_sigkill_restores_from_epoch():
    """Two port shard worker PROCESSES over one root.  SIGKILL one
    mid-traffic: the survivor never notices, and a fresh process over the
    dead shard's store restores from its epoch — committed tells survive,
    nothing pre-crash replays, and the destroyed round re-derives
    bitwise."""
    async def main(d0, d1):
        p0, ep0 = _spawn_worker(d0)
        p1 = None
        try:
            assert not ep0["restored"]
            p1, ep1 = _spawn_worker(d1)
            c0 = await tx.ShardClient.connect(ep0["host"], ep0["port"])
            c1 = await tx.ShardClient.connect(ep1["host"], ep1["port"])
            s0a = await c0.call("create_study", name="a")
            s0b = await c0.call("create_study", name="b")
            s1a = await c1.call("create_study", name="c")
            pre = {s: [] for s in (s0a, s0b)}
            for _ in range(2):
                for s in pre:
                    pre[s].append(await _worker_round(c0, s))
                await _worker_round(c1, s1a)
            await c0.call("checkpoint")
            await c1.call("checkpoint")
            lost = {}
            for s in pre:
                lost[s] = await _worker_round(c0, s)
            await _worker_round(c1, s1a)

            os.kill(p0.pid, signal.SIGKILL)
            assert p0.wait(timeout=30) == -signal.SIGKILL
            c0.close()
            await _worker_round(c1, s1a)
            assert (await c1.call("study_info", sid=s1a))["n_obs"] == 4

            p0, ep0b = _spawn_worker(d0)
            assert ep0b["restored"]
            c0b = await tx.ShardClient.connect(ep0b["host"], ep0b["port"])
            for s in pre:
                assert (await c0b.call("study_info", sid=s))["n_obs"] == 2, \
                    "a committed tell was lost in the crash"
            post = {s: [] for s in pre}
            for _ in range(2):
                for s in pre:
                    post[s].append(await _worker_round(c0b, s))
            for s in pre:
                assert set(pre[s]).isdisjoint(post[s])
                assert post[s][0] == lost[s], \
                    "the crashed round did not re-derive from the epoch"
            for c in (c0b, c1):
                await c.call("shutdown", _timeout=30)
                c.close()
            assert p0.wait(timeout=30) == 0 and p1.wait(timeout=30) == 0
        finally:
            for p in (p0, p1):
                if p is not None and p.poll() is None:
                    p.kill()
                    p.wait()
    with tempfile.TemporaryDirectory() as d0, \
            tempfile.TemporaryDirectory() as d1:
        asyncio.run(main(d0, d1))


def test_fed_restore_refuses_shard_count_mismatch():
    async def main(root):
        fg = _mk_fed(root, n_shards=2)
        sids = [fg.create_study(name=f"s{i}") for i in range(3)]
        await drive_serial(fg, sids, 1)
        fg.checkpoint()
        await fg.aclose()
        fg3 = _mk_fed(root, n_shards=3)
        with pytest.raises(ValueError, match=r"n_shards=2.*n_shards=3"):
            fg3.restore()
        fg2 = _mk_fed(root, n_shards=2)
        assert fg2.restore()
        assert fg2.study_ids() == sids
        for s in sids:
            assert fg2.study_info(s)["n_obs"] == 1
        await fg2.aclose()
    with tempfile.TemporaryDirectory() as root:
        asyncio.run(main(root))


def test_fed_migration_sweeps_stale_staging_not_inflight():
    """A copier killed mid-migration leaks a `.tmp_migrate_*` directory in
    the destination's study store.  The next migration of that study
    sweeps it when it is stale (age-guarded), leaves a concurrent
    writer's fresh one alone, and publishes."""
    async def main(root):
        fg = _mk_fed(root)
        sids = [fg.create_study(name=f"s{i}") for i in range(2)]
        await drive_serial(fg, sids, 1)
        sid = sids[0]
        dst = 1 - fg.shard_of(sid)
        sdir = store_mod.study_dir(fg.shard_dir(dst),
                                   fg.shards[fg.shard_of(sid)]
                                   .registry_record(sid)["key"])
        stale = os.path.join(sdir, ".tmp_migrate_dead0")
        fresh = os.path.join(sdir, ".tmp_migrate_inflight")
        for p in (stale, fresh):
            os.makedirs(p)
            with open(os.path.join(p, "arrays-0.npz"), "wb") as f:
                f.write(b"partial")
        old = time.time() - 7200.0           # default TTL is 3600 s
        os.utime(stale, (old, old))
        fg.migrate_study(sid, dst)
        assert not os.path.exists(stale), "stale staging debris survived"
        assert os.path.isdir(fresh), "swept a concurrent writer's dir"
        assert fg.study_info(sid)["n_obs"] == 1
        await drive_serial(fg, [sid], 1)
        assert fg.study_info(sid)["n_obs"] == 2
        await fg.aclose()
    with tempfile.TemporaryDirectory() as root:
        asyncio.run(main(root))


# ---------------------------------------------------------------------------
# The short federation soak (tests/test_soak.py:107)
# ---------------------------------------------------------------------------
async def _soak(d, *, slots, n_studies, rounds, n_max, traffic_seed):
    gw = _mk_gw(d, slots, n_max)
    sids = [gw.create_study(name=f"t{i}") for i in range(n_studies)]
    streams, gw = await run_traffic(gw, sids, rounds,
                                    traffic_seed=traffic_seed)
    await gw.aclose()
    return streams


async def _fed_soak(d, *, n_shards, slots, n_studies, rounds, n_max,
                    kill_every, migrate_every, traffic_seed):
    fg = _mk_fed(d, n_shards=n_shards, slots=slots, n_max=n_max)
    sids = [fg.create_study(name=f"t{i}") for i in range(n_studies)]
    state = {"kill": 0}

    async def on_round(r, cur):
        if (r + 1) % migrate_every == 0:
            sid = sids[r % len(sids)]
            cur.migrate_study(sid, (cur.shard_of(sid) + 1) % n_shards)
        if (r + 1) % kill_every == 0:
            cur.checkpoint()
            i = state["kill"] % n_shards
            state["kill"] += 1
            cur.kill_shard(i)
            cur.revive_shard(i)
        return None

    streams, _ = await run_traffic(fg, sids, rounds,
                                   traffic_seed=traffic_seed,
                                   on_round=on_round)
    summary = fg.summary()
    info = {s: fg.study_info(s) for s in sids}
    await fg.aclose()
    return streams, summary, info


def test_fed_soak_equals_single_pool_short():
    """2 shards with eviction churn, a shard killed and revived twice and
    periodic forced migrations serve every study the same stream as one
    uninterrupted all-resident port pool."""
    async def main(d_a, d_b):
        ref = await _soak(d_a, slots=6, n_studies=6, rounds=12, n_max=24,
                          traffic_seed=11)
        fed, summary, info = await _fed_soak(
            d_b, n_shards=2, slots=2, n_studies=6, rounds=12, n_max=24,
            kill_every=5, migrate_every=3, traffic_seed=11)
        assert_streams_identical(ref, fed)
        assert summary["evictions"] >= 1
        assert summary["epoch"] >= 2
        for s, i in info.items():
            assert i["n_obs"] == len(ref[s])
    with tempfile.TemporaryDirectory() as d_a, \
            tempfile.TemporaryDirectory() as d_b:
        asyncio.run(main(d_a, d_b))
