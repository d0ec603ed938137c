"""The port's cross-process transport (`repro_torch.hpo.transport`) on the
CPU: real port shard worker PROCESSES behind the socket RPC front end —
tests/test_transport.py on the port.  Frames, the spec round trip, two
worker processes bit for bit a port single pool (streams, ledgers, state
digests, summary counts), SIGKILL and respawn, connection faults, the
gateway's error types across the wire, a heartbeat flap mid-migration, a
SIGKILL during the snapshot copy, and a worker asked for the card where
there is none.  Workers run with one torch thread (OMP_NUM_THREADS=1);
every spawn and every wait is bounded."""
import asyncio
import json
import os
import signal
import socket
import struct
import tempfile

import numpy as np
import pytest
from _traffic import drive_serial, drive_serial_rpc
from _traffic import objective as obj

from repro_torch import checkpoint as ckpt_mod
from repro_torch.core import GPCapacityError
from repro_torch.core.acquisition import AcqConfig
from repro_torch.hpo import (GatewayConfig, SchedulerConfig, StudyGateway,
                             TransportConfig, TransportError,
                             TransportFederation, FederationConfig)
from repro_torch.hpo import transport as tx
from repro_torch.hpo.space import RESNET_SPACE

WAIT_S = 120.0       # the most any one test's federation may take


def _cfg(d, n_max=16, **kw):
    kw.setdefault("acq", AcqConfig(restarts=8, ascent_steps=4))
    kw.setdefault("ckpt_every", 10_000)
    kw.setdefault("seed", 0)
    return SchedulerConfig(n_max=n_max, ckpt_dir=d, **kw)


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """Spawned workers inherit the environment: one torch thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _mk_tf(root, n_shards=2, slots=4, n_max=24, device="cpu", **tkw):
    """2-worker port transport federation on the CPU with test-sized
    budgets; health checks are explicit (`heartbeat_s=0`)."""
    tkw.setdefault("spawn_timeout_s", 60.0)
    return TransportFederation(
        RESNET_SPACE, _cfg(root, n_max=n_max), GatewayConfig(slots=slots),
        FederationConfig(n_shards=n_shards),
        TransportConfig(heartbeat_s=0.0, **tkw), device=device)


def _run(main, *dirs):
    """Run `main(tf_holder, *dirs)` bounded by WAIT_S; the federation it
    put in `tf_holder` is closed (workers shut down or killed) whatever
    happens."""
    async def wrapped():
        holder = []
        try:
            await asyncio.wait_for(main(holder, *dirs), WAIT_S)
        finally:
            for tf in holder:
                for p in tf.procs:
                    if p is not None and p.poll() is None:
                        try:
                            os.kill(p.pid, signal.SIGCONT)
                        except ProcessLookupError:
                            pass
                await asyncio.wait_for(tf.aclose(), 60)
    asyncio.run(wrapped())


async def _create_on_both(tf, n=4):
    sids = [await tf.create_study(name=f"s{i}") for i in range(n)]
    by_shard = {i: [s for s in sids if tf.shard_of(s) == i]
                for i in range(tf.fed.n_shards)}
    assert all(by_shard.values()), f"one-sided placement: {by_shard}"
    return sids, by_shard


# ---------------------------------------------------------------------------
# Frame codec (no processes)
# ---------------------------------------------------------------------------
def test_frame_roundtrip():
    msg = {"id": 7, "op": "tell",
           "args": {"sid": 3, "trial": {"unit": [0.25, 1.0]}, "value": -2.5}}
    buf = tx.encode_frame(msg)
    assert struct.unpack(">I", buf[:4])[0] == len(buf) - 4

    async def main():
        reader = asyncio.StreamReader()
        reader.feed_data(buf)
        assert await tx.read_frame(reader) == msg
    asyncio.run(main())


def test_frame_truncation_and_oversize_are_connection_errors():
    async def main():
        reader = asyncio.StreamReader()
        reader.feed_data(tx.encode_frame({"op": "ping"})[:-3])
        reader.feed_eof()
        with pytest.raises(asyncio.IncompleteReadError):
            await tx.read_frame(reader)
        reader = asyncio.StreamReader()
        reader.feed_data(struct.pack(">I", 1 << 30) + b"x" * 16)
        with pytest.raises(TransportError, match="desynchronized"):
            await tx.read_frame(reader)
        reader = asyncio.StreamReader()
        reader.feed_data(struct.pack(">I", 4) + b"\xff\xfe\x00\x01")
        with pytest.raises(TransportError, match="undecodable"):
            await tx.read_frame(reader)
    asyncio.run(main())


def test_spec_roundtrip_rebuilds_the_same_gateway_shape(tmp_path):
    cfg = _cfg(str(tmp_path / "a"), n_max=24, seed=11)
    gwc = GatewayConfig(slots=3, max_inflight=2)
    spec = json.loads(json.dumps(tx.build_spec(RESNET_SPACE, cfg, gwc,
                                               device="cpu")))
    assert spec["device"] == "cpu"
    gw = tx.gateway_from_spec(spec, str(tmp_path / "b"))
    assert gw.cfg == _cfg(str(tmp_path / "b"), n_max=24, seed=11)
    assert gw.gw == gwc
    assert gw.pool.engine.device.type == "cpu"
    assert [d.name for d in gw._template_space.dims] == \
        [d.name for d in RESNET_SPACE.dims]


# ---------------------------------------------------------------------------
# Cross-deployment equivalence: 2 worker processes == 1 port pool
# ---------------------------------------------------------------------------
def test_two_process_federation_matches_single_pool_bitwise():
    """WHERE a study is served (one port pool, or 2 port shard processes
    over sockets) never changes WHAT it is suggested: streams, ledgers,
    per-study state digests and summary counts equal, bit for bit."""
    async def main(holder, root, twin_dir):
        tf = _mk_tf(os.path.join(root, "fed"))
        holder.append(tf)
        await tf.start()
        sids, _ = await _create_on_both(tf, 4)
        solo = StudyGateway(RESNET_SPACE, _cfg(twin_dir, n_max=24),
                            GatewayConfig(slots=8), device="cpu")
        assert [solo.create_study(name=f"s{i}") for i in range(4)] == sids

        st_tf = await drive_serial_rpc(tf, sids, 3)
        st_solo = await drive_serial(solo, sids, 3)
        assert st_tf == st_solo, "suggestion streams diverged"

        fed_sum, solo_sum = await tf.summary(), solo.summary()
        assert fed_sum["asks_served"] == solo_sum["asks_served"] == 12
        assert fed_sum["absorbed"] == solo_sum["absorbed"] == 12
        stable = ("trial_id", "unit", "value", "status", "error")
        for s in sids:
            i_tf, i_solo = await tf.study_info(s), solo.study_info(s)
            assert i_tf["n_obs"] == i_solo["n_obs"] == 3
            assert i_tf["best_value"] == i_solo["best_value"]
            led = await tf._client_for(s).call("ledger", sid=s)
            twin = solo.pool.history(i_solo["slot"])
            assert led is not None and len(led) == len(twin)
            for a, b in zip(led, twin):
                for k in stable:
                    assert a[k] == b[k], f"ledger[{k}] of study {s}"
            dig = await tf._client_for(s).call("state_digest", sid=s)
            assert dig == tx.study_state_digest(solo.pool, i_solo["slot"]), \
                f"study {s}: GP state diverged from the single pool"
        await solo.aclose()
    with tempfile.TemporaryDirectory() as root, \
            tempfile.TemporaryDirectory() as twin:
        _run(main, root, twin)


# ---------------------------------------------------------------------------
# SIGKILL + respawn
# ---------------------------------------------------------------------------
def test_sigkill_respawn_loses_exactly_the_uncommitted_round():
    async def main(holder, root):
        tf = _mk_tf(root)
        holder.append(tf)
        await tf.start()
        sids, by_shard = await _create_on_both(tf, 4)
        victim = tf.shard_of(sids[0])
        survivor = 1 - victim
        pre = await drive_serial_rpc(tf, sids, 2)
        await tf.checkpoint()
        lost = await drive_serial_rpc(tf, sids, 1)

        pid = tf.procs[victim].pid
        tf.kill_shard(victim)
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
        s_surv = by_shard[survivor][0]
        tr = await tf.ask(s_surv)
        await tf.tell(s_surv, tr, obj(s_surv, tr.unit))
        await tf.drain()
        assert (await tf.study_info(s_surv))["n_obs"] == 4

        await tf.revive_shard(victim)
        for s in by_shard[victim]:
            assert (await tf.study_info(s))["n_obs"] == 2, \
                "a committed tell was lost in the crash"
        post = await drive_serial_rpc(tf, sids, 2)
        for s in sids:
            assert set(pre[s]).isdisjoint(post[s]), \
                "revived worker replayed a pre-crash suggestion"
            if tf.shard_of(s) == victim:
                assert post[s][0] == lost[s][0], \
                    "the lost round did not re-derive bitwise"
    with tempfile.TemporaryDirectory() as root:
        _run(main, root)


# ---------------------------------------------------------------------------
# Fault matrix: dropped connections, parked asks, garbage frames
# ---------------------------------------------------------------------------
def test_connection_faults_cancel_asks_fail_tells_survive_garbage():
    async def main(holder, root):
        tf = _mk_tf(root)
        holder.append(tf)
        await tf.start()
        sids, by_shard = await _create_on_both(tf, 4)
        victim = tf.shard_of(sids[0])
        survivor = 1 - victim
        s_vic, s_surv = by_shard[victim][0], by_shard[survivor][0]
        await drive_serial_rpc(tf, sids, 1)
        await tf.checkpoint()

        held = await tf.ask(s_vic)
        os.kill(tf.procs[victim].pid, signal.SIGSTOP)
        ask_fut = asyncio.ensure_future(tf.ask(s_vic))
        tell_fut = asyncio.ensure_future(
            tf.tell(s_vic, held, obj(s_vic, held.unit)))
        await asyncio.sleep(0.3)
        assert not ask_fut.done() and not tell_fut.done()
        tf.kill_shard(victim)
        with pytest.raises(asyncio.CancelledError):
            await ask_fut
        with pytest.raises(tx.ShardConnectionError):
            await tell_fut
        with pytest.raises(RuntimeError, match="down"):
            await tf.ask(s_vic)

        with open(os.path.join(tf.shard_dir(survivor),
                               tx.ENDPOINT_FILE)) as f:
            ep = json.load(f)
        for garbage in (struct.pack(">I", 100) + b"short",
                        struct.pack(">I", 1 << 30) + b"x" * 32):
            raw = socket.create_connection((ep["host"], ep["port"]))
            raw.sendall(garbage)
            raw.close()
        tr = await tf.ask(s_surv)
        await tf.tell(s_surv, tr, obj(s_surv, tr.unit))
        await tf.drain()

        await tf.revive_shard(victim)
        assert (await tf.study_info(s_vic))["n_obs"] == 1
        tr = await tf.ask(s_vic)
        await tf.tell(s_vic, tr, obj(s_vic, tr.unit))
        await tf.drain()
        assert (await tf.study_info(s_vic))["n_obs"] == 2
    with tempfile.TemporaryDirectory() as root:
        _run(main, root)


def test_tell_replay_and_capacity_errors_cross_the_wire():
    async def main(holder, root):
        tf = _mk_tf(root)
        holder.append(tf)
        await tf.start()
        sid = await tf.create_study(name="s")
        tr = await tf.ask(sid)
        await tf.tell(sid, tr, 0.5)
        with pytest.raises(RuntimeError, match="exactly one tell"):
            await tf.tell(sid, tr, 0.5)
        tr.status = "running"
        with pytest.raises(RuntimeError, match="exactly one tell"):
            await tf.tell(sid, tr, 0.5)
        with pytest.raises(GPCapacityError, match="max_inflight"):
            await tf.ask(sid, q=99)
        with pytest.raises(KeyError, match="unknown study"):
            await tf.ask(777)
    with tempfile.TemporaryDirectory() as root:
        _run(main, root)


# ---------------------------------------------------------------------------
# Heartbeat flap during an in-flight migration
# ---------------------------------------------------------------------------
def test_heartbeat_flap_mid_migration_aborts_all_or_nothing():
    async def main(holder, root):
        tf = _mk_tf(root, heartbeat_timeout_s=0.25, miss_limit=2)
        holder.append(tf)
        await tf.start()
        sids, _ = await _create_on_both(tf, 4)
        sid = sids[0]
        src = tf.shard_of(sid)
        dst = 1 - src
        await drive_serial_rpc(tf, sids, 2)

        os.kill(tf.procs[dst].pid, signal.SIGSTOP)
        mig = asyncio.ensure_future(tf.migrate_study(sid, dst))
        await asyncio.sleep(0.4)
        died = []
        for _ in range(4):
            died += await tf.check_health()
            if dst in died:
                break
        assert dst in died, "flapping shard was never marked dead"
        with pytest.raises(RuntimeError):
            await mig
        assert tf.shard_of(sid) == src
        tr = await tf.ask(sid)
        await tf.tell(sid, tr, obj(sid, tr.unit))
        await tf.drain()
        assert (await tf.study_info(sid))["n_obs"] == 3

        os.kill(tf.procs[dst].pid, signal.SIGCONT)
        await tf.revive_shard(dst)
        await tf.migrate_study(sid, dst)
        assert tf.shard_of(sid) == dst
        info = await tf.study_info(sid)
        assert info["n_obs"] == 3 and info["shard"] == dst
        tr = await tf.ask(sid)
        await tf.tell(sid, tr, obj(sid, tr.unit))
        await tf.drain()
        assert (await tf.study_info(sid))["n_obs"] == 4
    with tempfile.TemporaryDirectory() as root:
        _run(main, root)


# ---------------------------------------------------------------------------
# SIGKILL during copy_study_version
# ---------------------------------------------------------------------------
def _copy_then_die(src, dst, key, version):
    """Child process: SIGKILL itself after the first snapshot file lands
    in the migration staging dir — a front end dying mid-copy."""
    from repro_torch.checkpoint import store as store_mod
    real = store_mod.shutil.copy2

    def die_after_one(a, b):
        real(a, b)
        os.kill(os.getpid(), signal.SIGKILL)
    store_mod.shutil.copy2 = die_after_one
    store_mod.copy_study_version(src, dst, key, version)


def test_sigkill_during_copy_leaves_no_adoptable_debris():
    import multiprocessing as mp
    with tempfile.TemporaryDirectory() as src_d, \
            tempfile.TemporaryDirectory() as dst_d:
        async def seed(d):
            gw = StudyGateway(RESNET_SPACE, _cfg(d), GatewayConfig(slots=2),
                              device="cpu")
            sid = gw.create_study()
            tr = await gw.ask(sid)
            gw.tell(sid, tr, obj(sid, tr.unit))
            await gw.drain()
            record = gw.export_for_migration(sid)   # commits version 1
            await gw.aclose()
            return record
        record = asyncio.run(seed(src_d))
        key, version = record["key"], record["version"]
        assert version in ckpt_mod.study_versions(src_d, key)

        ctx = mp.get_context("spawn")
        p = ctx.Process(target=_copy_then_die,
                        args=(src_d, dst_d, key, version), daemon=True)
        p.start()
        p.join(timeout=120)
        assert p.exitcode == -signal.SIGKILL

        sdir = ckpt_mod.study_dir(dst_d, key)
        debris = [f for f in os.listdir(sdir)
                  if f.startswith(".tmp_migrate_")]
        assert debris, "the SIGKILL arrived after publication?"
        assert not ckpt_mod.study_versions(dst_d, key)
        dst_gw = StudyGateway(RESNET_SPACE, _cfg(dst_d),
                              GatewayConfig(slots=2), device="cpu")
        with pytest.raises(RuntimeError, match="not.*committed"):
            dst_gw.adopt_study(record)
        assert ckpt_mod.sweep_tmp(sdir) == []
        swept = ckpt_mod.sweep_tmp(sdir, ttl_s=0.0)
        assert [os.path.basename(s) for s in swept] == debris
        ckpt_mod.copy_study_version(src_d, dst_d, key, version)
        assert version in ckpt_mod.study_versions(dst_d, key)
        dst_gw.adopt_study(record)
        assert dst_gw.study_info(int(record["sid"]))["n_obs"] == 1


# ---------------------------------------------------------------------------
# The default device: the card, or an error
# ---------------------------------------------------------------------------
def test_worker_asked_for_the_card_without_one_fails_to_come_up(
        monkeypatch):
    """A federation left at its default `device="cuda"` whose workers see
    no card (`CUDA_VISIBLE_DEVICES` empty, on any host): its first worker
    raises in `gateway_from_spec` (`gp.resolve_device`) and exits, and
    `start()` raises TransportError with the exit code — no worker carries
    on on the CPU."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")

    async def main(holder, root):
        tf = _mk_tf(root, device="cuda")
        holder.append(tf)
        with pytest.raises(TransportError, match=r"exited rc=1"):
            await tf.start()
        with open(os.path.join(tf.shard_dir(0), tx.SPEC_FILE)) as f:
            assert json.load(f)["device"] == "cuda"
        assert not os.path.exists(os.path.join(tf.shard_dir(0),
                                               tx.ENDPOINT_FILE))
    with tempfile.TemporaryDirectory() as root:
        _run(main, root)
