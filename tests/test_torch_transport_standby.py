"""The transport's warm standby worker (`repro_torch.hpo.transport`) on the
CPU: a federation that spawns its shards keeps one standby process, the
interpreter started and the port imported, which writes nothing before
it is given a shard; `revive_shard` hands a dead shard to it (the revived
shard runs in the former standby's process) and spawns a new one; a
standby whose stdin closes exits on its own, one that is gone makes the
revive raise, and no child outlives `aclose()`.  A federation of adopted
workers spawns none.  Workers run with one torch thread; every spawn and
every wait is bounded."""
import asyncio
import json
import os
import signal
import subprocess
import tempfile

import pytest
from _traffic import drive_serial_rpc

from repro_torch.core.acquisition import AcqConfig
from repro_torch.hpo import (FederationConfig, GatewayConfig, SchedulerConfig,
                             TransportConfig, TransportError,
                             TransportFederation)
from repro_torch.hpo import transport as tx
from repro_torch.hpo.space import RESNET_SPACE

WAIT_S = 120.0       # the most any one test's federation may take


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """Spawned workers inherit the environment: one torch thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _mk_tf(root, **tkw):
    tkw.setdefault("spawn_timeout_s", 60.0)
    cfg = SchedulerConfig(n_max=16, ckpt_dir=root, ckpt_every=10_000,
                          seed=0, acq=AcqConfig(restarts=8, ascent_steps=4))
    return TransportFederation(
        RESNET_SPACE, cfg, GatewayConfig(slots=4),
        FederationConfig(n_shards=2),
        TransportConfig(heartbeat_s=0.0, **tkw), device="cpu")


def _alive(pid: int) -> bool:
    """True while `pid` runs (a zombie, not yet reaped, counts as gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def _files(root: str) -> set[str]:
    return {os.path.relpath(os.path.join(d, f), root)
            for d, _, fs in os.walk(root) for f in fs}


def _run(main, root):
    """`main(tf)` bounded by WAIT_S on a fresh federation over `root`,
    closed whatever happens; returns every child pid it had."""
    tf = _mk_tf(root)
    pids = set()

    async def wrapped():
        try:
            await asyncio.wait_for(main(tf, pids), WAIT_S)
        finally:
            pids.update(p.pid for p in [*tf.procs, tf.standby]
                        if p is not None)
            await asyncio.wait_for(tf.aclose(), 60)
    asyncio.run(wrapped())
    return tf, pids


def test_start_keeps_one_standby_that_writes_nothing():
    async def main(tf, pids):
        await tf.start()
        sb = tf.standby
        assert sb is not None and sb.poll() is None
        pids.update(p.pid for p in tf.procs)
        pids.add(sb.pid)
        assert sb.pid not in {p.pid for p in tf.procs}
        # the root holds what the front end and the two shard workers
        # write, and the standby holds no file under it open
        root = os.path.dirname(tf.shard_dir(0))
        assert _files(root) == {
            os.path.join(f"shard-{i}", f)
            for i in range(2) for f in (tx.SPEC_FILE, tx.ENDPOINT_FILE)}
        root = os.path.realpath(root)
        for fd in os.listdir(f"/proc/{sb.pid}/fd"):
            try:
                target = os.readlink(f"/proc/{sb.pid}/fd/{fd}")
            except FileNotFoundError:
                continue
            assert not target.startswith(root), target
        # nor a socket bound: no listening socket of its own
        assert not any(os.readlink(f"/proc/{sb.pid}/fd/{fd}").startswith(
            "socket:") for fd in os.listdir(f"/proc/{sb.pid}/fd"))
    with tempfile.TemporaryDirectory() as root:
        tf, pids = _run(main, root)
    assert tf.standby is None and len(pids) == 3
    assert not any(_alive(p) for p in pids), "a child outlived aclose()"


def test_revive_runs_the_shard_in_the_former_standby():
    async def main(tf, pids):
        await tf.start()
        sids = [await tf.create_study(name=f"s{i}") for i in range(4)]
        await drive_serial_rpc(tf, sids, 2)
        await tf.checkpoint()
        await drive_serial_rpc(tf, sids, 1)      # uncommitted on shard 0
        pids.update(p.pid for p in tf.procs)
        old, warm = tf.procs[0], tf.standby
        pids.add(warm.pid)
        tf.kill_shard(0)
        assert old.poll() == -signal.SIGKILL
        await tf.revive_shard(0)
        assert tf.procs[0] is warm and tf.procs[0].pid == warm.pid
        fresh = tf.standby
        assert fresh is not None and fresh.pid not in (warm.pid, old.pid)
        pids.add(fresh.pid)
        for s in sids:
            want = 2 if tf.shard_of(s) == 0 else 3
            assert (await tf.study_info(s))["n_obs"] == want
        assert [w["shard"] for w in tf.worker_starts] == [0, 1, 0]
        assert set(tf.worker_starts[-1]) == {
            "shard", "endpoint_s", "standby_s", "imports", "gateway",
            "restore", "bind"}
        # shard 0 keeps serving; a second revive waits for the new standby
        await drive_serial_rpc(tf, sids, 1)
        tf.kill_shard(0)
        await tf.revive_shard(0)
        assert tf.procs[0] is fresh
        pids.add(tf.standby.pid)
        for s in sids:
            want = 2 if tf.shard_of(s) == 0 else 4
            assert (await tf.study_info(s))["n_obs"] == want
    with tempfile.TemporaryDirectory() as root:
        _, pids = _run(main, root)
    assert len(pids) == 5
    assert not any(_alive(p) for p in pids), "a child outlived aclose()"


def test_standby_exits_when_its_stdin_closes():
    async def main(tf, pids):
        await tf.start()
        sb = tf.standby
        sb.stdin.close()
        assert sb.wait(timeout=30) == 0
    with tempfile.TemporaryDirectory() as root:
        _run(main, root)


def test_revive_raises_when_the_standby_is_gone():
    async def main(tf, pids):
        await tf.start()
        sid = await tf.create_study(name="s")
        sb = tf.standby
        sb.kill()
        sb.wait()
        victim = tf.shard_of(sid)
        tf.kill_shard(victim)
        with pytest.raises(TransportError,
                           match=f"standby worker exited rc={-signal.SIGKILL}"):
            await tf.revive_shard(victim)
        assert tf.clients[victim] is None
    with tempfile.TemporaryDirectory() as root:
        _, pids = _run(main, root)
    assert not any(_alive(p) for p in pids), "a child outlived aclose()"


def test_adopted_federation_spawns_no_standby():
    """Two operator-started workers adopted through `connect`: no
    standby process."""
    with tempfile.TemporaryDirectory() as root:
        spawner = _mk_tf(root)
        spec = tx.build_spec(RESNET_SPACE, spawner.cfg, spawner.gw,
                             device="cpu")
        procs, endpoints = [], []
        try:
            for i in range(2):
                d = spawner.shard_dir(i)
                os.makedirs(d)
                tx._write_json_atomic(os.path.join(d, tx.SPEC_FILE), spec)
                cmd, env = spawner._worker_cmd("--ckpt-dir", d)
                procs.append(subprocess.Popen(cmd, env=env))

            async def main():
                for i, p in enumerate(procs):
                    await spawner._await_endpoint(
                        i, p, os.path.join(spawner.shard_dir(i),
                                           tx.ENDPOINT_FILE))
                    with open(os.path.join(spawner.shard_dir(i),
                                           tx.ENDPOINT_FILE)) as f:
                        ep = json.load(f)
                    endpoints.append(f"{ep['host']}:{ep['port']}")
                tf = _mk_tf(root, connect=tuple(endpoints))
                try:
                    await tf.start()
                    assert tf.standby is None
                    sid = await tf.create_study(name="s")
                    tr = await tf.ask(sid)
                    await tf.tell(sid, tr, 0.5)
                    await tf.drain()
                finally:
                    await asyncio.wait_for(tf.aclose(), 60)
                assert tf.standby is None
            asyncio.run(asyncio.wait_for(main(), WAIT_S))
            for p in procs:
                assert p.wait(timeout=30) == 0      # shut down over RPC
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
