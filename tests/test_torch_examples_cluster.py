"""The port's serve_cluster example (`repro_torch.examples.serve_cluster`:
shard worker processes behind the socket front end) against the JAX
package's `examples/serve_cluster.py` at the same options, the reference
started as a subprocess before the first test.  Without a kill every
tenant's n and shard are the reference's.  With `--kill` shard 0 is
SIGKILLed and revived, and a tenant of shard 0 may lose its one
uncommitted tell; that run is held to the reference's run without a
kill, its lines less the supervisor's.  (The JAX example's own
`--kill` run is not started here: under a loaded test run its revived
worker once failed to find its spec file and the run hung.)  The worker
processes' own lines (`[shard-worker ...]`, standard error) are not
compared."""
import pytest
from _torch_examples import (numbers, reference_outputs, shape,
                             start_reference, stop)

from repro_torch.examples import serve_cluster

CLUSTER = ["--studies", "4", "--budget", "3", "--latency", "0.05",
           "--kill-after", "0.3"]


def test_failover_budget_is_the_references():
    """`examples/serve_cluster.py:69-70`: `retried += 1; if retried > 50:
    raise`."""
    assert serve_cluster.MAX_RETRIES == 50


@pytest.fixture(scope="module")
def reference():
    proc = start_reference("serve_cluster", CLUSTER)
    outs = []

    def read():
        if not outs:
            outs.extend(reference_outputs(proc))
        return outs[0]

    yield read
    stop(proc)


def _front(text: str) -> list[str]:
    return [ln for ln in shape(text)
            if not ln.startswith(("[shard-worker", "[supervisor]"))]


def _tenants(text: str) -> dict:
    return {f"tenant{t}": (shard, n) for t, shard, n in
            numbers(r"tenant(\d+): shard (\d+) n=(\d+)", text)}


@pytest.mark.parametrize("run", ["plain", "kill"])
def test_serve_cluster_matches_reference(capsys, monkeypatch, reference,
                                         run):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # the spawned workers'
    argv = CLUSTER + (["--kill"] if run == "kill" else []) + ["--device",
                                                              "cpu"]
    got = serve_cluster.main(argv)
    out = capsys.readouterr().out
    want = reference()
    assert _front(out) == _front(want)
    (served, _), = numbers(r"served (\d+) suggestions for (\d+) tenants",
                           want)
    assert got["served"] == served == 12
    assert got["resumed"] is False
    want_t = _tenants(want)
    assert {k: t["shard"] for k, t in got["tenants"].items()} == \
        {k: shard for k, (shard, _) in want_t.items()}
    for k, t in got["tenants"].items():
        assert t["best"] is not None and t["best"] <= 0.0
        assert want_t[k][1] == 3
        if run == "plain" or t["shard"] != 0:
            assert t["n"] == 3
        else:
            # the killed shard's tenants lose at most their uncommitted tell
            assert 2 <= t["n"] <= 3
    # Each spawned worker's start, stage by stage (no CUDA stage on the
    # CPU), the revived shard 0 last: the standby's, whose record adds its
    # spawn to ready (`standby_s`) and counts `endpoint_s` from the
    # assignment.
    starts = got["worker_starts"]
    assert [w["shard"] for w in starts] == [0, 1] + [0] * (run == "kill")
    first = {"shard", "endpoint_s", "imports", "gateway", "restore", "bind"}
    for j, w in enumerate(starts):
        assert set(w) == (first | {"standby_s"} if j >= 2 else first)
        assert all(v >= 0.0 for k, v in w.items() if k != "shard")
        assert w["endpoint_s"] >= w["gateway"] + w["restore"] + w["bind"]
    retries = got["client_retries"]
    assert len(retries) == len(got["tenants"]) == 4
    assert sum(retries.values()) == got["retries"]
    assert all(0 <= r <= 50 for r in retries.values()), retries
    if run == "kill":
        assert got["kill"]["revived"] and got["kill"]["revive_s"] > 0.0
        assert "[supervisor] shard 0 SIGKILLed after epoch 1" in out
        assert "[supervisor] shard 0 respawned + reconciled" in out
        assert "[supervisor] retries by study" in out
    else:
        assert got["kill"] is None and got["retries"] == 0
