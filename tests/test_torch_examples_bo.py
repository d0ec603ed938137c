"""The port's quickstart, hpo_service and serve examples
(`repro_torch.examples`) against the JAX package's `examples/*.py` at the
same options: the JAX examples run as subprocesses on the CPU (all started
at once, a resume after its first run) while the port's `main(argv)` runs
in process with `--device cpu`.  Held to the reference's printed totals
(evaluations, suggestions served, each tenant's n, the resumed n after a
second run on the same checkpoint directory) and to its lines with every
number blanked.  Best values come from other random streams (threefry
against Philox), so they are held to bounds, not to the reference's
bits."""
import ast
import re

import numpy as np
import pytest
from _torch_examples import (numbers, reference_outputs, shape,
                             start_reference, stop)

from repro_torch.examples import hpo_service, quickstart, serve

QUICK = ["--iterations", "10", "--seeds", "3"]
QUICK_RUNS = {"lazy": [], "naive": ["--mode", "naive"], "lag4": ["--lag", "4"]}
SERVICE = ["--studies", "3", "--budget", "5", "--latency", "0",
           "--categorical-tenant"]
SERVE = ["--studies", "5", "--slots", "2", "--budget", "4", "--latency", "0"]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every JAX run of this file, started before the first test."""
    d = tmp_path_factory.mktemp("jax")
    procs = {f"quickstart {k}": start_reference("quickstart", QUICK + v)
             for k, v in QUICK_RUNS.items()}
    service = SERVICE + ["--ckpt-dir", str(d / "service")]
    procs["hpo_service"] = start_reference("hpo_service", service, service)
    for q in (1, 4):
        argv = SERVE + ["--q", str(q), "--ckpt-dir", str(d / f"serve{q}")]
        procs[f"serve {q}"] = start_reference("serve", argv, argv)
    outs = {}

    def read(key):
        if key not in outs:
            outs[key] = reference_outputs(procs[key])
        return outs[key]

    yield read
    for p in procs.values():
        stop(p)


@pytest.mark.parametrize("run", list(QUICK_RUNS))
def test_quickstart_matches_reference(capsys, reference, run):
    got = quickstart.main(QUICK + QUICK_RUNS[run] + ["--device", "cpu"])
    out = capsys.readouterr().out
    (want,) = reference(f"quickstart {run}")
    assert shape(out) == shape(want)
    evals = [n for n, _ in numbers(r"after +(\d+) evals: best = +(\S+)",
                                   want)]
    assert list(got["best_after"]) == evals == [3, 6, 9, 13]
    assert got["evals"] == 13
    assert got["device"] == "cpu"
    trajectory = list(got["best_after"].values())
    assert trajectory == sorted(trajectory)          # a running best
    assert got["best"] == trajectory[-1] <= 0.0      # -Levy peaks at 0
    assert np.all(np.abs(got["best_x"]) <= 10.0)     # inside the box
    assert got["mean_gp_ms"] > 0 and got["mean_suggest_ms"] > 0


def test_hpo_service_matches_reference_and_resumes(capsys, tmp_path,
                                                   reference):
    argv = SERVICE + ["--ckpt-dir", str(tmp_path), "--device", "cpu"]
    runs = []
    for want in reference("hpo_service"):
        got = hpo_service.main(argv)
        runs.append((got, capsys.readouterr().out, want))
    for got, out, want in runs:
        assert shape(out) == shape(want)
        served, absorbed = numbers(r"served (\d+) suggestions / absorbed "
                                   r"(\d+) results", want)[0]
        assert (got["suggested"], got["absorbed"]) == (served, absorbed)
        want_n = {f"tenant{i}": n for i, n in
                  numbers(r"tenant(\d+): n=(\d+)", want)}
        assert {k: v["n"] for k, v in got["tenants"].items()} == want_n
        assert got["failures"] == 0
        for name, t in got["tenants"].items():
            assert -3.0 <= t["best"] <= 0.0, name    # the bowls peak at 0
        # The categorical tenant's best is a named choice of its table.
        assert got["tenants"]["tenant2"]["choice"]["optimizer"] in (
            "sgd", "adam", "rmsprop")
    (first, _, _), (resumed, _, want) = runs
    assert first["resumed"] is None and first["suggested"] == 15
    assert resumed["resumed"] == {k: v["n"] for k, v in
                                  first["tenants"].items()}
    assert resumed["suggested"] == 0
    assert "resumed pool: tenant0 n=5, tenant1 n=5, tenant2 n=5" in want


@pytest.mark.parametrize("q", [1, 4])
def test_serve_matches_reference_and_resumes(capsys, tmp_path, reference,
                                             q):
    argv = SERVE + ["--q", str(q), "--ckpt-dir", str(tmp_path), "--device",
                    "cpu"]
    runs = []
    for want in reference(f"serve {q}"):
        got = serve.main(argv)
        runs.append((got, capsys.readouterr().out, want))
    for i, (got, out, want) in enumerate(runs):
        assert shape(out) == shape(want)
        served, total = numbers(r"served (\d+) suggestions \((\d+) absorbed",
                                want)[0]
        assert (got["served"], got["absorbed"]) == (served, total) \
            == (20, 20 * (i + 1))
        assert got["told"] == 20
        want_n = {f"tenant{i}": n for i, n in
                  numbers(r"tenant(\d+): n=(\d+)", want)}
        assert {k: v["n"] for k, v in got["tenants"].items()} == want_n
        assert got["evictions"] > 0                  # 5 studies, 2 slots
        assert all(t["best"] <= 0.0 for t in got["tenants"].values())
        if q > 1:
            widths = ast.literal_eval(
                re.search(r"q-widths=(\{[^}]*\})", want).group(1))
            assert got["q_width_hist"] == widths
            assert got["fantasy_active"] == 0
    assert runs[0][0]["resumed"] is None
    assert runs[1][0]["resumed"] == {f"tenant{i}": 4 for i in range(5)}
