"""The fused EI's tile autotuner (`acq.acq_tile_config`) and the committed
plan table it reads (`kernels/acq_plans.json`, raced on the card by
`python -m repro_torch.kernels.tune_acq`).

The first four tests mirror the reference's (tests/test_fused_acq.py:
158-196), each beside the reference's own call where the two APIs share a
meaning: the port keys on (plan_rows, n, d, mixed) and races R x k-split
plans, the reference on (n_pad, d, S, substrate) and `block_r`.  The rest
hold the table: every plan compiled, within shared memory, covering U
once, no worse than the heuristic on the recorded launches' device time
(the race itself with faked times), one plan for every
batch and restart shard of a key, and the tabled plan's two-level sum (the
kernel's order, emulated on the CPU) at the reference's tolerance.
"""
import json

import numpy as np
import pytest
import torch
from _torch_port import CPU, j, jax_state_leaves, n, t
from test_torch_acq_plan import EI_TOL, _emulated, _walk

from repro.core import gp as jgp
from repro.core.kernels import make_mixed_kernel as jmake_mixed_kernel
from repro.core.kernels import matern52 as jmatern52
from repro.kernels import acq as jacq
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.kernels import acq, tune_acq

TABLE = json.loads(acq.PLANS_PATH.read_text())
ENTRIES = TABLE["entries"]
IDS = [f"{e['plan_rows']}-{e['n']}-{e['d']}-{e['form']}" for e in ENTRIES]


def _key(e):
    return (e["plan_rows"], e["n"], e["d"], e["form"] == "mixed")


@pytest.fixture(autouse=True)
def _fresh_tune_cache(monkeypatch):
    monkeypatch.setenv("REPRO_ACQ_AUTOTUNE", "on")
    monkeypatch.setattr(acq, "_ACQ_TUNE_CACHE", {})
    monkeypatch.setattr(jops, "_ACQ_TUNE_CACHE", {})


# ---------------------------------------------------------------------------
# The reference's four autotuner tests, on the port's API
# ---------------------------------------------------------------------------
def test_autotuner_same_key_same_config_no_remeasure():
    calls, jcalls = [], []

    def fake_measure(cfg, plan_rows, nn, d, mixed):
        calls.append(cfg)
        return float(abs(cfg.rows - 16) + cfg.tiles_per_slice)  # R 16 wins

    cfg1 = acq.acq_tile_config(64, 1024, 5, False, measure_fn=fake_measure)
    n_first = len(calls)
    assert n_first == len(acq.candidates(64, 1024, 5, False)) == 24
    k_tiles = 1024 // acq.TK
    assert (cfg1.rows, cfg1.tiles_per_slice, cfg1.measured) == (
        16, k_tiles // (k_tiles // acq.MIN_SLICE_TILES), True)
    assert acq.acq_tile_config(64, 1024, 5, False,
                               measure_fn=fake_measure) == cfg1
    assert len(calls) == n_first              # cache hit: no re-measure
    acq.acq_tile_config(64, 1024, 7, False, measure_fn=fake_measure)
    assert len(calls) == 2 * n_first          # new key does re-measure
    acq.acq_tile_config(64, 1024, 5, True, measure_fn=fake_measure)
    assert len(calls) == 3 * n_first          # so does the other form

    # The reference's: the same key, no second measurement.
    def jmeasure(block_r, d_pad, n_pad, s):
        jcalls.append(block_r)
        return float(abs(block_r - 64))

    assert jops.acq_tile_config(256, 5, 1, True, measure_fn=jmeasure) == \
        jops.acq_tile_config(256, 5, 1, True, measure_fn=jmeasure)
    assert len(jcalls) == len(jops.ACQ_BLOCK_R_CANDIDATES)


def test_autotuner_env_off_pins_heuristic(monkeypatch):
    monkeypatch.setenv("REPRO_ACQ_AUTOTUNE", "off")
    called = []
    cfg = acq.acq_tile_config(48, 1024, 5, False,
                              measure_fn=lambda *a: called.append(a) or 0.0)
    assert not called and not cfg.measured
    assert cfg == acq.heuristic_config(48, 1024)
    assert (cfg.rows, cfg.tiles_per_slice) == (acq.ROWS, 6)
    for key in map(_key, ENTRIES):            # the table is bypassed too
        assert acq.acq_tile_config(*key) == acq.heuristic_config(*key[:2])
    assert not acq._ACQ_TUNE_CACHE            # bypasses the cache entirely
    jcfg = jops.acq_tile_config(256, 5, 1, False,
                                measure_fn=lambda *a: called.append(a) or 0.0)
    assert not called and not jcfg.measured and not jops._ACQ_TUNE_CACHE


@pytest.mark.parametrize("value", ["off", "0", "FALSE", " Off "])
def test_env_flip_is_seen_by_every_call(monkeypatch, value):
    """The variable is read at each call: a plan already cached, and the
    launch plan built from it, give way to the heuristic while it is off
    and come back when it is on."""
    def measure(cfg, *key):
        return float(cfg.rows != 4)           # R = 4 wins

    cfg = acq.acq_tile_config(64, 1024, 5, False, measure_fn=measure)
    assert cfg.rows == 4 and acq.call_plan(3, 64, 1024, 5, False).rows == 4
    monkeypatch.setenv("REPRO_ACQ_AUTOTUNE", value)
    assert acq.acq_tile_config(64, 1024, 5, False) == \
        acq.heuristic_config(64, 1024)
    assert acq.call_plan(3, 64, 1024, 5, False) == \
        acq.launch_plan(3, 64, 1024, 5, False)
    monkeypatch.setenv("REPRO_ACQ_AUTOTUNE", "on")
    assert acq.call_plan(3, 64, 1024, 5, False).rows == 4


def test_autotuner_without_measure_or_table_entry_gives_heuristic():
    """No `measure_fn` and a key the table lacks: the heuristic, cached;
    the reference keeps its heuristic in interpret mode the same way."""
    key = (7, 333, 3, False)
    assert key not in set(map(_key, ENTRIES))
    cfg = acq.acq_tile_config(*key)
    assert not cfg.measured and cfg == acq.heuristic_config(7, 333)
    assert acq.acq_tile_config(*key) == cfg
    jcfg = jops.acq_tile_config(256, 5, 1, True)
    assert not jcfg.measured and jcfg.block_r == jops.ACQ_DEFAULT_BLOCK_R


def test_next_power_of_2():
    vals = (1, 2, 3, 5, 8, 9, 129)
    want = [1, 2, 4, 8, 8, 16, 256]
    assert [acq.next_power_of_2(v) for v in vals] == want
    assert [jops.next_power_of_2(v) for v in vals] == want


def test_heuristic_config_is_todays_plan():
    """The heuristic through `launch_plan` is the plan with no config at
    every shape `test_torch_acq_plan.py` walks."""
    for r in (1, 7, 48, 64):
        for nn in (1, 100, 1000, 1024, 40000):
            for pr in (r, 2 * r):
                assert acq.launch_plan(
                    3, r, nn, 5, False, pr,
                    acq.heuristic_config(pr, nn)) == acq.launch_plan(
                        3, r, nn, 5, False, pr)


@pytest.mark.parametrize("rows", [2, 12, 32])
def test_an_uncompiled_tile_raises(rows):
    with pytest.raises(ValueError, match="compiled"):
        acq.launch_plan(1, 64, 1024, 5, False, None,
                        acq.AcqTileConfig(rows, 8, True))
    with pytest.raises(ValueError, match="compiled"):
        acq.launch_plan(1, 64, 1024, 5, False, None,
                        acq.AcqTileConfig(8, 0, True))


@pytest.mark.parametrize("d", [1, 5, 6, 20])
@pytest.mark.parametrize("mixed", [False, True])
def test_shared_bytes_by_tile(d, mixed):
    """`shared_bytes` mirrors `layout(R, 512 / R, d, mixed)` for each
    compiled R: the A stages shrink as R grows, the row buffers grow."""
    sizes = [acq.shared_bytes(d, mixed, rows) for rows in acq.COMPILED_ROWS]
    assert sizes == sorted(sizes, reverse=True)
    assert acq.shared_bytes(d, mixed) == sizes[acq.COMPILED_ROWS.index(8)]
    for rows, size in zip(acq.COMPILED_ROWS, sizes):
        assert size % 16 == 0 and size <= acq.MAX_SHARED
        plan = acq.launch_plan(1, 64, 1024, d, mixed, None,
                               acq.AcqTileConfig(rows, 8, True))
        assert plan.shared_bytes == size and plan.cols == 512 // rows


def test_candidates_hold_the_heuristic_and_every_tile():
    for key in [(64, 1024, 5, False), (48, 1024, 6, True), (64, 24, 3, False),
                (7, 333, 3, False)]:
        cands = acq.candidates(*key)
        heur = acq.heuristic_config(*key[:2])
        assert (cands[0].rows, cands[0].tiles_per_slice) == (
            heur.rows, heur.tiles_per_slice)
        assert len({(c.rows, c.tiles_per_slice) for c in cands}) == len(cands)
        k_tiles = -(-key[1] // acq.TK)
        top = max(1, k_tiles // acq.MIN_SLICE_TILES)
        assert {c.rows for c in cands} == set(acq.COMPILED_ROWS)
        assert {-(-k_tiles // c.tiles_per_slice) for c in cands} == \
            {-(-k_tiles // -(-k_tiles // s)) for s in range(1, top + 1)}


def test_cpu_calls_never_read_the_config(monkeypatch):
    """The plain version ignores the tile config: a CPU call reads no plan
    and counts no miss."""
    def no_config(*a, **k):
        raise AssertionError("a CPU call read a tile config")

    monkeypatch.setattr(acq, "acq_tile_config", no_config)
    rng = np.random.default_rng(3)
    x, xb = rng.uniform(size=(9, 4)), rng.uniform(size=(40, 4))
    a = rng.standard_normal((40, 40)) / 40
    before = acq.MISSES
    ei, g = acq.fused_ei_grad(t(x), t(xb), torch.ones(40), t(rng.standard_normal(40)),
                              t(a @ a.T), 1.0, 0.3, -0.2, plan_rows=18)
    assert ei.shape == (9,) and g.shape == (9, 4) and acq.MISSES == before


# ---------------------------------------------------------------------------
# The committed table
# ---------------------------------------------------------------------------
def test_table_records_the_card_and_the_source():
    assert ENTRIES, "no plan in acq_plans.json: run tune_acq on the card"
    assert "H100" in TABLE["card"] and "W" in TABLE["card"]
    for k in ("device", "torch", "cuda"):
        assert TABLE[k]
    assert TABLE["studies"] > 1 and TABLE["reps"] > 0
    assert isinstance(TABLE["seed"], int)
    assert len(TABLE["acq_cu_sha256"]) == 64
    assert len(set(map(_key, ENTRIES))) == len(ENTRIES)


@pytest.mark.parametrize("e", ENTRIES, ids=IDS)
def test_table_plan_is_compiled_and_fits(e):
    mixed = e["form"] == "mixed"
    assert e["rows"] in acq.COMPILED_ROWS
    assert acq.shared_bytes(e["d"], mixed, e["rows"]) <= acq.MAX_SHARED
    k_tiles = -(-e["n"] // acq.TK)
    assert 1 <= e["tiles_per_slice"] <= k_tiles
    assert e["slices"] == -(-k_tiles // e["tiles_per_slice"])


@pytest.mark.parametrize("e", ENTRIES, ids=IDS)
def test_table_plan_covers_every_entry_of_u_once(e):
    """The tabled plan at S = 1 and 3 owns every (row, column) of U once
    per k-slice and every k-tile once per (row, column) block."""
    key = _key(e)
    cfg = acq.acq_tile_config(*key)
    assert cfg == acq.AcqTileConfig(e["rows"], e["tiles_per_slice"], True)
    r, nn, d, mixed = key
    for batch in (1, 3):
        plan = acq.call_plan(batch, r, nn, d, mixed)
        assert (plan.rows, plan.tiles_per_slice) == (e["rows"],
                                                     e["tiles_per_slice"])
        owned = np.zeros((plan.slices, batch, r, nn), np.int32)
        covered = {}
        for z, (r0, r1), (c0, c1), (k0, k1) in _walk(plan, r, nn):
            assert k0 < k1 and r0 < r1 and c0 < c1
            owned[k0 // plan.tiles_per_slice, z, r0:r1, c0:c1] += 1
            covered[(z, r0, c0)] = covered.get((z, r0, c0), 0) + k1 - k0
        assert (owned == 1).all()
        assert set(covered.values()) == {-(-nn // acq.TK)}


@pytest.mark.parametrize("e", ENTRIES, ids=IDS)
def test_table_winner_is_no_worse_than_the_heuristic(e):
    """The heuristic was raced, and the winner has the least device time
    over the key's recorded launches (each study count's time times its
    launches) of the candidates that hold as many seeded states as the
    heuristic, so it is no worse on that time and that count."""
    key = _key(e)
    launches = {int(s): c for s, c in e["launches"].items()}
    assert launches and all(c > 0 for c in launches.values())
    cost = {(c["rows"], c["tiles_per_slice"]): tune_acq.cost_ms(c, launches)
            for c in e["candidates"]}
    assert set(cost) == {(c.rows, c.tiles_per_slice)
                         for c in acq.candidates(*key)}
    for c in e["candidates"]:
        assert c["cost_ms"] == pytest.approx(cost[(c["rows"],
                                                   c["tiles_per_slice"])])
        assert {"s1_ms", f"s{TABLE['studies']}_ms"} <= set(c)
    heur = acq.heuristic_config(*key[:2])
    assert (e["heuristic"]["rows"], e["heuristic"]["tiles_per_slice"]) == (
        heur.rows, heur.tiles_per_slice)
    win = cost[(e["rows"], e["tiles_per_slice"])]
    held = {(c["rows"], c["tiles_per_slice"]): c["held"]
            for c in e["candidates"]}
    assert all(0 <= h <= TABLE["held_states"] for h in held.values())
    floor = held[(heur.rows, heur.tiles_per_slice)]
    assert held[(e["rows"], e["tiles_per_slice"])] >= floor
    assert win == min(v for k, v in cost.items() if held[k] >= floor)
    assert win <= cost[(heur.rows, heur.tiles_per_slice)]
    assert win == pytest.approx(e["cost_ms"])


@pytest.mark.parametrize("e", ENTRIES, ids=IDS)
def test_table_k_split_holds_as_many_as_one_slice(e):
    """The kernel sums U over its k-slices before any column sum, so at
    every key each candidate holds at least as many seeded states as the
    one-slice candidate of its R, the winner included."""
    one = {c["rows"]: c["held"] for c in e["candidates"]
           if c["slices"] == 1}
    assert set(one) == {c["rows"] for c in e["candidates"]}
    for c in e["candidates"]:
        assert c["held"] >= one[c["rows"]], c


# Every key the paths of chip_smoke.py launch, its examples phase's
# in-process runs included (serve, hpo_service's mixed tenant,
# parallel_hpo, quickstart), as the race recorded them.
TABLE_KEYS = [(16, 16, 3, "float"), (48, 20, 3, "mixed"),
              (48, 64, 3, "float"), (48, 1024, 5, "float"),
              (48, 1024, 6, "mixed"), (64, 24, 3, "float"),
              (64, 133, 5, "float"), (64, 1024, 5, "float"),
              (64, 1024, 6, "mixed")]


@pytest.mark.parametrize("key", TABLE_KEYS, ids=["-".join(map(str, k))
                                                 for k in TABLE_KEYS])
def test_table_key_takes_its_raced_plan(key):
    """The key is tabled, a call reads its raced plan (not the heuristic:
    no table miss), and that plan holds as many seeded states as the
    one-slice candidate of its R."""
    assert sorted(tuple(k) for k in TABLE_KEYS) == sorted(
        (e["plan_rows"], e["n"], e["d"], e["form"]) for e in ENTRIES)
    e = next(e for e in ENTRIES
             if (e["plan_rows"], e["n"], e["d"], e["form"]) == key)
    cfg = acq.acq_tile_config(*_key(e))
    assert cfg == acq.AcqTileConfig(e["rows"], e["tiles_per_slice"], True)
    win = next(c for c in e["candidates"] if (c["rows"], c["tiles_per_slice"])
               == (e["rows"], e["tiles_per_slice"]))
    one = next(c for c in e["candidates"]
               if c["rows"] == e["rows"] and c["slices"] == 1)
    assert win["held"] >= one["held"]
    assert win["held"] >= e["heuristic"]["held"]


def test_table_covers_every_recorded_key():
    """Every key the recorded traffic launched is in the table, and each
    entry was raced on the study counts it was launched with."""
    for e in ENTRIES:
        timed = {int(k[1:-3]) for k in e["ms"]}
        assert {int(s) for s in e["launches"]} <= timed
        assert {1, TABLE["studies"]} <= timed


def _fake_times(by_plan):
    """A `plan_times` stand-in: each config's {"s<S>_ms": ms} from
    `by_plan[(rows, tiles_per_slice)]`, a function of S."""
    def plan_times(key, configs, sizes, reps, seed):
        return [{f"s{s}_ms": by_plan(c.rows, c.tiles_per_slice, s)
                 for s in sizes} for c in configs]
    return plan_times


def _fake_held(fewer):
    """A `held_states` stand-in: every config holds all states but those
    of `fewer` ({(rows, tiles_per_slice): states held})."""
    def held_states(key, configs, states, seed):
        return [{"held": [True] * fewer.get((c.rows, c.tiles_per_slice),
                                            states)} for c in configs]
    return held_states


@pytest.mark.parametrize("launches, want", [
    ({1: 100}, (4, 8)),                  # S = 1 only: its own best
    ({16: 100}, (16, 32)),               # S = 16 only: its own best
    ({1: 10, 16: 10}, (16, 32)),         # 10 x (1.0 + 0.1) < 10 x (0.5 + 1.3)
    ({1: 1000, 16: 1}, (4, 8)),
    ({1: 5, 4: 7, 16: 3}, (16, 32)),     # a recorded S = 4 is timed too
])
def test_race_weights_the_recorded_launches(monkeypatch, launches, want):
    """`tune_acq.tune_key` picks the least device time over the recorded
    launches by study count, times every recorded S, and keeps the
    heuristic on a tie."""
    from repro_torch.kernels import tune_acq as ta

    def ms(rows, tps, s):
        if (rows, tps) == (4, 8):
            return 0.5 if s == 1 else 0.05 * s + 0.5
        if (rows, tps) == (16, 32):
            return 1.0 if s == 1 else 0.1
        return 2.0
    monkeypatch.setattr(ta, "plan_times", _fake_times(ms))
    monkeypatch.setattr(ta, "entry_digests", lambda *a: {})
    monkeypatch.setattr(ta, "held_states", _fake_held({}))
    e = ta.tune_key((48, 1024, 5, "mixed"), launches)
    assert (e["rows"], e["tiles_per_slice"]) == want
    assert set(e["ms"]) == {f"s{s}_ms" for s in {1, ta.STUDIES, *launches}}
    assert e["launches"] == {str(s): c for s, c in sorted(launches.items())}
    assert e["cost_ms"] == pytest.approx(sum(c * ms(*want, s)
                                             for s, c in launches.items()))
    # A tie goes to the heuristic (the first candidate).
    monkeypatch.setattr(ta, "plan_times", _fake_times(lambda *a: 1.0))
    heur = acq.heuristic_config(48, 1024)
    e = ta.tune_key((48, 1024, 5, "mixed"), launches)
    assert (e["rows"], e["tiles_per_slice"]) == (heur.rows,
                                                 heur.tiles_per_slice)
    # A plan that holds fewer seeded states than the heuristic's is not
    # admitted: the fastest of the rest wins.
    monkeypatch.setattr(ta, "plan_times", _fake_times(ms))
    monkeypatch.setattr(ta, "held_states", _fake_held({want: 4}))
    e = ta.tune_key((48, 1024, 5, "mixed"), launches)
    other = {(4, 8): (16, 32), (16, 32): (4, 8)}[want]
    assert (e["rows"], e["tiles_per_slice"]) == other
    assert e["heuristic"]["held"] == 6 and e["candidates"][0]["held"] == 6
    assert e["heuristic"] == e["candidates"][0]


def test_load_launches_sums_the_record(tmp_path):
    """A `--acq-keys` record's launch rows summed by key and study count."""
    from repro_torch.kernels import tune_acq as ta
    path = tmp_path / "keys.json"
    path.write_text(json.dumps({"launches": [
        [48, 1024, 5, "float", 16, 693], [48, 1024, 5, "float", 1, 21],
        [48, 1024, 5, "float", 16, 7], [64, 24, 3, "float", 1, 312]]}))
    assert ta.load_launches(str(path)) == {
        (48, 1024, 5, "float"): {16: 700, 1: 21}, (64, 24, 3, "float"): {1: 312}}


@pytest.mark.parametrize("e", ENTRIES, ids=IDS)
def test_batches_and_restart_shards_read_one_plan(e):
    """A batch of 1-64 studies and a restart shard of R / 2, R / 3 or R / 4
    rows planned at `plan_rows=R` read the key's one config and k-split;
    only the grid's rows and studies follow the call."""
    r, nn, d, mixed = _key(e)
    one = acq.call_plan(1, r, nn, d, mixed)
    for batch in range(1, 65):
        plan = acq.call_plan(batch, r, nn, d, mixed)
        assert (plan.rows, plan.slices, plan.tiles_per_slice) == (
            one.rows, one.slices, one.tiles_per_slice)
        assert plan.grid == (*one.grid[:2], batch)
    for k in (2, 3, 4):
        if r % k:
            continue
        for batch in (1, 16):
            loc = acq.call_plan(batch, r // k, nn, d, mixed, r)
            assert (loc.rows, loc.slices, loc.tiles_per_slice) == (
                one.rows, one.slices, one.tiles_per_slice)
            assert loc.grid == (one.grid[0], -(-(r // k) // one.rows), batch)


def _key_state(e, seed=21):
    """A reference state at the key's n_max with 150 points (the mixed
    form's masks as `tune_acq.key_masks`: two thirds continuous), the
    key's plan_rows candidates, both packages' operands."""
    rng = np.random.default_rng(seed)
    r, nn, d, mixed = _key(e)
    n0 = min(150, nn - 1)
    cont = (np.arange(d) < max(1, 2 * d // 3)).astype(np.float32)
    kern = jmake_mixed_kernel(j(cont), j(1.0 - cont)) if mixed else jmatern52
    xs = rng.uniform(size=(n0, d)).astype(np.float32)
    ys = (np.sin(3.0 * xs.sum(-1)) + 0.1 * xs[:, 0]).astype(np.float32)
    cfg = jgp.GPConfig(n_max=nn, dim=d, implementation="xla", noise2=1e-2)
    st = jgp.refactor(jgp.append_batch(jgp.init_state(cfg), kern, j(xs),
                                       j(ys), implementation="xla"),
                      kern, implementation="xla")
    amask = (np.arange(nn) < n0).astype(np.float32)
    a_buf = (n(st.li_buf).T @ n(st.li_buf)).astype(np.float32)
    x = rng.uniform(size=(r, d)).astype(np.float32)
    args = (x, n(st.x_buf), amask, n(st.alpha), a_buf,
            float(n(st.params.sigma2)), float(n(st.params.rho)), -0.3)
    masks = (cont, 1.0 - cont) if mixed else None
    return args, masks, convert.state_from_numpy(jax_state_leaves(st),
                                                 device=CPU)


@pytest.mark.parametrize("e", ENTRIES, ids=IDS)
def test_tabled_plan_matches_the_reference(e):
    """At a tabled key: the port's `fused_ei_grad` (the plain version on
    the CPU) against the reference's `ops.fused_ei_grad` (its jnp form),
    and the tabled plan's two-level sum, emulated in the kernel's order,
    against the reference's `ei_grad_jnp`, both at tests/
    test_fused_acq.py:65's tolerances."""
    args, masks, tst = _key_state(e)
    x, xb, am, al, ab, s2, rho, shift = args
    assert np.array_equal(n(tst.x_buf), xb)
    mk = {} if masks is None else dict(cont_mask=j(masks[0]),
                                       cat_mask=j(masks[1]))
    ei_w, g_w = jops.fused_ei_grad(j(x), j(xb), j(am), j(al), j(ab), s2, rho,
                                   shift, implementation="xla", **mk)
    tmk = {} if masks is None else dict(cont_mask=t(masks[0]),
                                        cat_mask=t(masks[1]))
    ei, g = acq.fused_ei_grad(t(x), t(xb), t(am), t(al), t(ab), s2, rho, shift,
                              plan_rows=x.shape[0], **tmk)
    np.testing.assert_allclose(n(ei), n(ei_w), **EI_TOL)
    np.testing.assert_allclose(n(g), n(g_w), **EI_TOL)
    plan = acq.call_plan(1, *_key(e))
    assert (plan.rows, plan.tiles_per_slice) == (e["rows"],
                                                 e["tiles_per_slice"])
    ei_t, g_t = _emulated(args, plan, None if masks is None
                          else tuple(t(m) for m in masks))
    ei_j, g_j = jacq.ei_grad_jnp(j(x), j(xb), j(am), j(al), j(ab), s2, rho,
                                 shift, **mk)
    np.testing.assert_allclose(n(ei_t), n(ei_j), **EI_TOL)
    np.testing.assert_allclose(n(g_t), n(g_j), **EI_TOL)
