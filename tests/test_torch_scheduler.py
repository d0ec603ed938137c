"""The port's TrialScheduler (`repro_torch.hpo.scheduler`), a one-study
StudyPool, on the CPU: mirrors of the scheduler tests of tests/test_hpo.py
(suggestion flow, async absorption, fault tolerance, elastic width,
checkpoint / restore and resumed runs that seed nothing) and of
tests/test_pool.py's one-code-path contract."""
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from _torch_port import n

from repro_torch.hpo.pool import StudyPool
from repro_torch.hpo.scheduler import SchedulerConfig, TrialScheduler
from repro_torch.hpo.space import LM_SPACE, RESNET_SPACE


def Sched(space, cfg):
    return TrialScheduler(space, cfg, device="cpu")


def quad_objective(hp: dict) -> float:
    """Smooth 3-D objective with optimum at known hparams (maximize)."""
    x = np.log10(hp["lr"]) + 2.5          # optimum lr = 10^-2.5
    y = np.log10(hp["weight_decay"]) + 4.5
    z = hp["momentum"] - 0.9
    return float(-(x ** 2 + 0.5 * y ** 2 + 2 * z ** 2))


def test_sequential_scheduler_improves():
    sched = Sched(RESNET_SPACE, SchedulerConfig(n_max=64, seed=0))
    best = sched.run(quad_objective, budget=25, n_seed=4)
    assert best is not None
    seeds = [t.value for t in sched.trials[:4] if t.value is not None]
    assert best.value >= max(seeds)
    assert best.value > -1.5


def test_parallel_scheduler_async_absorption():
    """Stragglers must not block absorption of faster trials."""
    call_log = []
    lock = threading.Lock()

    def slow_objective(hp):
        # every 4th call is a straggler
        with lock:
            idx = len(call_log)
            call_log.append(idx)
        time.sleep(0.8 if idx % 4 == 0 else 0.02)
        return quad_objective(hp)

    sched = Sched(RESNET_SPACE,
                           SchedulerConfig(n_max=64, parallel=4, seed=1))
    best = sched.run(slow_objective, budget=12, n_seed=4)
    assert best is not None
    assert sched.state.n == 12
    # async proof: some trial that STARTED after a straggler FINISHED before
    # it (i.e. absorption happened out of start order).
    done = [t for t in sched.trials if t.status == "done"]
    overtook = any(
        b.started > a.started and b.finished < a.finished
        for a in done for b in done if a is not b)
    assert overtook, "no out-of-order absorption observed"


def test_failed_trial_retries_and_gp_consistent():
    calls = {"n": 0}

    def flaky(hp):
        calls["n"] += 1
        if calls["n"] % 3 == 0:
            raise RuntimeError("node lost")
        return quad_objective(hp)

    sched = Sched(RESNET_SPACE,
                           SchedulerConfig(n_max=64, seed=2, max_retries=2))
    best = sched.run(flaky, budget=10, n_seed=2)
    assert best is not None
    n_done = sum(t.status == "done" for t in sched.trials)
    n_fail = sum(t.status == "failed" for t in sched.trials)
    assert n_done == 10 and n_fail >= 1
    # GP absorbed exactly the done trials
    assert sched.state.n == n_done


def test_failure_penalty_mode_appends_pseudo_observation():
    def always_fails(hp):
        raise RuntimeError("boom")

    sched = Sched(
        RESNET_SPACE, SchedulerConfig(n_max=32, seed=3, max_retries=0,
                                      failure_penalty=-100.0))
    tr = sched.seed_trials(1)[0]
    sched._run_one(always_fails, tr)
    assert tr.status == "failed"
    assert sched.state.n == 1  # penalty observation recorded


def test_elastic_width():
    widths = iter([4, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1])
    seen = []

    def width():
        w = next(widths, 1)
        seen.append(w)
        return w

    sched = Sched(RESNET_SPACE,
                           SchedulerConfig(n_max=64, parallel=4, seed=4))
    with ThreadPoolExecutor(4) as pool:
        best = sched.run(lambda hp: quad_objective(hp), budget=10, n_seed=2,
                         executor=pool, parallel=width)
    assert best is not None and len(seen) >= 1


def test_gp_state_checkpoint_restore():
    with tempfile.TemporaryDirectory() as d:
        cfg = SchedulerConfig(n_max=32, seed=5, ckpt_dir=d)
        sched = Sched(RESNET_SPACE, cfg)
        sched.run(quad_objective, budget=6, n_seed=2)
        n_before = sched.state.n
        alpha_before = n(sched.state.alpha)

        sched2 = Sched(RESNET_SPACE, cfg)
        assert sched2.restore()
        assert sched2.state.n == n_before
        np.testing.assert_allclose(n(sched2.state.alpha),
                                   alpha_before, rtol=1e-6)
        assert len(sched2.trials) == len(sched.trials)
        # restarted controller can continue suggesting + absorbing
        best = sched2.run(quad_objective, budget=n_before + 2, n_seed=0)
        assert best is not None


def test_restore_resume_identical_state_no_duplicate_seeds():
    """A restored scheduler resumes the exact posterior + ledger and must
    NOT re-run its random seed trials (they are already in the GP)."""
    with tempfile.TemporaryDirectory() as d:
        cfg = SchedulerConfig(n_max=32, seed=7, ckpt_dir=d)
        s1 = Sched(RESNET_SPACE, cfg)
        s1.run(quad_objective, budget=5, n_seed=3)
        n_before = s1.state.n
        ledger_before = [(t.trial_id, t.status, t.value) for t in s1.trials]

        s2 = Sched(RESNET_SPACE, cfg)
        assert s2.restore()
        # identical posterior
        assert s2.state.n == n_before
        np.testing.assert_allclose(n(s2.state.alpha),
                                   n(s1.state.alpha), rtol=1e-6)
        np.testing.assert_allclose(n(s2.state.l_buf),
                                   n(s1.state.l_buf), rtol=1e-6)
        # identical trial ledger
        assert [(t.trial_id, t.status, t.value)
                for t in s2.trials] == ledger_before

        # resume with the same n_seed: the resumed run must go straight to
        # EI suggestions, not absorb the seed batch a second time (budget
        # counts absorptions per run() call, same as the parallel path)
        s2.run(quad_objective, budget=2, n_seed=3)
        assert s2.state.n == n_before + 2
        seed_units = {tuple(t.unit.tolist()) for t in s1.trials[:3]}
        new_trials = s2.trials[len(ledger_before):]
        assert len(new_trials) == 2
        assert all(tuple(t.unit.tolist()) not in seed_units
                   for t in new_trials), "seed trials were re-run on resume"


def test_restore_resume_parallel_path_no_duplicate_seeds():
    """Same contract through the thread-pool (parallel) run path."""
    with tempfile.TemporaryDirectory() as d:
        cfg = SchedulerConfig(n_max=32, seed=8, parallel=2, ckpt_dir=d)
        s1 = Sched(RESNET_SPACE, cfg)
        s1.run(quad_objective, budget=4, n_seed=2)

        s2 = Sched(RESNET_SPACE, cfg)
        assert s2.restore()
        n_restored = s2.state.n
        ledger_len = len(s2.trials)
        s2.run(quad_objective, budget=2, n_seed=2)
        # parallel path counts absorptions per run: exactly 2 more, and the
        # new trials are EI suggestions, not a re-seeded random batch
        assert s2.state.n == n_restored + 2
        seed_units = {tuple(t.unit.tolist()) for t in s1.trials[:2]}
        new_trials = s2.trials[ledger_len:]
        assert all(tuple(t.unit.tolist()) not in seed_units
                   for t in new_trials), "seed trials were re-run on resume"


def test_suggestions_within_bounds_and_distinct():
    sched = Sched(LM_SPACE, SchedulerConfig(n_max=64, seed=6))
    sched.run(quad_lm, budget=5, n_seed=3)
    trs = sched.suggest(4)
    units = np.stack([t.unit for t in trs])
    assert units.min() >= 0.0 and units.max() <= 1.0
    d01 = np.linalg.norm(units[0] - units[1])
    assert d01 > 1e-4


def quad_lm(hp):
    return -((np.log10(hp["lr"]) + 3) ** 2 + hp["warmup_frac"])


def test_scheduler_is_one_study_pool():
    """The scheduler's suggest / absorb are the pool's (the same engine,
    the same ledger list)."""
    sched = Sched(RESNET_SPACE, SchedulerConfig(n_max=16, seed=0))
    assert isinstance(sched.pool, StudyPool)
    assert sched.trials is sched.pool.studies[0].trials
    tr = sched._make_trial(np.full(3, 0.4, np.float32))
    sched.absorb(tr, 1.0)
    assert sched.pool.engine.n(0) == 1
    assert sched.state.n == 1


def test_scheduler_defaults_to_the_card():
    assert TrialScheduler.__init__.__kwdefaults__["device"] == "cuda"
    assert StudyPool.__init__.__kwdefaults__["device"] == "cuda"
