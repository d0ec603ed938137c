"""Multi-tenant StudyPool: S concurrent HPO studies on one card or a
(study x restart) device mesh (counterpart of `repro/hpo/pool.py`).

`StudyPool` multiplexes S studies over one `StudyEngine` (a stacked
`LazyGPState`, DESIGN.md §7):

  * **batched suggest** — `suggest_all` advances every study's EI ascent
    together, one fused-EI launch an ascent step for all S.
  * **completion-order absorb** — results go to the owning study as they
    arrive (`absorb`), or drain in masked batched rounds (`absorb_many`) of
    at most one observation per study a round.
  * **serving rounds** — `advance_round` absorbs the last round's
    completions and suggests the next batch (`engine.advance`); it is
    `advance_round_begin(...).finish()`, and the begin reads nothing back
    from the card unless a lag event is due.
  * **per-study everything** — ledgers, random streams, capacity guards,
    fault policy (retry / penalized pseudo-observation), lag counters and
    clamp telemetry are kept per tenant.
  * **pool checkpointing** — the stacked GP state and every ledger ride one
    atomic `checkpoint.store` snapshot, under the reference's leaf names
    and metadata, so either package restores the other's.

Random streams: each study owns a numpy `Generator` for its seed trials
(`space.sample`, so seed trials are the reference's points exactly) and a
host-side `torch.Generator` for its EI draws, both seeded `cfg.seed + i`.
The pool draws a study's restart seeds (R, d) and top-t jitter (t, d) from
its own generator (`acquisition.draw_seeds` / `draw_jitter`) and hands
them to the engine, whose own generator it never uses; studies that need
no EI get fixed dummy rows.  So a study's draws are the same on the CPU
and on the card, and the same whether it is served routed or batched.  The
generator's state rides checkpoints and exports under `TORCH_RNG_FIELD`,
beside the reference's numpy `rng_state`.  An export also writes a JAX
`key` (`_gen_key`: two words hashed from the generator's state), so the
reference's `import_study` can adopt a port study, and a port import of a
reference export seeds the slot's generator from that key.

`TrialScheduler` is the S = 1 case: it wraps a one-study pool.  The port
has no `implementation` knob: the tensor's device picks a kernel or its
plain version.

Device mesh: `cfg.mesh` ("none", "auto" or "SxR") and the pool's
`devices` (logical devices, e.g. `["cuda:0"] * 4`; default every visible
device of the pool's type) reach the engine, which refuses a spec that
does not fit when the pool is built.  The draws above are the same with
any mesh, so every spec serves the same bits; `restore` re-places the
snapshot onto the mesh through the engine's `state` setter.
"""
from __future__ import annotations

import base64
import dataclasses
import hashlib
import json
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch import checkpoint as ckpt_mod
from repro_torch.core import acquisition as acq_mod
from repro_torch.core import gp as gp_mod
from repro_torch.core import neural_basis as nb_mod
from repro_torch.core.kernels import KernelParams
from repro_torch.hpo.engine import StudyEngine

TORCH_RNG_FIELD = "torch_rng_state"   # a study's EI generator, base64


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Shared study/pool configuration (one GP shape for every tenant)."""

    n_max: int = 512
    kernel: str = "matern52"
    lag: int = 0                 # 0 = fully lazy (paper's main mode)
    parallel: int = 1            # t (elastic; re-read each round)
    rho0: float = 0.25
    noise2: float = 1e-5
    seed: int = 0                # the engine's torch.Generator seed
    mixed: bool = False          # force the mixed-space kernel (DESIGN.md
    # §10) even when every constructor space is all-continuous, so that a
    # slot can later take a tenant with discrete dims (`set_desc`)
    mesh: str = "none"           # device mesh of the batched path (DESIGN.md
    # §8): "none", "auto" or "SxR" study x restart shards over the pool's
    # logical devices (`hpo/mesh.py`)
    failure_penalty: float | None = None  # None: drop; else pseudo-y
    max_retries: int = 1
    ckpt_dir: str | None = None
    ckpt_every: int = 1          # absorptions between pool checkpoints
    inv_refresh: int = 128       # fully-lazy mode (lag=0): rebuild the
    # factor + maintained inverse from the Gram every `inv_refresh` appends
    # per study, re-anchoring float32 drift without touching the kernel
    # params (0 = never; lag > 0 supersedes it, DESIGN.md §4)
    acq: acq_mod.AcqConfig = dataclasses.field(
        default_factory=lambda: acq_mod.AcqConfig(restarts=48,
                                                  ascent_steps=20))
    fantasy: gp_mod.FantasyConfig = dataclasses.field(
        default_factory=gp_mod.FantasyConfig)  # liar policy for q-asks
    # (DESIGN.md §12): "mean" = kriging believer, "pessimistic" = constant
    # liar; the engine reads it at each ask
    neural: nb_mod.NeuralConfig = dataclasses.field(
        default_factory=nb_mod.NeuralConfig)  # the escalated tier's model
    # (DESIGN.md §15): MLP widths, the head's ridge noise and the refit
    # cadence (the tier's `lag`) of a slot promoted off the full lazy GP


@dataclasses.dataclass
class Trial:
    trial_id: int
    unit: np.ndarray
    hparams: dict
    status: str = "pending"      # pending | running | told | done | failed
    value: float | None = None
    error: str | None = None
    started: float = 0.0
    finished: float = 0.0
    retries: int = 0
    clamp_count: int | None = None  # cumulative GP conditioning-floor hits
    # at absorb time (ill-conditioning telemetry, DESIGN.md §6)
    cost: float = 1.0            # tell-time observation cost (DESIGN.md
    # §15): a row of the escalated tier's log-cost head


def _trial_from_dict(t: dict) -> Trial:
    """Rebuild a ledger Trial from its checkpoint / export dict form."""
    return Trial(t["trial_id"], np.asarray(t["unit"], np.float32),
                 t["hparams"], t["status"], t["value"], t["error"],
                 t["started"], t["finished"], t["retries"],
                 t.get("clamp_count"), t.get("cost", 1.0))


class _HostCopy:
    """A staged round's output on its way to the host: a pinned tensor of
    this round alone, written by a non-blocking copy, and the event
    recorded right after the round's copies."""

    __slots__ = ("host", "ready")

    def __init__(self, host: torch.Tensor, ready: torch.cuda.Event):
        self.host = host
        self.ready = ready


def _materialize(x) -> np.ndarray:
    """Host copy of a staged round's outputs: the first read of the card in
    a round without a lag event.  A `_HostCopy` waits on its round's event
    alone, never on rounds queued after it.  Module-level so that fault
    tests can inject a failure where a round's device error would
    surface."""
    if isinstance(x, _HostCopy):
        x.ready.synchronize()
        return x.host.numpy()
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _to_host(tensors: dict) -> dict:
    """Start the host copies of a staged round's outputs ({name: tensor},
    None entries kept): on the card, each into a pinned tensor of its own
    by a non-blocking copy, then one event for the round, so that `finish`
    waits for this round only; on the CPU the tensors themselves."""
    live = [t for t in tensors.values() if t is not None]
    if not live or live[0].device.type != "cuda":
        return tensors
    out = {}
    for name, t in tensors.items():
        if t is not None:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            t = host
        out[name] = t
    ready = torch.cuda.Event()
    ready.record()
    return {name: None if t is None else _HostCopy(t, ready)
            for name, t in out.items()}


def _gen_state(gen: torch.Generator) -> str:
    return base64.b64encode(gen.get_state().numpy().tobytes()).decode("ascii")


def _set_gen_state(gen: torch.Generator, state: str) -> None:
    raw = np.frombuffer(base64.b64decode(state), np.uint8).copy()
    gen.set_state(torch.from_numpy(raw))


def _new_gen(seed: int) -> torch.Generator:
    gen = torch.Generator()
    gen.manual_seed(int(seed))
    return gen


def _gen_key(gen: torch.Generator) -> list[int]:
    """The JAX `key` an export writes for a study: two uint32 words, the
    first 8 bytes of the SHA-256 of the generator's state (read without a
    draw)."""
    digest = hashlib.sha256(gen.get_state().numpy().tobytes()).digest()
    return [int.from_bytes(digest[:4], "big"),
            int.from_bytes(digest[4:8], "big")]


def _key_seed(key) -> int:
    """The torch seed of a JAX key's two words: k0 * 2^32 + k1."""
    k0, k1 = (int(k) & 0xFFFFFFFF for k in key)
    return (k0 << 32) | k1


class _PendingRound:
    """A staged serving round whose host half has not run yet.

    `advance_round(...)` is `advance_round_begin(...).finish()`.  Every
    launch is queued at begin time in the serial order (fantasy rollback,
    overflow drain, the engine's advance, the clamp copy, the replay), so
    the state's bits are the same whether or not the host defers
    `finish()`, which only does host work: read the suggestions, flip the
    absorbed trials to "done" and mint the new ledger Trials.  It holds
    only fresh outputs (`units`, a copied clamp vector, the escalated
    studies' `nb_units`), never a tensor of `engine.state`, which later
    rounds write in place.  On the card those outputs are already on their
    way to pinned host tensors of this round alone (`_to_host`), and
    `finish()` waits on this round's event only: a round staged after it
    (the gateway's pipelined tick) keeps running on the card meanwhile.
    """

    __slots__ = ("_pool", "_first", "_ids", "_need_seed", "_t",
                 "_units", "_clamps", "_nb_units", "_finished")

    def __init__(self, pool: "StudyPool", first: dict, ids: list,
                 need_seed: set, t: int, units, clamps, nb_units=None):
        self._pool = pool
        self._first = first
        self._ids = ids
        self._need_seed = need_seed
        self._t = t
        self._units = units
        self._clamps = clamps
        self._nb_units = nb_units or {}
        self._finished = False

    def finish(self) -> dict[int, list[Trial]]:
        """Materialize the round: commit the ledger flips, mint trials."""
        if self._finished:
            raise RuntimeError("pending round already finished")
        self._finished = True
        pool = self._pool
        units = None if self._units is None else _materialize(self._units)
        if self._first:
            clamps = _materialize(self._clamps)
            # "done" only once the round's append is in (see absorb())
            for sid, (tr, val) in self._first.items():
                tr.status = "done"
                tr.value = float(val)
                tr.finished = time.time()
                tr.clamp_count = int(clamps[sid])
            pool._n_done += len(self._first)
        out: dict[int, list[Trial]] = {}
        for s in self._ids:
            if s in self._need_seed:
                out[s] = pool.seed_trials(s, self._t)
            elif s in self._nb_units:
                # escalated tenants: suggestions from their own tier
                out[s] = [pool._make_trial(s, u)
                          for u in _materialize(self._nb_units[s])]
            else:
                out[s] = [pool._make_trial(s, u) for u in units[s]]
        pool._maybe_checkpoint()
        return out


@dataclasses.dataclass
class StudyHandle:
    """Host-side per-tenant record: ledger, id counter, random streams."""

    study_id: int
    space: object                # a SearchSpace
    name: str
    trials: list[Trial] = dataclasses.field(default_factory=list)
    next_id: int = 0
    gen: torch.Generator | None = None   # EI draws (host, persistent)
    rng: np.random.Generator | None = None  # seed-trial stream; persistent
    # so repeated seeding draws fresh points, never the same batch twice


class StudyPool:
    """S concurrent studies multiplexed over one batched lazy-GP engine.

    All studies share the GP shape (`cfg.n_max`, `space.dim`) but own
    their posteriors, ledgers and fault state; spaces may differ per study
    as long as their widths match.  Runs on the card unless `device` says
    otherwise; `devices` are the logical devices of `cfg.mesh`.
    """

    def __init__(self, spaces: Sequence, cfg: SchedulerConfig,
                 names: Sequence[str] | None = None, *,
                 device: str | torch.device = "cuda", devices=None):
        spaces = list(spaces)
        if not spaces:
            raise ValueError("StudyPool needs at least one study")
        dims = {sp.dim for sp in spaces}
        if len(dims) != 1:
            raise ValueError(
                f"all studies must share one dimensionality, got {dims} "
                "(the stacked (S, n_max, d) buffers are rectangular)")
        names = list(names) if names is not None else [
            f"study{i}" for i in range(len(spaces))]
        if len(names) != len(spaces):
            raise ValueError("len(names) != len(spaces)")
        self.cfg = cfg
        descs = [sp.descriptor() for sp in spaces] \
            if cfg.mixed or any(sp.has_discrete for sp in spaces) else None
        self.engine = StudyEngine(spaces[0].dim, cfg, len(spaces),
                                  descs=descs, device=device,
                                  devices=devices)
        self.studies = [
            StudyHandle(i, sp, names[i], gen=_new_gen(cfg.seed + i),
                        rng=np.random.default_rng(cfg.seed + i))
            for i, sp in enumerate(spaces)]
        self._lo = torch.zeros((self.dim,), dtype=torch.float32)
        self._hi = torch.ones((self.dim,), dtype=torch.float32)
        self._done_at_last_ckpt = 0
        self._n_done = 0  # absorptions ever (checkpoint cadence + step)
        self.last_restore_meta: dict | None = None  # set by restore()
        # Fantasy protocol (DESIGN.md §12): per-slot pending fantasy points
        # in append order; a slot's model n exceeds its real ledger by
        # exactly len(self._fantasies[slot]).  Every real absorb first
        # rolls the fantasy rows back (bitwise), then replays the survivors.
        self._fantasies: list[list[np.ndarray]] = [[] for _ in spaces]
        self.fantasy_rollbacks = 0

    @property
    def n_studies(self) -> int:
        return len(self.studies)

    @property
    def dim(self) -> int:
        return self.engine.dim

    # -- ledger -------------------------------------------------------------
    def _make_trial(self, study_id: int, unit: np.ndarray) -> Trial:
        h = self.studies[study_id]
        unit = np.asarray(unit, np.float32)
        tr = Trial(h.next_id, unit, h.space.to_hparams(unit))
        h.next_id += 1
        h.trials.append(tr)
        return tr

    def state(self, study_id: int) -> gp_mod.LazyGPState:
        """Unstacked single-study GP snapshot."""
        return self.engine.study_state(study_id)

    # -- random streams ------------------------------------------------------
    def _draw(self, study_id: int, top_t: int) -> tuple[torch.Tensor,
                                                        torch.Tensor]:
        """One suggest's draws from the study's own generator: restart
        seeds (R, d), then the top-t jitter (top_t, d), on the host."""
        gen = self.studies[study_id].gen
        return (acq_mod.draw_seeds(self._lo, self._hi,
                                   self.cfg.acq.restarts, gen),
                acq_mod.draw_jitter(self._lo, top_t, gen))

    def _draw_q(self, study_id: int, q: int) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
        """A q-ask's draws: q suggests' draws in turn, (q, R, d) and
        (q, 1, d)."""
        draws = [self._draw(study_id, 1) for _ in range(q)]
        return tuple(torch.stack(d) for d in zip(*draws))

    def _staged_draws(self, ei_ids: Sequence[int], top_t: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """(S, R, d) seeds and (S, top_t, d) jitter: fresh draws for
        `ei_ids` (their streams advance), fixed dummy rows for the others
        (their lanes compute alongside and the result is dropped)."""
        seeds = torch.zeros((self.n_studies, self.cfg.acq.restarts,
                             self.dim))
        jitter = torch.zeros((self.n_studies, top_t, self.dim))
        for s in ei_ids:
            seeds[s], jitter[s] = self._draw(s, top_t)
        return seeds, jitter

    def _nb_params(self, study_id: int) -> dict[str, torch.Tensor]:
        """A promotion's initial MLP, drawn as `nb_init` draws it, from the
        study's generator."""
        st = nb_mod.nb_init(self.dim, 1, self.cfg.neural,
                            generator=self.studies[study_id].gen,
                            device="cpu")
        return {k: getattr(st, k) for k in nb_mod.PARAMS}

    # -- saturation escalation (DESIGN.md §15) ------------------------------
    def tier(self, study_id: int) -> int:
        """0 = lazy GP, 1 = neural basis (escalated past n_max)."""
        return self.engine.tier(study_id)

    def promote(self, study_id: int) -> None:
        """Escalate a saturated study to the neural-basis tier.

        Pending fantasy rows are rolled back first (bitwise truncate), so
        the tier trains on the real ledger and tell costs only; the
        survivors are then replayed against the escalated posterior."""
        pend = self._fantasies[study_id]
        if pend:
            self.engine.truncate_slot(
                study_id, self.engine.n(study_id) - len(pend))
            self.fantasy_rollbacks += 1
        self.engine.promote_slot(study_id, params=self._nb_params(study_id))
        if pend:
            self.engine.nb_refantasize(study_id, np.stack(pend))

    # -- suggest ------------------------------------------------------------
    def seed_trials(self, study_id: int, n: int) -> list[Trial]:
        h = self.studies[study_id]
        return [self._make_trial(study_id, u)
                for u in h.space.sample(h.rng, n)]

    def suggest(self, study_id: int, t: int | None = None) -> list[Trial]:
        """Top-t distinct EI local maxima from one study's posterior."""
        t = t or self.cfg.parallel
        if self.engine.tier(study_id):
            seeds, jitter = self._draw(study_id, t)
            units, _ = self.engine.nb_suggest(study_id, t, seeds=seeds,
                                              jitter=jitter)
        elif self.engine.n(study_id) == 0:
            return self.seed_trials(study_id, t)
        else:
            seeds, jitter = self._draw(study_id, t)
            units, _ = self.engine.suggest(study_id, t, seeds=seeds,
                                           jitter=jitter)
        return [self._make_trial(study_id, u) for u in _materialize(units)]

    # -- fantasy protocol: q-suggestion (DESIGN.md §12) ---------------------
    def fantasy_active(self, study_id: int) -> int:
        """Pending fantasy rows currently appended to this slot."""
        return len(self._fantasies[study_id])

    def n_real(self, study_id: int) -> int:
        """Real-ledger active count (model n minus pending fantasy rows)."""
        n = self.engine.nb_n(study_id) if self.engine.tier(study_id) \
            else self.engine.n(study_id)
        return n - len(self._fantasies[study_id])

    def ask_q(self, study_id: int, q: int) -> list[Trial]:
        """q distinct suggestions through the fantasy path (engine
        `ask_q`): q rounds of suggest-then-fantasize, whose fantasy rows
        stay in the slot (later asks see the collapsed variance) until a
        real observation arrives and the absorb paths roll them back.
        Studies with no observation get q seed trials instead."""
        if q < 1:
            raise ValueError(f"q must be >= 1, got {q}")
        if self.engine.tier(study_id):
            # escalated: the ledger doubles instead of filling
            seeds, jitter = self._draw_q(study_id, q)
            units, _ = self.engine.nb_ask_q(study_id, q, seeds=seeds,
                                            jitter=jitter)
        else:
            if self.engine.n(study_id) == 0:
                return self.seed_trials(study_id, q)
            gp_mod.ensure_capacity(self.engine.n(study_id),
                                   self.cfg.n_max, q)
            seeds, jitter = self._draw_q(study_id, q)
            units, _ = self.engine.ask_q(study_id, q, seeds=seeds,
                                         jitter=jitter)
        units = _materialize(units)
        self._fantasies[study_id].extend(u.copy() for u in units)
        return [self._make_trial(study_id, u) for u in units]

    def _rollback_for_events(
            self, events: Sequence[tuple[int, Trial, float]]) -> None:
        """Truncate every fantasy-active study named in `events` back to
        its real ledger (bitwise, `engine.truncate_slot`), dropping each
        told trial's point from the study's pending list.  Told points that
        were never fantasies (plain suggestions, foreign tells) roll back
        too: a real append never lands on fantasy rows."""
        by_sid: dict[int, list[Trial]] = {}
        for sid, tr, _ in events:
            by_sid.setdefault(sid, []).append(tr)
        for sid, trs in by_sid.items():
            pend = self._fantasies[sid]
            if not pend:
                continue
            if self.engine.tier(sid):
                # the tier's rank-1 updates do not reverse bit for bit: the
                # rollback restores its pre-fantasy snapshot
                self.engine.nb_rollback(sid)
            else:
                self.engine.truncate_slot(sid,
                                          self.engine.n(sid) - len(pend))
            self.fantasy_rollbacks += 1
            for tr in trs:
                for i, u in enumerate(pend):
                    if np.array_equal(u, tr.unit):
                        del pend[i]
                        break

    def release_fantasies(self, study_id: int, units) -> int:
        """Drop abandoned fantasy rows (asks whose tell will never come):
        one bitwise truncate and one replay of the survivors.  Each unit
        releases at most one pending row; unknown units are ignored.
        Returns the number of rows released."""
        pend = self._fantasies[study_id]
        if not pend:
            return 0
        drop: list[int] = []
        for u in units:
            for i, p in enumerate(pend):
                if i not in drop and np.array_equal(p, u):
                    drop.append(i)
                    break
        if not drop:
            return 0
        if self.engine.tier(study_id):
            self.engine.nb_rollback(study_id)
        else:
            self.engine.truncate_slot(
                study_id, self.engine.n(study_id) - len(pend))
        self.fantasy_rollbacks += 1
        self._fantasies[study_id] = [
            p for i, p in enumerate(pend) if i not in drop]
        self._refantasize_pending([study_id])
        return len(drop)

    def _refantasize_pending(self, sids) -> None:
        """Append each study's surviving fantasy points again in one
        replay (liar values against the updated real posterior)."""
        for sid in sorted(set(sids)):
            pend = self._fantasies[sid]
            if pend:
                if self.engine.tier(sid):
                    self.engine.nb_refantasize(sid, np.stack(pend))
                else:
                    self.engine.refantasize(sid, np.stack(pend))

    def _check_capacity(self,
                        events: Sequence[tuple[int, Trial, float]]) -> None:
        """All-or-nothing capacity: the whole queue (per-study multiplicity
        included) is checked before any ledger changes, so a full study
        never leaves a neighbor's trial "done" without its observation.
        Surviving fantasy rows count too (they are appended again after the
        absorb); callers run the rollback first, so `engine.n` is real."""
        counts: dict[int, int] = {}
        for sid, _, _ in events:
            counts[sid] = counts.get(sid, 0) + 1
        for sid, c in counts.items():
            if self.engine.tier(sid):
                continue   # escalated ledgers double instead of filling
            gp_mod.ensure_capacity(self.engine.n(sid), self.cfg.n_max,
                                   incoming=c + len(self._fantasies[sid]))

    def suggest_all(self, t: int = 1,
                    studies: Sequence[int] | None = None
                    ) -> dict[int, list[Trial]]:
        """Batched suggestion round, one ascent for all studies.  Studies
        with no observation get seed trials instead; escalated ones their
        tier's suggestion.  Returns {study_id: [t trials]} for `studies`
        (default all)."""
        ids = list(studies) if studies is not None else \
            list(range(self.n_studies))
        nb_set = {s for s in ids if self.engine.tier(s)}
        need_ei = sorted(s for s in ids
                         if s not in nb_set and self.engine.n(s) > 0)
        ei_set = set(need_ei)
        units_all = None
        if need_ei:
            seeds, jitter = self._staged_draws(need_ei, t)
            units_all = _materialize(self.engine.suggest_all(
                t, seeds=seeds, jitter=jitter)[0])
        out: dict[int, list[Trial]] = {}
        for s in ids:
            if s in ei_set:
                out[s] = [self._make_trial(s, u) for u in units_all[s]]
            elif s in nb_set:
                seeds, jitter = self._draw(s, t)
                units, _ = self.engine.nb_suggest(s, t, seeds=seeds,
                                                  jitter=jitter)
                out[s] = [self._make_trial(s, u) for u in _materialize(units)]
            else:
                out[s] = self.seed_trials(s, t)
        return out

    def _nb_stage(self, ids, nb_set, t) -> dict:
        """The escalated tenants' suggestions of a staged round (left on
        the device until `finish`)."""
        out = {}
        for s in ids:
            if s in nb_set:
                seeds, jitter = self._draw(s, t)
                out[s] = self.engine.nb_suggest(s, t, seeds=seeds,
                                                jitter=jitter)[0]
        return out

    def advance_round_begin(self,
                            events: Sequence[tuple[int, Trial, float]],
                            t: int = 1,
                            studies: Sequence[int] | None = None
                            ) -> _PendingRound:
        """Stage a serving round: queue every launch, defer the commits.

        Queues the round's launches (fantasy rollback, overflow drain, the
        engine's advance, replay) in the serial order and returns a
        `_PendingRound` whose `finish()` does the host half.  The guards
        run here: a capacity error raises with no ledger or buffer changed
        (beyond the fantasy rollback, which the replay restores).  Nothing
        is read back from the card here unless a lag event is due, an
        overflow is drained or fantasy rows are replayed: capacity and lag
        come from the engine's host mirrors, and the clamp counts are
        copied into a fresh tensor that `finish()` reads.
        """
        ids = list(studies) if studies is not None else \
            list(range(self.n_studies))
        nb_set = {s for s in range(self.n_studies) if self.engine.tier(s)}
        if not events:
            # a deferred suggest_all: the same draws and seed routing
            need_ei = sorted(s for s in ids
                             if s not in nb_set and self.engine.n(s) > 0)
            units = None
            if need_ei:
                seeds, jitter = self._staged_draws(need_ei, t)
                units = self.engine.suggest_all(t, seeds=seeds,
                                                jitter=jitter)[0]
            nb_units = self._nb_stage(ids, nb_set, t)
            out = _to_host({"units": units, **nb_units})
            return _PendingRound(self, {}, ids,
                                 set(ids) - set(need_ei) - nb_set,
                                 t, out.pop("units"), None, out)
        if not ids:
            self.absorb_many(events)
            return _PendingRound(self, {}, [], set(), t, None, None)
        # Escalated tenants' completions take the routed tier absorb; the
        # GP-tier events keep the one-per-study round split.
        nb_events = [e for e in events if e[0] in nb_set]
        gp_events = [e for e in events if e[0] not in nb_set]
        first: dict[int, tuple[Trial, float]] = {}
        overflow = []
        for sid, tr, val in gp_events:
            if sid in first:
                overflow.append((sid, tr, val))
            else:
                first[sid] = (tr, val)
        # Fantasy rollback before the capacity check and any absorb: told
        # studies are truncated to their real ledger (bitwise), so every
        # append lands where a never-fantasized run puts it; survivors are
        # replayed after the round.
        self._rollback_for_events(events)
        self._check_capacity(events)
        if nb_events:
            self.absorb_many(nb_events, _fantasies_handled=True)
        if overflow:
            self.absorb_many(overflow, _fantasies_handled=True)
        flags = np.zeros((self.n_studies,), bool)
        xs = np.zeros((self.n_studies, self.dim), np.float32)
        ys = np.zeros((self.n_studies,), np.float32)
        costs = np.ones((self.n_studies,), np.float32)
        for sid, (tr, val) in first.items():
            flags[sid] = True
            xs[sid] = tr.unit
            ys[sid] = float(val)
            costs[sid] = tr.cost
        # Studies still empty after this absorb get seed trials; only the
        # requested non-seed studies advance their streams.
        need_seed = {s for s in ids if s not in nb_set
                     and self.engine.n(s) == 0 and not flags[s]}
        ei_ids = [s for s in ids if s not in need_seed and s not in nb_set]
        seeds, jitter = self._staged_draws(ei_ids, t)
        units, _ = self.engine.advance(flags, xs, ys, top_t=t, costs=costs,
                                       seeds=seeds, jitter=jitter)
        # The clamp counts, copied into a fresh tensor before the replay:
        # later rounds write the state's own tensor in place.
        clamps = self.engine.clamp_count_tensor()
        nb_units = self._nb_stage(ids, nb_set, t)
        self._refantasize_pending(sid for sid, _, _ in events)
        out = _to_host({"units": units, "clamps": clamps, **nb_units})
        return _PendingRound(self, first, ids, need_seed, t,
                             out.pop("units"), out.pop("clamps"), out)

    def advance_round(self, events: Sequence[tuple[int, Trial, float]],
                      t: int = 1,
                      studies: Sequence[int] | None = None
                      ) -> dict[int, list[Trial]]:
        """Serving round: absorb at most one completion per study and
        suggest the next t points from the updated posteriors, in one
        `engine.advance`.  Suggestions are minted as ledger trials only for
        `studies` (default all).  Events beyond one per study drain through
        `absorb_many` first; studies still empty after the absorb get seed
        trials, as in `suggest_all`.  A round with nothing to absorb is a
        `suggest_all`; a round with nobody to suggest for an
        `absorb_many`.  It is `advance_round_begin(...).finish()`."""
        return self.advance_round_begin(events, t=t, studies=studies).finish()

    # -- absorb -------------------------------------------------------------
    def absorb(self, study_id: int, trial: Trial, value: float,
               cost: float | None = None) -> None:
        """Completion-order absorb routed to the owning study."""
        if cost is not None:
            trial.cost = float(cost)
        self._rollback_for_events([(study_id, trial, value)])
        if self.engine.tier(study_id):
            self.engine.nb_absorb(study_id, trial.unit, float(value),
                                  cost=trial.cost)
        else:
            gp_mod.ensure_capacity(
                self.engine.n(study_id), self.cfg.n_max,
                incoming=1 + len(self._fantasies[study_id]))
            self.engine.absorb(study_id, trial.unit, float(value),
                               cost=trial.cost)
        # "done" only once the append is in: callers (the gateway's fault
        # unwind) read it as "in the GP"
        trial.status = "done"
        trial.value = float(value)
        trial.finished = time.time()
        trial.clamp_count = self.engine.clamp_count(study_id)
        self._refantasize_pending([study_id])
        self._n_done += 1
        self._maybe_checkpoint()

    def absorb_many(self,
                    events: Sequence[tuple[int, Trial, float]],
                    _fantasies_handled: bool = False) -> None:
        """Drain a completion queue in masked batched rounds.

        Events may come in any order and multiplicity; each round takes at
        most one event per study (`engine.absorb_round`), so k completions
        across S studies cost ceil(max per-study count) rounds, and the
        clamp counts are read once a round.  `_fantasies_handled` is the
        `advance_round` overflow path: the caller already rolled the
        fantasy rows back and replays them after its own round."""
        queue = list(events)
        if not _fantasies_handled:
            self._rollback_for_events(queue)
        self._check_capacity(queue)
        # Escalated tenants drain through the routed tier absorb.
        nb_queue = [e for e in queue if self.engine.tier(e[0])]
        queue = [e for e in queue if not self.engine.tier(e[0])]
        for sid, tr, val in nb_queue:
            self.engine.nb_absorb(sid, tr.unit, float(val), cost=tr.cost)
            tr.status = "done"
            tr.value = float(val)
            tr.finished = time.time()
            tr.clamp_count = self.engine.clamp_count(sid)
            self._n_done += 1
        while queue:
            round_events: dict[int, tuple[Trial, float]] = {}
            rest = []
            for sid, tr, val in queue:
                if sid in round_events:
                    rest.append((sid, tr, val))
                else:
                    round_events[sid] = (tr, val)
            queue = rest
            flags = np.zeros((self.n_studies,), bool)
            xs = np.zeros((self.n_studies, self.dim), np.float32)
            ys = np.zeros((self.n_studies,), np.float32)
            costs = np.ones((self.n_studies,), np.float32)
            for sid, (tr, val) in round_events.items():
                flags[sid] = True
                xs[sid] = tr.unit
                ys[sid] = float(val)
                costs[sid] = tr.cost
            self.engine.absorb_round(flags, xs, ys, costs)
            clamps = self.engine.clamp_counts()   # one transfer for all S
            for sid, (tr, val) in round_events.items():
                tr.status = "done"
                tr.value = float(val)
                tr.finished = time.time()
                tr.clamp_count = int(clamps[sid])
            self._n_done += len(round_events)
        if not _fantasies_handled:
            self._refantasize_pending(sid for sid, _, _ in events)
        self._maybe_checkpoint()

    def record_failure(self, study_id: int, trial: Trial,
                       error: str) -> Trial | None:
        """Failed trial: retry (fresh suggestion) or penalize the region."""
        trial.status = "failed"
        trial.error = error
        trial.finished = time.time()
        if self.cfg.failure_penalty is not None:
            # A pseudo-observation keeps EI away from a crashing region.
            self._rollback_for_events([(study_id, trial, 0.0)])
            if self.engine.tier(study_id):
                self.engine.nb_absorb(study_id, trial.unit,
                                      float(self.cfg.failure_penalty),
                                      cost=trial.cost)
            else:
                gp_mod.ensure_capacity(
                    self.engine.n(study_id), self.cfg.n_max,
                    incoming=1 + len(self._fantasies[study_id]))
                self.engine.absorb(study_id, trial.unit,
                                   float(self.cfg.failure_penalty),
                                   cost=trial.cost)
            trial.clamp_count = self.engine.clamp_count(study_id)
            self._refantasize_pending([study_id])
        elif any(np.array_equal(u, trial.unit)
                 for u in self._fantasies[study_id]):
            # No pseudo-observation lands, but the failed trial's fantasy
            # row is released: truncate, then replay the survivors.
            self._rollback_for_events([(study_id, trial, 0.0)])
            self._refantasize_pending([study_id])
        if trial.retries < self.cfg.max_retries:
            nxt = self.suggest(study_id, 1)[0]
            nxt.retries = trial.retries + 1
            return nxt
        return None

    # -- inspection ---------------------------------------------------------
    def best(self, study_id: int) -> Trial | None:
        done = [t for t in self.studies[study_id].trials
                if t.status == "done"]
        return max(done, key=lambda t: t.value) if done else None

    def history(self, study_id: int) -> list[dict]:
        return [dataclasses.asdict(t) | {"unit": t.unit.tolist()}
                for t in self.studies[study_id].trials]

    def total_done(self) -> int:
        return sum(t.status == "done"
                   for h in self.studies for t in h.trials)

    # -- slot lifecycle (the gateway's evict / restore / reuse hooks, §9) ---
    def export_study(self, slot: int) -> dict:
        """Host-side snapshot of one slot: its GP state as numpy leaves
        under the reference's names, and the handle's metadata.  Round-trips
        through `import_study` (and `checkpoint.save_study`) bit for bit.
        A slot with fantasy rows out refuses: snapshots hold only real
        state (DESIGN.md §12).  Beside the generator's state the metadata
        holds a JAX `key` (`_gen_key`, no draw), which the reference's
        `import_study` reads."""
        if self._fantasies[slot]:
            raise RuntimeError(
                f"slot {slot} has {len(self._fantasies[slot])} active "
                "fantasy rows; eviction snapshots must see only real state "
                "(resolve or roll back the pending q-ask first)")
        h = self.studies[slot]
        tree = _numpy_tree(_state_tree(self.engine.study_state(slot)))
        meta = {"name": h.name, "next_id": h.next_id,
                "trials": self.history(slot),
                "key": _gen_key(h.gen),
                "rng_state": h.rng.bit_generator.state,
                TORCH_RNG_FIELD: _gen_state(h.gen),
                # the escalation tier (DESIGN.md §15): the tag, the per-row
                # tell costs and, for an escalated slot, its state
                "tier": self.engine.tier(slot),
                "costs": self.engine.cost_row(slot).tolist()}
        if self.engine.tier(slot):
            meta["nb"] = nb_mod.nb_to_json(self.engine.nb_state(slot))
        return {"tree": tree, "meta": meta}

    def import_study(self, slot: int, tree: dict, meta: dict,
                     space=None) -> None:
        """Load an exported study into `slot` (inverse of
        `export_study`).  The slot's EI generator takes the snapshot's
        `TORCH_RNG_FIELD` where it has one (a port export); else, as for a
        reference export, it is seeded from the JAX `key`, seed = k0 * 2^32
        + k1, so its stream depends on the study alone, never on the slot
        or the slot's previous tenant.  (`restore` keeps a slot's generator
        where a snapshot has no `TORCH_RNG_FIELD`.)"""
        dev = self.engine.device

        def t(a):
            return torch.as_tensor(np.array(a), device=dev)

        p = tree["params"]
        self.engine.load_slot(slot, gp_mod.LazyGPState(
            x_buf=t(tree["x_buf"]), y_buf=t(tree["y_buf"]),
            l_buf=t(tree["l_buf"]), li_buf=t(tree["li_buf"]),
            alpha=t(tree["alpha"]), n=int(tree["n"]),
            since_refit=int(tree["since_refit"]),
            clamp_count=t(tree["clamp_count"]).to(torch.int32),
            params=KernelParams(t(p["sigma2"]), t(p["rho"]),
                                t(p["noise2"]))))
        self.engine.clear_nb_slot(slot)
        if "costs" in meta:          # after the clear, which resets the row
            self.engine.set_cost_row(slot, meta["costs"])
        if meta.get("tier"):
            self.engine.load_nb_slot(slot, nb_mod.nb_from_json(
                meta["nb"], device=dev))
        self._fantasies[slot] = []   # snapshots hold only real state
        h = self.studies[slot]
        if space is not None:
            h.space = space
            if self.engine.mixed or space.has_discrete:
                self.engine.set_desc(slot, space.descriptor())
        h.name = meta["name"]
        h.next_id = int(meta["next_id"])
        if TORCH_RNG_FIELD in meta:
            _set_gen_state(h.gen, meta[TORCH_RNG_FIELD])
        else:
            h.gen = _new_gen(_key_seed(meta["key"]))
        h.rng = np.random.default_rng()
        h.rng.bit_generator.state = meta["rng_state"]
        h.trials = [_trial_from_dict(t) for t in meta["trials"]]

    def reset_study(self, slot: int, space=None, name: str | None = None,
                    seed: int | None = None) -> None:
        """Blank a slot for a new tenant: fresh GP state, ledger, streams.
        `seed` defaults to `cfg.seed + slot`."""
        if space is not None and space.dim != self.dim:
            raise ValueError(f"space dim {space.dim} != pool dim {self.dim}")
        self.engine.reset_slot(slot)
        self._fantasies[slot] = []
        h = self.studies[slot]
        seed = self.cfg.seed + slot if seed is None else seed
        if space is not None:
            h.space = space
            if self.engine.mixed or space.has_discrete:
                self.engine.set_desc(slot, space.descriptor())
        h.name = name if name is not None else f"study{slot}"
        h.trials = []
        h.next_id = 0
        h.gen = _new_gen(seed)
        h.rng = np.random.default_rng(seed)

    # -- checkpointing (the whole pool rides one atomic snapshot) -----------
    def _maybe_checkpoint(self) -> None:
        """Snapshot every `ckpt_every` absorptions (each snapshot writes
        the whole stacked state and every ledger)."""
        if not self.cfg.ckpt_dir:
            return
        if self._n_done - self._done_at_last_ckpt >= max(1, self.cfg.ckpt_every):
            self.checkpoint()

    def checkpoint(self, extra: dict | None = None) -> str | None:
        """Atomic whole-pool snapshot; `extra` metadata (JSON) rides along
        and comes back in `last_restore_meta`.  Snapshots see only real
        state: fantasy-active slots are truncated to their real ledger
        (bitwise) for the snapshot and replayed right after."""
        if not self.cfg.ckpt_dir:
            return None
        active = [s for s in range(self.n_studies) if self._fantasies[s]]
        for sid in active:
            if self.engine.tier(sid):
                self.engine.nb_rollback(sid)
            else:
                self.engine.truncate_slot(
                    sid, self.engine.n(sid) - len(self._fantasies[sid]))
            self.fantasy_rollbacks += 1
        self._done_at_last_ckpt = self._n_done
        meta = {
            "n_studies": self.n_studies,
            "studies": json.dumps([
                {"study_id": h.study_id, "name": h.name,
                 "next_id": h.next_id, "trials": self.history(h.study_id),
                 # the streams ride the snapshot, so a restored pool never
                 # draws again what it drew before the crash
                 "rng_state": h.rng.bit_generator.state,
                 TORCH_RNG_FIELD: _gen_state(h.gen)}
                for h in self.studies]),
            # the escalated tier rides as metadata: the store checks the
            # tree against the fixed GP layout
            "escalated": json.dumps({
                str(s): nb_mod.nb_to_json(self.engine.nb_state(s))
                for s in range(self.n_studies) if self.engine.tier(s)}),
            "cost_rows": json.dumps({
                str(s): self.engine.cost_row(s).tolist()
                for s in range(self.n_studies)}),
        }
        if extra:
            meta.update(extra)
        path = ckpt_mod.save(self.cfg.ckpt_dir, self._n_done,
                             _state_tree(self.engine.state), metadata=meta)
        self._refantasize_pending(active)
        return path

    def restore(self) -> bool:
        """Load the latest committed snapshot onto the pool's device (the
        engine's `state` setter re-places it onto the mesh and re-syncs
        its host mirrors); a JAX pool's
        snapshot loads too (its `key`s are ignored, the port's generators
        kept where it has none)."""
        if not self.cfg.ckpt_dir:
            return False
        out = ckpt_mod.restore_latest(self.cfg.ckpt_dir,
                                      _state_tree(self.engine.state))
        if out is None:
            return False
        step, tree, meta = out
        self.last_restore_meta = meta
        if int(meta.get("n_studies", -1)) != self.n_studies:
            raise ValueError(
                f"checkpoint holds {meta.get('n_studies')} studies, "
                f"pool has {self.n_studies}")
        dev = self.engine.device
        leaves = {k: v.to(dev) for k, v in tree.items() if k != "params"}
        p = {k: v.to(dev) for k, v in tree["params"].items()}
        self.engine.state = gp_mod.LazyGPState(
            **leaves, params=KernelParams(p["sigma2"], p["rho"],
                                          p["noise2"]))
        # Snapshots hold only real state; pending q-asks died with the
        # crash and are re-served upstream, so no fantasy rows survive.
        self._fantasies = [[] for _ in range(self.n_studies)]
        esc = json.loads(meta.get("escalated", "{}"))
        rows = json.loads(meta.get("cost_rows", "{}"))
        for s in range(self.n_studies):
            self.engine.clear_nb_slot(s)
            if str(s) in rows:
                self.engine.set_cost_row(s, rows[str(s)])
            if str(s) in esc:
                self.engine.load_nb_slot(s, nb_mod.nb_from_json(
                    esc[str(s)], device=dev))
        for rec in json.loads(meta["studies"]):
            h = self.studies[rec["study_id"]]
            h.name = rec["name"]
            h.next_id = int(rec["next_id"])
            if TORCH_RNG_FIELD in rec:
                _set_gen_state(h.gen, rec[TORCH_RNG_FIELD])
            if "rng_state" in rec:
                h.rng = np.random.default_rng()
                h.rng.bit_generator.state = rec["rng_state"]
            h.trials = [_trial_from_dict(t) for t in rec["trials"]]
        # The step counter resumes from the snapshot's own step, not from
        # total_done(): under a gateway, absorbs of evicted studies live in
        # per-study snapshots, so total_done() under-counts and a later
        # checkpoint would land below the restored step.
        self._n_done = int(step)
        self._done_at_last_ckpt = self._n_done
        return True


def _state_tree(st: gp_mod.LazyGPState) -> dict:
    """The GP state as the reference checkpoints it (`dataclasses.asdict`:
    leaf names alpha, clamp_count, l_buf, li_buf, n, params/noise2,
    params/rho, params/sigma2, since_refit, x_buf, y_buf), built from the
    state's own tensors: nothing is copied."""
    p = st.params
    return {"x_buf": st.x_buf, "y_buf": st.y_buf, "l_buf": st.l_buf,
            "li_buf": st.li_buf, "alpha": st.alpha, "n": st.n,
            "since_refit": st.since_refit, "clamp_count": st.clamp_count,
            "params": {"sigma2": p.sigma2, "rho": p.rho, "noise2": p.noise2}}


def _numpy_tree(tree):
    """A state tree's leaves as numpy arrays (host counts as 0-d int32)."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree, np.int32)
