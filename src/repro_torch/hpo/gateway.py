"""Async ask–tell serving gateway: many concurrent clients, one fused
round (counterpart of `repro/hpo/gateway.py`).

`StudyGateway` is the traffic-facing layer of the stack (DESIGN.md §9): it
multiplexes an unbounded population of *logical* studies onto one
`StudyPool`/`StudyEngine` with a fixed number of resident *slots* in the
stacked `(S, …)` state.  Three mechanisms make that serve:

  * **coalescing tick** — concurrent `ask()`s (and queued `tell()`s) are
    gathered for a configurable window and served by ONE fused
    `pool.advance_round`: the masked absorb of every queued completion and
    the batched EI suggest for every asking study, one fused-EI launch an
    ascent step for all slots, not one round per caller.  Batched
    `ask(sid, q=N)` requests coalesce with the same tick: each is served
    by one q-suggestion call (`pool.ask_q`, the fantasy path of DESIGN.md
    §12) right after the round's absorbs.  Fantasy rows pin their study
    resident until every suggestion is told back (rollback is exact, but
    eviction snapshots must see only real observations).
  * **slot lifecycle** — `create_study` registers a logical study without
    claiming a slot; the first `ask` allocates one (free-list).  When slots
    run out, the least-recently-used *idle* resident study (nothing in
    flight, nothing queued) is evicted to a per-study partial snapshot
    (`checkpoint.save_study`) and transparently restored on its next `ask`
    — the pool serves more logical studies than resident slots.  Eviction
    is exact: the slot swap copies a lane bit for bit and the lanes are
    independent, so an evicted-and-restored study produces bitwise-
    identical suggestions to one that stayed resident (test-enforced).
  * **admission control** — bounded ask queue, per-study in-flight caps,
    and a capacity-aware reject: an `ask` whose eventual `tell` could not
    fit the study's `(n_max, …)` buffers is refused up front with
    `GPCapacityError` (the same error the absorb path raises), never after
    the client has already trained a model.

`tell` routes through the masked-absorb path (`advance_round` /
`absorb_many`), so the all-or-nothing capacity contract and the per-study
random streams carry over unchanged; each study's streams are seeded by
its *logical* id (`reset_study(seed=)`) and ride its eviction snapshot, so
what a tenant is suggested never depends on which slot it lands in.

The gateway is asyncio-native and single-threaded: `ask` is a coroutine,
`tell` a plain enqueue, and one background ticker task drives the rounds.
Synchronous callers (tests, benchmarks) can instead call `tick()` directly
for deterministic control.  Telemetry per tick (coalesce width, queue
depth, latency, evictions) accumulates in `gateway.stats`.

Pipelined ticks (DESIGN.md §13) on the card: `tick_begin` queues round
t+1's launches on the current stream behind round t's, then finishes round
t, which waits on round t's own event (`pool.advance_round_begin`), so the
host commits t while t+1 runs.  One stream: a second one would reorder the
rounds' in-place writes to `engine.state`.  The gateway runs on the card
unless `device` says otherwise; its registry, eviction snapshots and
checkpoints use the reference's format, so either package's gateway
restores the other's.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import time
from collections import deque
from typing import Sequence

import numpy as np

import torch

from repro_torch import checkpoint as ckpt_mod
from repro_torch.core import gp as gp_mod
from repro_torch.core.gp import (BackpressureError, GPCapacityError,
                                 StudySaturatedError)
from repro_torch.hpo import pool as pool_mod
from repro_torch.hpo.pool import SchedulerConfig, StudyPool, Trial
from repro_torch.hpo.space import (SearchSpace, space_from_dicts,
                                   space_to_dicts)

__all__ = ["GatewayConfig", "StudyGateway"]


@dataclasses.dataclass(frozen=True)
class GatewayConfig:
    """Serving-layer knobs (the GP/pool shape comes from SchedulerConfig)."""

    slots: int = 8            # resident studies (the stacked S axis)
    coalesce_ms: float = 0.0  # tick gathering window; 0 = one event-loop
    # yield (everything already enqueued by runnable clients coalesces)
    max_batch: int = 0        # asks served per tick (0 = no cap)
    max_queue: int = 1024     # queued asks across all studies (admission)
    max_inflight: int = 4     # per-study suggestions outstanding (ask - tell)
    stats_window: int = 4096  # per-tick telemetry records retained
    ckpt_every_ticks: int = 0  # whole-gateway snapshot cadence (0 = only
    # explicit checkpoint() calls).  The pool's own per-absorb cadence is
    # disabled under a gateway: a bare pool snapshot has no gateway
    # registry and could shadow a restorable one.
    pipeline: bool = True     # double-buffer the ticker (DESIGN.md §13):
    # stage tick t+1's host-side gather/validation and queue its launches
    # while tick t's round is still running on the card, finishing t
    # afterwards.  Residency changes, q>1 asks, and checkpoints flush the
    # pipeline first (they read or rewrite state the staged round writes);
    # the launches are queued in the same order either way, so pipeline
    # on/off produce bitwise-identical pool state for the same traffic
    # trace (test-enforced).  Off = every tick is served start-to-finish
    # like the sync tick().
    escalate: bool = True     # saturation escalation (DESIGN.md §15): when
    # a study's lazy-GP slot fills (committed == n_max), promote it to the
    # neural-basis tier (MLP feature map + exact Bayesian linear head,
    # flat per-append cost) instead of rejecting every further ask with
    # StudySaturatedError.  Off = the pre-§15 terminal-capacity contract.


@dataclasses.dataclass
class _Logical:
    """Gateway-side record of one logical study (resident or evicted)."""

    sid: int
    name: str
    space: SearchSpace
    seed: int
    slot: int | None = None   # resident slot, None = evicted / never placed
    n_obs: int = 0            # absorbed observations (survives eviction)
    best_value: float | None = None  # max told value (residency-independent
    # — the resident ledger leaves with the study on eviction)
    inflight: int = 0         # suggestions handed out, not yet told back
    pending_asks: int = 0
    pending_tells: int = 0
    last_tick: int = 0        # LRU stamp
    version: int = 0          # eviction snapshot counter (monotonic)
    evicted_ever: bool = False
    tier: int = 0             # 0 = lazy GP, 1 = neural basis (escalated
    # past n_max, DESIGN.md §15).  Mirrors the pool/engine tier tag but
    # survives eviction: the NB state itself rides the study's partial
    # snapshot metadata.


@dataclasses.dataclass
class _PendingTick:
    """A staged-but-unfinished coalesced tick (pipelined serving, §13).

    Holds everything `_tick_finish` needs to commit the round once the
    round's launches have run on the card: the popped queues, the slot
    placements, and the pool's pending round handle.
    """

    round: object                 # pool._PendingRound
    tells: list                   # (sid, Trial, value) popped this tick
    take: list                    # (sid, fut, q) being served this tick
    events: list                  # (slot, Trial, value) placed tells
    ask_slots: dict               # sid -> slot
    deferred: int                 # asks that could not place (requeued)
    t0: float
    evictions: int
    restores: int

    @property
    def size(self) -> int:
        return len(self.take) + len(self.events)


class StudyGateway:
    """Asynchronous ask–tell front end over one multi-tenant StudyPool."""

    def __init__(self, template_space: SearchSpace, cfg: SchedulerConfig,
                 gw: GatewayConfig | None = None, *,
                 device: str | torch.device = "cuda"):
        self.gw = gw or GatewayConfig()
        if self.gw.slots < 1:
            raise ValueError("GatewayConfig.slots must be >= 1")
        if cfg.ckpt_dir is None:
            # Eviction needs somewhere to put the partial snapshots; the
            # whole-pool cadence can still be disabled via ckpt_every.
            raise ValueError(
                "StudyGateway needs SchedulerConfig.ckpt_dir (the eviction "
                "store for per-study partial snapshots)")
        self.cfg = cfg
        self._template_space = template_space  # default for create_study;
        # slot 0's handle can't serve as the template — reset/import
        # overwrite it with whatever tenant lands there
        # The pool's per-absorb snapshot cadence is disabled: its snapshots
        # would lack the gateway registry (see GatewayConfig.ckpt_every_ticks
        # for the gateway-level cadence).
        self.pool = StudyPool(
            [template_space] * self.gw.slots,
            dataclasses.replace(cfg, ckpt_every=10 ** 9), device=device)
        self._free: list[int] = list(range(self.gw.slots - 1, -1, -1))
        self._owner: list[int | None] = [None] * self.gw.slots
        self._studies: dict[int, _Logical] = {}
        self._closed_sids: set[int] = set()   # tombstones: closed studies
        # leave the registry (and, at the next checkpoint commit, the
        # eviction store) so tenant churn doesn't grow either unboundedly
        self._closed_gc: list[str] = []       # snapshot dirs to drop at
        # the next checkpoint COMMIT (never before — a crash must restore
        # a registry whose studies are all still on disk)
        self._next_sid = 0
        self._asks: deque[tuple[int, asyncio.Future | None, int]] = deque()
        self._tells: list[tuple[int, Trial, float]] = []
        self._tick_count = 0
        self.stats: deque[dict] = deque(maxlen=self.gw.stats_window)
        # lifetime counters: the stats deque is a WINDOW (stats_window
        # ticks) — run totals must not silently shrink past it.  The
        # q-width histogram maps str(q) -> asks served at that width
        # (string keys so it round-trips the JSON registry unchanged);
        # fantasy_rollbacks mirrors the pool's counter into a lifetime
        # total that survives checkpoint/restore.
        self._totals = {"asks_served": 0, "absorbed": 0,
                        "evictions": 0, "restores": 0,
                        "fantasy_rollbacks": 0, "q_width_hist": {}}
        self._pool_rollbacks_seen = 0
        self._wake: asyncio.Event | None = None
        self._tick_done: asyncio.Event | None = None  # pulsed per tick
        # attempt so drain() waiters re-check instead of busy-polling
        self._ticker: asyncio.Task | None = None
        self._closed = False
        self._restores_this_tick = 0
        self._evictions_this_tick = 0
        self._retry_absorb = False
        self._pending: _PendingTick | None = None  # at most ONE staged
        # tick in flight (depth-1 double buffering, DESIGN.md §13)
        # Tells that can never be absorbed (study at capacity) land here
        # instead of poisoning the queue forever; the trial records the
        # error.
        self.dead_tells: list[tuple[int, Trial, float]] = []

    # -- lifecycle ----------------------------------------------------------
    def create_study(self, space: SearchSpace | None = None,
                     name: str | None = None, sid: int | None = None) -> int:
        """Register a logical study; no slot is claimed until its first ask.

        Random streams are seeded `cfg.seed + logical_id`, so two gateways
        with the same creation order serve identical suggestion streams
        regardless of slot churn.  A federation front end passes an
        explicit `sid` from its GLOBAL id space (DESIGN.md §13): shards
        then seed by global identity, so WHERE a study is routed never
        changes WHAT it is suggested — the single-pool-equivalence
        contract.  Explicit sids must be fresh (never used or closed on
        this shard).
        """
        space = space if space is not None else self._template_space
        if space.dim != self.pool.engine.gp_cfg.dim:
            raise ValueError(
                f"space dim {space.dim} != gateway dim "
                f"{self.pool.engine.gp_cfg.dim} (the stacked buffers are "
                "rectangular)")
        if space.has_discrete and not self.pool.engine.mixed:
            raise ValueError(
                "space has int/categorical dims but the gateway was built "
                "without mixed-space closures; construct it with a mixed "
                "template space or SchedulerConfig(mixed=True)")
        if sid is None:
            sid = self._next_sid
        elif sid in self._studies or sid in self._closed_sids:
            raise ValueError(f"study id {sid} already used on this gateway")
        self._next_sid = max(self._next_sid, sid + 1)
        self._studies[sid] = _Logical(
            sid, name if name is not None else f"study{sid}", space,
            seed=self.cfg.seed + sid)
        return sid

    def close_study(self, sid: int) -> None:
        """Release a study's slot and drop it from the registry.  Refuses
        while work is in flight.  Its snapshots are deleted at the next
        checkpoint commit (not before: a crash must restore a registry
        whose studies are all still on disk)."""
        log = self._require(sid)
        if log.inflight or log.pending_asks or log.pending_tells:
            raise RuntimeError(
                f"study {sid} has work in flight "
                f"(inflight={log.inflight}, asks={log.pending_asks}, "
                f"tells={log.pending_tells}); tell or drain first")
        if log.slot is not None:
            self._owner[log.slot] = None
            self._free.append(log.slot)
            log.slot = None
        self._closed_sids.add(sid)
        if log.evicted_ever:
            self._closed_gc.append(self._study_key(log))
        del self._studies[sid]
        if self._wake is not None:
            self._wake.set()  # the freed slot may unblock a deferred ask

    def _require(self, sid: int) -> _Logical:
        if sid in self._closed_sids:
            raise RuntimeError(f"study {sid} is closed")
        log = self._studies.get(sid)
        if log is None:
            raise KeyError(f"unknown study id {sid}")
        return log

    # -- admission control --------------------------------------------------
    def _admit_ask(self, log: _Logical, q: int = 1) -> None:
        if self._closed:
            raise RuntimeError("gateway is shut down")
        if q < 1:
            raise ValueError(f"ask q must be >= 1, got {q}")
        if q > self.gw.max_inflight:
            # Reject the impossible width HERE, loudly: queueing it would
            # hand the client a future that can never be woken (the
            # in-flight budget can't clear below zero to make room).
            raise GPCapacityError(
                f"ask(q={q}) exceeds the per-study in-flight cap "
                f"max_inflight={self.gw.max_inflight}: such an ask could "
                "never be served; lower q or raise "
                "GatewayConfig.max_inflight")
        if len(self._asks) >= self.gw.max_queue:
            raise BackpressureError(
                f"gateway ask queue full ({self.gw.max_queue} queued); "
                "backpressure — retry after the next tick")
        if log.inflight + log.pending_asks + q > self.gw.max_inflight:
            raise BackpressureError(
                f"study {log.sid} ({log.name}): ask(q={q}) with "
                f"{log.inflight + log.pending_asks} suggestions already "
                f"in flight exceeds max_inflight={self.gw.max_inflight}; "
                "tell() results back before asking again")
        # Capacity-aware reject: every outstanding suggestion implies a
        # future observation (a q-ask implies q of them, each shadowed by
        # a fantasy row until told).  Refuse the ask now rather than fail
        # the tell after the client has spent a training run on it.
        # Escalated studies (and, with `escalate` on, studies that WILL be
        # promoted when this ask is served — see `_needs_escalation`) have
        # no n_max: the NB ledger doubles instead of filling.  Promotion
        # needs at least one real observation to train on, so a study that
        # never absorbed anything keeps the terminal contract.
        if log.tier:
            return
        committed = (log.n_obs + log.inflight + log.pending_asks
                     + log.pending_tells)
        if committed + q > self.cfg.n_max and not (
                self.gw.escalate and log.n_obs > 0):
            raise StudySaturatedError(
                f"study {log.sid} ({log.name}): n={log.n_obs} absorbed + "
                f"{committed - log.n_obs} outstanding + q={q} would exceed "
                f"n_max={self.cfg.n_max}")

    # -- ask / tell ---------------------------------------------------------
    async def ask(self, sid: int, q: int = 1) -> Trial | list[Trial]:
        """Request suggestions; resolves at the next coalesced tick.

        `q=1` (the default) returns one Trial.  `q>1` returns a list of q
        jointly-diverse Trials from ONE q-suggestion call: each
        suggestion is made against a posterior that pretends the previous
        ones were already observed (constant/believer liar per
        `SchedulerConfig.fantasy`), so the batch spreads instead of
        stacking q copies of the same argmax.  The fantasy rows roll back
        bitwise-exactly as the real tells arrive."""
        log = self._require(sid)
        self._admit_ask(log, q)
        loop = asyncio.get_running_loop()
        self._ensure_ticker(loop)
        fut: asyncio.Future = loop.create_future()
        self._asks.append((sid, fut, q))
        log.pending_asks += q
        self._wake.set()
        return await fut

    def ask_nowait(self, sid: int, q: int = 1) -> None:
        """Queue an ask without a future (drive with `tick()`; the
        suggestions land in the study's ledger).  For sync callers/tests."""
        log = self._require(sid)
        self._admit_ask(log, q)
        self._asks.append((sid, None, q))
        log.pending_asks += q
        if self._wake is not None:
            self._wake.set()

    def _check_unit(self, trial: Trial, space: SearchSpace) -> None:
        """Validate a told trial's unit vector at the caller, not inside
        the fused round: a malformed unit raising mid-round would abort
        the whole coalesced tick for every study in it.  Mixed spaces also
        require the unit to sit on the study's feasible lattice (exact
        one-hots, ints on their grid) — an off-lattice row would teach the
        GP covariances no suggestion can ever reproduce."""
        unit = np.asarray(trial.unit)
        dim = self.pool.engine.gp_cfg.dim
        if unit.shape != (dim,):
            raise ValueError(
                f"trial unit shape {unit.shape} != ({dim},)")
        if not np.all(np.isfinite(unit)) or unit.min() < 0.0 \
                or unit.max() > 1.0:
            raise ValueError(
                f"trial unit must be finite in [0, 1]^{dim}, got {unit}")
        if space.has_discrete:
            repaired = space.project(unit)
            if not np.allclose(repaired, unit, atol=1e-5):
                raise ValueError(
                    f"trial unit {unit} is off the feasible lattice of its "
                    f"mixed space (round-and-repair gives {repaired}); "
                    "encode values with space.to_unit")

    def tell(self, sid: int, trial: Trial, value: float,
             cost: float = 1.0) -> None:
        """Report a result; absorbed by the next tick's fused round.

        `cost` (default 1.0) is the observation's evaluation cost (wall
        seconds, GPU-hours — any positive unit, consistent per study): it
        rides the trial into the ledger and trains the escalated tier's
        log-cost head, the denominator of EI-per-unit-cost acquisition
        (DESIGN.md §15).

        Rejected at the caller (never inside the fused round, where one bad
        input would abort the whole tick): wrong-dim units, non-finite
        values (report divergence via `tell_failure` instead — a NaN row
        would silently poison the posterior), and replays of a trial that
        already resolved (each suggestion takes exactly one tell)."""
        log = self._require(sid)
        if trial.status not in ("pending", "running"):
            raise RuntimeError(
                f"trial {trial.trial_id} of study {sid} was already told "
                f"({trial.status}); each suggestion takes exactly one tell")
        self._check_unit(trial, log.space)
        value = float(value)
        if not np.isfinite(value):
            raise ValueError(
                f"non-finite objective value {value!r}; report crashes "
                "and divergence via tell_failure()")
        cost = float(cost)
        if not np.isfinite(cost) or cost <= 0.0:
            raise ValueError(
                f"tell cost must be a positive finite number, got {cost!r}")
        trial.cost = cost
        # "told" blocks a same-window replay (the absorb flips it to
        # "done" once the append commits)
        trial.status = "told"
        self._tells.append((sid, trial, value))
        log.pending_tells += 1
        log.inflight = max(0, log.inflight - 1)
        if self._wake is not None:
            self._wake.set()

    def tell_failure(self, sid: int, trial: Trial, error: str) -> None:
        """Report a failed trial.  The ledger records the fault; with
        `cfg.failure_penalty` set, a penalty pseudo-observation is queued
        through the same coalesced absorb path (keeping EI away from the
        crashing region).  Retry policy is the client's: ask again."""
        log = self._require(sid)
        if self.cfg.failure_penalty is not None:
            self._check_unit(trial, log.space)
        trial.status = "failed"
        trial.error = error
        trial.finished = time.time()
        log.inflight = max(0, log.inflight - 1)
        if self.cfg.failure_penalty is None and log.slot is not None:
            # No penalty tell will ever come for this trial: if it was a
            # q-ask suggestion its fantasy row must be released now, or it
            # would pin the study non-evictable (and hold buffer capacity)
            # forever.  With a penalty configured, the penalty tell's
            # absorb performs the same rollback through the normal path.
            self.pool.release_fantasies(log.slot,
                                        [np.asarray(trial.unit)])
        if self.cfg.failure_penalty is not None:
            penalty = Trial(trial.trial_id, trial.unit, trial.hparams,
                            cost=trial.cost)
            # the error tag marks this as a pseudo-observation: it enters
            # the GP through the normal absorb path but must never be
            # reported as the study's best (failure_penalty=0.0 would beat
            # every genuine negative objective)
            penalty.error = f"failure penalty ({error})"
            self._tells.append((sid, penalty, self.cfg.failure_penalty))
            log.pending_tells += 1
        if self._wake is not None:
            # wake even without a penalty tell: the freed in-flight budget
            # may make this study evictable and unblock a deferred ask
            self._wake.set()

    # -- slot residency / eviction ------------------------------------------
    def _study_key(self, log: _Logical) -> str:
        return f"study{log.sid:06d}"

    def _evictable(self, log: _Logical) -> bool:
        # fantasy-pinned: pending fantasy rows mean suggestions are still
        # outstanding from a q-ask — export_study would refuse anyway
        # (snapshots must hold only real observations), so such a study
        # is never an eviction candidate
        return (log.slot is not None and not log.inflight
                and not log.pending_asks and not log.pending_tells
                and not self.pool.fantasy_active(log.slot))

    def _evict_lru(self) -> int:
        """Evict the least-recently-used *idle* resident study, returning
        its slot.  Studies with anything in flight or queued this tick are
        never candidates (their pending counters pin them resident)."""
        # scan the SLOT map, not the whole logical registry: candidates
        # are resident by definition, so this is O(slots) regardless of
        # how many logical studies have ever been created
        candidates = [self._studies[sid] for sid in self._owner
                      if sid is not None
                      and self._evictable(self._studies[sid])]
        if not candidates:
            raise GPCapacityError(
                f"all {self.gw.slots} slots are busy (studies with work in "
                "flight cannot be evicted); raise GatewayConfig.slots or "
                "tell() outstanding results back")
        victim = min(candidates, key=lambda l: (l.last_tick, l.sid))
        return self._evict(victim)

    def _evict(self, log: _Logical) -> int:
        """Snapshot one resident study to the eviction store, free its slot.

        The snapshot commits BEFORE any bookkeeping changes: a failed write
        raises with the study still resident and serving (and any prior
        committed snapshot still the restore target)."""
        slot = log.slot
        snap = self.pool.export_study(slot)
        ckpt_mod.save_study(self.cfg.ckpt_dir, self._study_key(log),
                            log.version + 1, snap["tree"],
                            metadata={"handle": json.dumps(snap["meta"]),
                                      "sid": log.sid, "n_obs": log.n_obs})
        log.version += 1
        log.slot = None
        log.evicted_ever = True
        self._owner[slot] = None
        # lifetime total counts here, not at tick commit: the snapshot is
        # a durable side effect even if the tick later aborts
        self._evictions_this_tick += 1
        self._totals["evictions"] += 1
        return slot

    def _ensure_resident(self, sid: int) -> int:
        """Give study `sid` a slot: free-list pop, else LRU eviction; then
        restore-on-demand from its latest partial snapshot (or a blank
        state if it never held one)."""
        log = self._require(sid)
        if log.slot is not None:
            return log.slot
        slot = self._free.pop() if self._free else self._evict_lru()
        if log.evicted_ever:
            # the template is the slot's own leaves, as views: restore reads
            # only their names, shapes and dtypes, so nothing is copied
            like = pool_mod._state_tree(gp_mod.unstack_state(
                self.pool.engine.state, slot, n=0, since_refit=0))
            # version-exact: after a crash/restore, snapshots NEWER than the
            # registry's version exist (written by the lost timeline) and
            # must not leak future state into the recovered one
            out = ckpt_mod.restore_study(self.cfg.ckpt_dir,
                                         self._study_key(log), like,
                                         version=log.version)
            if out is None:
                raise RuntimeError(
                    f"study {sid} was evicted but snapshot version "
                    f"{log.version} is not committed under "
                    f"{self.cfg.ckpt_dir}")
            _, tree, meta = out
            self.pool.import_study(slot, tree,
                                   json.loads(meta["handle"]),
                                   space=log.space)
            self._restores_this_tick += 1
            self._totals["restores"] += 1
        else:
            self.pool.reset_study(slot, space=log.space, name=log.name,
                                  seed=log.seed)
        log.slot = slot
        self._owner[slot] = sid
        return slot

    def _try_resident(self, sid: int) -> int | None:
        """Best-effort residency: None when every slot is pinned (the ask
        defers to a later tick instead of failing)."""
        try:
            return self._ensure_resident(sid)
        except GPCapacityError:
            return None

    # -- saturation escalation (DESIGN.md §15) ------------------------------
    def _needs_escalation(self, log: _Logical, q: int) -> bool:
        """True when serving a q-wide ask for this study could not fit its
        lazy-GP buffers: every absorbed row, outstanding suggestion (each
        shadowed by a fantasy row), and queued tell claims a row, and the
        ask adds q more."""
        return (self.gw.escalate and log.tier == 0 and log.n_obs > 0
                and (log.n_obs + log.inflight + log.pending_tells + q
                     > self.cfg.n_max))

    def _promote(self, log: _Logical) -> None:
        """Escalate a resident study to the neural-basis tier: the pool
        retrains the full real ledger (+ tell costs) into the NB model and
        re-fantasizes any outstanding q-ask rows against it.  The tier tag
        follows the study through eviction snapshots, checkpoints, and
        migration records."""
        self.pool.promote(log.slot)
        log.tier = 1

    # -- federation support (DESIGN.md §13/§14) -----------------------------
    # The federation front end (in-memory FederatedGateway or the socket
    # RPC TransportFederation) sees shards ONLY through this public
    # surface: quiescence, portable registry records, global-id sync, and
    # the migrate/adopt/detach/expel protocol.  Privates don't cross
    # process boundaries — anything the front end needs must live here.

    def is_quiescent(self, sid: int) -> bool:
        """True when the study exists and has NOTHING in motion: no
        suggestions outstanding, no queued asks or tells, no q-ask fantasy
        rows pinning its slot.  The public gate for migration/rebalance
        candidate scans (unknown or closed sids are simply not quiescent);
        `detach_study` and `export_for_migration` enforce the same
        predicate, so the in-memory and RPC paths can never drift."""
        log = self._studies.get(sid)
        if log is None:
            return False
        return (not log.inflight and not log.pending_asks
                and not log.pending_tells
                and not (log.slot is not None
                         and self.pool.fantasy_active(log.slot)))

    def registry_record(self, sid: int) -> dict:
        """Portable (JSON-safe) registry record of one study — the
        federation's fallback record and the migration manifest.  Pure
        read: unlike `export_for_migration` it neither quiesces nor
        evicts, so `record["version"]` only names a restorable snapshot
        when the study is non-resident (`evicted_ever` + not resident)."""
        log = self._require(sid)
        return {
            "sid": log.sid, "name": log.name, "seed": log.seed,
            "dims": space_to_dicts(log.space), "n_obs": log.n_obs,
            "best_value": log.best_value, "version": log.version,
            "evicted_ever": log.evicted_ever, "tier": log.tier,
            "key": self._study_key(log),
        }

    def sync_registry(self, next_sid: int | None = None,
                      closed_sids: Sequence[int] = ()) -> None:
        """Merge global-id bookkeeping pushed down by a federation front
        end: the global sid watermark (fresh-sid collisions with studies
        created elsewhere must be impossible) and globally closed sids
        (tombstones, so a stale shard can't resurrect a closed study)."""
        if next_sid is not None:
            self._next_sid = max(self._next_sid, int(next_sid))
        for sid in closed_sids:
            self._closed_sids.add(int(sid))

    def abandon(self) -> None:
        """Crash semantics WITHOUT a checkpoint (the in-memory analogue of
        SIGKILL, used by `FederatedGateway.kill_shard`): stop the ticker,
        cancel every parked ask future — a real crash severs those client
        connections the same way — and discard the staged tick.  The
        object must not be used afterwards; uncommitted work is lost."""
        self._closed = True
        if self._wake is not None:
            self._wake.set()
        pending = list(self._asks)
        if self._pending is not None:
            pending += self._pending.take
        self._pending = None
        for _sid, fut, _q in pending:
            if fut is not None and not fut.done():
                fut.cancel()

    def export_for_migration(self, sid: int) -> dict:
        """Quiesce one study and hand back a portable registry record.

        The study must be idle (nothing in flight or queued); if resident
        it is evicted first, so its latest state sits in THIS gateway's
        eviction store as a committed snapshot at `record["version"]`.
        The federation front end then copies that snapshot to the
        destination store (`checkpoint.copy_study_version`), adopts the
        record there, and finally `detach_study` here — a fault anywhere
        before the detach leaves the study fully intact on this shard.
        """
        self.tick_flush()
        log = self._require(sid)
        if not self.is_quiescent(sid):
            raise RuntimeError(
                f"study {sid} has work in flight "
                f"(inflight={log.inflight}, asks={log.pending_asks}, "
                f"tells={log.pending_tells}, fantasies="
                f"{self.pool.fantasy_active(log.slot) if log.slot is not None else 0}"
                "); drain before migrating")
        if log.slot is not None:
            self._free.append(self._evict(log))
        return self.registry_record(sid)

    def adopt_study(self, record: dict, *,
                    require_snapshot: bool = True) -> None:
        """Register a study exported from another shard.

        With `require_snapshot` (migration): the record's snapshot version
        must already be committed in THIS gateway's eviction store, or the
        adoption refuses — all-or-nothing, the source keeps the study.
        Without it (crash-recovery reconcile, where the snapshot may have
        lived only on the lost timeline): a missing snapshot degrades to a
        fresh study — its uncommitted observations are lost, never
        silently replayed."""
        sid = int(record["sid"])
        if sid in self._studies:
            raise ValueError(f"study id {sid} already lives on this shard")
        if sid in self._closed_sids:
            raise ValueError(f"study id {sid} was closed on this shard")
        space = space_from_dicts(record["dims"])
        if space.dim != self.pool.engine.gp_cfg.dim:
            raise ValueError(
                f"space dim {space.dim} != gateway dim "
                f"{self.pool.engine.gp_cfg.dim}")
        if space.has_discrete and not self.pool.engine.mixed:
            raise ValueError(
                "record has int/categorical dims but this shard was built "
                "without mixed-space closures")
        log = _Logical(sid, record["name"], space, int(record["seed"]),
                       n_obs=int(record["n_obs"]),
                       best_value=record.get("best_value"),
                       last_tick=self._tick_count,
                       version=int(record["version"]),
                       evicted_ever=bool(record["evicted_ever"]),
                       tier=int(record.get("tier", 0)))
        if log.evicted_ever and log.version not in \
                ckpt_mod.study_versions(self.cfg.ckpt_dir,
                                        self._study_key(log)):
            if require_snapshot:
                raise RuntimeError(
                    f"study {sid} snapshot version {log.version} is not "
                    f"committed under {self.cfg.ckpt_dir}; copy it before "
                    "adopting (all-or-nothing migration)")
            log.n_obs = 0
            log.best_value = None
            log.version = 0
            log.evicted_ever = False
            log.tier = 0
        self._studies[sid] = log
        self._next_sid = max(self._next_sid, sid + 1)
        if self._wake is not None:
            self._wake.set()

    def detach_study(self, sid: int) -> None:
        """Drop a migrated-away study from the registry WITHOUT a
        tombstone: the sid stays globally valid (it lives on another shard
        now, and may even migrate back).  This shard's copy of its
        snapshots is reclaimed at the next checkpoint commit."""
        log = self._require(sid)
        if log.slot is not None or not self.is_quiescent(sid):
            raise RuntimeError(
                f"study {sid} is not quiescent; export_for_migration first")
        if log.evicted_ever:
            self._closed_gc.append(self._study_key(log))
        del self._studies[sid]

    def expel_study(self, sid: int) -> None:
        """Remove a study this shard no longer owns (federation restore
        reconcile: the federation registry is newer than this shard's
        restored one — the study closed or migrated away on a timeline
        this shard lost).  Nothing is in flight after a restore, so this
        is pure registry surgery; snapshot files are left for the owning
        shard's GC."""
        log = self._studies.pop(sid, None)
        if log is None:
            return
        if log.slot is not None:
            self._owner[log.slot] = None
            self._free.append(log.slot)

    # -- the coalescing tick ------------------------------------------------
    def tick(self) -> int:
        """Serve one coalesced round synchronously; returns the number of
        asks served plus tells absorbed (0 = no progress).

        Gathers every queued tell and up to `max_batch` queued asks (at
        most one ask per study per tick — a second ask for the same study
        waits for the next round), makes the involved studies resident,
        and queues ONE fused `advance_round`.  Asks that cannot
        get a slot this tick (every slot pinned by in-flight work) stay
        queued and are retried when a tell frees a study; tells always
        place, or the tick fails without absorbing anything.

        `tick()` == `_tick_stage()` + `_tick_finish()` back to back (no
        overlap); the pipelined ticker drives the same two halves with one
        staged tick left in flight (`tick_begin`/`tick_flush`, §13).
        """
        self.tick_flush()
        staged = self._tick_stage()
        if staged is None:
            return 0
        return self._tick_finish(staged)

    def tick_begin(self) -> int:
        """Stage one coalesced round, finishing the PREVIOUSLY staged one
        after the new round's launches are queued — the pipelined tick:
        while tick t runs on the card, the host pops/validates/places tick
        t+1, queues its launches behind t's on the same stream, and then
        commits t's results (waiting on t's event alone).  Returns the
        staged round's size (asks taken + tells placed; 0 = nothing to
        stage).

        Pipeline hazards flush first (inside `_tick_stage`): residency
        changes and q>1 asks must not be staged over an in-flight round.
        q-ask ticks are additionally barriers on their OWN finish — their
        fantasy calls must run against this tick's posterior,
        before any later round is staged.
        """
        staged = self._tick_stage()
        if staged is None:
            return 0
        if any(q > 1 for _sid, _fut, q in staged.take):
            # the residency/q hazard check already flushed the previous
            # tick; finishing this one immediately keeps its ask_q
            # launches ordered before the next staged round
            self._tick_finish(staged)
            return staged.size
        prev, self._pending = self._pending, staged
        if prev is not None:
            self._tick_finish(prev)
        return staged.size

    def tick_flush(self) -> int:
        """Finish the staged in-flight tick, if any (pipeline drain)."""
        prev, self._pending = self._pending, None
        if prev is None:
            return 0
        return self._tick_finish(prev)

    def _tick_stage(self) -> _PendingTick | None:
        """Pop the queues, place the involved studies, queue the fused
        round — everything up to (but not including) the host reads."""
        tells, self._tells = self._tells, []
        # one ask per study per tick; respect max_batch; keep queue order
        take: list[tuple[int, asyncio.Future | None, int]] = []
        requeue: deque = deque()
        seen: set[int] = set()
        limit = self.gw.max_batch or len(self._asks)
        while self._asks:
            sid, fut, q = self._asks.popleft()
            if sid in seen or len(take) >= limit:
                requeue.append((sid, fut, q))
            else:
                seen.add(sid)
                take.append((sid, fut, q))
        self._asks = requeue
        if not tells and not take:
            # nothing new to stage — let the in-flight tick (if any) land
            self.tick_flush()
            return None
        if self._pending is not None and (
                any(q > 1 for _sid, _fut, q in take)
                or any(self._studies[sid].slot is None
                       for sid, _fut, _q in take)
                or any(self._studies[sid].slot is None
                       for sid, _tr, _val in tells)
                or any(self._needs_escalation(self._studies[sid], q)
                       for sid, _fut, q in take)):
            # pipeline hazards (§13): residency changes re-rank the LRU and
            # snapshot engine state, q>1 asks append fantasy rows whose
            # rollback bookkeeping the next round's staging reads, and tier
            # promotion rebuilds a slot's model — none may overlap an
            # unfinished tick.  Flush it first.
            try:
                self.tick_flush()
            except BaseException:
                self._tells = tells + self._tells
                self._asks.extendleft(reversed(take))
                raise
        self._restores_this_tick = 0
        self._evictions_this_tick = 0
        t0 = time.perf_counter()
        # Tells MUST place (their observation has nowhere else to go); their
        # pending counters pin them against the evictions they trigger.
        try:
            events = [(self._ensure_resident(sid), tr, val)
                      for sid, tr, val in tells]
        except GPCapacityError as e:
            # every slot pinned by other in-flight work: nothing was
            # absorbed (placement precedes the round) — requeue the
            # tells untouched, fail this tick's asks loudly
            self._tells = tells + self._tells
            for sid, fut, q in take:
                self._studies[sid].pending_asks -= q
                if fut is not None and not fut.done():
                    fut.set_exception(e)
            raise
        except Exception:
            # IO fault in the eviction store: nothing was queued —
            # requeue the whole tick untouched and surface the error
            self._tells = tells + self._tells
            self._asks.extendleft(reversed(take))
            raise
        # Asks place best-effort: the overflow defers to the next tick.
        ask_slots: dict[int, int] = {}
        deferred: list[tuple[int, asyncio.Future | None, int]] = []
        served: list[tuple[int, asyncio.Future | None, int]] = []
        try:
            for sid, fut, q in take:
                slot = self._try_resident(sid)
                if slot is None:
                    deferred.append((sid, fut, q))
                else:
                    ask_slots[sid] = slot
                    served.append((sid, fut, q))
        except Exception:
            # IO fault placing an ask (eviction snapshot failed): requeue
            # everything untouched — already-placed asks keep their slots
            # and replace them idempotently next tick — and surface.
            self._tells = tells + self._tells
            self._asks.extendleft(reversed(take))
            raise
        self._asks.extendleft(reversed(deferred))
        take = served
        if not events and not take:
            return None
        # Saturation escalation (DESIGN.md §15): a served ask that could
        # not fit the study's GP buffers promotes it to the NB tier BEFORE
        # the fused round — this tick's tells for it then take the routed
        # NB absorb, and its q-ask (if any) runs against the escalated
        # posterior with no capacity guard to trip mid-fantasy.
        for sid, _fut, q in take:
            log = self._studies[sid]
            if self._needs_escalation(log, q):
                self._promote(log)
        one_slots = sorted(ask_slots[sid] for sid, _f, q in take if q == 1)
        try:
            round_ = self.pool.advance_round_begin(
                events, t=1, studies=one_slots)
        except GPCapacityError as e:
            # advance_round capacity-checks the WHOLE round before mutating
            # any ledger or GP buffer (all-or-nothing), so the queues can be
            # rebuilt exactly: absorbable tells are requeued, unabsorbable
            # ones dead-letter (their trial records the error), and this
            # tick's asks fail loudly at their futures.
            self._retry_absorb = self._unwind_capacity_failure(tells, take, e)
            raise
        except Exception as e:
            # unexpected fault inside the fused round (units are
            # validated at tell(), so this is an engine/runtime error):
            # observations must not vanish and clients must not hang.
            self._fail_tick(tells, take, e)
            raise
        return _PendingTick(round=round_, tells=tells, take=take,
                            events=events, ask_slots=ask_slots,
                            deferred=len(deferred), t0=t0,
                            evictions=self._evictions_this_tick,
                            restores=self._restores_this_tick)

    def _fail_tick(self, tells, take, err) -> None:
        """Settle a failed tick so observations don't vanish and clients
        don't hang.  The pool flips a trial's status to "done" only AFTER
        its append committed to the GP, so requeue exactly the uncommitted
        tells — re-absorbing a committed one would silently duplicate its
        row — and settle the committed ones' counters here.  The tick's
        asks fail at their futures; the caller re-raises so the operator
        sees the error."""
        requeue = []
        for sid, tr, val in tells:
            log = self._studies[sid]
            if tr.status == "done":
                log.pending_tells -= 1
                log.n_obs += 1
                if tr.error is None and (log.best_value is None
                                         or val > log.best_value):
                    log.best_value = val
            else:
                requeue.append((sid, tr, val))
        self._tells = requeue + self._tells
        for sid, fut, q in take:
            self._studies[sid].pending_asks -= q
            if fut is not None and not fut.done():
                fut.set_exception(err)

    def _tick_finish(self, p: _PendingTick) -> int:
        """Materialize a staged round and commit it: settle ledgers,
        resolve futures, record telemetry, run the checkpoint cadence."""
        tells, take, ask_slots = p.tells, p.take, p.ask_slots
        try:
            suggestions = p.round.finish()
        except Exception as e:  # noqa: BLE001 — partitioned by status
            self._fail_tick(tells, take, e)
            raise
        # q>1 asks: one q-suggestion call per study, issued after
        # the round so each batch conditions on this tick's absorbs.  A
        # per-ask failure (capacity stolen by a foreign tell between
        # admission and serve) fails only that future, not the tick.
        q_results: dict[int, list[Trial] | Exception] = {}
        for sid, _fut, q in take:
            if q == 1:
                continue
            try:
                q_results[sid] = self.pool.ask_q(ask_slots[sid], q)
            except Exception as e:  # noqa: BLE001 — meted to the future
                q_results[sid] = e
        latency_ms = 1e3 * (time.perf_counter() - p.t0)
        self._tick_count += 1
        for sid, tr, val in tells:
            log = self._studies[sid]
            log.pending_tells -= 1
            log.n_obs += 1
            log.last_tick = self._tick_count
            if tr.error is None and (log.best_value is None
                                     or val > log.best_value):
                log.best_value = val
        n_suggested = 0
        for sid, fut, q in take:
            log = self._studies[sid]
            log.pending_asks -= q
            log.last_tick = self._tick_count
            hist = self._totals["q_width_hist"]
            hist[str(q)] = hist.get(str(q), 0) + 1
            if q == 1:
                trials = [suggestions[ask_slots[sid]][0]]
            else:
                res = q_results[sid]
                if isinstance(res, Exception):
                    if fut is not None and not fut.done():
                        fut.set_exception(res)
                    continue
                trials = res
            n_suggested += q
            if fut is not None and fut.cancelled():
                # the client is gone: nobody holds these suggestions, so
                # no tell will ever come back — counting them in flight
                # would pin the study non-evictable and eat its
                # max_inflight budget forever, and a q-ask's fantasy rows
                # would hold buffer capacity with no tell to release them
                for tr in trials:
                    tr.status = "failed"
                    tr.error = "ask cancelled before delivery"
                if q > 1:
                    self.pool.release_fantasies(
                        ask_slots[sid],
                        [np.asarray(tr.unit) for tr in trials])
                continue
            log.inflight += q
            for tr in trials:
                tr.status = "running"
                tr.started = time.time()
            if fut is not None:
                fut.set_result(trials if q > 1 else trials[0])
        self._sync_fantasy_totals()
        self.stats.append({
            "tick": self._tick_count,
            "width": len(take),
            "suggestions": n_suggested,
            "absorbed": len(p.events),
            "deferred": p.deferred,
            "queued_after": len(self._asks),
            "latency_ms": latency_ms,
            "evictions": p.evictions,
            "restores": p.restores,
        })
        self._totals["asks_served"] += n_suggested
        self._totals["absorbed"] += len(p.events)
        if self.gw.ckpt_every_ticks and \
                self._tick_count % self.gw.ckpt_every_ticks == 0:
            self.checkpoint()
        return p.size

    def _unwind_capacity_failure(self, tells, take, err) -> bool:
        """Rebuild the queues after an all-or-nothing capacity abort.

        Returns True when absorbable tells were requeued — their retry
        round is guaranteed to fit (the overflow was dead-lettered and the
        coalesced asks removed), so the ticker may re-wake once."""
        keep, counts = [], {}
        for sid, tr, val in tells:
            log = self._studies[sid]
            counts[sid] = counts.get(sid, 0) + 1
            # escalated studies can never be the raiser (their ledger
            # doubles instead of filling) — their tells always requeue
            if log.tier == 0 and log.n_obs + counts[sid] > self.cfg.n_max:
                # can never fit — dead-letter instead of poisoning the queue
                log.pending_tells -= 1
                counts[sid] -= 1
                tr.status = "failed"
                tr.error = f"dropped at capacity: {err}"
                self.dead_tells.append((sid, tr, val))
            else:
                keep.append((sid, tr, val))
        self._tells = keep + self._tells
        for sid, fut, q in take:
            self._studies[sid].pending_asks -= q
            if fut is not None and not fut.done():
                fut.set_exception(err)
        return bool(keep)

    async def drain(self) -> None:
        """Wait until every queued ask/tell has been served (or the ticker
        has died — its exception re-raises here).  Parks on the per-tick
        event instead of busy-polling: a waiter re-checks only after the
        ticker attempts a round (or exits)."""
        while self._asks or self._tells or self._pending is not None or (
                self._wake is not None and self._wake.is_set()):
            if self._ticker is None:
                break  # nothing will ever serve; sync callers drive tick()
            if self._ticker.done():
                if not self._ticker.cancelled() and \
                        self._ticker.exception() is not None:
                    raise self._ticker.exception()
                break
            self._tick_done.clear()
            # re-check after the clear: a tick that completed between the
            # loop condition and the clear must not be waited out
            if not (self._asks or self._tells or self._wake.is_set()
                    or self._pending is not None):
                break
            await self._tick_done.wait()

    def _ensure_ticker(self, loop: asyncio.AbstractEventLoop) -> None:
        if self._wake is None:
            self._wake = asyncio.Event()
        if self._tick_done is None:
            self._tick_done = asyncio.Event()
        if self._ticker is None or self._ticker.done():
            self._ticker = loop.create_task(self._run_ticker())

    async def _run_ticker(self) -> None:
        try:
            while not self._closed:
                await self._wake.wait()
                self._wake.clear()
                if self._closed:
                    break
                if self.gw.coalesce_ms > 0:
                    await asyncio.sleep(self.gw.coalesce_ms / 1e3)
                else:
                    # One cooperative yield: every client task already
                    # runnable gets to enqueue before the round fires.
                    await asyncio.sleep(0)
                progressed = 0
                self._retry_absorb = False
                try:
                    if self.gw.pipeline:
                        progressed = self.tick_begin()
                        if progressed and self._pending is not None:
                            # one cooperative yield: clients woken by the
                            # round that just finished enqueue NOW, so the
                            # next begin can stage them while this round is
                            # still in flight — without it the staged round
                            # always drains at the tail below and nothing
                            # ever overlaps
                            await asyncio.sleep(0)
                        if self._pending is not None and not (
                                self._asks or self._tells):
                            # pipeline tail: no new traffic arrived — land
                            # the staged round so its clients aren't parked
                            # behind an idle gateway
                            progressed += self.tick_flush()
                            await asyncio.sleep(0)
                    else:
                        progressed = self.tick()
                except GPCapacityError:
                    # already meted out to the affected futures/queues;
                    # retry once when absorbable tells were requeued (their
                    # round is guaranteed to fit now).  A staged tick can't
                    # be the raiser (capacity is checked at stage), but it
                    # must still land or its clients park forever.
                    if self._pending is not None:
                        self.tick_flush()
                    if self._retry_absorb:
                        self._wake.set()
                except Exception as e:
                    # non-capacity fault (e.g. eviction-store IO): the tick
                    # requeued everything untouched, but dying silently
                    # would park every client awaiting ask() forever —
                    # fail their futures loudly instead.  Tells stay
                    # queued (observations are never dropped); the next
                    # ask() re-creates the ticker and retries them.
                    if self._pending is not None:
                        try:
                            self.tick_flush()
                        except Exception:  # noqa: BLE001 — already failing
                            pass
                    while self._asks:
                        sid, fut, q = self._asks.popleft()
                        self._studies[sid].pending_asks -= q
                        if fut is not None and not fut.done():
                            fut.set_exception(e)
                    raise
                # Re-wake only on progress: deferred asks that could not
                # place wait for the external event (a tell freeing a
                # study) instead of spinning the loop.
                if progressed and (self._asks or self._tells):
                    self._wake.set()
                self._tick_done.set()
        finally:
            # wake drain() waiters on ANY exit (aclose, tick exception) so
            # they observe the dead ticker instead of parking forever
            if self._tick_done is not None:
                self._tick_done.set()

    async def aclose(self) -> None:
        """Stop the ticker (queued asks are abandoned; tells stay queued
        until a final explicit `tick()`)."""
        self._closed = True
        if self._wake is not None:
            self._wake.set()
        if self._ticker is not None:
            try:
                await self._ticker
            except asyncio.CancelledError:
                pass
        self.tick_flush()  # land any round the ticker left in flight
        for sid, fut, q in self._asks:
            if fut is not None and not fut.done():
                fut.cancel()
            self._studies[sid].pending_asks -= q
        self._asks.clear()

    # -- telemetry / checkpointing ------------------------------------------
    def _sync_fantasy_totals(self) -> None:
        """Fold the pool's rollback counter into the lifetime total.  The
        pool counter is a live monotonic tally that does not persist; the
        gateway total rides the checkpoint registry like every other
        lifetime counter, so the delta since the last sync is folded in
        and the watermark advanced."""
        cur = self.pool.fantasy_rollbacks
        self._totals["fantasy_rollbacks"] += cur - self._pool_rollbacks_seen
        self._pool_rollbacks_seen = cur

    def study_ids(self) -> list[int]:
        """Open logical study ids (closed studies leave the registry)."""
        return sorted(self._studies)

    def study_info(self, sid: int) -> dict:
        """Public view of one logical study's serving state: name, absorbed
        count, residency, eviction count, and the best genuine observation
        (residency-independent; penalty pseudo-observations excluded) — the
        stable surface examples and dashboards read instead of the private
        registry."""
        log = self._studies.get(sid)
        if log is None:
            raise KeyError(f"unknown study id {sid}")
        return {
            "sid": log.sid, "name": log.name, "n_obs": log.n_obs,
            "slot": log.slot, "resident": log.slot is not None,
            "inflight": log.inflight, "evictions": log.version,
            "best_value": log.best_value,
            "fantasy_active": (self.pool.fantasy_active(log.slot)
                               if log.slot is not None else 0),
            # saturation observability (DESIGN.md §15): the tier tag and
            # whether the study has ever hit its GP buffer boundary; both
            # survive eviction and checkpoint/restore with the registry
            "tier": log.tier,
            "saturated": bool(log.tier or log.n_obs >= self.cfg.n_max),
        }

    def summary(self) -> dict:
        """Serving telemetry: counts are LIFETIME totals (including the
        fantasy rollback count and the q-width histogram, which survive
        checkpoint/restore); `fantasy_active` is the LIVE number of
        fantasy rows across resident slots; latency/width distributions
        cover the retained window (`stats_window` ticks)."""
        self._sync_fantasy_totals()
        out = {"ticks": self._tick_count, **self._totals,
               "fantasy_active": sum(self.pool.fantasy_active(s)
                                     for s in range(self.gw.slots)),
               # saturation gauges (DESIGN.md §15): escalated = studies on
               # the NB tier; saturated = studies at/past their GP buffer
               # boundary (escalated ones included).  Derived from the
               # registry, so they persist across checkpoint/restore and
               # sum across federation shards.
               "escalated": sum(1 for log in self._studies.values()
                                if log.tier),
               "saturated": sum(1 for log in self._studies.values()
                                if log.tier
                                or log.n_obs >= self.cfg.n_max),
               "mean_coalesce_width": 0.0,
               "p50_tick_ms": 0.0, "p95_tick_ms": 0.0}
        if self.stats:
            lat = sorted(s["latency_ms"] for s in self.stats)
            # width over ask-serving ticks only: tell-only drain ticks
            # have width 0 and would understate the coalescing achieved
            widths = [s["width"] for s in self.stats if s["width"]]
            if widths:
                out["mean_coalesce_width"] = float(np.mean(widths))
            out["p50_tick_ms"] = lat[len(lat) // 2]
            out["p95_tick_ms"] = lat[min(len(lat) - 1,
                                         int(0.95 * len(lat)))]
        return out

    def checkpoint(self) -> str | None:
        """Whole-gateway snapshot: evicted studies already sit in their
        partial snapshots; the pool snapshot covers the resident slots and
        the logical registry rides the pool metadata.  In-flight asks and
        un-told suggestions do NOT survive a crash — clients re-ask, and
        the persistent per-study PRNG streams guarantee the retried round
        never replays a pre-crash batch.  Fantasy rows never reach disk:
        `pool.checkpoint` rolls every fantasy-active slot back to real
        observations before snapshotting and re-fantasizes after."""
        # a staged tick is half-committed state: land it before snapshotting
        # (no-op when the cadence fires from _tick_finish — the pending
        # record was popped before finish ran)
        self.tick_flush()
        self._sync_fantasy_totals()
        registry = {
            "next_sid": self._next_sid,
            "tick_count": self._tick_count,
            "totals": dict(self._totals),
            "closed_sids": sorted(self._closed_sids),
            "studies": [{
                "sid": log.sid, "name": log.name, "seed": log.seed,
                "slot": log.slot, "n_obs": log.n_obs,
                "best_value": log.best_value,
                "last_tick": log.last_tick, "version": log.version,
                "evicted_ever": log.evicted_ever, "tier": log.tier,
                "dims": space_to_dicts(log.space),
            } for log in self._studies.values()],
        }
        path = self.pool.checkpoint(extra={"gateway": json.dumps(registry)})
        if path is not None:
            # the committed registry references each study's CURRENT
            # version; older partial snapshots are now unreachable
            ckpt_mod.prune_studies(self.cfg.ckpt_dir, {
                self._study_key(log): log.version
                for log in self._studies.values() if log.evicted_ever})
            # studies closed since the last commit are now unreferenced by
            # any restorable registry — their snapshot dirs can go.  A key
            # that came BACK (study migrated away and returned before this
            # commit) is live again and must keep its files.
            live = {self._study_key(log) for log in self._studies.values()}
            ckpt_mod.drop_studies(self.cfg.ckpt_dir,
                                  [k for k in self._closed_gc
                                   if k not in live])
            self._closed_gc = []
        return path

    def restore(self) -> bool:
        """Resume from the latest pool snapshot + its gateway registry.

        Pending/in-flight work is reset (those clients are gone); absorbed
        state, ledgers, PRNG streams, slot map, and LRU/eviction bookkeeping
        come back exactly as checkpointed.
        """
        self.tick_flush()  # resolve any staged round on the old timeline
        if not self.pool.restore():
            return False
        meta = self.pool.last_restore_meta or {}
        if "gateway" not in meta:
            raise ValueError("checkpoint has no gateway registry "
                             "(written by a bare StudyPool?)")
        registry = json.loads(meta["gateway"])
        self._next_sid = int(registry["next_sid"])
        self._tick_count = int(registry["tick_count"])
        self._totals.update(registry.get("totals", {}))
        # pool.restore() cleared every fantasy row (snapshots hold only
        # real state); re-arm the rollback watermark at the pool's live
        # counter so only post-restore rollbacks accrue on top of the
        # persisted lifetime total
        self._pool_rollbacks_seen = self.pool.fantasy_rollbacks
        self._closed_sids = set(registry.get("closed_sids", []))
        self._closed_gc = []
        self._studies = {}
        self._owner = [None] * self.gw.slots
        # clients parked on pre-restore asks belong to the discarded
        # timeline: cancel their futures (dropping them silently would
        # hang those tasks forever — aclose() does the same)
        for _sid, fut, _q in self._asks:
            if fut is not None and not fut.done():
                fut.cancel()
        self._asks.clear()
        self._tells = []
        for rec in registry["studies"]:
            space = space_from_dicts(rec["dims"])
            log = _Logical(rec["sid"], rec["name"], space, rec["seed"],
                           slot=rec["slot"], n_obs=rec["n_obs"],
                           best_value=rec.get("best_value"),
                           last_tick=rec["last_tick"],
                           version=rec["version"],
                           evicted_ever=rec["evicted_ever"],
                           tier=int(rec.get("tier", 0)))
            self._studies[log.sid] = log
            if log.slot is not None:
                self._owner[log.slot] = log.sid
                # pool.restore() rebuilds slot handles from the pool
                # snapshot, which carries no spaces — re-apply the logical
                # study's own (possibly custom) space AND its type
                # descriptor, or its resident suggestions map through the
                # template's bounds/layout
                self.pool.studies[log.slot].space = log.space
                if self.pool.engine.mixed or log.space.has_discrete:
                    self.pool.engine.set_desc(log.slot,
                                              log.space.descriptor())
        self._free = [s for s in range(self.gw.slots - 1, -1, -1)
                      if self._owner[s] is None]
        return True
