"""The batched GP suggest/absorb engine shared by the HPO orchestrators.

Counterpart of `repro/hpo/engine.py`: the lazy-GP tier, its q-fantasy
protocol, the neural-basis escalation tier and the (study x restart)
device mesh.  `StudyEngine` owns the stacked `LazyGPState` of S studies
with a leading study axis (DESIGN.md §7) and advances it:

  * `suggest_all` — the acquisition ascent of every study at once: each
    ascent step is one fused-EI launch for all S studies.
  * `suggest`     — one study's ascent (routed, per-study requests).
  * `absorb`      — one observation routed to its study.
  * `absorb_round`— at most one observation per study (flagged), one gram
    launch for every flagged study's covariance column, the bordered
    update study by study.
  * `advance`     — the serving round: `absorb_round`, then `suggest_all`
    from the updated posteriors.
  * lag events    — after an absorb, each flagged study whose lag counter
    is due is refit (grid LML, then refactor) or, fully lazy, re-anchored
    (refactor under its current params), one study at a time.
  * `ask_q` / `truncate_slot` / `refantasize` — the fantasy protocol
    (DESIGN.md §12), routed to one slot: q suggestions, each appended as a
    fantasy row; the rollback to the real rows; the pending points
    appended again after a real tell.
  * `promote_slot` / `nb_*` — the saturation escalation tier (DESIGN.md
    §15): a slot whose GP is full trains a `NeuralBasisState` on its
    ledger and serves from it (`nb_suggest`, `nb_absorb`, `nb_ask_q`,
    `nb_rollback`, `nb_refantasize`), one slot at a time.

**Fantasy rows** live in the slot's own rows of the stacked buffers and
are written there in place (no (n_max, n_max) buffer is copied); the
host `n` mirror and the device `state.n` both count them, so the caller
(the pool's real ledger) must roll them back before a real append lands.
The rollback re-pads x, y, the factor and its inverse bit for bit
(`gp.truncate`).  Alpha cannot be re-padded: the reference recomputes it,
which differs from the fused append's alpha in the last bit when no real
append follows (a release).  So the engine copies a slot's alpha when the
slot takes its first fantasy row on top of real rows, and a truncate back
to that count puts the copy back: every leaf is then restored bit for bit,
whether or not a real append follows.  A truncate to any other count
recomputes alpha as `gp.truncate` does; a real append, a slot load or a
new state drops the copy.

The reference's engine donates the stacked buffers to its fused round; the
port writes the absorbed rows in place (`gp.append_stacked`), so a round
copies no (S, n_max, n_max) buffer.  One gram launch builds every flagged
study's covariance column; the rest of a study's append runs on its rows
with the single-study append's calls, and the batched suggest hoists its
operands lane by lane (`acquisition.hoist`), so a lane of a round is bit
for bit the single-study step on that lane.  Studies that are not flagged
keep every bit.  `study_state` returns a copy, so a snapshot a caller holds
never changes under later in-place writes.

**Mixed spaces** (DESIGN.md §10): when any study's space has discrete dims
(or `cfg.mixed` forces it), the engine keeps the stacked per-study
`TypeDescriptor` (S, d) and one mixed-kernel closure over its (S, d) masks:
studies with different type layouts advance in the same launches, and a
slot's new layout is a row write (`set_desc`).

Host-side per-study telemetry: `n` and `since_refit` are mirrored in host
numpy arrays (they evolve with the appends the engine itself makes), so
the capacity guards and the lag policy never read the device; a round's
observations go to the device in one copy that does not wait for it.
`clamp_count` is data-dependent and reads the device (`clamp_counts()`
fetches all studies in one transfer).

**Escalated slots** (`tier(slot) == 1`) keep their GP lane in the stack,
frozen: it rides the batched launches as dead weight and is never written
again (a flagged absorb into it raises), so an export still carries it bit
for bit.  The live model is the slot's `NeuralBasisState`, held here with
host mirrors of its row count (fantasy rows included) and its refit
counter, so an absorb decides a refit without reading the device.  Its
fantasy rows are rank-1 appends that do not reverse bit for bit, so an ask
keeps a snapshot of the state and the rollback restores it.

Draws: the restart seeds and the top-t jitter are drawn from the engine's
`torch.Generator` (seeded from `cfg.seed`, on the engine's device) unless
the caller passes them (`seeds (S, R, d)` / `jitter (S, top_t, d)`, or one
study's slices to `suggest`), as the tests pass the reference's own draws.

**Device mesh** (DESIGN.md §8, `repro_torch.hpo.mesh`): `cfg.mesh` "SxR"
or "auto" over a list of logical devices (`devices`; default every
visible device of the engine's type) splits the engine into study shards,
each a stacked state of its own lanes on its home device, with the
descriptor rows and the host mirrors of the same lanes.  Without a mesh
there is one shard of all S lanes on the engine's device.  The batched
calls run shard by shard, each making the unsharded engine's calls on its
lanes (the fused-EI plan and the gram are per lane, so a lane keeps its
bits); the routed calls go to the shard that holds the study.  The
restart seeds are drawn once at full (S, R) from the one generator, as
without a mesh, then sliced; a study shard with R > 1 restart shards
ascends each restart slice on its cell (`acquisition.optimize_acquisition`
with `restart_states`): restart shards on the home's card read the
shard's one copy, one on another card a replica that every write of the
shard copies into.  Logical devices on one card run in order on its
current stream.  `state` reads as one (S, ...) state on the engine's
device (a copy, with a mesh) and writing it splits the state onto the
shards.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import acquisition as acq_mod
from repro_torch.core import descriptor as desc_mod
from repro_torch.core import gp as gp_mod
from repro_torch.core import neural_basis as nb_mod
from repro_torch.core.kernels import KERNELS, make_mixed_kernel
from repro_torch.hpo import mesh as mesh_mod

Tensor = torch.Tensor


@dataclasses.dataclass
class _Shard:
    """One study shard: its lanes (global study ids), its stacked state on
    its home device, the state each restart shard reads (`state` itself,
    or a replica on another card), and its descriptor rows, kernel and
    unit box."""
    lanes: range
    home: torch.device
    cells: list[torch.device]
    state: gp_mod.LazyGPState = None
    replicas: list = None
    desc: desc_mod.TypeDescriptor | None = None
    kernel: object = None
    lo: Tensor = None
    hi: Tensor = None

    @property
    def span(self) -> slice:
        return slice(self.lanes.start, self.lanes.stop)


class StudyEngine:
    """Stacked lazy-GP state of S studies and the batched transitions.

    `cfg` is duck-typed (`SchedulerConfig` works): it needs n_max, kernel,
    lag, rho0, noise2, acq and seed; optionally mixed, mesh ("none"),
    inv_refresh, fantasy and neural.  Runs on the card unless `device` says
    otherwise; `devices` are the mesh's logical devices (repeats allowed,
    e.g. `["cuda:0"] * 4`), of the engine's device type.
    """

    def __init__(self, dim: int, cfg, n_studies: int,
                 descs: "list[desc_mod.TypeDescriptor] | None" = None, *,
                 device: str | torch.device = "cuda", devices=None):
        if n_studies < 1:
            raise ValueError(f"n_studies must be >= 1, got {n_studies}")
        self.cfg = cfg
        self.dim = dim
        self.n_studies = n_studies
        self.device = gp_mod.resolve_device(device)
        self.mixed = bool(getattr(cfg, "mixed", False)) or (
            descs is not None and any(d.has_discrete for d in descs))
        if self.mixed and cfg.kernel != "matern52":
            raise ValueError(
                f"mixed spaces require kernel='matern52', got {cfg.kernel!r}")
        self.gp_cfg = gp_mod.GPConfig(
            n_max=cfg.n_max, dim=dim, kernel=cfg.kernel, lag=cfg.lag,
            noise2=cfg.noise2, rho0=cfg.rho0, device=str(self.device))
        if devices is None:
            devices = mesh_mod.default_devices(self.device.type)
        devices = [torch.device(d) for d in devices]
        if any(d.type != self.device.type for d in devices):
            raise ValueError(f"mesh devices {[str(d) for d in devices]} are "
                             f"not all of the engine's type "
                             f"{self.device.type!r}")
        self.mesh = mesh_mod.build(getattr(cfg, "mesh", "none"), n_studies,
                                   cfg.acq.restarts, devices)
        if self.mesh is None:
            self._shards = [_Shard(range(n_studies), self.device,
                                   [self.device])]
        else:
            self._shards = [_Shard(lanes, self.mesh.home(i), self.mesh.row(i))
                            for i, lanes in enumerate(self.mesh.lanes)]
        self._shard_of = np.repeat(np.arange(len(self._shards)),
                                   n_studies // len(self._shards))
        # Mixed mode: the stacked descriptor is data, and each shard's
        # kernel closes over its rows' (S/k, d) mask tensors, so `set_desc`
        # rewrites a row that every later launch reads.
        if self.mixed:
            if descs is None:
                descs = [desc_mod.all_continuous(dim)] * n_studies
            if len(descs) != n_studies:
                raise ValueError(
                    f"got {len(descs)} descriptors for {n_studies} studies")
            if any(d.dim != dim for d in descs):
                raise ValueError(f"descriptors must have width {dim}")
        for sh in self._shards:
            if self.mixed:
                sh.desc = desc_mod.stack_descriptors(
                    [descs[s].to(sh.home) for s in sh.lanes])
                sh.kernel = make_mixed_kernel(sh.desc.cont_mask,
                                              sh.desc.cat_mask)
            else:
                sh.kernel = KERNELS[cfg.kernel]
            sh.lo = torch.zeros((dim,), device=sh.home)
            sh.hi = torch.ones((dim,), device=sh.home)
        self.state = gp_mod.init_pool_state(self.gp_cfg, n_studies)
        self._lo = torch.zeros((dim,), device=self.device)
        self._hi = torch.ones((dim,), device=self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(getattr(cfg, "seed", 0)))
        # Per-row observation costs (tell `cost=`, default 1.0): the
        # training set of a promoted slot's log-cost head.
        self._cost_host = np.ones((n_studies, cfg.n_max), np.float32)
        # Fantasy-active slots: slot -> (real count, alpha at that count).
        self._alpha_kept: dict[int, tuple[int, Tensor]] = {}
        # The neural-basis tier: the per-slot tag (0 = lazy GP, 1 =
        # escalated), each escalated slot's state, its host mirrors (rows
        # with fantasies, appends since the last refit) and, while fantasy
        # rows are out, the snapshot an `nb_rollback` restores.
        self.neural = getattr(cfg, "neural", None) or nb_mod.NeuralConfig()
        self._tier = np.zeros((n_studies,), np.int8)
        self._nb: dict[int, nb_mod.NeuralBasisState] = {}
        self._nb_n: dict[int, int] = {}
        self._nb_sr: dict[int, int] = {}
        self._nb_shadow: dict[int, tuple[nb_mod.NeuralBasisState, int,
                                         int]] = {}

    # -- state + host-side counter mirrors ----------------------------------
    @property
    def state(self) -> gp_mod.LazyGPState:
        """The stacked (S, ...) state: without a mesh the engine's own
        (later rounds write it in place); with one, the shards' lanes
        joined on the engine's device (a copy)."""
        if self.mesh is None:
            return self._shards[0].state
        return gp_mod.concat_states([sh.state for sh in self._shards],
                                    self.device)

    @state.setter
    def state(self, st: gp_mod.LazyGPState) -> None:
        """Install a stacked state (split onto the shards' devices, with a
        mesh); re-syncs the host mirrors from it."""
        if not st.is_batched or st.n_studies != self.n_studies:
            raise ValueError(f"expected a stacked state of {self.n_studies} "
                             f"studies, got x_buf {tuple(st.x_buf.shape)}")
        for sh in self._shards:
            sh.state = (st if self.mesh is None
                        else gp_mod.place(gp_mod.lanes(st, sh.span), sh.home))
            home = mesh_mod.physical(sh.home)
            sh.replicas = [sh.state if mesh_mod.physical(c) == home
                           else gp_mod.place(sh.state, c) for c in sh.cells]
        self._alpha_kept = {}
        self._n_host = st.n.cpu().numpy().astype(np.int64)
        self._sr_host = st.since_refit.cpu().numpy().astype(np.int64)

    @property
    def desc(self) -> desc_mod.TypeDescriptor | None:
        """The stacked (S, d) descriptor in mixed mode (a copy on the
        engine's device, with a mesh), else None."""
        if not self.mixed or self.mesh is None:
            return self._shards[0].desc
        return desc_mod.TypeDescriptor(*(
            torch.cat([getattr(sh.desc, f).to(self.device)
                       for sh in self._shards]) for f in desc_mod.FIELDS))

    @property
    def kernel(self):
        """The kernel over all S studies: the mixed closure over the
        stacked (S, d) masks in mixed mode (over `desc`'s copy, with a
        mesh)."""
        if not self.mixed or self.mesh is None:
            return self._shards[0].kernel
        desc = self.desc
        return make_mixed_kernel(desc.cont_mask, desc.cat_mask)

    def _at(self, study: int) -> tuple[_Shard, int]:
        """The shard that holds `study`, and the study's lane in it."""
        sh = self._shards[self._shard_of[study]]
        return sh, study - sh.lanes.start

    def _wrote(self, sh: _Shard, idx) -> None:
        """Copy the shard's lanes `idx` into its replicas on other cards
        (none where every cell shares the home's card)."""
        for rep in sh.replicas:
            if rep is not sh.state:
                gp_mod.copy_lanes(rep, sh.state, idx)

    def n(self, study: int) -> int:
        return int(self._n_host[study])

    def since_refit(self, study: int) -> int:
        return int(self._sr_host[study])

    def clamp_count(self, study: int) -> int:
        sh, i = self._at(study)
        return int(sh.state.clamp_count[i])

    def clamp_count_tensor(self) -> Tensor:
        """All studies' conditioning-floor counters, (S,) int32 on the
        engine's device, in a tensor of their own (no read back)."""
        if self.mesh is None:
            return self._shards[0].state.clamp_count.clone()
        return torch.cat([sh.state.clamp_count.to(self.device)
                          for sh in self._shards])

    def clamp_counts(self) -> np.ndarray:
        """All studies' conditioning-floor counters in one transfer a
        shard."""
        return np.concatenate([sh.state.clamp_count.cpu().numpy()
                               for sh in self._shards])

    def sync(self) -> None:
        """Block until every queued launch has written the state."""
        for dev in {mesh_mod.physical(c) for sh in self._shards
                    for c in sh.cells}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def study_state(self, study: int) -> gp_mod.LazyGPState:
        """Study `study` as a single-study state with its own buffers (a
        snapshot: later in-place rounds do not change it)."""
        sh, i = self._at(study)
        return gp_mod.unstack_state(sh.state, i, n=self.n(study),
                                    since_refit=self.since_refit(study),
                                    copy=True)

    # -- slot-level state swap (evict/restore, DESIGN.md §9) ----------------
    def load_slot(self, slot: int, sub: gp_mod.LazyGPState) -> None:
        """Copy single-study state `sub` into slot `slot`, bit for bit; the
        host mirrors change for that slot only."""
        sh, i = self._at(slot)
        gp_mod.write_study(sh.state, i, sub)
        self._wrote(sh, i)
        self._alpha_kept.pop(slot, None)
        self._n_host[slot] = int(sub.n)
        self._sr_host[slot] = int(sub.since_refit)

    def reset_slot(self, slot: int) -> None:
        """Blank a slot for a new tenant (an empty single-study state, back
        on the GP tier, costs 1.0)."""
        self.load_slot(slot, gp_mod.init_state(self.gp_cfg))
        self.clear_nb_slot(slot)

    def set_desc(self, slot: int, desc: desc_mod.TypeDescriptor) -> None:
        """Install a (possibly different) type layout for one slot: a row
        write into the stacked descriptor, which the mixed kernel's masks
        are.  No-op outside mixed mode, where every slot is all-continuous
        by construction, and an error there for a discrete layout."""
        if not self.mixed:
            if desc.has_discrete:
                raise ValueError(
                    "engine was built without mixed-space support; "
                    "construct it with a discrete space or cfg.mixed=True")
            return
        if desc.dim != self.dim:
            raise ValueError(f"descriptor width {desc.dim}, engine {self.dim}")
        sh, i = self._at(slot)
        for name in desc_mod.FIELDS:
            getattr(sh.desc, name)[i] = getattr(desc, name)

    # -- suggest ------------------------------------------------------------
    def _lane(self, study: int) -> gp_mod.LazyGPState:
        """Views of one study's rows with its host counts (no copy)."""
        sh, i = self._at(study)
        return gp_mod.unstack_state(sh.state, i, n=self.n(study),
                                    since_refit=self.since_refit(study))

    def _kernel_for(self, lanes):
        """The kernel of one study (an int) or of a slice of the studies of
        one shard."""
        first = lanes.start if isinstance(lanes, slice) else lanes
        sh, i = self._at(first)
        if sh.desc is None:
            return sh.kernel
        if isinstance(lanes, slice):
            i = slice(i, i + lanes.stop - lanes.start)
        return make_mixed_kernel(sh.desc.cont_mask[i], sh.desc.cat_mask[i])

    def _tensor(self, a, device=None) -> Tensor | None:
        """Caller-given draws as a float32 tensor on `device` (default the
        engine's)."""
        if a is None:
            return None
        if not isinstance(a, Tensor):
            a = torch.from_numpy(np.array(a, np.float32))
        return a.to(device or self.device, torch.float32, non_blocking=True)

    def _desc_for(self, study: int) -> desc_mod.TypeDescriptor | None:
        """One study's row of the stacked descriptor (mixed mode)."""
        sh, i = self._at(study)
        if sh.desc is None:
            return None
        return desc_mod.index_descriptor(sh.desc, i)

    def suggest(self, study: int, top_t: int = 1, *, seeds=None,
                jitter=None) -> tuple[Tensor, Tensor]:
        """Top-t EI local maxima for one study: ((top_t, d), (top_t,));
        `seeds (R, d)` / `jitter (top_t, d)` when given.  Runs on the
        study's home device, its restarts unsplit."""
        sh = self._at(study)[0]
        return acq_mod.optimize_acquisition(
            self._lane(study), self._kernel_for(study), sh.lo, sh.hi,
            self.cfg.acq, top_t, generator=self._gen,
            seeds=self._tensor(seeds), jitter=self._tensor(jitter),
            desc=self._desc_for(study))

    def suggest_all(self, top_t: int = 1, *, seeds=None,
                    jitter=None) -> tuple[Tensor, Tensor]:
        """Batched suggestion for every study: ((S, top_t, d), (S, top_t));
        `seeds (S, R, d)` / `jitter (S, top_t, d)` when given, else drawn
        at full (S, R) as the unsharded ascent draws them.  Shard by shard,
        each on its lanes' draws, its restarts split over its cells."""
        seeds, jitter = acq_mod.draw_stacked(
            self._lo, self._hi, self.cfg.acq, self._shards[0].kernel, top_t,
            self._gen, self.n_studies, self._tensor(seeds),
            self._tensor(jitter))
        units, vals = [], []
        for sh in self._shards:
            sl = sh.span
            u, v = acq_mod.optimize_acquisition(
                sh.state, sh.kernel, sh.lo, sh.hi, self.cfg.acq, top_t,
                generator=self._gen, seeds=seeds[sl].to(sh.home),
                jitter=None if jitter is None else jitter[sl].to(sh.home),
                desc=sh.desc, counts=self._n_host[sl],
                restart_states=sh.replicas if len(sh.cells) > 1 else None)
            units.append(u)
            vals.append(v)
        if len(self._shards) == 1:
            return units[0], vals[0]
        return (torch.cat([u.to(self.device) for u in units]),
                torch.cat([v.to(self.device) for v in vals]))

    # -- absorb -------------------------------------------------------------
    def _upload(self, device: torch.device, flags: np.ndarray, xs, ys
                ) -> tuple[Tensor, Tensor, Tensor]:
        """flags, xs and ys to `device` in one copy that does not wait for
        the card; xs already there (the last round's suggestions) stay."""
        on_device = isinstance(xs, Tensor)
        width = 2 if on_device else self.dim + 2
        packed = np.empty((flags.shape[0], width), np.float32)
        if not on_device:
            packed[:, :self.dim] = xs
        packed[:, -2] = ys
        packed[:, -1] = flags
        dev = torch.from_numpy(packed).to(device, non_blocking=True)
        x = (xs.to(device, torch.float32) if on_device
             else dev[:, :self.dim])
        return dev[:, -1] > 0, x, dev[:, -2]

    def _admit(self, flags, costs) -> tuple[np.ndarray, np.ndarray]:
        """Check every flagged study's capacity before anything is written
        (a full study leaves every lane untouched), then record the costs."""
        flags = np.asarray(flags, bool)
        flagged = np.flatnonzero(flags)
        for s in flagged:
            self._gp_tier(s)
            gp_mod.ensure_capacity(self.n(s), self.cfg.n_max)
        if costs is None:
            costs = np.ones((self.n_studies,), np.float32)
        costs = np.asarray(costs, np.float32)
        for s in flagged:
            self._cost_host[s, self.n(s)] = costs[s]
        return flags, flagged

    def _append(self, flags: np.ndarray, flagged: np.ndarray, xs, ys) -> None:
        """The flagged studies' appends, shard by shard: one upload and one
        `append_stacked` for each shard that holds a flagged study."""
        for s in flagged:
            self._alpha_kept.pop(int(s), None)
        for sh in self._shards:
            sl = sh.span
            local = flagged[(flagged >= sl.start) & (flagged < sl.stop)] \
                - sl.start
            if local.size:
                f, x, y = self._upload(sh.home, flags[sl], xs[sl], ys[sl])
                gp_mod.append_stacked(sh.state, sh.kernel, x, y, f, local,
                                      self._n_host[sl])
                self._wrote(sh, local)
        self._n_host[flagged] += 1
        self._sr_host[flagged] += 1

    def absorb(self, study: int, x, y, cost: float = 1.0) -> None:
        """Routed absorb of one observation (+ the study's lag policy): the
        stacked append on that study's rows alone."""
        self._gp_tier(study)
        gp_mod.ensure_capacity(self.n(study), self.cfg.n_max)
        self._cost_host[study, self.n(study)] = cost
        self._alpha_kept.pop(study, None)
        sh, i = self._at(study)
        x = x[None] if isinstance(x, Tensor) else np.asarray(x)[None]
        f, xs, ys = self._upload(sh.home, np.ones(1, bool), x, [y])
        gp_mod.append_stacked(gp_mod.lanes(sh.state, slice(i, i + 1)),
                              self._kernel_for(slice(study, study + 1)),
                              xs, ys, f, [0], [self.n(study)])
        self._wrote(sh, i)
        self._n_host[study] += 1
        self._sr_host[study] += 1
        self._refit_flagged([study])

    def absorb_round(self, flags, xs, ys, costs=None) -> None:
        """Masked batched absorb: at most one new observation per study.

        `flags (S,)` bool selects the studies that append; `xs (S, d)` /
        `ys (S,)` carry the observations (ignored where the flag is off);
        `xs` may be a tensor on the engine's device, which is not copied
        back.  `costs (S,)` (optional) records each flagged observation's
        cost.
        """
        flags, flagged = self._admit(flags, costs)
        self._append(flags, flagged, xs, ys)
        self._refit_flagged(flagged)

    def advance(self, flags, xs, ys, top_t: int = 1, costs=None, *,
                seeds=None, jitter=None) -> tuple[Tensor, Tensor]:
        """The serving round: the masked absorb of `absorb_round`, then a
        suggestion for EVERY study from the updated posteriors,
        ((S, top_t, d), (S, top_t)); then the lag policy of the flagged
        studies.  Reads nothing back from the device unless a lag event
        is due (or top_t > 1, whose dedup copies one mask to the host)."""
        flags, flagged = self._admit(flags, costs)
        self._append(flags, flagged, xs, ys)
        units, vals = self.suggest_all(top_t, seeds=seeds, jitter=jitter)
        self._refit_flagged(flagged)
        return units, vals

    # -- fantasy protocol (q-suggestion serving, DESIGN.md §12) -------------
    @property
    def liar(self) -> str:
        """The fantasy liar (`cfg.fantasy`), read at each call."""
        return getattr(self.cfg, "fantasy", gp_mod.FantasyConfig()).liar

    def _keep_alpha(self, study: int) -> None:
        """Copy the slot's alpha before its first fantasy row on top of
        real rows (once: later fantasy rows sit on fantasy rows)."""
        if study not in self._alpha_kept:
            sh, i = self._at(study)
            self._alpha_kept[study] = (self.n(study),
                                       sh.state.alpha[i].clone())

    def _set_n(self, study: int, count: int) -> None:
        """The slot's count on the host mirror and on the device (a fill
        kernel: no copy from the host, no read back); the last write of
        every fantasy call, so the slot's replicas follow here."""
        sh, i = self._at(study)
        self._n_host[study] = count
        sh.state.n[i].fill_(count)
        self._wrote(sh, i)

    def ask_q(self, study: int, q: int, *, seeds=None,
              jitter=None) -> tuple[Tensor, Tensor]:
        """q suggestions for one slot: ((q, d) points, (q,) acq values).

        q rounds of suggest-then-fantasize (`acquisition.suggest_q`) on the
        slot's rows, which keep the q fantasy rows: the slot's host and
        device counts grow by q, and the caller rolls the rows back
        (`truncate_slot`) before any real append lands.  Capacity is
        checked before anything is written.  Draws: `seeds (q, R, d)` /
        `jitter (q, 1, d)` when given, else the engine's generator.
        """
        if q < 1:
            raise ValueError(f"q must be >= 1, got {q}")
        gp_mod.ensure_capacity(self.n(study), self.cfg.n_max, q)
        self._keep_alpha(study)
        sh = self._at(study)[0]
        xs, vals, _ = acq_mod.suggest_q(
            self._lane(study), self._kernel_for(study), sh.lo, sh.hi,
            self.cfg.acq, q, liar=self.liar, generator=self._gen,
            seeds=self._tensor(seeds), jitter=self._tensor(jitter),
            desc=self._desc_for(study), in_place=True)
        self._set_n(study, self.n(study) + q)
        return xs, vals

    def truncate_slot(self, study: int, n_real: int) -> None:
        """Roll slot `study` back to its first `n_real` rows (re-padding,
        `gp.truncate`).  Back to the count it had before its first fantasy
        row, alpha is the copy kept then, so every leaf of the slot is
        restored bit for bit; to any other count alpha is recomputed."""
        n_real = int(n_real)
        if not 0 <= n_real <= self.n(study):
            raise ValueError(f"truncate to {n_real} rows: slot {study} "
                             f"holds {self.n(study)}")
        alpha = None
        kept = self._alpha_kept.get(study)
        if kept is not None and n_real <= kept[0]:
            del self._alpha_kept[study]
            if n_real == kept[0]:
                alpha = kept[1]
        gp_mod.truncate(self._lane(study), n_real, in_place=True, alpha=alpha)
        self._set_n(study, n_real)

    def refantasize(self, study: int, xs) -> None:
        """Append pending fantasy points `xs (p, d)` to one slot in one
        `gp.fantasize` call (the tell-time replay: after `truncate_slot`
        and the real absorb, the liar values are taken against the updated
        posterior).  Capacity is checked first."""
        xs = self._tensor(xs, self._at(study)[0].home)
        if xs.shape[0] == 0:
            return
        gp_mod.ensure_capacity(self.n(study), self.cfg.n_max, xs.shape[0])
        self._keep_alpha(study)
        gp_mod.fantasize(self._lane(study), self._kernel_for(study), xs,
                         self.liar, in_place=True)
        self._set_n(study, self.n(study) + xs.shape[0])

    def cost_row(self, study: int) -> np.ndarray:
        """The study's per-row tell costs (they ride eviction snapshots, so
        a study promoted after a restore trains its cost head on all of
        its rows)."""
        return self._cost_host[study].copy()

    def set_cost_row(self, study: int, costs) -> None:
        self._cost_host[study] = np.asarray(costs, np.float32)

    # -- neural-basis tier (saturation escalation, DESIGN.md §15) -----------
    def tier(self, study: int) -> int:
        """0 = lazy GP, 1 = neural basis (escalated)."""
        return int(self._tier[study])

    def _gp_tier(self, study: int) -> None:
        """An absorb into the GP lane of an escalated slot would write the
        frozen lane: refuse it before anything is written."""
        if self._tier[study]:
            raise RuntimeError(f"slot {study} is escalated: absorb through "
                               f"nb_absorb, and leave its flag off")

    def promote_slot(self, slot: int, *, params=None) -> None:
        """Escalate a (saturated) GP slot to the neural-basis tier.

        The model trains on the slot's active rows, the exact points and
        observations its GP absorbed (read on the device, not through the
        host), and log(max(cost, 1e-12)) of their tell costs; the caller
        must have rolled back any fantasy rows first.  The MLP starts from
        `params` (`nb_init`) when given, else from the engine's generator.
        The GP lane stays in the stack, frozen; the model lives on the
        slot's home device."""
        if self._tier[slot]:
            raise RuntimeError(f"slot {slot} is already escalated")
        n0 = self.n(slot)
        if n0 < 1:
            raise RuntimeError("cannot promote an empty slot")
        lane = self._lane(slot)
        logcs = np.log(np.maximum(self._cost_host[slot, :n0], 1e-12))
        self._nb[slot] = nb_mod.nb_from_data(
            lane.x_buf[:n0], lane.y_buf[:n0], logcs, self.neural,
            params=params, generator=self._gen, device=self._at(slot)[0].home)
        self._tier[slot] = 1
        self._nb_n[slot], self._nb_sr[slot] = n0, 0
        self._nb_shadow.pop(slot, None)

    def clear_nb_slot(self, slot: int) -> None:
        """Drop the escalated model (new tenant, detach): back to tier 0,
        costs 1.0."""
        self._tier[slot] = 0
        for held in (self._nb, self._nb_n, self._nb_sr, self._nb_shadow):
            held.pop(slot, None)
        self._cost_host[slot] = 1.0

    def nb_state(self, slot: int) -> nb_mod.NeuralBasisState:
        return self._nb[slot]

    def load_nb_slot(self, slot: int, state: nb_mod.NeuralBasisState
                     ) -> None:
        """Install a restored or imported state (the tier tag follows), on
        the slot's home device; its counters are read once, to set the host
        mirrors."""
        home = self._at(slot)[0].home
        if mesh_mod.physical(state.device) != mesh_mod.physical(home):
            state = dataclasses.replace(state, **{
                f.name: getattr(state, f.name).to(home)
                for f in dataclasses.fields(state)
                if isinstance(getattr(state, f.name), Tensor)})
        self._tier[slot] = 1
        self._nb[slot] = state
        self._nb_n[slot] = int(state.n)
        self._nb_sr[slot] = int(state.since_refit)
        self._nb_shadow.pop(slot, None)

    def nb_n(self, slot: int) -> int:
        """Rows of an escalated slot, fantasy rows included (host mirror)."""
        return self._nb_n[slot]

    def _nb_room(self, slot: int, incoming: int) -> nb_mod.NeuralBasisState:
        """The slot's state with room for `incoming` more rows."""
        st = self._nb[slot]
        while self._nb_n[slot] + incoming > st.cap:
            st = nb_mod.nb_grow(st, self.neural)
        return st

    def _nb_advance(self, slot: int, st: nb_mod.NeuralBasisState,
                    rows: int) -> None:
        self._nb[slot] = st
        self._nb_n[slot] += rows
        self._nb_sr[slot] += rows

    def nb_absorb(self, slot: int, x, y, cost: float = 1.0) -> None:
        """Escalated absorb: the rank-1 append (the ledger grows, never
        fills), then an MLP refit when `refit_every` appends have gathered
        (decided on the host mirror).  Runs with no fantasy rows out (the
        caller rolls back first, as on the GP tier).  A host x, y and the
        log cost go to the device in one copy; an x already on the device
        stays there."""
        st = self._nb_room(slot, 1)
        on_device = isinstance(x, Tensor)
        packed = np.empty(2 if on_device else self.dim + 2, np.float32)
        if not on_device:
            packed[:self.dim] = x
        packed[-2:] = y, np.log(max(float(cost), 1e-12))
        obs = torch.from_numpy(packed).to(st.device, non_blocking=True)
        x = (x.to(st.device, torch.float32) if on_device
             else obs[:self.dim])
        st = nb_mod.nb_append(st, x, obs[-2], obs[-1], self.neural)
        self._nb_advance(slot, st, 1)
        if self._nb_sr[slot] >= self.neural.refit_every:
            self._nb[slot] = nb_mod.nb_refit(st, self.neural)
            self._nb_sr[slot] = 0

    def nb_suggest(self, slot: int, top_t: int = 1, *, seeds=None,
                   jitter=None) -> tuple[Tensor, Tensor]:
        """Escalated suggest: the ascent against the O(m^2) posterior, flat
        in n; draws as `suggest`."""
        return nb_mod.nb_suggest(
            self._nb[slot], self._desc_for(slot), acq=self.cfg.acq,
            top_t=top_t, seeds=self._tensor(seeds),
            jitter=self._tensor(jitter), generator=self._gen)

    def _nb_snapshot(self, slot: int) -> tuple:
        return self._nb[slot], self._nb_n[slot], self._nb_sr[slot]

    def nb_ask_q(self, slot: int, q: int, *, seeds=None,
                 jitter=None) -> tuple[Tensor, Tensor]:
        """Escalated q-suggestion: a snapshot of the pre-fantasy state
        (kept until `nb_rollback`), then q rounds of suggest-and-fantasize;
        draws as `ask_q`."""
        if slot not in self._nb_shadow:
            self._nb_shadow[slot] = self._nb_snapshot(slot)
        st = self._nb_room(slot, q)
        xs, vals, st = nb_mod.nb_ask_q(
            st, self.neural, self._desc_for(slot), acq=self.cfg.acq, q=q,
            liar=self.liar, seeds=self._tensor(seeds),
            jitter=self._tensor(jitter), generator=self._gen)
        self._nb_advance(slot, st, q)
        return xs, vals

    def nb_rollback(self, slot: int) -> None:
        """Drop every fantasy row of an escalated slot: the pre-fantasy
        snapshot comes back, bit for bit by construction."""
        kept = self._nb_shadow.pop(slot, None)
        if kept is not None:
            self._nb[slot], self._nb_n[slot], self._nb_sr[slot] = kept

    def nb_refantasize(self, slot: int, xs) -> None:
        """Append still-pending fantasy points `xs (p, d)` against the
        updated posterior (the tell-time replay, as `refantasize`), after a
        fresh snapshot."""
        xs = self._tensor(xs, self._nb[slot].device)
        self._nb_shadow[slot] = self._nb_snapshot(slot)
        st = self._nb_room(slot, xs.shape[0])
        st = nb_mod.nb_fantasize(st, xs, self.neural, self.liar)
        self._nb_advance(slot, st, xs.shape[0])

    # -- lag policy -----------------------------------------------------------
    def _refit_flagged(self, flagged) -> None:
        """Apply the per-study lag policy after an absorb (host mirrors).

        lag > 0: grid refit of the kernel params + refactor every `lag`
        appends.  lag <= 0 (the paper's fully lazy mode): no param refit,
        but every `inv_refresh` appends the factor and its maintained
        inverse are rebuilt from the Gram under the current params,
        re-anchoring the float32 drift of the bordered updates (DESIGN.md
        §4).  One study at a time, through the single-study path.
        """
        lag = self.cfg.lag
        inv_refresh = getattr(self.cfg, "inv_refresh", 0)
        if lag <= 0 and inv_refresh <= 0:
            return
        for s in flagged:
            if lag > 0:
                if self.since_refit(s) >= lag:
                    self._refactor(int(s), refit=True)
            elif self.since_refit(s) >= inv_refresh:
                self._refactor(int(s), refit=False)

    def _refactor(self, study: int, *, refit: bool) -> None:
        sh, i = self._at(study)
        st, kern = self._lane(study), self._kernel_for(study)
        params = gp_mod.refit_params(st, kern) if refit else None
        gp_mod.write_study(sh.state, i, gp_mod.refactor(st, kern, params))
        self._wrote(sh, i)
        self._sr_host[study] = 0
