"""Multi-pool federation: N StudyGateway shards behind one front end
(counterpart of `repro/hpo/federation.py`).

`FederatedGateway` is the horizontal-scaling layer of the serving stack
(DESIGN.md §13).  Each shard is a full `StudyGateway` + `StudyPool` with
its own slots, ticker, and checkpoint store under `<root>/shard-<i>/`; the
front end owns the GLOBAL study id space and routes every ask/tell to the
shard that currently holds the study:

  * **routing** — rendezvous (highest-random-weight) hashing over
    `sha256(f"{shard}:{sid}")`: deterministic across processes (no
    PYTHONHASHSEED dependence), stable under a fixed shard count, and
    minimal-movement if the count ever changes.  The same ring as the
    reference's, so both packages place every sid on the same shard.
  * **single-pool equivalence** — shards seed per-study random streams by
    GLOBAL sid (`create_study(sid=...)`), and a study's suggestions depend
    only on its own absorbed rows + its own stream, so WHERE a study is
    routed never changes WHAT it is suggested: a federation serves every
    study the same suggestions as one big pool given the same per-study
    event order.
  * **migration** — built on the bitwise-exact eviction snapshots:
    quiesce + evict on the source (committed snapshot at version v), copy
    that one version to the destination store
    (`checkpoint.copy_study_version`, atomic COMMITTED-last publish),
    adopt the registry record there, then detach from the source.  Any
    fault before the detach leaves the study fully intact on its source
    shard — all-or-nothing.  `rebalance()` applies the same move to drain
    a saturated shard.
  * **epochs** — `checkpoint()` writes the federation registry (placement
    map + a fallback record per study) as its own committed epoch under
    `<root>/fed/` FIRST, then checkpoints each shard.  Shards crash and
    restore independently from their own latest epoch;
    `revive_shard`/`restore` reconcile a restored shard against the
    federation registry — studies the shard forgot are re-adopted from the
    fallback records, studies it no longer owns are expelled.  Committed
    observations survive; uncommitted ones are lost, never replayed.  The
    registry is the reference's (`ckpt_mod.save` metadata key
    "federation", the same JSON payload), so a federation root written by
    either package restores in the other.

The routing/registry/reconcile core lives in `FederationBase` and is
shared with `repro_torch.hpo.transport.TransportFederation`, which applies
it over a socket RPC connection per shard process (DESIGN.md §14).  In
this module every shard's ticker shares one event loop and one Python
thread; on the card the shards also share one stream, and each staged
round waits on its own event (`pool.advance_round_begin`).  Shards are
only touched through the public `StudyGateway` federation surface.
"""
from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import json
import os

import torch

from repro_torch import checkpoint as ckpt_mod
from repro_torch.hpo.gateway import GatewayConfig, StudyGateway
from repro_torch.hpo.pool import SchedulerConfig, Trial
from repro_torch.hpo.space import SearchSpace

__all__ = ["FederationConfig", "FederationBase", "FederatedGateway",
           "rendezvous_shard"]


def rendezvous_shard(sid: int, n_shards: int) -> int:
    """Rendezvous (HRW) ring position of study `sid` over `n_shards`."""
    best, best_w = 0, b""
    for shard in range(n_shards):
        w = hashlib.sha256(f"{shard}:{sid}".encode()).digest()
        if w > best_w:
            best, best_w = shard, w
    return best


@dataclasses.dataclass(frozen=True)
class FederationConfig:
    """Federation-level knobs (each shard's shape comes from the shared
    SchedulerConfig/GatewayConfig)."""

    n_shards: int = 2
    ckpt_dir: str | None = None  # federation root; shard i stores under
    # <root>/shard-<i>/, the federation registry under <root>/fed/.
    # None = SchedulerConfig.ckpt_dir is the root.


class FederationBase:
    """Routing + registry + reconcile core of a shard federation.

    Owns everything that is a pure function of the front end's own state:
    the global sid space, the placement map, the fallback records, the
    epoch registry payload (build/parse/validate), and the reconcile plan
    for a restored shard.  Subclasses apply the plans to their shards —
    `FederatedGateway` with in-memory method calls, `TransportFederation`
    with socket RPCs — so the two deployments can never drift on routing
    or recovery semantics.
    """

    def __init__(self, template_space: SearchSpace, cfg: SchedulerConfig,
                 gw: GatewayConfig | None = None,
                 fed: FederationConfig | None = None):
        self.fed = fed or FederationConfig()
        if self.fed.n_shards < 1:
            raise ValueError("FederationConfig.n_shards must be >= 1")
        root = self.fed.ckpt_dir or cfg.ckpt_dir
        if root is None:
            raise ValueError(
                "a federation needs a checkpoint root "
                "(FederationConfig.ckpt_dir or SchedulerConfig.ckpt_dir)")
        self._root = root
        self._fed_dir = os.path.join(root, "fed")
        self._template_space = template_space
        self.cfg = cfg
        self.gw = gw or GatewayConfig()
        self._placement: dict[int, int] = {}   # sid -> shard index
        self._records: dict[int, dict] = {}    # last-known fallback record
        # per study (kept fresh at checkpoint; serves studies whose shard
        # is dead when the next epoch is written)
        self._closed_sids: set[int] = set()
        self._next_sid = 0
        self._epoch = 0

    # -- routing ------------------------------------------------------------
    def route(self, sid: int) -> int:
        """Ring position of a study: rendezvous hash over the shard set."""
        return rendezvous_shard(sid, self.fed.n_shards)

    def shard_of(self, sid: int) -> int:
        """Current placement (ring position unless migrated)."""
        if sid in self._closed_sids:
            raise RuntimeError(f"study {sid} is closed")
        if sid not in self._placement:
            raise KeyError(f"unknown study id {sid}")
        return self._placement[sid]

    def shard_dir(self, i: int) -> str:
        """Shard i's checkpoint store under the shared federation root."""
        return os.path.join(self._root, f"shard-{i}")

    def study_ids(self) -> list[int]:
        return sorted(self._placement)

    # -- the epoch registry (build / persist / parse) -----------------------
    def _registry_payload(self, records: dict[int, dict]) -> dict:
        """Federation registry payload: placement + one fallback record
        per study so a shard restored from an older epoch can re-adopt
        studies it forgot."""
        return {
            "epoch": self._epoch,
            "n_shards": self.fed.n_shards,
            "next_sid": self._next_sid,
            "closed_sids": sorted(self._closed_sids),
            "placement": {str(s): sh for s, sh in
                          sorted(self._placement.items())},
            "records": {str(s): r for s, r in sorted(records.items())},
        }

    def _save_epoch(self, records: dict[int, dict]) -> int:
        """Commit epoch N of the federation registry under `<root>/fed/`.
        Must be written BEFORE the shard checkpoints (it may never
        reference shard state newer than itself)."""
        self._epoch += 1
        self._records.update(records)
        ckpt_mod.save(self._fed_dir, self._epoch, {},
                      metadata={"federation":
                                json.dumps(self._registry_payload(records))},
                      keep=3)
        return self._epoch

    def _load_epoch(self) -> bool:
        """Parse the latest committed federation epoch into the front
        end's bookkeeping; False when none exists.

        Fails fast when the recorded shard count disagrees with the live
        `FederationConfig`: with FEWER live shards, placements recorded on
        the missing shards would strand every routed call on an
        out-of-range index; with MORE, `route()` sends NEW sids onto
        shards the old placements know nothing about while existing
        studies stay put — two silently different topologies.  Resizing a
        federation is a migration (move the studies, then re-checkpoint),
        not a restore-time reinterpretation.
        """
        out = ckpt_mod.restore_latest(self._fed_dir, {})
        if out is None:
            return False
        _epoch, _tree, meta = out
        reg = json.loads(meta["federation"])
        saved_shards = int(reg["n_shards"])
        if saved_shards != self.fed.n_shards:
            raise ValueError(
                f"federation registry under {self._fed_dir} was written "
                f"with n_shards={saved_shards} but the live "
                f"FederationConfig has n_shards={self.fed.n_shards}; "
                "restore with the recorded shard count (resizing is a "
                "migration, not a restore)")
        self._epoch = int(reg["epoch"])
        self._next_sid = int(reg["next_sid"])
        self._closed_sids = set(int(s) for s in reg["closed_sids"])
        self._placement = {int(s): int(sh)
                           for s, sh in reg["placement"].items()}
        self._records = {int(s): r for s, r in reg["records"].items()}
        return True

    def _merge_summaries(self, per_shard: dict[int, dict],
                         dead: list[int]) -> dict:
        """Federation-wide telemetry from per-shard summaries: lifetime
        counters summed, q-width histograms merged."""
        out = {"ticks": 0, "asks_served": 0, "absorbed": 0,
               "evictions": 0, "restores": 0, "fantasy_rollbacks": 0,
               "fantasy_active": 0, "escalated": 0, "saturated": 0,
               "q_width_hist": {},
               "n_shards": self.fed.n_shards,
               "dead_shards": sorted(dead),
               "studies": len(self._placement),
               "epoch": self._epoch}
        for i in sorted(per_shard):
            s = per_shard[i]
            for k in ("ticks", "asks_served", "absorbed", "evictions",
                      "restores", "fantasy_rollbacks", "fantasy_active"):
                out[k] += s[k]
            for k in ("escalated", "saturated"):
                # saturation gauges (DESIGN.md §15); .get so a newer front
                # end keeps merging summaries from an older remote shard
                out[k] += s.get(k, 0)
            for w, n in s["q_width_hist"].items():
                out["q_width_hist"][w] = out["q_width_hist"].get(w, 0) + n
        out["per_shard"] = {str(i): s for i, s in sorted(per_shard.items())}
        return out

    # -- reconcile planning -------------------------------------------------
    def _reconcile_plan(self, i: int, present: set[int]
                        ) -> tuple[list[int], list[int]]:
        """What a just-restored shard `i` must change, given the study ids
        `present` in its restored registry: (expel, missing) — `expel` are
        studies it no longer owns (closed or migrated away on a timeline
        it lost), `missing` are studies the federation placed on it after
        its epoch (re-adopt from the fallback record, or recreate empty
        when none exists — same seed law as create_study)."""
        owned = {sid for sid, shard in self._placement.items()
                 if shard == i}
        return sorted(present - owned), sorted(owned - present)


class FederatedGateway(FederationBase):
    """Route one global study population across N in-process StudyGateway
    shards — the single-process degenerate case of the federation (every
    shard ticker shares this process's event loop), on the card unless
    `device` says otherwise; the cross-process deployment is
    `repro_torch.hpo.transport.TransportFederation` over the same core."""

    def __init__(self, template_space: SearchSpace, cfg: SchedulerConfig,
                 gw: GatewayConfig | None = None,
                 fed: FederationConfig | None = None, *,
                 device: str | torch.device = "cuda"):
        super().__init__(template_space, cfg, gw, fed)
        self.device = device
        self.shards: list[StudyGateway | None] = [
            self._build_shard(i) for i in range(self.fed.n_shards)]

    def _build_shard(self, i: int) -> StudyGateway:
        cfg = dataclasses.replace(self.cfg, ckpt_dir=self.shard_dir(i))
        return StudyGateway(self._template_space, cfg, self.gw,
                            device=self.device)

    def _live(self, i: int) -> StudyGateway:
        gw = self.shards[i]
        if gw is None:
            raise RuntimeError(f"shard {i} is down (kill_shard); "
                               "revive_shard to restore it from its epoch")
        return gw

    def _gw_for(self, sid: int) -> StudyGateway:
        return self._live(self.shard_of(sid))

    def _live_shards(self) -> list[tuple[int, StudyGateway]]:
        return [(i, gw) for i, gw in enumerate(self.shards)
                if gw is not None]

    # -- lifecycle ----------------------------------------------------------
    def create_study(self, space: SearchSpace | None = None,
                     name: str | None = None) -> int:
        """Register a study on its ring shard; global sids keep per-study
        suggestion streams identical to a single pool's."""
        sid = self._next_sid
        shard = self.route(sid)
        self._live(shard).create_study(space, name, sid=sid)
        self._next_sid = sid + 1
        self._placement[sid] = shard
        return sid

    def close_study(self, sid: int) -> None:
        self._gw_for(sid).close_study(sid)
        self._placement.pop(sid, None)
        self._records.pop(sid, None)
        self._closed_sids.add(sid)

    # -- ask / tell ---------------------------------------------------------
    async def ask(self, sid: int, q: int = 1) -> Trial | list[Trial]:
        """Routed ask; admission (queue depth, per-study in-flight cap,
        n_max headroom, q-width) is enforced by the owning shard."""
        return await self._gw_for(sid).ask(sid, q)

    def ask_nowait(self, sid: int, q: int = 1) -> None:
        self._gw_for(sid).ask_nowait(sid, q)

    def tell(self, sid: int, trial: Trial, value: float,
             cost: float = 1.0) -> None:
        self._gw_for(sid).tell(sid, trial, value, cost)

    def tell_failure(self, sid: int, trial: Trial, error: str) -> None:
        self._gw_for(sid).tell_failure(sid, trial, error)

    async def drain(self) -> None:
        await asyncio.gather(*(gw.drain() for _i, gw in
                               self._live_shards()))

    def tick(self) -> int:
        """Drive one synchronous tick on every live shard (tests/sync
        callers; the asyncio path runs each shard's own ticker)."""
        return sum(gw.tick() for _i, gw in self._live_shards())

    async def aclose(self) -> None:
        for _i, gw in self._live_shards():
            await gw.aclose()

    # -- introspection ------------------------------------------------------
    def study_info(self, sid: int) -> dict:
        info = self._gw_for(sid).study_info(sid)
        info["shard"] = self.shard_of(sid)
        return info

    def summary(self) -> dict:
        """Federation-wide telemetry: lifetime counters summed across live
        shards, q-width histograms merged, plus the per-shard summaries."""
        return self._merge_summaries(
            {i: gw.summary() for i, gw in self._live_shards()},
            [i for i, gw in enumerate(self.shards) if gw is None])

    # -- migration / rebalancing --------------------------------------------
    def migrate_study(self, sid: int, dst: int) -> None:
        """Move one quiescent study to shard `dst` — evict-here /
        restore-there on the bitwise-exact snapshot machinery.

        All-or-nothing: export evicts on the source (the snapshot commits
        in the source store), the copy publishes atomically on the
        destination, adoption refuses unless the copied version is
        committed — any fault up to the final detach leaves the study
        intact (and restorable) on its source shard.  The snapshot carries
        the study's generator state, so its stream goes on unbroken."""
        src = self.shard_of(sid)
        if dst == src:
            return
        src_gw, dst_gw = self._live(src), self._live(dst)
        record = src_gw.export_for_migration(sid)
        if record["evicted_ever"]:
            ckpt_mod.copy_study_version(src_gw.cfg.ckpt_dir,
                                        dst_gw.cfg.ckpt_dir,
                                        record["key"], record["version"])
        dst_gw.adopt_study(record)
        src_gw.detach_study(sid)
        self._placement[sid] = dst
        self._records[sid] = dict(record, shard=dst)

    def rebalance(self) -> list[tuple[int, int, int]]:
        """Even out study counts across live shards by migrating quiescent
        studies from the fullest shard to the emptiest (lowest sid first —
        deterministic).  Returns the moves as (sid, src, dst)."""
        moves: list[tuple[int, int, int]] = []
        live = [i for i, gw in enumerate(self.shards) if gw is not None]
        if len(live) < 2:
            return moves
        while True:
            counts = {i: sum(1 for s in self._placement.values() if s == i)
                      for i in live}
            src = max(live, key=lambda i: (counts[i], i))
            dst = min(live, key=lambda i: (counts[i], i))
            if counts[src] - counts[dst] <= 1:
                return moves
            movable = sorted(
                sid for sid, s in self._placement.items()
                if s == src and self.shards[src].is_quiescent(sid))
            if not movable:
                return moves
            sid = movable[0]
            self.migrate_study(sid, dst)
            moves.append((sid, src, dst))

    # -- epochs: checkpoint / crash / restore -------------------------------
    def _collect_records(self) -> dict[int, dict]:
        """One fallback record per placed study: fresh from its live
        shard, else the last one seen (its shard is dead right now)."""
        records: dict[int, dict] = {}
        for sid, shard in sorted(self._placement.items()):
            gw = self.shards[shard]
            if gw is not None and sid in set(gw.study_ids()):
                records[sid] = dict(gw.registry_record(sid), shard=shard)
            elif sid in self._records:
                records[sid] = self._records[sid]
        return records

    def checkpoint(self) -> int:
        """Write federation epoch N: the federation registry commits FIRST
        (it must never reference shard state newer than itself), then each
        live shard checkpoints.  A crash between the two restores shards
        from their previous epoch and reconciles against this registry —
        committed observations survive either way.  Dead shards are
        skipped (their fallback records ride the registry).  Returns the
        epoch number."""
        epoch = self._save_epoch(self._collect_records())
        for _i, gw in self._live_shards():
            gw.checkpoint()
        return epoch

    def kill_shard(self, i: int) -> None:
        """Simulate a shard crash: the in-memory gateway is discarded
        WITHOUT a checkpoint (its uncommitted work is lost, like a
        SIGKILL).  Parked clients' futures are cancelled — a real crash
        severs their connections the same way."""
        gw = self.shards[i]
        self.shards[i] = None
        if gw is not None:
            gw.abandon()

    def revive_shard(self, i: int) -> None:
        """Bring a dead shard back from ITS latest committed epoch and
        reconcile it against the federation registry: nothing pre-crash
        replays (random streams persist in the snapshots), no committed
        tell is lost, studies the shard's epoch predates are re-adopted
        from the fallback records (their uncommitted observations are
        gone), and studies it no longer owns are expelled."""
        if self.shards[i] is not None:
            raise RuntimeError(f"shard {i} is already live")
        gw = self._build_shard(i)
        gw.restore()  # False (fresh) when the shard never checkpointed
        self.shards[i] = gw
        self._reconcile_shard(i)

    def _reconcile_shard(self, i: int) -> None:
        gw = self.shards[i]
        expel, missing = self._reconcile_plan(i, set(gw.study_ids()))
        for sid in expel:
            gw.expel_study(sid)
        for sid in missing:
            rec = self._records.get(sid)
            if rec is None:
                # never checkpointed anywhere: recreate empty from the
                # global id (same seed law as create_study)
                gw.create_study(self._template_space, sid=sid)
            else:
                gw.adopt_study(rec, require_snapshot=False)
        gw.sync_registry(self._next_sid, self._closed_sids)
        # refresh fallback records from the authoritative shard registry
        for sid in gw.study_ids():
            if self._placement.get(sid) == i:
                self._records[sid] = dict(gw.registry_record(sid), shard=i)

    def restore(self) -> bool:
        """Resume the whole federation: latest federation epoch for the
        registry, each shard from ITS latest epoch, then reconcile.
        Refuses a registry whose recorded shard count differs from the
        live config (see `FederationBase._load_epoch`)."""
        if not self._load_epoch():
            return False
        self.shards = [None] * self.fed.n_shards
        for i in range(self.fed.n_shards):
            gw = self._build_shard(i)
            gw.restore()
            self.shards[i] = gw
            self._reconcile_shard(i)
        return True
