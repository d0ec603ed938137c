"""Hyper-parameter optimization surfaces (counterpart of `repro.hpo`).

  * `space.py`     — typed search spaces over the encoded unit cube and
    their `TypeDescriptor` (the mixed-space slice);
  * `engine.py`    — `StudyEngine`, the stacked lazy-GP state of S studies
    and its batched suggest / absorb / serving round (`mesh="none"`), the
    fantasy protocol and the neural-basis escalation tier;
  * `mesh.py`      — the mesh spec (only the unsharded engine runs so far);
  * `pool.py`      — `SchedulerConfig` and `StudyPool`, S studies with
    their ledgers, random streams, fault policy and checkpoints over one
    engine;
  * `scheduler.py` — `TrialScheduler`, the objective loop over a one-study
    pool;
  * `gateway.py`   — `GatewayConfig` and `StudyGateway`, the asyncio
    ask/tell front end: coalesced (and pipelined) ticks over one pool, LRU
    eviction and restore of more logical studies than slots, admission
    control, escalation, q-asks and whole-gateway checkpoints.
The federation and transport come with later slices.
"""
from repro_torch.hpo.gateway import GatewayConfig, StudyGateway
from repro_torch.hpo.pool import SchedulerConfig, StudyPool, Trial
from repro_torch.hpo.scheduler import TrialScheduler

__all__ = ["GatewayConfig", "SchedulerConfig", "StudyGateway", "StudyPool",
           "Trial", "TrialScheduler"]
