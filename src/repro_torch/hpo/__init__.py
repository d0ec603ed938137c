"""Hyper-parameter optimization surfaces (counterpart of `repro.hpo`).

  * `space.py`     — typed search spaces over the encoded unit cube and
    their `TypeDescriptor` (the mixed-space slice);
  * `engine.py`    — `StudyEngine`, the stacked lazy-GP state of S studies
    and its batched suggest / absorb / serving round, shard by shard on a
    mesh, the fantasy protocol and the neural-basis escalation tier;
  * `mesh.py`      — the (study x restart) mesh of logical devices;
  * `pool.py`      — `SchedulerConfig` and `StudyPool`, S studies with
    their ledgers, random streams, fault policy and checkpoints over one
    engine;
  * `scheduler.py` — `TrialScheduler`, the objective loop over a one-study
    pool;
  * `gateway.py`   — `GatewayConfig` and `StudyGateway`, the asyncio
    ask/tell front end: coalesced (and pipelined) ticks over one pool, LRU
    eviction and restore of more logical studies than slots, admission
    control, escalation, q-asks and whole-gateway checkpoints;
  * `federation.py` — `FederatedGateway`, N gateway shards in one process
    behind one global study id space (rendezvous routing, migration,
    registry epochs, shard kill / revive);
  * `transport.py` / `shard_worker.py` — `TransportFederation`, the same
    federation over one shard worker process each, length-prefixed JSON
    frames on a socket (`ShardServer`, `ShardClient`).
"""
from repro_torch.hpo.federation import (FederatedGateway, FederationBase,
                                        FederationConfig, rendezvous_shard)
from repro_torch.hpo.gateway import GatewayConfig, StudyGateway
from repro_torch.hpo.pool import SchedulerConfig, StudyPool, Trial
from repro_torch.hpo.scheduler import TrialScheduler
from repro_torch.hpo.transport import (ShardClient, ShardConnectionError,
                                       ShardServer, TransportConfig,
                                       TransportError, TransportFederation)

__all__ = ["FederatedGateway", "FederationBase", "FederationConfig",
           "GatewayConfig", "SchedulerConfig", "ShardClient",
           "ShardConnectionError", "ShardServer", "StudyGateway",
           "StudyPool", "TransportConfig", "TransportError",
           "TransportFederation", "Trial", "TrialScheduler",
           "rendezvous_shard"]
