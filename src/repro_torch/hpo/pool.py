"""Shared configuration of the study engine and, in a later slice, the pool
(counterpart of `repro/hpo/pool.py`).

Only `SchedulerConfig` is here so far: the `StudyEngine`
(`repro_torch.hpo.engine`) reads its GP shape, lag policy, acquisition
settings, fantasy liar, neural-basis tier and seed.  The reference's
`implementation` knob has no counterpart (the tensor's device picks a
kernel or its plain version).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import acquisition as acq_mod
from repro_torch.core import gp as gp_mod
from repro_torch.core import neural_basis as nb_mod


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
    # §8); the port runs "none" ("auto" on one device), see `hpo/mesh.py`
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
