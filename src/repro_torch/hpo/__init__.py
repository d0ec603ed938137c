"""Hyper-parameter optimization surfaces (counterpart of `repro.hpo`).

  * `space.py`  — typed search spaces over the encoded unit cube and their
    `TypeDescriptor` (the mixed-space slice);
  * `engine.py` — `StudyEngine`, the stacked lazy-GP state of S studies
    and its batched suggest / absorb / serving round (`mesh="none"`), the
    fantasy protocol and the neural-basis escalation tier;
  * `mesh.py`   — the mesh spec (only the unsharded engine runs so far);
  * `pool.py`   — `SchedulerConfig`, the engine's configuration (with
    its `NeuralConfig`).
The pool, scheduler and gateway come with later slices.
"""
