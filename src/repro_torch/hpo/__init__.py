"""Hyper-parameter optimization surfaces (counterpart of `repro.hpo`).

  * `space.py` — typed search spaces over the encoded unit cube and their
    `TypeDescriptor` (the mixed-space slice); the engine, pool, scheduler
    and gateway come with later slices.
"""
