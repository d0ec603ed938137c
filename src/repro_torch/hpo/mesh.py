"""Device-mesh spec of the HPO stack (counterpart of `repro/hpo/mesh.py`).

The reference maps the stacked engine's (study x restart) axes onto a
`jax.sharding.Mesh` (DESIGN.md §8).  The port runs the unsharded case for
now: `"none"`, and `"auto"` on one device, both give no mesh, the single
program on one card.  Any spec that needs more than one device raises
`NotImplementedError` until the mesh itself is ported (ROADMAP.md, "the
study x restart mesh": the study x restart split across CUDA devices).
"""
from __future__ import annotations


def parse_spec(spec: str) -> tuple[int, int] | str | None:
    """``"none"`` -> None, ``"auto"`` -> "auto", ``"SxR"``/``"S"`` -> ints."""
    s = (spec or "none").strip().lower()
    if s in ("none", ""):
        return None
    if s == "auto":
        return "auto"
    parts = s.split("x")
    try:
        if len(parts) == 1:
            return int(parts[0]), 1
        if len(parts) == 2:
            return int(parts[0]), int(parts[1])
    except ValueError:
        pass
    raise ValueError(
        f"bad mesh spec {spec!r}: expected 'none', 'auto', 'S' or 'SxR' "
        "(study shards x restart shards, e.g. '4x2')")


def build(spec: str, n_studies: int, restarts: int, devices: int = 1) -> None:
    """Resolve a mesh spec against `devices` visible devices: None (the
    unsharded single program) for "none", and for "auto" on one device;
    any other spec raises NotImplementedError."""
    del n_studies, restarts     # the shard counts' divisors, once sharded
    parsed = parse_spec(spec)
    if parsed is None or (parsed == "auto" and devices <= 1):
        return None
    raise NotImplementedError(
        f"mesh {spec!r} over {devices} device(s): the port runs the "
        f"unsharded engine only (mesh='none'); see ROADMAP.md, \"the "
        f"study x restart mesh\"")
