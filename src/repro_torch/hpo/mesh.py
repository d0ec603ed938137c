"""Device mesh of the HPO stack (counterpart of `repro/hpo/mesh.py`).

One suggest round is independent over two axes: the **study** axis (S
posteriors of the stacked `LazyGPState`) and the **restart** axis (R EI
ascents of each study).  The reference maps them onto a
`jax.sharding.Mesh` (DESIGN.md §8).  The port has no `shard_map` and no
`NamedSharding`: an `HPOMesh` is a plain table of logical devices that
the engine walks shard by shard.

  * axis ``"study"`` — study shard i holds lanes `lanes[i]` (a contiguous
    range of S / study_shards studies) as a stacked state of its own, on
    its home device `cell(i, 0)`.  No data crosses this axis.
  * axis ``"restart"`` — restart shard j of study shard i ascends the
    contiguous slice j of each study's R seeds on `cell(i, j)`; the finals
    are concatenated in shard order before the basin selection, as the
    reference's tiled `all_gather` reassembles them.  A restart shard on
    its study shard's physical device reads the shard's one copy of the
    state; on another device it holds a replica.

A logical device is a `torch.device`, and the list may repeat one: the
CPU tests run `["cpu"] * k`, and one card runs `["cuda:0"] * k`, whose
shards then run in order on that card's current stream.

`build(spec, n_studies, restarts, devices)` turns `SchedulerConfig.mesh`
into an `HPOMesh`, or None for the unsharded single program:

  * ``"none"``  — no mesh (the default).
  * ``"auto"``  — factor the devices into study x restart shards that
    divide S and R; None on one device.
  * ``"SxR"``   — explicit shard counts, e.g. ``"4x2"``; ``"8"`` is
    ``"8x1"``.  They must divide S and R and fit the device list.
"""
from __future__ import annotations

import dataclasses

import torch

STUDY_AXIS = "study"
RESTART_AXIS = "restart"


def _largest_divisor_leq(n: int, cap: int) -> int:
    for c in range(min(n, cap), 0, -1):
        if n % c == 0:
            return c
    return 1


def physical(dev: torch.device) -> torch.device:
    """The card a logical device names (`cuda` -> `cuda:<current>`)."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def default_devices(device_type: str) -> list[torch.device]:
    """Every visible device of the engine's type: `cuda:0..count-1`, or
    the one CPU."""
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


@dataclasses.dataclass(frozen=True)
class HPOMesh:
    """A (study x restart) table of logical devices.

    `devices` are the `study_shards * restart_shards` logical devices in
    row-major (study, restart) order; `lanes[i]` is study shard i's
    contiguous range of studies."""

    devices: tuple[torch.device, ...]
    study_shards: int
    restart_shards: int
    lanes: tuple[range, ...]

    @property
    def n_devices(self) -> int:
        return self.study_shards * self.restart_shards

    @property
    def axis_names(self) -> tuple[str, str]:
        return (STUDY_AXIS, RESTART_AXIS)

    def cell(self, study_shard: int, restart_shard: int) -> torch.device:
        """The device of one (study shard, restart shard) cell."""
        return self.devices[study_shard * self.restart_shards + restart_shard]

    def home(self, study_shard: int) -> torch.device:
        """The study shard's own device, which holds its state."""
        return self.cell(study_shard, 0)

    def row(self, study_shard: int) -> list[torch.device]:
        """The devices of the study shard's restart shards, in order."""
        return [self.cell(study_shard, j) for j in range(self.restart_shards)]


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


def build(spec: str, n_studies: int, restarts: int,
          devices=None) -> HPOMesh | None:
    """Resolve a mesh spec against the study / restart extents and a list
    of logical devices (default: every visible CUDA device, else the CPU).

    Shard counts must divide their axes exactly: a study shard owns
    S / study_shards whole studies and a restart shard ascends
    R / restart_shards whole seeds."""
    parsed = parse_spec(spec)
    if parsed is None:
        return None
    if devices is None:
        devices = default_devices(
            "cuda" if torch.cuda.is_available() else "cpu")
    devices = [torch.device(d) for d in devices]
    if parsed == "auto":
        if len(devices) <= 1:
            return None  # the unsharded path IS the one-device case
        s = _largest_divisor_leq(n_studies, len(devices))
        r = _largest_divisor_leq(restarts, len(devices) // s)
        parsed = (s, r)
    s, r = parsed
    if s < 1 or r < 1:
        raise ValueError(f"mesh shards must be >= 1, got {s}x{r}")
    if s * r > len(devices):
        raise ValueError(
            f"mesh {s}x{r} needs {s * r} devices, have {len(devices)} "
            "(a logical device may repeat: pass e.g. ['cuda:0'] * 4)")
    if n_studies % s:
        raise ValueError(
            f"study shards ({s}) must divide n_studies ({n_studies})")
    if restarts % r:
        raise ValueError(
            f"restart shards ({r}) must divide acq.restarts ({restarts})")
    per = n_studies // s
    return HPOMesh(devices=tuple(devices[:s * r]), study_shards=s,
                   restart_shards=r,
                   lanes=tuple(range(i * per, (i + 1) * per)
                               for i in range(s)))
