"""Hyper-parameter search spaces: typed dimensions over one unit cube.

Counterpart of `repro/hpo/space.py`, host numpy like it; only `descriptor()`
differs, returning the port's `TypeDescriptor` of CPU tensors (a driver
moves it to its device).

The GP always sees the **encoded unit cube** (DESIGN.md §10): every
dimension contributes `width` unit coordinates —

  * `Float` (alias `Dim`) — one coordinate, "linear" or "log" scale (the
    paper's Sec. 4.2/4.3 domains are all Floats);
  * `Int` — one coordinate on the uniform lattice `{k / (L-1)}` for the
    L integer values `lo..hi` (linear scale);
  * `Categorical` — a one-hot block of `len(choices)` coordinates;
  * `Conditional` — wraps any of the above, active only when a parent
    `Categorical` takes a given choice; inactive children encode to the
    neutral 0-vector (the "collapse" convention, so the kernel sees no
    spurious distance between two points that both lack the child).

`SearchSpace.to_hparams` decodes an encoded unit vector to named values
(inactive conditionals decode to None); `to_unit` is the vectorized inverse
and **clamps** out-of-range values instead of extrapolating — a restored or
externally produced trial whose value sits at `hi + eps` must map to the
cube edge, not outside it.  `sample` draws *feasible* points (ints on the
lattice, exact one-hots, conditionals gated); `descriptor()` exports the
static per-coordinate `repro_torch.core.descriptor.TypeDescriptor` the mixed
kernel and the acquisition's round-and-repair projection consume.

The paper's LeNet/ResNet presets and the framework's LM space ship below.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import descriptor as desc_mod


def _clamp01(u: float) -> float:
    return min(max(float(u), 0.0), 1.0)


@dataclasses.dataclass(frozen=True)
class Dim:
    """A continuous dimension (the paper's only kind).  `Float` aliases it."""

    name: str
    lo: float
    hi: float
    scale: str = "linear"   # "linear" | "log"

    @property
    def width(self) -> int:
        return 1

    def to_value(self, u: float) -> float:
        u = _clamp01(u)
        if self.scale == "log":
            llo, lhi = math.log(self.lo), math.log(self.hi)
            return math.exp(llo + u * (lhi - llo))
        return self.lo + u * (self.hi - self.lo)

    def to_unit(self, v: float) -> float:
        # Clamp exactly like to_value: a value at hi + eps (float spill from
        # a restored/external trial) must map to the cube edge, not outside
        # it — an out-of-cube unit aborts the gateway's coalesced tell tick.
        v = min(max(float(v), self.lo), self.hi)
        if self.scale == "log":
            llo, lhi = math.log(self.lo), math.log(self.hi)
            return _clamp01((math.log(v) - llo) / (lhi - llo))
        return _clamp01((v - self.lo) / (self.hi - self.lo))

    def encode(self, v) -> np.ndarray:
        return np.asarray([self.to_unit(v)], np.float32)

    def decode(self, u: np.ndarray):
        return self.to_value(float(u[0]))


Float = Dim


@dataclasses.dataclass(frozen=True)
class Int:
    """An integer dimension `lo..hi` inclusive, encoded on the uniform unit
    lattice `{k / (L-1)}` (linear scale; L = hi - lo + 1 levels)."""

    name: str
    lo: int
    hi: int

    def __post_init__(self):
        if int(self.lo) != self.lo or int(self.hi) != self.hi:
            raise ValueError(f"Int {self.name}: bounds must be integers")
        if self.hi < self.lo:
            raise ValueError(f"Int {self.name}: hi {self.hi} < lo {self.lo}")

    @property
    def width(self) -> int:
        return 1

    @property
    def levels(self) -> int:
        return int(self.hi) - int(self.lo) + 1

    def to_value(self, u: float) -> int:
        u = _clamp01(u)
        return int(self.lo) + int(round(u * (self.levels - 1)))

    def to_unit(self, v) -> float:
        k = min(max(int(round(float(v))), int(self.lo)), int(self.hi))
        if self.levels == 1:
            return 0.0
        return (k - int(self.lo)) / (self.levels - 1)

    def encode(self, v) -> np.ndarray:
        return np.asarray([self.to_unit(v)], np.float32)

    def decode(self, u: np.ndarray) -> int:
        return self.to_value(float(u[0]))


@dataclasses.dataclass(frozen=True)
class Categorical:
    """An unordered choice, encoded one-hot (`width = len(choices)`).

    Decoding takes the argmax of the block (first index wins ties — the
    same deterministic rule as the acquisition's projection)."""

    name: str
    choices: tuple

    def __post_init__(self):
        if len(self.choices) < 2:
            raise ValueError(
                f"Categorical {self.name}: needs >= 2 choices")
        if len(set(self.choices)) != len(self.choices):
            raise ValueError(f"Categorical {self.name}: duplicate choices")
        # Choices must survive the JSON round-trip of the gateway registry
        # (a tuple choice would serialize as a list and make the committed
        # checkpoint unrestorable) — fail at construction, not at recovery.
        for c in self.choices:
            if not isinstance(c, (str, int, float, bool)):
                raise ValueError(
                    f"Categorical {self.name}: choice {c!r} is not a JSON "
                    "primitive (str/int/float/bool); composite choices "
                    "would not survive a checkpoint round-trip")

    @property
    def width(self) -> int:
        return len(self.choices)

    def encode(self, v) -> np.ndarray:
        u = np.zeros((self.width,), np.float32)
        u[self.choices.index(v)] = 1.0
        return u

    def decode(self, u: np.ndarray):
        return self.choices[int(np.argmax(u))]


@dataclasses.dataclass(frozen=True)
class Conditional:
    """A dimension active only when `parent` (a Categorical appearing
    earlier in the space) equals `when`; inactive values decode to None and
    encode to the neutral 0-vector."""

    inner: "Dim | Int | Categorical"
    parent: str
    when: object

    def __post_init__(self):
        if isinstance(self.inner, Conditional):
            raise ValueError("Conditional dims cannot nest (one-level "
                             "parent gating only)")

    @property
    def name(self) -> str:
        return self.inner.name

    @property
    def width(self) -> int:
        return self.inner.width

    def encode(self, v) -> np.ndarray:
        if v is None:
            return np.zeros((self.width,), np.float32)
        return self.inner.encode(v)

    def decode(self, u: np.ndarray):
        return self.inner.decode(u)


AnyDim = "Dim | Int | Categorical | Conditional"


# --- serialization (the gateway registry rides the pool checkpoint) --------

_DIM_TYPES = {"float": Dim, "int": Int, "categorical": Categorical,
              "conditional": Conditional}


def dim_to_dict(d) -> dict:
    """JSON-serializable form of any dim (inverse: `dim_from_dict`)."""
    if isinstance(d, Conditional):
        return {"type": "conditional", "parent": d.parent, "when": d.when,
                "inner": dim_to_dict(d.inner)}
    if isinstance(d, Categorical):
        return {"type": "categorical", "name": d.name,
                "choices": list(d.choices)}
    if isinstance(d, Int):
        return {"type": "int", "name": d.name, "lo": int(d.lo),
                "hi": int(d.hi)}
    return {"type": "float", "name": d.name, "lo": d.lo, "hi": d.hi,
            "scale": d.scale}


def dim_from_dict(rec: dict):
    """Rebuild a dim from its dict form.  Dicts without a "type" tag are
    pre-typed-space checkpoints: plain float Dims."""
    kind = rec.get("type", "float")
    if kind == "conditional":
        return Conditional(dim_from_dict(rec["inner"]), rec["parent"],
                           rec["when"])
    if kind == "categorical":
        return Categorical(rec["name"], tuple(rec["choices"]))
    if kind == "int":
        return Int(rec["name"], rec["lo"], rec["hi"])
    return Dim(rec["name"], rec["lo"], rec["hi"],
               rec.get("scale", "linear"))


def space_to_dicts(space: "SearchSpace") -> list[dict]:
    return [dim_to_dict(d) for d in space.dims]


def space_from_dicts(recs: list[dict]) -> "SearchSpace":
    return SearchSpace(tuple(dim_from_dict(r) for r in recs))


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    dims: tuple

    def __post_init__(self):
        names = [d.name for d in self.dims]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate dim names: {names}")
        cats: dict[str, Categorical] = {}
        for d in self.dims:
            if isinstance(d, Conditional):
                parent = cats.get(d.parent)
                if parent is None:
                    raise ValueError(
                        f"Conditional {d.name}: parent {d.parent!r} must be "
                        "an (unconditional) Categorical appearing earlier "
                        "in the space")
                if d.when not in parent.choices:
                    raise ValueError(
                        f"Conditional {d.name}: {d.when!r} is not a choice "
                        f"of {d.parent!r} {parent.choices}")
            elif isinstance(d, Categorical):
                cats[d.name] = d

    @property
    def names(self) -> list[str]:
        return [d.name for d in self.dims]

    @property
    def dim(self) -> int:
        """Width of the encoded unit cube (what the GP sees)."""
        return sum(d.width for d in self.dims)

    @property
    def has_discrete(self) -> bool:
        return any(not isinstance(d, Dim) for d in self.dims)

    def _offsets(self) -> list[int]:
        offs, o = [], 0
        for d in self.dims:
            offs.append(o)
            o += d.width
        return offs

    def to_hparams(self, u: np.ndarray) -> dict:
        """Decode an encoded unit vector to {name: value}.  Inactive
        conditional dims decode to None (every name is always a key)."""
        u = np.asarray(u)
        out: dict = {}
        for d, o in zip(self.dims, self._offsets()):
            if isinstance(d, Conditional) and out.get(d.parent) != d.when:
                out[d.name] = None
            else:
                out[d.name] = d.decode(u[o:o + d.width])
        return out

    def to_unit(self, hparams: dict) -> np.ndarray:
        """Encode named values to the unit cube (vectorized inverse of
        `to_hparams`; clamps out-of-range values — see module docstring).
        Conditional dims whose parent choice doesn't match (or that are
        absent/None) encode to the neutral 0-block."""
        parts = []
        for d in self.dims:
            if isinstance(d, Conditional):
                v = hparams.get(d.name)
                if hparams.get(d.parent) != d.when:
                    v = None
                parts.append(d.encode(v))
            else:
                parts.append(d.encode(hparams[d.name]))
        return np.concatenate(parts).astype(np.float32)

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """n feasible encoded points.  One uniform draw over the encoded
        cube (bit-identical to the pre-typed-space stream on all-Float
        spaces) followed by the host-side round-and-repair projection."""
        u = rng.uniform(0.0, 1.0, (n, self.dim)).astype(np.float32)
        return self.project(u)

    def project(self, u: np.ndarray) -> np.ndarray:
        """Host-side (numpy) round-and-repair onto the feasible lattice —
        the same three passes as `descriptor.project_units`, so device and
        host agree on what "feasible" means."""
        u = np.asarray(u, np.float32)
        batched = u.ndim == 2
        u = np.atleast_2d(u).copy()
        for d, o in zip(self.dims, self._offsets()):
            inner = d.inner if isinstance(d, Conditional) else d
            sl = slice(o, o + d.width)
            if isinstance(inner, Int):
                lev = inner.levels
                u[:, o] = np.round(u[:, o] * (lev - 1)) / max(lev - 1, 1)
            elif isinstance(inner, Categorical):
                best = np.argmax(u[:, sl], axis=1)
                u[:, sl] = 0.0
                u[np.arange(u.shape[0]), o + best] = 1.0
        for d, o in zip(self.dims, self._offsets()):
            if isinstance(d, Conditional):
                po, _ = self._parent_coord(d)
                u[:, o:o + d.width] *= u[:, po:po + 1]
        return u if batched else u[0]

    def _parent_coord(self, d: Conditional) -> tuple[int, Categorical]:
        """Encoded index of the parent choice's one-hot coordinate."""
        for p, o in zip(self.dims, self._offsets()):
            if isinstance(p, Categorical) and p.name == d.parent:
                return o + p.choices.index(d.when), p
        raise ValueError(f"no Categorical parent {d.parent!r}")  # unreachable

    def descriptor(self) -> desc_mod.TypeDescriptor:
        """The static per-coordinate type descriptor (DESIGN.md §10), as
        CPU tensors."""
        dim = self.dim
        cont = np.ones((dim,), np.float32)
        cat = np.zeros((dim,), np.float32)
        levels = np.zeros((dim,), np.float32)
        group = np.full((dim,), -1, np.int32)
        parent = np.full((dim,), -1, np.int32)
        for d, o in zip(self.dims, self._offsets()):
            inner = d.inner if isinstance(d, Conditional) else d
            if isinstance(inner, Int):
                levels[o] = inner.levels
            elif isinstance(inner, Categorical):
                cont[o:o + d.width] = 0.0
                cat[o:o + d.width] = 1.0
                group[o:o + d.width] = o
            if isinstance(d, Conditional):
                parent[o:o + d.width] = self._parent_coord(d)[0]
        return desc_mod.TypeDescriptor(
            cont_mask=torch.from_numpy(cont), cat_mask=torch.from_numpy(cat),
            levels=torch.from_numpy(levels),
            group=torch.from_numpy(group).long(),
            parent=torch.from_numpy(parent).long())


# --- presets (paper Sec. 4.2 / 4.3) ---------------------------------------

LENET_SPACE = SearchSpace((
    Dim("dropout1", 0.01, 1.0),
    Dim("dropout2", 0.01, 1.0),
    Dim("lr", 1e-4, 1e-1, "log"),
    Dim("weight_decay", 1e-6, 1e-3, "log"),
    Dim("momentum", 0.0, 0.99),
))

RESNET_SPACE = SearchSpace((
    Dim("lr", 1e-4, 1e-1, "log"),
    Dim("weight_decay", 1e-6, 1e-3, "log"),
    Dim("momentum", 0.0, 0.99),
))

LM_SPACE = SearchSpace((
    Dim("lr", 1e-4, 3e-2, "log"),
    Dim("weight_decay", 1e-4, 0.3, "log"),
    Dim("warmup_frac", 0.01, 0.4),
    Dim("b2", 0.9, 0.999),
))

# A mixed-space exemplar (beyond-paper, DESIGN.md §10): real HPO traffic is
# dominated by integer and categorical choices (Snoek et al. 2012).
MIXED_DEMO_SPACE = SearchSpace((
    Dim("lr", 1e-4, 1e-1, "log"),
    Int("depth", 2, 8),
    Categorical("optimizer", ("sgd", "adam", "rmsprop")),
    Conditional(Dim("momentum", 0.0, 0.99), parent="optimizer", when="sgd"),
))
