"""The port's `hpo/space.py` against the JAX package's: unit-cube round
trips on typed dimensions (the mirror of `tests/test_space.py`), and the
same encodings, decodings, projections, samples and descriptors from both
packages on the same numpy inputs."""
import math

import numpy as np
import pytest
import torch
from _torch_port import n

from repro.hpo import space as jspace
from repro_torch import convert
from repro_torch.hpo.space import (LENET_SPACE, LM_SPACE, MIXED_DEMO_SPACE,
                                   RESNET_SPACE, Categorical, Conditional, Dim,
                                   Float, Int, SearchSpace, dim_from_dict,
                                   space_from_dicts, space_to_dicts)

LIN = Dim("momentum", 0.0, 0.99)
LOG = Dim("lr", 1e-4, 1e-1, "log")
INT = Int("depth", 2, 8)
CAT = Categorical("opt", ("sgd", "adam", "rmsprop"))
PRESETS = {"lenet": (LENET_SPACE, jspace.LENET_SPACE),
           "resnet": (RESNET_SPACE, jspace.RESNET_SPACE),
           "lm": (LM_SPACE, jspace.LM_SPACE),
           "mixed": (MIXED_DEMO_SPACE, jspace.MIXED_DEMO_SPACE)}


def _reference_space(space: SearchSpace) -> "jspace.SearchSpace":
    """The same space built by the reference, through the dict form."""
    return jspace.space_from_dicts(space_to_dicts(space))


# ---------------------------------------------------------------------------
# Round trips (tests/test_space.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dim", [LIN, LOG], ids=["linear", "log"])
@pytest.mark.parametrize("u", [0.0, 0.25, 0.5, 0.75, 1.0])
def test_unit_value_round_trip(dim, u):
    v = dim.to_value(u)
    assert dim.lo <= v <= dim.hi or math.isclose(v, dim.lo) \
        or math.isclose(v, dim.hi)
    assert dim.to_unit(v) == pytest.approx(u, abs=1e-12)


@pytest.mark.parametrize("dim", [LIN, LOG], ids=["linear", "log"])
def test_edges_and_out_of_range_clamp(dim):
    assert dim.to_value(0.0) == pytest.approx(dim.lo, rel=1e-12)
    assert dim.to_value(1.0) == pytest.approx(dim.hi, rel=1e-12)
    assert dim.to_value(-0.25) == pytest.approx(dim.to_value(0.0))
    assert dim.to_value(1.25) == pytest.approx(dim.to_value(1.0))
    eps = abs(dim.hi) * 1e-6 + 1e-9
    assert dim.to_unit(dim.hi + eps) == pytest.approx(1.0, abs=1e-5)
    assert dim.to_unit(dim.hi * 10.0) == 1.0
    assert dim.to_unit(dim.lo - 1.0) == 0.0


def test_log_dim_is_geometric():
    assert LOG.to_value(0.5) == pytest.approx(math.sqrt(LOG.lo * LOG.hi),
                                              rel=1e-9)
    assert Float is Dim


def test_int_lattice_round_trip():
    assert INT.levels == 7
    for v in range(2, 9):
        assert INT.to_value(INT.to_unit(v)) == v
    assert INT.to_value(INT.to_unit(5) + 0.01) == 5
    assert INT.to_unit(100) == 1.0 and INT.to_unit(-3) == 0.0
    single = Int("k", 3, 3)
    assert single.levels == 1 and single.to_unit(3) == 0.0
    assert single.to_value(0.7) == 3


def test_categorical_one_hot_round_trip_and_validation():
    for c in CAT.choices:
        u = CAT.encode(c)
        assert u.sum() == 1.0 and CAT.decode(u) == c
    assert CAT.decode(np.asarray([0.5, 0.5, 0.0])) == "sgd"
    with pytest.raises(ValueError):
        Categorical("c", ("only",))
    with pytest.raises(ValueError):
        Categorical("c", ("a", "a"))
    with pytest.raises(ValueError, match="JSON"):
        Categorical("filter", ((3, 3), (5, 5)))


def test_conditional_gating_round_trip_and_validation():
    sp = MIXED_DEMO_SPACE
    u = sp.to_unit({"lr": 1e-2, "depth": 4, "optimizer": "sgd",
                    "momentum": 0.5})
    back = sp.to_hparams(u)
    assert back["optimizer"] == "sgd"
    assert back["momentum"] == pytest.approx(0.5, abs=1e-5)
    u2 = sp.to_unit({"lr": 1e-2, "depth": 4, "optimizer": "adam",
                     "momentum": 0.9})
    assert u2[-1] == 0.0 and sp.to_hparams(u2)["momentum"] is None
    with pytest.raises(ValueError, match="parent"):
        SearchSpace((Conditional(Dim("m", 0.0, 1.0), "nope", "x"),))
    with pytest.raises(ValueError, match="choice"):
        SearchSpace((CAT, Conditional(Dim("m", 0.0, 1.0), "opt", "bad")))
    with pytest.raises(ValueError, match="nest"):
        Conditional(Conditional(Dim("m", 0.0, 1.0), "a", "b"), "c", "d")


def test_space_serialization_round_trip():
    sp = MIXED_DEMO_SPACE
    assert space_from_dicts(space_to_dicts(sp)) == sp
    legacy = dim_from_dict({"name": "lr", "lo": 1e-4, "hi": 1e-1,
                            "scale": "log"})
    assert legacy == Dim("lr", 1e-4, 1e-1, "log")


def test_descriptor_matches_layout():
    desc = MIXED_DEMO_SPACE.descriptor()
    assert desc.cont_mask.device.type == "cpu"
    np.testing.assert_array_equal(n(desc.cont_mask), [1, 1, 0, 0, 0, 1])
    np.testing.assert_array_equal(n(desc.cat_mask), [0, 0, 1, 1, 1, 0])
    np.testing.assert_array_equal(n(desc.levels), [0, 7, 0, 0, 0, 0])
    np.testing.assert_array_equal(n(desc.group), [-1, -1, 2, 2, 2, -1])
    np.testing.assert_array_equal(n(desc.parent), [-1, -1, -1, -1, -1, 2])
    assert desc.group.dtype == torch.int64
    assert desc.has_discrete
    assert not RESNET_SPACE.descriptor().has_discrete


# ---------------------------------------------------------------------------
# Both packages on the same inputs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", PRESETS)
def test_presets_match_reference(name):
    port, ref = PRESETS[name]
    assert space_to_dicts(port) == jspace.space_to_dicts(ref)
    assert port.dim == ref.dim and port.names == ref.names
    assert port.has_discrete == ref.has_discrete


@pytest.mark.parametrize("name", PRESETS)
def test_encode_decode_project_match_reference(name):
    port, ref = PRESETS[name]
    rng = np.random.default_rng(11)
    u = rng.uniform(size=(16, port.dim)).astype(np.float32)
    np.testing.assert_array_equal(port.project(u), ref.project(u))
    for row in port.project(u):
        hp = port.to_hparams(row)
        assert hp == ref.to_hparams(row)
        np.testing.assert_array_equal(port.to_unit(hp), ref.to_unit(hp))
        np.testing.assert_allclose(port.to_unit(hp), row, atol=1e-5)


@pytest.mark.parametrize("name", PRESETS)
def test_sample_matches_reference_stream(name):
    port, ref = PRESETS[name]
    got = port.sample(np.random.default_rng(7), 9)
    want = ref.sample(np.random.default_rng(7), 9)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(port.project(got), got, atol=1e-6)


def test_descriptor_matches_reference_through_convert():
    sp = SearchSpace((Dim("a", 0.0, 1.0), Int("k", -3, 3),
                      Categorical("c", ("p", "q", "r")),
                      Conditional(Int("w", 1, 4), parent="c", when="q"),
                      Conditional(Categorical("v", ("x", "y")), parent="c",
                                  when="r")))
    ref = _reference_space(sp)
    leaves = convert.descriptor_to_numpy(sp.descriptor())
    from repro.checkpoint.store import _flatten_with_paths
    names, vals, _ = _flatten_with_paths(ref.descriptor())
    want = {k: np.asarray(v) for k, v in zip(names, vals)}
    assert sorted(leaves) == sorted(want)
    for k in want:
        assert leaves[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(leaves[k], want[k], err_msg=k)
    back = convert.descriptor_from_numpy(want, device="cpu")
    for k in want:
        np.testing.assert_array_equal(n(getattr(back, k[1:])), want[k])
