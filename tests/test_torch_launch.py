"""The port's launch layer (`repro_torch/launch/{sharding,mesh,specs}.py`)
against the reference's (`repro/launch/`): the rule tables and logical
specs for every arch, both pod layouts, with and without sequence
parallelism (shape-only meshes, as tests/test_launch.py uses); the
divisibility fallback on every full config's parameter shapes (the
reference's `jax.eval_shape`) at 16x16 and 2x16x16; the decode-cache
specs; `cell_applicable`; the per-device parameter bytes of a full arch
on a fake 256-rank process group; the production mesh's world check.
All comparisons are exact (specs are tuples of names)."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from _torch_port import CPU
from jax.sharding import AbstractMesh

from repro.configs import get_config as jget_config
from repro.launch import sharding as jsharding
from repro.launch import specs as jspecs
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro_torch.configs import ARCH_IDS, REGISTRY, get_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import sharding, specs
from repro_torch.models import init_cache, init_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class ShapeMesh:
    """A mesh's axis names and sizes, no devices."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))


def _meshes(name):
    shape, axes = MESHES[name]
    return ShapeMesh(shape, axes), AbstractMesh(shape, axes)


def _spec(p) -> tuple:
    return tuple(p)


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree)
                for k2, v2 in _leaf_paths(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


def _port_specs(arch):
    """The port's logical-axis spec tree of `arch` (its structure: one
    shared-block period of layers, the widths of the reduced config)."""
    cfg = get_config(arch, reduced=True)
    layers = max(get_config(arch).shared_attn_every, cfg.num_layers)
    _, spec_tree = init_params(dataclasses.replace(cfg, num_layers=layers),
                               0, device=CPU)
    return spec_tree


def _jax_full(arch):
    """The reference's full-config (shapes, logical specs), by eval_shape."""
    captured = {}

    def init(key):
        p, s = jinit_params(jget_config(arch), key)
        captured["specs"] = s
        return p

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return shapes, captured["specs"]


@pytest.mark.parametrize("pods", sorted(MESHES))
@pytest.mark.parametrize("sp", [False, True])
def test_rules_and_logical_specs_equal_the_reference(pods, sp):
    mesh, amesh = _meshes(pods)
    axes_seen = set()
    for arch in sorted(REGISTRY):
        rules = sharding.rules_for(arch, mesh, seq_parallel=sp)
        jrules = jsharding.rules_for(arch, mesh, seq_parallel=sp)
        assert rules == jrules, arch
        for ax in _leaf_paths(_port_specs(arch)).values():
            axes_seen.add(tuple(ax))
    axes_seen |= {("batch", "seq", "embed"), ("batch", "seq", "heads", None),
                  ("batch", "seq", "kv_heads", None), ("batch", "seq", "mlp"),
                  ("batch", "seq", "vocab"), ("batch", None, None),
                  ("batch", "expert", "capacity", None),
                  ("batch", "expert", "capacity", "mlp")}
    for arch in sorted(REGISTRY):
        rules = sharding.rules_for(arch, mesh, seq_parallel=sp)
        for ax in sorted(axes_seen, key=str):
            assert sharding.logical_to_spec(ax, rules) == _spec(
                jsharding.logical_to_spec(ax, rules)), (arch, ax)


def test_rule_table_example():
    """tests/test_launch.py's example: batch takes data, embed loses it."""
    mesh = ShapeMesh((4, 2), ("data", "model"))
    rules = sharding.rules_for("granite-3-2b", mesh, seq_parallel=True)
    assert rules["batch"] == "data" and rules["seq"] == "model"
    assert sharding.logical_to_spec(("batch", "seq", "embed"), rules) == (
        "data", "model", None)
    assert sharding.rules_for("gemma3-4b", mesh)["heads"] is None


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_divisibility_fallback_equals_param_shardings(arch):
    """Every leaf of the full config: the port's spec after its fallback
    equals the reference's `param_shardings(..., shapes=)` spec."""
    shapes, jspec_tree = _jax_full(arch)
    port = _leaf_paths(_port_specs(arch))
    shape_leaves = _leaf_paths(jax.tree_util.tree_map(lambda s: s, shapes))
    assert set(port) == set(shape_leaves)
    for pods in sorted(MESHES):
        mesh, amesh = _meshes(pods)
        rules = jsharding.rules_for(arch, amesh)
        jsh = _leaf_paths(jsharding.param_shardings(jspec_tree, amesh, rules,
                                                    shapes=shapes))
        for path, ax in port.items():
            got = sharding.divisible_spec(
                sharding.logical_to_spec(ax, rules), mesh,
                shape_leaves[path].shape)
            want = _spec(jsh[path].spec)
            want = want + (None,) * (len(got) - len(want))
            assert got == want, (arch, pods, path)


@pytest.mark.parametrize("batch", [2, 1])
def test_cache_shardings_equal_the_reference(batch):
    archs = [a for a in REGISTRY if get_config(a).supports_decode]
    for pods in sorted(MESHES):
        mesh, amesh = _meshes(pods)
        for arch in archs:
            cfg, jcfg = get_config(arch, reduced=True), \
                jget_config(arch, reduced=True)
            params, _ = init_params(cfg, 0, device=CPU)
            got = _leaf_paths(specs.cache_shardings(
                cfg, init_cache(params, cfg, batch, 16), mesh, batch))
            jshapes = jax.eval_shape(lambda k: jinit_params(jcfg, k)[0],
                                     jax.random.PRNGKey(0))
            jcache = jax.eval_shape(
                lambda p: jinit_cache(p, jcfg, batch, 16), jshapes)
            want = _leaf_paths(jspecs.cache_shardings(jcfg, jcache, amesh,
                                                      batch))
            assert set(got) == set(want), arch
            for path in want:
                w = _spec(want[path].spec)
                g = got[path]
                assert g[:len(w)] == w and set(g[len(w):]) <= {None}, \
                    (arch, pods, path, g, w)


def test_cell_applicable_equals_the_reference():
    for arch in sorted(REGISTRY):
        for shape in specs.SHAPES:
            assert specs.cell_applicable(get_config(arch), shape) == \
                jspecs.cell_applicable(jget_config(arch), shape), (arch, shape)
    assert set(specs.SHAPES) == set(jspecs.SHAPES)
    for name, cell in specs.SHAPES.items():
        j = jspecs.SHAPES[name]
        assert (cell.kind, cell.seq, cell.batch) == (j.kind, j.seq, j.batch)


def test_placements_shard_pod_major_and_skip_size_one_axes():
    mesh = ShapeMesh((2, 4, 1), ("pod", "data", "model"))
    from torch.distributed.tensor import Replicate, Shard
    got = sharding.placements((("pod", "data"), "model"), mesh, (16, 8))
    assert got == [Shard(0), Shard(0), Replicate()]
    assert sharding.placements((("pod", "data"), None), mesh, (6, 8)) == [
        Replicate()] * 3          # 6 does not divide over 8 ranks
    with pytest.raises(ValueError, match="axis order"):
        sharding.placements((("data", "pod"),), mesh, (16,))


def test_constrain_is_the_identity_without_a_context():
    x = torch.randn(2, 3, 4)
    assert sharding.constrain(x, ("batch", "seq", "embed")) is x
    with sharding.use_rules(ShapeMesh((2, 2), ("data", "model")), {}):
        assert sharding.constrain(x, ("batch", "seq", "embed")) is x


def test_bound_carries_the_context_to_another_thread():
    """A checkpointed layer's recompute runs on the autograd engine's
    thread for CUDA tensors: `bound` takes the context along."""
    import threading
    mesh = ShapeMesh((2, 2), ("data", "model"))
    seen = []
    plain = sharding.bound(lambda: sharding.current())
    assert plain() is None
    with sharding.use_rules(mesh, {"batch": "data"}):
        fn = sharding.bound(lambda: seen.append(sharding.current()))
        t = threading.Thread(target=fn)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert seen and seen[0] is not None and seen[0].mesh is mesh
    assert sharding.current() is None


def test_production_mesh_requires_ranks():
    """In a one-rank process the production mesh refuses, naming the dry
    run's fake process group."""
    with pytest.raises(RuntimeError, match="fake"):
        mesh_mod.make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="fake"):
        mesh_mod.make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(RuntimeError, match="needs a process group of 4"):
        mesh_mod.make_mesh((2, 2), ("data", "model"), device_type="cpu")


def _jax_bytes_per_device(arch, pods):
    shapes, jspec_tree = _jax_full(arch)
    _, amesh = _meshes(pods)
    rules = jsharding.rules_for(arch, amesh)
    shard = jsharding.param_shardings(jspec_tree, amesh, rules, shapes=shapes)
    total = 0
    for s, sh in zip(jax.tree_util.tree_leaves(shapes),
                     jax.tree_util.tree_leaves(shard)):
        total += int(np.prod(sh.shard_shape(s.shape))) * s.dtype.itemsize
    return total


def test_parameter_bytes_per_device_equal_the_reference():
    """qwen3-moe-30b-a3b's full tree as DTensors of fake tensors on a fake
    256-rank group (rank 0's shards, in a subprocess): its bytes equal
    the sum of the reference's shard shapes at 16x16."""
    code = textwrap.dedent("""
        import torch
        from torch._subclasses.fake_tensor import FakeTensorMode
        from repro_torch.configs import get_config
        from repro_torch.launch import dryrun, sharding, specs
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.models.common import tree_leaves
        with dryrun.fake_world(256):
            mesh = make_production_mesh(device_type="cpu")
            rules = sharding.rules_for("qwen3-moe-30b-a3b", mesh)
            params = specs.abstract_params(
                get_config("qwen3-moe-30b-a3b"), mesh, rules,
                FakeTensorMode())
            print("BYTES", sum(x.to_local().numel() * x.element_size()
                               for x in tree_leaves(params)))
        """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    got = int(out.stdout.split("BYTES")[1].split()[0])
    assert got == _jax_bytes_per_device("qwen3-moe-30b-a3b", "16x16")
