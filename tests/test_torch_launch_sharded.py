"""The port's sharded training on gloo process groups of CPU ranks (one
subprocess a rank, rendezvous through a file in tmp_path), against the
port's and the reference's one-device results:

  * tiny-lm's reduced config in float32, one SGD-momentum step on a 2x2
    mesh (the reference's test uses 2x4; eight ranks push this file past
    its time): the loss and every parameter against the port's one-device
    step and the reference's, within 1e-5 of a leaf's largest entry (the
    LM tests' float32 tolerance; measured about 1e-7);
  * `moe_ffn`'s expert-parallel path on qwen3-moe's reduced config in
    float32 at 1x2 and 2x2: the call counter shows the path ran; output,
    aux loss and gradients against the port's one-device path, and, with
    the expert tables at 8 (unpadded) experts, against the reference's own
    `_moe_shard_map` run on 4 forced host devices, within 1e-5 of each
    leaf's largest entry (sums over the model group in another order;
    measured about 1e-7);
  * a launcher mesh whose size is not the world's raises.  The launcher's
    runs are in tests/test_torch_launch_resume.py.

The reference's `_moe_shard_map` with tables padded past the expert count
(qwen3 reduced: 8 experts, 16 rows) scatters each dropped (token, choice)
into the first slot of the last model rank's first padded expert, whose
output the combine then reads (`src/repro/models/moe.py:226-228`); the
port sends them to the sentinel, as the one-device path does.  So the
reference is compared at 8 rows only.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from _torch_port import CPU, jax_state_leaves

from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.optim import OptimizerConfig as JOptimizerConfig
from repro.optim import init_opt_state as jinit_opt_state
from repro.training import make_train_step as jmake_train_step
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, synth_tokens
from repro_torch.launch import train
from repro_torch.models import init_params, moe
from repro_torch.models.common import tree_leaves
from repro_torch.optim import OptimizerConfig, init_opt_state
from repro_torch.training import TrainConfig, make_train_step, value_and_grad

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = os.path.join(REPO, "tests", "_torch_launch_ranks.py")
sys.path.insert(0, os.path.dirname(RANKS))
import _torch_launch_ranks as ranks_mod  # noqa: E402
from _torch_launch_ranks import finish as _finish  # noqa: E402
from _torch_launch_ranks import TIMEOUT  # noqa: E402
from _torch_launch_ranks import start as _start  # noqa: E402

TOL = 1e-5
# The error-feedback residual is (g + r) - Q(g + r): a gradient that sums
# in another order on the mesh may round to the next int8 level, which
# moves its residual by one level, 1/127 of the leaf's largest entry.
TOL_RESIDUAL = 1.0 / 127


def _ranks(case, mesh, tmp_path, tag, **extra):
    world = int(mesh[0]) * int(mesh[2])
    out = tmp_path / f"{tag}.npz"
    store = tmp_path / f"{tag}.store"
    procs = _start([sys.executable, RANKS, case, mesh, f"file://{store}",
                    str(out)], world, **extra)
    return procs, out


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= tol, f"{what}: {err:.3g} > {tol}"


# ---------------------------------------------------------------------------
# The reference's expert-parallel path, on 4 forced host devices
# ---------------------------------------------------------------------------

JAX_MOE = textwrap.dedent("""
    import sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.launch import sharding as sh
    from repro.launch.mesh import make_mesh
    from repro.models.moe import moe_ffn
    d = dict(np.load(sys.argv[1]))
    x, r = jnp.asarray(d.pop("x")), jnp.asarray(d.pop("r"))
    params = {k: jnp.asarray(v) for k, v in d.items()}
    out = {}
    for shape in ((1, 2), (2, 2)):
        mesh = make_mesh(shape, ("data", "model"))
        rules = sh.rules_for("qwen3-moe-30b-a3b", mesh)

        def f(p, x):
            with sh.use_rules(mesh, rules):
                y, aux = moe_ffn(p, x, top_k=2, capacity_factor=1.25)
            return (y * r).sum() + aux, (y, aux)

        with mesh:
            (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True))(params, x)
        tag = f"{shape[0]}x{shape[1]}"
        out[f"{tag}_out"], out[f"{tag}_aux"] = np.asarray(y), np.asarray(aux)
        out[f"{tag}_dx"] = np.asarray(gx)
        for k, v in gp.items():
            out[f"{tag}_d_{k}"] = np.asarray(v)
    np.savez(sys.argv[2], **out)
    """)


def _moe_one_device(pad):
    """The port's one-device moe_ffn on the rank script's inputs."""
    cfg = dataclasses.replace(ranks_mod.moe_config(), expert_pad_to=pad)
    params, _ = init_params(cfg, 0, device=CPU)
    mp = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    x, r = ranks_mod.moe_inputs(cfg)
    x, r = torch.from_numpy(x), torch.from_numpy(r)

    def loss(p, _):
        y, aux = moe.moe_ffn(p["moe"], p["x"], top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor)
        return (y * r).sum() + aux, {"out": y, "aux": aux}

    (_, m), g = value_and_grad(loss, {"moe": mp, "x": x}, None)
    want = {"out": m["out"], "aux": m["aux"], "dx": g["x"],
            **{f"d_{k}": v for k, v in g["moe"].items()}}
    return mp, x, r, {k: v.numpy() for k, v in want.items()}


def test_moe_expert_parallel_matches_one_device_and_the_reference(tmp_path):
    # The reference first (it takes the longest), on the port's weights.
    mp8, x, r, want8 = _moe_one_device(8)
    inputs = tmp_path / "moe_inputs.npz"
    np.savez(inputs, x=x.numpy(), r=r.numpy(),
             **{k: v.numpy() for k, v in mp8.items()})
    jenv = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                XLA_FLAGS="--xla_force_host_platform_device_count=4",
                JAX_PLATFORMS="cpu")
    jref = tmp_path / "moe_reference.npz"
    jproc = subprocess.Popen([sys.executable, "-c", JAX_MOE, str(inputs),
                              str(jref)], env=jenv, cwd=REPO,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
    runs = {}
    for mesh in ("1x2", "2x2"):
        for pad in (16, 8):
            runs[mesh, pad] = _ranks("moe", mesh, tmp_path,
                                     f"moe_{mesh}_{pad}", PAD=str(pad))
    _, _, _, want16 = _moe_one_device(16)
    for (mesh, pad), (procs, out) in runs.items():
        _finish(procs)
        got = dict(np.load(out))
        assert int(got.pop("ep_calls")) == 1, (mesh, pad)
        want = want16 if pad == 16 else want8
        for k in want:
            _close(got[k], want[k], TOL, f"{mesh} pad {pad} {k}")
    out, _ = jproc.communicate(timeout=TIMEOUT)
    assert jproc.returncode == 0, out[-3000:]
    ref = dict(np.load(jref))
    for mesh in ("1x2", "2x2"):
        got = dict(np.load(runs[mesh, 8][1]))
        for k in want8:
            _close(got[k], ref[f"{mesh}_{k}"], TOL, f"{mesh} reference {k}")


def test_moe_one_device_path_is_unchanged_outside_a_context():
    """No context: `moe_ffn` takes the one-device path (no EP call)."""
    before = moe.EP_CALLS
    _moe_one_device(16)
    assert moe.EP_CALLS == before


# ---------------------------------------------------------------------------
# One sharded train step of tiny-lm
# ---------------------------------------------------------------------------

def test_sharded_train_step_matches_one_device(tmp_path):
    """The reference's initial parameters (by tree path) and the port
    pipeline's batch 0 go to the ranks, the port's one-device step and the
    reference's."""
    jcfg = dataclasses.replace(jget_config("tiny-lm", reduced=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("tiny-lm", reduced=True),
                              dtype="float32")
    jparams, _ = jinit_params(jcfg, jax.random.PRNGKey(0))
    leaves = jax_state_leaves(jparams)
    batch = synth_tokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=8), 0, device=CPU)
    init = tmp_path / "init.npz"
    np.savez(init, **{f"param:{k}": v for k, v in leaves.items()},
             **{f"batch:{k}": v.numpy() for k, v in batch.items()})
    procs, out = _ranks("step", "2x2", tmp_path, "step", INIT=str(init))
    ocfg = dict(name="sgdm", lr=1e-2, warmup_steps=0, total_steps=10)
    params = convert.lm_params_from_numpy(leaves, device=CPU)
    o = OptimizerConfig(**ocfg)
    p1, _, m1 = make_train_step(cfg, o)(params, init_opt_state(o, params),
                                       batch)
    jo = JOptimizerConfig(**ocfg)
    jp, _, jm = jax.jit(jmake_train_step(jcfg, jo))(
        jparams, jinit_opt_state(jo, jparams),
        {k: jax.numpy.asarray(v.numpy()) for k, v in batch.items()})
    jleaves = jax_state_leaves(jp)
    _finish(procs)
    got = dict(np.load(out))
    for want in (float(m1["loss"]), float(jm["loss"])):
        assert abs(float(got["loss"]) - want) <= TOL * abs(want)
    names = _leaf_names(p1)
    assert sorted(names) == sorted(jleaves)
    for i, (leaf, name) in enumerate(zip(tree_leaves(p1), names)):
        _close(got[f"p{i}"], leaf.numpy(), TOL, f"port {name}")
        _close(got[f"p{i}"], jleaves[name], TOL, f"reference {name}")
    # int8 error feedback (its residual placed as its parameter is) and
    # two microbatches, against the port's one-device step.
    eo = dataclasses.replace(o, compress_grads=True)
    q1, e1, em = make_train_step(cfg, eo, TrainConfig(microbatches=2))(
        params, init_opt_state(eo, params), batch)
    assert bool(got["residual_placed_as_params"])
    assert abs(float(got["ef_loss"]) - float(em["loss"])) <= TOL * abs(
        float(em["loss"]))
    for i, (leaf, res, name) in enumerate(zip(
            tree_leaves(q1), tree_leaves(e1.ef_residual), names)):
        _close(got[f"q{i}"], leaf.numpy(), TOL, f"error feedback {name}")
        _close(got[f"r{i}"], res.numpy(), TOL_RESIDUAL, f"residual {name}")


def _leaf_names(tree, prefix=""):
    """Tree-path names in `tree_leaves` order ("blocks/attn/wq", ...)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def test_mesh_must_match_the_world(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="WORLD_SIZE is 4"):
        train.run(train.parse_args(["--arch", "tiny-lm", "--reduced",
                                    "--device", "cpu", "--mesh-shape",
                                    "2x1", "--steps", "1"]))
