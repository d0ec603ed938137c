"""One rank of tests/test_torch_launch_sharded.py's gloo process groups.

    RANK=r WORLD_SIZE=n python tests/_torch_launch_ranks.py CASE MESH INIT OUT

CASE "step": one SGD-momentum step of tiny-lm's reduced config in float32
on a DxM mesh, from the parameters and the batch in the npz `INIT` names
(an environment variable), and one more from the same state with int8
error feedback and two microbatches; rank 0 writes the losses, the full
parameters after each step and the error-feedback residual to OUT
(npz).
CASE "moe": `moe_ffn` of qwen3-moe's reduced config in float32 (expert
tables padded to `PAD`, an environment variable) on a seeded x, its
output, aux loss and the gradients of sum(out * r) + aux with respect to
x and the MoE parameters; rank 0 writes them with the expert-parallel
call count.  Imports no JAX.  `start` / `finish` run any command as the
ranks of such a group (the tests' helpers)."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)

MOE_SHAPE = (4, 16)       # batch, sequence of the moe case
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300             # seconds a rank may take (a hang guard)


def _env(rank, world, **extra):
    env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
               LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
               PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    env.pop("MASTER_PORT", None)
    env.update(extra)
    return env


def start(cmd, world, **extra):
    """`cmd` as `world` rank processes (RANK, WORLD_SIZE, LOCAL_* set)."""
    return [subprocess.Popen(cmd, env=_env(r, world, **extra), cwd=REPO,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for r in range(world)]


def finish(procs, codes=(0,)):
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode in codes, out[-3000:]
    return outs


def moe_inputs(cfg):
    rng = np.random.default_rng(7)
    b, s = MOE_SHAPE
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return x, r


def moe_config():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen3-moe-30b-a3b", reduced=True),
                               dtype="float32",
                               expert_pad_to=int(os.environ.get("PAD", "16")))


def main(case, mesh_shape, init, out):
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_mesh
    rank = int(os.environ["RANK"])
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=int(os.environ["WORLD_SIZE"]))
    shape = tuple(int(v) for v in mesh_shape.split("x"))
    mesh = make_mesh(shape, ("data", "model"), device_type="cpu")

    def batch_placed(v):
        spec = ("data",) + (None,) * (v.ndim - 1)
        return distribute_tensor(v, mesh, sharding.placements(
            spec, mesh, v.shape), src_data_rank=None)

    if case == "step":
        from repro_torch.configs import get_config
        from repro_torch.models import init_params
        from repro_torch.models.common import tree_leaves
        from repro_torch.optim import OptimizerConfig, init_opt_state
        from repro_torch.training import make_train_step
        cfg = dataclasses.replace(get_config("tiny-lm", reduced=True),
                                  dtype="float32")
        rules = sharding.rules_for("tiny-lm", mesh)
        ocfg = OptimizerConfig(name="sgdm", lr=1e-2, warmup_steps=0,
                               total_steps=10)
        from repro_torch import convert
        init = dict(np.load(os.environ["INIT"]))
        params = convert.lm_params_from_numpy(
            {k[6:]: v for k, v in init.items() if k.startswith("param:")},
            device="cpu")
        _, specs = init_params(cfg, 0, device="cpu")
        params = sharding.distribute(params, specs, mesh, rules)
        batch = {k[6:]: torch.from_numpy(v) for k, v in init.items()
                 if k.startswith("batch:")}
        batch = {k: batch_placed(v) for k, v in batch.items()}
        from repro_torch.training import TrainConfig
        ecfg = dataclasses.replace(ocfg, compress_grads=True)
        with sharding.use_rules(mesh, rules), implicit_replication():
            stepped, _, metrics = make_train_step(cfg, ocfg)(
                params, init_opt_state(ocfg, params), batch)
            # int8 error feedback and two microbatches
            ef_params, ef_state, ef_metrics = make_train_step(
                cfg, ecfg, TrainConfig(microbatches=2))(
                params, init_opt_state(ecfg, params), batch)
        same = all(r.placements == p.placements for r, p in zip(
            tree_leaves(ef_state.ef_residual), tree_leaves(params)))
        got = {f"p{i}": x.full_tensor().numpy()
               for i, x in enumerate(tree_leaves(stepped))}
        got.update({f"q{i}": x.full_tensor().numpy()
                    for i, x in enumerate(tree_leaves(ef_params))})
        got.update({f"r{i}": x.full_tensor().numpy()
                    for i, x in enumerate(tree_leaves(ef_state.ef_residual))})
        loss = float(metrics["loss"].full_tensor())
        ef_loss = float(ef_metrics["loss"].full_tensor())
        if rank == 0:
            np.savez(out, loss=loss, ef_loss=ef_loss,
                     residual_placed_as_params=same, **got)
    else:
        from repro_torch.models import init_params, moe
        cfg = moe_config()
        rules = sharding.rules_for("qwen3-moe-30b-a3b", mesh)
        params, specs = init_params(cfg, 0, device="cpu")
        mp = {k: v[0] for k, v in params["blocks"]["moe"].items()}
        ms = {k: v[1:] for k, v in specs["blocks"]["moe"].items()}
        mp = sharding.distribute(mp, ms, mesh, rules)
        x, r = moe_inputs(cfg)
        x = batch_placed(torch.from_numpy(x)).requires_grad_(True)
        r = batch_placed(torch.from_numpy(r))
        watched = {k: v.detach().requires_grad_(True) for k, v in mp.items()}
        with sharding.use_rules(mesh, rules), implicit_replication():
            y, aux = moe.moe_ffn(watched, x, top_k=cfg.top_k,
                                 capacity_factor=cfg.capacity_factor)
            ((y * r).sum() + aux).backward()
        got = {"out": y.full_tensor(), "aux": aux.full_tensor(),
               "dx": x.grad.full_tensor(),
               **{f"d_{k}": sharding.replicated(v.grad).to_local()
                  for k, v in watched.items()}}
        if rank == 0:
            np.savez(out, ep_calls=moe.EP_CALLS,
                     **{k: v.detach().numpy() for k, v in got.items()})
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:5])
