"""Production-mesh dry run of every (arch x shape x mesh) cell, in one
process (counterpart of `repro/launch/dryrun.py`).

For each runnable cell this:
  1. joins a fake process group of the production mesh's size (256 for
     16x16, 512 for 2x16x16) as rank 0 and builds the mesh on it,
  2. makes the parameters, the optimizer state, the batch and the cache
     as fake tensors (`FakeTensorMode`: shapes and dtypes, no storage),
     the parameters and the state as DTensors placed by the rules,
  3. runs the cell's train, prefill or decode step on them eagerly, every
     layer at full depth (so the reference's two shallow cost compiles
     and their linear combination, `_lin_combine`, have no counterpart),
  4. records rank 0's peak memory (`MemTracker`), its floating-point
     operations and the collective census.

The census and the flop count are taken by `_LocalCensus`, a dispatch
mode that lets DTensor desugar each op first and then sees what rank 0
runs: the local shards' ops (`FlopCounterMode`'s formulas), and the
functional collectives DTensor issues with their input sizes and group
sizes.  `flops_per_device` is therefore rank 0's own work, replicated
work (every model rank's routing, the norms) included.  Each collective
is counted as the reference counts an HLO instruction: operand bytes and
link bytes (ring cost, (g - 1) / g per device).

The fake process group (`torch.testing._internal.distributed.fake_pg`)
and `MemTracker` (`torch.distributed._tools.mem_tracker`) are private
PyTorch APIs.

The decode step writes one position of its cache in place, which DTensor
cannot do on a dim sharded over the mesh: the cache is placed by
`specs.cache_shardings` with its sequence dim whole (the batch, heads and
states keep their specs).

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun.jsonl
  python -m repro_torch.launch.dryrun --all --mesh single --no-sp
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import sharding
from repro_torch.launch import specs as specs_mod

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def _census_entry(op: str, nbytes: int, g: int) -> tuple[str, int, int]:
    """(reference op name, operand bytes, link bytes) of one functional
    collective whose input has `nbytes` over a group of `g`."""
    if op == "all_gather_into_tensor":
        return "all-gather", nbytes, nbytes * (g - 1)
    if op == "reduce_scatter_tensor":
        return "reduce-scatter", nbytes, nbytes // g * (g - 1)
    if op == "all_reduce":
        return "all-reduce", nbytes, 2 * nbytes * (g - 1) // max(g, 1)
    if op == "all_to_all_single":
        return "all-to-all", nbytes, nbytes * (g - 1) // max(g, 1)
    return "collective-permute", nbytes, nbytes


def collective_census(calls) -> dict:
    """Per op kind: count, operand bytes and link bytes of (op, input
    bytes, group size) calls, with the totals, in the reference's keys."""
    census = {op: {"count": 0, "operand_bytes": 0, "link_bytes": 0}
              for op in COLLECTIVES}
    for op, nbytes, g in calls:
        name, operand, link = _census_entry(op, nbytes, g)
        census[name]["count"] += 1
        census[name]["operand_bytes"] += operand
        census[name]["link_bytes"] += link
    census["total_bytes"] = sum(v["operand_bytes"] for v in census.values()
                                if isinstance(v, dict))
    census["total_link_bytes"] = sum(v["link_bytes"] for v in census.values()
                                     if isinstance(v, dict))
    return census


def _local_census_mode():
    """A dispatch mode recording rank 0's functional collectives (op,
    input bytes, group size) in `.calls` and its flops in `.flops`."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import FlopCounterMode

    group_arg = {"all_gather_into_tensor": 1, "reduce_scatter_tensor": 2,
                 "all_to_all_single": None, "all_reduce": None}

    class _LocalCensus(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls, self.flops = [], 0
            self.formulas = FlopCounterMode(display=False).flop_registry

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented       # DTensor desugars it first
            out = func(*args, **kwargs)
            packet = func._overloadpacket
            name = packet.__name__
            if packet.__module__.endswith("_c10d_functional") \
                    or "c10d_functional" in str(packet):
                if name in group_arg:
                    x = args[0]
                    at = group_arg[name]
                    g = args[at] if at is not None else \
                        _resolve_process_group(args[-1]).size()
                    self.calls.append((name, x.numel() * x.element_size(),
                                       int(g)))
            elif packet in self.formulas:
                self.flops += self.formulas[packet](*args, **kwargs,
                                                    out_val=out)
            return out

    return _LocalCensus()


@contextlib.contextmanager
def fake_world(world: int):
    """A fake default process group of `world` ranks (this process rank 0)
    for the duration: collectives return at once with their outputs'
    shapes."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_batch(tree, spec_tree, mesh, device):
    from torch.distributed.tensor import distribute_tensor
    return {k: distribute_tensor(
        torch.zeros(sds.shape, dtype=sds.dtype, device=device), mesh,
        sharding.placements(spec_tree[k], mesh, sds.shape),
        src_data_rank=None) for k, sds in tree.items()}


SEQ_CACHES = ("k", "v", "shared_k", "shared_v", "c_kv", "k_rope")


def _placed_cache(cache, spec_tree, mesh):
    """The cache's tensors as DTensors placed by their specs, the K/V and
    latent caches' sequence dim (2) whole: the decode step writes one
    position in place."""
    from torch.distributed.tensor import distribute_tensor

    def put(name, x, spec):
        if name in SEQ_CACHES:
            spec = spec[:2] + (None,) + spec[3:]
        return distribute_tensor(x, mesh, sharding.placements(spec, mesh,
                                                              x.shape),
                                 src_data_rank=None)
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out[k] = {kk: put(kk, vv, spec_tree[k][kk])
                      for kk, vv in v.items()}
        else:
            out[k] = put(k, v, spec_tree[k]) \
                if isinstance(v, torch.Tensor) else v
    return out


def _run_step(arch, shape_name, mesh, *, seq_parallel, opt_overrides,
              cfg, train_overrides, device_type):
    """One cell's step on fake DTensors; returns the record's measured
    parts."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import OptimizerConfig
    from repro_torch.training import (TrainConfig, make_decode_step,
                                      make_prefill_step, make_train_step)
    cell = specs_mod.SHAPES[shape_name]
    rules = sharding.rules_for(arch, mesh, seq_parallel=seq_parallel)
    # The step runs outside the mode: DTensor's sharding propagation makes
    # small real index tensors (a strided shard's offsets) and reads them
    # back, which fails on fake ones; the tensors the model makes from no
    # input (positions, masks, the dispatch buffer) are then real ones of
    # the local shapes, which the fake ops take as inputs.
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    params = specs_mod.abstract_params(cfg, mesh, rules, mode)
    if cell.kind == "train":
        opt_cfg = OptimizerConfig(**(opt_overrides or {}))
        opt = specs_mod.abstract_opt_state(opt_cfg, params, mode)
        tree, spec_tree = specs_mod.token_specs(cfg, cell.batch, cell.seq,
                                                mesh)
        with mode:
            batch = _fake_batch(tree, spec_tree, mesh, device_type)
        step = make_train_step(cfg, opt_cfg,
                               TrainConfig(**(train_overrides or {})))
        args, held = (params, opt, batch), (params, opt)
    elif cell.kind == "prefill":
        tree, spec_tree = specs_mod.token_specs(cfg, cell.batch, cell.seq,
                                                mesh)
        with mode:
            tokens = _fake_batch({"inputs": tree["inputs"]},
                                 {"inputs": spec_tree["inputs"]}, mesh,
                                 device_type)["inputs"]
        step = make_prefill_step(cfg, max_len=cell.seq)
        args, held = (params, tokens), (params,)
    else:
        cache = specs_mod.abstract_cache(cfg, cell.batch, cell.seq, params,
                                         mode)
        spec_tree = specs_mod.cache_shardings(cfg, cache, mesh, cell.batch)
        bspec = specs_mod.batch_spec(mesh) if cell.batch > 1 else (None,)
        with mode:
            cache = _placed_cache(cache, spec_tree, mesh)
            cache["pos"] = cell.seq - 1
            token = _fake_batch({"t": specs_mod.SDS((cell.batch, 1),
                                                    torch.int64)},
                                {"t": (*bspec, None)}, mesh,
                                device_type)["t"]
        step = make_decode_step(cfg)
        args, held = (params, cache, token), (params, cache)
    tracker = MemTracker()
    tracker.track_external(*[x for x in tree_leaves(held)
                             if isinstance(x, torch.Tensor)])
    census = _local_census_mode()
    with sharding.use_rules(mesh, rules), implicit_replication(), tracker, \
            census:
        step(*args)
    peak = tracker.get_tracker_snapshot("peak")
    dev = next(k for k in peak if torch.device(k).type == device_type)
    return {
        "memory": {"peak_per_device_bytes": int(peak[dev]["Total"]),
                   "by_kind": {str(getattr(k, "value", k)): int(v)
                               for k, v in peak[dev].items()}},
        "cost": {"flops_per_device": int(census.flops)},
        "collectives": collective_census(census.calls),
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             seq_parallel: bool = False, opt_overrides=None,
             cfg_overrides=None, train_overrides=None,
             device_type: str = "cuda") -> dict:
    """One dry-run cell: the record of `repro.launch.dryrun.run_cell`
    where it has a counterpart (`status`, `n_devices`, `model`, `memory`,
    `cost`, `collectives`).  `device_type` is the fake tensors' device
    ("cuda" needs a CUDA build of PyTorch, not a card)."""
    from repro_torch.core.gp import resolve_device
    from repro_torch.launch import mesh as mesh_mod
    cfg = get_config(arch)
    ok, reason = specs_mod.cell_applicable(cfg, shape_name)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "seq_parallel": seq_parallel}
    if not ok:
        return dict(base, status="skipped", reason=reason)
    if specs_mod.SHAPES[shape_name].kind == "decode":
        seq_parallel = False        # decode activations have seq = 1
        base["seq_parallel"] = False
    cfg = dataclasses.replace(cfg, **(cfg_overrides or {}))
    world = 1
    for s in (mesh_mod.MULTI_POD if multi_pod else mesh_mod.SINGLE_POD):
        world *= s
    t0 = time.time()
    try:
        resolve_device(device_type)
        with fake_world(world):
            mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                                 device_type=device_type)
            measured = _run_step(arch, shape_name, mesh,
                                 seq_parallel=seq_parallel,
                                 opt_overrides=opt_overrides, cfg=cfg,
                                 train_overrides=train_overrides,
                                 device_type=device_type)
        return dict(base, status="ok", n_devices=world,
                    model={"n_params": cfg.n_params(),
                           "n_active_params": cfg.n_active_params()},
                    seconds=round(time.time() - t0, 1), **measured)
    except Exception as e:  # a failing cell is recorded, as the reference does
        return dict(base, status="error", error=f"{type(e).__name__}: {e}",
                    traceback=traceback.format_exc()[-2000:],
                    seconds=round(time.time() - t0, 1))


def iterate_cells(mesh_modes, archs=None, shapes=None):
    for arch in (archs or ARCH_IDS):
        for shape_name in (shapes or specs_mod.SHAPES):
            for multi_pod in mesh_modes:
                yield arch, shape_name, multi_pod


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(specs_mod.SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-sp", action="store_true",
                    help="disable sequence-parallel activation rules")
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device type (cpu on a CPU "
                         "build of PyTorch)")
    args = ap.parse_args(argv)

    mesh_modes = {"single": [False], "multi": [True],
                  "both": [False, True]}[args.mesh]
    archs = [args.arch] if args.arch else None
    shapes = [args.shape] if args.shape else None
    if not args.all and not args.arch:
        ap.error("pass --arch or --all")

    results = []
    for arch, shape_name, multi_pod in iterate_cells(mesh_modes, archs,
                                                     shapes):
        r = run_cell(arch, shape_name, multi_pod,
                     seq_parallel=not args.no_sp, device_type=args.device)
        results.append(r)
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"# dryrun done: ok={n_ok} skipped={n_skip} errors={n_err}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
