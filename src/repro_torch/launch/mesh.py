"""Device meshes of the LM side on DTensor (counterpart of
`repro/launch/mesh.py`): the production meshes (16x16 single-pod, 2x16x16
multi-pod), a mesh of any shape over the process group, and one device.

A mesh spans the default process group, one rank per mesh position:
`make_mesh` needs the group to exist already (`init_process_group`, or the
fake backend of the dry run, `launch/dryrun.py`) with exactly as many ranks
as the mesh has positions.  The functions build nothing when the module is
imported.

Ranks that share one card (the card host has one) run over gloo, which
stages CUDA tensors through the host; NCCL refuses two ranks on one card
("Duplicate GPU detected").  `gloo_collectives` probes which of the three
collectives DTensor issues gloo takes on the ranks' tensors.  On an H100
under PyTorch 2.11 gloo takes all three from `torch.distributed` on CUDA
tensors, and the functional all-reduce, but its functional all-gather
(the form DTensor calls) kills the process (SIGSEGV).  So for ranks that
share a card `shared_card_collectives` builds DTensor's functional
all-gather, reduce-scatter and all-to-all on CUDA tensors from the
functional all-reduce: an all-gather sums each rank's input placed at its
offset in zeros (exact), a reduce-scatter keeps its rank's slice of the
all-reduce, an all-to-all picks its rank's chunks from an all-gather.
"""
from __future__ import annotations

import torch

SINGLE_POD = (16, 16)              # 256 devices
MULTI_POD = (2, 16, 16)            # 2 pods = 512 devices


def _product(shape) -> int:
    need = 1
    for s in shape:
        need *= s
    return need


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device_type: str = "cuda"):
    """A `DeviceMesh` of `shape` named `axes` over the default process
    group, whose world size must be the product of `shape`."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} against axes {axes}")
    need = _product(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise RuntimeError(
            f"mesh {'x'.join(map(str, shape))} needs a process group of "
            f"{need} ranks, the world has {world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    import torch.distributed as dist
    need = _product(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} ranks, the world has {world}: the "
            f"dry run builds it in one process on the fake process group "
            f"(`launch/dryrun.py`: init_process_group('fake', world_size="
            f"{need}))")
    return make_mesh(shape, axes, device_type=device_type)


def single_device_mesh(*, device_type: str = "cuda"):
    return make_mesh((1, 1), ("data", "model"), device_type=device_type)


def gloo_collectives(device) -> dict[str, str]:
    """Which of all_gather_into_tensor, reduce_scatter_tensor and
    all_reduce the default (gloo) group takes on a float32 tensor on
    `device`, from every rank: "ok", or the error's first line."""
    import torch
    import torch.distributed as dist
    world = dist.get_world_size()
    x = torch.arange(4 * world, dtype=torch.float32, device=device)
    calls = {
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(4 * world * world, device=device), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=device), x),
        "all_reduce": lambda: dist.all_reduce(x.clone()),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = "ok"
        except RuntimeError as e:   # the backend's refusal, reported
            out[name] = str(e).splitlines()[0][:200]
    return out


_SHARED_CARD = []   # the torch.library registration, made at most once


def _group(group_name: str):
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    group = _resolve_process_group(group_name)
    return group, dist.get_rank(group)


def _all_reduce(x, op: str, group_name: str):
    f = torch.ops._c10d_functional
    return f.wait_tensor(f.all_reduce(x.contiguous(), op, group_name))


def _all_gather(x, group_size: int, group_name: str):
    """All-gather along dim 0 as the sum of each rank's input placed at
    its offset in zeros."""
    _, rank = _group(group_name)
    n = x.shape[0]
    buf = x.new_zeros((group_size * n, *x.shape[1:]))
    buf[rank * n:(rank + 1) * n] = x
    return _all_reduce(buf, "sum", group_name)


def _reduce_scatter(x, op: str, group_size: int, group_name: str):
    _, rank = _group(group_name)
    n = x.shape[0] // group_size
    return _all_reduce(x, op, group_name)[rank * n:(rank + 1) * n].clone()


def _all_to_all(x, output_split_sizes, input_split_sizes, group_name: str):
    """Rank r's output: chunk r of every rank's input, in rank order (equal
    splits only)."""
    group, rank = _group(group_name)
    g = group.size()
    for sizes in (output_split_sizes, input_split_sizes):
        if sizes is not None and len(set(sizes)) > 1:
            raise ValueError(f"all_to_all on a shared card: unequal splits "
                             f"{sizes}")
    every = _all_gather(x, g, group_name).reshape(g, g, -1, *x.shape[1:])
    return every[:, rank].reshape(-1, *x.shape[1:]).clone()


def shared_card_collectives() -> None:
    """Route the functional all-gather, reduce-scatter and all-to-all on
    CUDA tensors through the functional all-reduce (see the module's
    docstring).  For ranks that share one card over gloo; once a
    process."""
    if _SHARED_CARD:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", _all_gather, "CUDA")
    lib.impl("reduce_scatter_tensor", _reduce_scatter, "CUDA")
    lib.impl("all_to_all_single", _all_to_all, "CUDA")
    _SHARED_CARD.append(lib)
