"""Mesh construction over ``torch.distributed`` (PyTorch port of
``repro.launch.mesh``): ``make_serving_mesh`` (ep x tp), and the train
meshes ``make_test_mesh`` (any (data, model) or (pod, data, model) shape)
and ``make_production_mesh`` (16 x 16, or 2 x 16 x 16 over two pods).

Every rank calls the factory with the same arguments.  The process
group is the caller's: ``init_method`` (``env://`` under ``torchrun``, a
``file://`` or ``tcp://localhost:<port>`` path otherwise), ``rank`` and
``world_size`` (read from the environment when not given) and ``backend``,
which is always the caller's choice, never picked here.  On a machine with
several cards rank r takes card ``LOCAL_RANK % device_count`` (NCCL wants
one rank per card); ranks that share one card can only run over gloo.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.parallel.sharding import AXES, ServingMesh, axis_groups

__all__ = ["make_serving_mesh", "make_test_mesh", "make_production_mesh"]


def _local_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def _join(backend: str, init_method: str, rank: Optional[int], world_size: Optional[int]) -> None:
    """Join the default process group unless it is up (with ``backend``)."""
    if not dist.is_initialized():
        if rank is None and "RANK" in os.environ:
            rank = int(os.environ["RANK"])
        if world_size is None and "WORLD_SIZE" in os.environ:
            world_size = int(os.environ["WORLD_SIZE"])
        dist.init_process_group(backend, init_method=init_method, rank=-1 if rank is None else rank,
                                world_size=-1 if world_size is None else world_size)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, not the requested {backend!r}")


def make_serving_mesh(*, ep: Optional[int] = None, tp: int = 1, backend: str = "nccl", device="cuda",
                      init_method: str = "env://", rank: Optional[int] = None,
                      world_size: Optional[int] = None) -> ServingMesh:
    """This rank's (ep, tp) serving mesh over ("data", "model").

    Joins the default process group first if it is not up yet.  ``ep``
    defaults to ``world_size // tp``; ep x tp must equal the number of
    ranks.  The data axis doubles as the expert-parallel axis: packed MoE
    banks split E/ep expert rows per rank along it, so pick an ep that
    divides ``n_experts`` (``parallel.sharding.expert_shard_size`` has the
    exact rule)."""
    if tp <= 0:
        raise ValueError(f"tp must be positive, got {tp}")
    if ep is not None and ep <= 0:
        raise ValueError(f"ep must be positive, got {ep}")
    dev = resolve_device(device)
    _join(backend, init_method, rank, world_size)
    n = dist.get_world_size()
    if ep is None:
        ep = max(n // tp, 1)
    if ep * tp > n:
        raise ValueError(f"serving mesh ({ep}, {tp}) needs {ep * tp} ranks but only {n} joined the "
                         f"process group (start that many, e.g. torchrun --nproc-per-node {ep * tp})")
    if ep * tp < n:
        raise ValueError(f"serving mesh ({ep}, {tp}) holds {ep * tp} ranks but {n} joined the process "
                         f"group; every rank must sit on the mesh")
    me = dist.get_rank()
    i, j = divmod(me, tp)
    # every rank creates every group, in the same order, as new_group requires
    tp_groups = [dist.new_group([a * tp + b for b in range(tp)]) for a in range(ep)]
    ep_groups = [dist.new_group([a * tp + b for a in range(ep)]) for b in range(tp)]
    return ServingMesh(ep=ep, tp=tp, data_index=i, model_index=j, device=_local_device(dev),
                       backend=backend, ep_group=ep_groups[j], tp_group=tp_groups[i])


def _train_mesh(shape, axes, what: str, *, backend: str, device, init_method: str, rank: Optional[int],
                world_size: Optional[int]) -> ServingMesh:
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or list(axes) != [a for a in AXES if a in axes] or "model" not in axes:
        raise ValueError(f"a train mesh's axes are (data, model) or (pod, data, model) in that order, each with "
                         f"a size; got shape {shape} over {axes}")
    if min(shape) <= 0:
        raise ValueError(f"mesh axis sizes must be positive, got {shape}")
    dev = resolve_device(device)
    _join(backend, init_method, rank, world_size)
    n, need = dist.get_world_size(), 1
    for size in shape:
        need *= size
    if need != n:
        raise ValueError(f"{what} {shape} over {axes} needs {need} ranks but {n} joined the process group "
                         f"(start {need}, e.g. torchrun --nproc-per-node {need}, with one card each under NCCL)")
    sizes = dict(zip(axes, shape))
    me = dist.get_rank()
    groups = {}
    for ax, members in axis_groups(sizes):  # every rank creates every group, in the same order
        for ranks in members:
            g = dist.new_group(ranks)
            if me in ranks:
                groups[ax] = g
    j, rest = me % sizes["model"], me // sizes["model"]
    i, p = rest % sizes.get("data", 1), rest // sizes.get("data", 1)
    return ServingMesh(ep=sizes.get("data", 1), tp=sizes["model"], data_index=i, model_index=j,
                       device=_local_device(dev), backend=backend, ep_group=groups.get(("data",)),
                       tp_group=groups.get(("model",)), pod=sizes.get("pod", 1), pod_index=p, axis_names=axes,
                       groups=groups)


def make_test_mesh(shape=(1, 1), axes=("data", "model"), *, backend: str = "nccl", device="cuda",
                   init_method: str = "env://", rank: Optional[int] = None,
                   world_size: Optional[int] = None) -> ServingMesh:
    """This rank's train mesh of ``shape`` over ``axes`` (the reference's
    ``make_test_mesh``): (1, 1) over a world of n > 1 ranks becomes (n,
    1), as there.  The ranks' number must equal the shape's product."""
    _join(backend, init_method, rank, world_size)
    if tuple(shape) == (1, 1) and dist.get_world_size() > 1:
        shape = (dist.get_world_size(), 1)
    return _train_mesh(shape, axes, "test mesh", backend=backend, device=device, init_method=init_method,
                       rank=rank, world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False, backend: str = "nccl", device="cuda",
                         init_method: str = "env://", rank: Optional[int] = None,
                         world_size: Optional[int] = None) -> ServingMesh:
    """The reference's production mesh: (16, 16) over (data, model), or
    (2, 16, 16) over (pod, data, model); 256 or 512 ranks must join."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _train_mesh(shape, axes, "production mesh", backend=backend, device=device, init_method=init_method,
                       rank=rank, world_size=world_size)
