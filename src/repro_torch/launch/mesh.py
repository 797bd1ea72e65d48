"""Serving-mesh construction over ``torch.distributed`` (PyTorch port of
``repro.launch.mesh.make_serving_mesh``).

Every rank calls ``make_serving_mesh`` with the same arguments.  The process
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
from repro_torch.parallel.sharding import ServingMesh

__all__ = ["make_serving_mesh"]


def _local_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


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
    if not dist.is_initialized():
        if rank is None and "RANK" in os.environ:
            rank = int(os.environ["RANK"])
        if world_size is None and "WORLD_SIZE" in os.environ:
            world_size = int(os.environ["WORLD_SIZE"])
        dist.init_process_group(backend, init_method=init_method, rank=-1 if rank is None else rank,
                                world_size=-1 if world_size is None else world_size)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, not the requested {backend!r}")
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
