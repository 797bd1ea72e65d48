"""AdamW with a cosine schedule (the port's copy of ``repro.train.optimizer``):
plain tensor ops in the reference's order of float operations, not
``torch.optim.AdamW``.

Every constant the reference divides by is a float32 tensor on the
parameters' device: CUDA divides by a host scalar as a multiplication by
its reciprocal, which rounds differently.  ``adamw_update`` writes the new
parameters and moments into the tensors it is given (the reference returns
new arrays): at full width the f32 parameters, gradients and two moments
take most of the card, and a second copy would not fit.

On a train mesh each rank updates its own shards and their moments; the
gradient norm, and so the clip scale, is the whole mesh's
(``global_norm(..., mesh=, placement=)``), the same on every rank.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from .tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "lr_at", "global_norm", "adamw_update"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    grad_clip: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor  # () int32
    m: Any
    v: Any


def init_opt_state(params) -> OptState:
    z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    dev = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev), m=z, v=tree_map(torch.clone, z))


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def lr_at(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an f32 tensor): linear warm-up, then a
    cosine decay to ``min_lr_frac`` of ``lr``."""
    warm = torch.clamp(step / _f32(max(cfg.warmup_steps, 1), step), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), step), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree, mesh=None, placement=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in f32.
    On a mesh (``placement``: the tree's ``Placement``s) ``tree`` holds
    this rank's shards: each rank sums its own, a leaf held whole along
    some axes (a norm gain, a leaf the rules leave unsplit) is counted on
    the first rank along them only, and the total is summed over the mesh."""
    total = None
    places = tree_leaves(tree_map(lambda _, pl: pl, tree, placement)) if mesh is not None else None
    for i, x in enumerate(tree_leaves(tree)):
        if places is not None and any(mesh.axis_index(a) for a in places[i].replicated_over(mesh)):
            continue
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    if mesh is not None:
        from repro_torch.parallel.collectives import group_sum

        if total is None:
            total = torch.zeros((), dtype=torch.float32, device=tree_leaves(tree)[0].device)
        total = group_sum(total, mesh.group(mesh.axis_names))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, state: OptState, cfg: AdamWConfig, *, mesh=None, placement=None):
    """-> (params, state, {"lr", "grad_norm"}); params, m and v are updated
    in place and returned.  On a mesh they are this rank's shards and
    ``placement`` their ``Placement`` tree (for the mesh's gradient norm)."""
    step = state.step + 1
    gnorm = global_norm(grads, mesh, placement)
    one = _f32(1.0, gnorm)
    scale = torch.minimum(one, _f32(cfg.grad_clip, gnorm) / (gnorm + 1e-9)) if cfg.grad_clip else one
    stepf = step.to(torch.float32)
    lr = lr_at(stepf, cfg)
    b1c = 1 - torch.pow(_f32(cfg.b1, stepf), stepf)
    b2c = 1 - torch.pow(_f32(cfg.b2, stepf), stepf)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.m), tree_leaves(state.v)):
        g = g.to(torch.float32) * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
    return params, OptState(step=step, m=state.m, v=state.v), {"lr": lr, "grad_norm": gnorm}
