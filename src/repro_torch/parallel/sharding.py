"""Serving-mesh context and parameter placement (PyTorch port of
``repro.parallel.sharding`` for the serving mesh).

A serving mesh is ep x tp ranks of ``torch.distributed`` laid out over two
axes, as in the reference (docs/parallelism.md):
  * "data" (ep): the expert-parallel axis; a packed MoE bank splits its
    expert dim over it;
  * "model" (tp): the tensor-parallel axis; a packed weight splits its
    reduction dim K over it, in whole 16-element quant blocks.
Rank ``i * tp + j`` sits at data index i and model index j.  ``tp_group``
holds the ranks that share this rank's data index, ``ep_group`` those that
share its model index.

Model code reads the live mesh through ``get_ctx()`` inside
``sharding_ctx(mesh)``.  Unlike the reference, whose parameters are global
arrays that XLA places, each rank here holds its own local tree:
``shard_params`` replaces every eligible packed container by this rank's
shard of it (``PackedRazerWeight.local_shard`` / ``PackedStackedTensor.
local_shard`` metadata, through the format registry's shard hooks), and
everything else -- embeddings, head, router, norms, ineligible containers --
stays replicated.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Optional, Tuple

import torch

from repro_torch.core import registry

__all__ = ["ServingMesh", "get_ctx", "sharding_ctx", "expert_shard_size", "kshard_size",
           "packed_weight_shards", "stacked_bank_shards", "moe_bank_shards", "shard_params"]


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """This rank's view of an (ep, tp) serving mesh (``launch.mesh.
    make_serving_mesh`` builds it)."""

    ep: int
    tp: int
    data_index: int  # i: this rank's coordinate on the ep axis
    model_index: int  # j: this rank's coordinate on the tp axis
    device: torch.device
    backend: str
    ep_group: Any = None  # ProcessGroup over the ranks (*, j)
    tp_group: Any = None  # ProcessGroup over the ranks (i, *)

    @property
    def rank(self) -> int:
        return self.data_index * self.tp + self.model_index


_local = threading.local()


def get_ctx() -> Optional[ServingMesh]:
    return getattr(_local, "ctx", None)


@contextlib.contextmanager
def sharding_ctx(mesh: Optional[ServingMesh]):
    prev = getattr(_local, "ctx", None)
    _local.ctx = mesh
    try:
        yield mesh
    finally:
        _local.ctx = prev


def expert_shard_size(e: int, ep: int) -> int:
    """local_E = E // ep for an expert-parallel shard, or a clear error."""
    if ep <= 0:
        raise ValueError(f"expert-parallel axis size must be positive, got ep={ep}")
    if e % ep:
        raise ValueError(
            f"cannot expert-parallel-shard E={e} experts over ep={ep} devices: "
            f"E must be divisible by the ep (data) mesh axis size -- choose a "
            f"mesh whose data axis divides n_experts, or leave the bank "
            f"replicated (see docs/parallelism.md)"
        )
    return e // ep


def kshard_size(k: int, tp: int, *, quant_block: int = 16) -> int:
    """local_K = K // tp for a tensor-parallel K-shard, or a clear error:
    block scales live along K, so K/tp must be a whole number of blocks."""
    if tp <= 0:
        raise ValueError(f"tensor-parallel axis size must be positive, got tp={tp}")
    if k % (tp * quant_block):
        raise ValueError(
            f"cannot tensor-parallel-shard the packed K dimension K={k} over "
            f"tp={tp} devices: K must be divisible by tp*quant_block = "
            f"{tp}*{quant_block} = {tp * quant_block} so every shard holds "
            f"whole {quant_block}-element quant blocks (block scales live "
            f"along K) -- choose a tp (model) axis size that divides "
            f"K/{quant_block}, or leave the weight replicated "
            f"(see docs/parallelism.md)"
        )
    return k // tp


def packed_weight_shards(pw, mesh: ServingMesh, *, strict: bool = False) -> int:
    """How many K-shards a dense packed weight splits into on ``mesh``: tp
    when the format has a shard hook, tp > 1, K % (tp * 16) == 0 and N % tp
    == 0 (the reduce-scatter tiles N over the axis), else 1 (replicated;
    the reference's ``packed_weight_specs`` returns None).  ``strict=True``
    raises the ``kshard_size`` error for an indivisible K."""
    entry = registry.packed_entry(pw)
    if entry is None or entry.shard_packed_fn is None or mesh.tp <= 1:
        return 1
    k, n = pw.shape
    if k % (mesh.tp * 16):
        if strict:
            kshard_size(k, mesh.tp)
        return 1
    return mesh.tp if n % mesh.tp == 0 else 1


def stacked_bank_shards(bank, mesh: ServingMesh, *, strict: bool = False) -> Optional[Tuple[int, int]]:
    """(expert shards, K shards) of one stacked packed bank on ``mesh``, or
    None when it cannot shard at all (no shard hook, or E % ep != 0; the
    reference's ``stacked_bank_specs`` returns None).  K splits over tp > 1
    when K % (tp * 16) == 0; an indivisible K degrades to the expert split
    alone.  ``strict=True`` raises the ``expert_shard_size`` /
    ``kshard_size`` error instead of degrading."""
    entry = registry.grouped_entry(bank)
    if entry is None or entry.shard_stacked_fn is None:
        return None
    e, k = bank.shape[0], bank.shape[1]
    if e % mesh.ep:
        if strict:
            expert_shard_size(e, mesh.ep)
        return None
    k_shards = 1
    if mesh.tp > 1:
        if k % (mesh.tp * 16) == 0:
            k_shards = mesh.tp
        elif strict:
            kshard_size(k, mesh.tp)
    return mesh.ep, k_shards


def moe_bank_shards(experts, mesh: ServingMesh) -> Tuple[int, int]:
    """(ep, tp) an MoE layer's packed gate/up/down trio runs on, as one
    unit (the reference's ``moe_forward`` gate): experts split over ep > 1
    when ep divides E; K splits over tp > 1 only when both d and f split
    into whole quant blocks per rank -- gate/up reduce over d, down over f,
    and each reduce-scatter tiles the other -- else the trio stays
    K-whole."""
    gate = experts["gate"]
    entry = registry.grouped_entry(gate)
    if entry is None or entry.shard_stacked_fn is None:
        return 1, 1
    e, d, f = gate.shape
    ep = mesh.ep if mesh.ep > 1 and e % mesh.ep == 0 else 1
    tp = mesh.tp if mesh.tp > 1 and d % (mesh.tp * 16) == 0 and f % (mesh.tp * 16) == 0 else 1
    return ep, tp


def shard_params(params, mesh: ServingMesh):
    """This rank's local tree of a packed parameter tree: every K-shardable
    packed weight becomes its K/tp shard and every packed MoE trio its
    E/ep x K/tp tiles (``moe_bank_shards``); every other leaf, and every
    container that cannot shard, is kept whole (the counterpart of the
    reference's ``param_sharding_tree``, with dense leaves replicated)."""

    def walk(tree):
        if isinstance(tree, dict):
            if {"gate", "up", "down"} <= tree.keys() and registry.grouped_entry(tree["gate"]) is not None:
                ep, tp = moe_bank_shards(tree, mesh)
                if ep == 1 and tp == 1:
                    return dict(tree)
                out = dict(tree)
                for role in ("gate", "up", "down"):
                    bank = tree[role]
                    out[role] = registry.grouped_entry(bank).shard_stacked_fn(
                        bank, ep, mesh.data_index if ep > 1 else 0, tp, mesh.model_index if tp > 1 else 0)
                return out
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        tp = packed_weight_shards(tree, mesh)
        if tp > 1:
            return registry.packed_entry(tree).shard_packed_fn(tree, tp, mesh.model_index)
        return tree

    return walk(params)
