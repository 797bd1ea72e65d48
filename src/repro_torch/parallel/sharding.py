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

A train mesh is the same class widened to the reference's optional "pod"
axis (inter-pod data parallelism): rank ``(p * data + i) * model + j`` sits
at (p, i, j), and ``groups`` holds, for every set of axes whose size is above
1, this rank's process group along them (``group``).  Training places dense
leaves as the reference's ``param_sharding_tree`` does (``_PARAM_RULES``:
FSDP over "data", TP over "model", the same divisibility fallbacks), each
rank holding its block of every split dim (``Placement``); the batch splits
over ("pod", "data") with ``input_sharding``'s fallbacks, and the
residual stream follows the reference's "resid" activation rule: its
sequence rows over "model" (``activation_spec``, ``shard_activation``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import re
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import registry

__all__ = ["ServingMesh", "AXES", "get_ctx", "sharding_ctx", "expert_shard_size", "kshard_size",
           "packed_weight_shards", "stacked_bank_shards", "moe_bank_shards", "shard_params", "Placement",
           "param_spec", "param_sharding_tree", "input_sharding", "local_tree", "activation_spec",
           "shard_activation", "axis_groups"]

AXES = ("pod", "data", "model")  # the reference's axis names, in rank-major order


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """This rank's view of an (ep, tp) serving mesh (``launch.mesh.
    make_serving_mesh`` builds it), or of a (pod,) data x model train mesh
    (``make_test_mesh``, ``make_production_mesh``)."""

    ep: int
    tp: int
    data_index: int  # i: this rank's coordinate on the ep (data) axis
    model_index: int  # j: this rank's coordinate on the tp (model) axis
    device: torch.device
    backend: str
    ep_group: Any = None  # ProcessGroup over the ranks (p, *, j)
    tp_group: Any = None  # ProcessGroup over the ranks (p, i, *)
    pod: int = 1
    pod_index: int = 0
    axis_names: Tuple[str, ...] = ("data", "model")
    # {axes (in AXES order, each of size > 1): this rank's ProcessGroup along them}
    groups: Any = dataclasses.field(default=None, compare=False, hash=False)

    @property
    def rank(self) -> int:
        return (self.pod_index * self.ep + self.data_index) * self.tp + self.model_index

    @property
    def shape(self) -> Dict[str, int]:
        return {a: self.axis_size(a) for a in self.axis_names}

    def axis_size(self, axes) -> int:
        """The product of the sizes of ``axes`` (a name, a tuple of names or
        None)."""
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        sizes = {"pod": self.pod, "data": self.ep, "model": self.tp}
        return math.prod(sizes[a] for a in axes)

    def axis_index(self, axes) -> int:
        """This rank's coordinate along ``axes``, row-major (the block a
        dim split over them gives it)."""
        if axes is None:
            return 0
        if isinstance(axes, str):
            axes = (axes,)
        index = {"pod": self.pod_index, "data": self.data_index, "model": self.model_index}
        out = 0
        for a in axes:
            out = out * self.axis_size(a) + index[a]
        return out

    def group(self, axes):
        """This rank's process group along ``axes`` (a name or names), or
        None when they hold this rank alone (nothing to exchange)."""
        if isinstance(axes, str):
            axes = (axes,)
        key = tuple(a for a in AXES if a in axes and a in self.axis_names and self.axis_size(a) > 1)
        if not key:
            return None
        if self.groups is None or key not in self.groups:
            raise ValueError(f"this mesh holds no process group along {key} (build it with launch.mesh)")
        return self.groups[key]


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


# ---------------------------------------------------------------------------
# training placement (the reference's param_spec / param_sharding_tree /
# input_sharding and its activation rules)
# ---------------------------------------------------------------------------
def axis_groups(shape: Dict[str, int]):
    """[(axes, [[ranks of one group], ...]), ...] for every set of mesh axes
    whose sizes are all above 1, in a fixed order: every rank creates every
    group in this order (``torch.distributed.new_group`` requires it)."""
    names = [a for a in AXES if a in shape]
    sizes = [shape[a] for a in names]
    coords = list(itertools.product(*(range(n) for n in sizes)))

    def rank_of(c):
        r = 0
        for n, i in zip(sizes, c):
            r = r * n + i
        return r

    out = []
    live = [a for a in names if shape[a] > 1]
    for k in range(1, len(live) + 1):
        for axes in itertools.combinations(live, k):
            idx = [names.index(a) for a in axes]
            members: Dict[tuple, list] = {}
            for c in coords:
                members.setdefault(tuple(v for i, v in enumerate(c) if i not in idx), []).append(rank_of(c))
            out.append((axes, list(members.values())))
    return out


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one leaf lives on a train mesh: for each dim, the axis (or
    tuple of axes) it is split over, or None (whole on every rank).  A rank
    holds block ``axis_index`` of each split dim, as a ``NamedSharding``
    of the same spec does."""

    spec: Tuple[Any, ...] = ()

    def shard_shape(self, shape, mesh: ServingMesh) -> Tuple[int, ...]:
        return tuple(n // mesh.axis_size(self.axis(d)) for d, n in enumerate(shape))

    def axis(self, dim: int):
        return self.spec[dim] if dim < len(self.spec) else None

    def local(self, t, mesh: ServingMesh):
        """This rank's block of a whole ``t`` (a view)."""
        for d in range(t.ndim):
            ax = self.axis(d)
            n = mesh.axis_size(ax)
            if n > 1:
                size = t.shape[d] // n
                t = t.narrow(d, mesh.axis_index(ax) * size, size)
        return t

    def split_axes(self) -> Tuple[str, ...]:
        out = []
        for ax in self.spec:
            out += [ax] if isinstance(ax, str) else list(ax or ())
        return tuple(out)

    def replicated_over(self, mesh: ServingMesh) -> Tuple[str, ...]:
        """The mesh axes along which every rank holds the same block."""
        return tuple(a for a in mesh.axis_names if a not in self.split_axes())


# (path regex, per-dim preferred roles): the reference's table.  A role is
# dropped for a dim the axis size does not divide; "fsdp" resolves to the
# data axis (never pod), "tp" to the model axis, "ep" to the data axis.
_PARAM_RULES = [
    (r"(^|/)(embed|lm_head|unembed)(/|$)", ("tp", "fsdp")),
    (r"experts/(gate|up)$", ("ep", None, "tp")),
    (r"experts/down$", ("ep", "tp", None)),
    (r"(wq|wk|wv|wkv|wo|q_a|q_b|kv_a|kv_b|gate|up|down|in_proj|out_proj|w_gate|w_in|router|w_dt)$",
     ("fsdp", "tp")),
    (r".*", None),
]


def _resolve_axis(role, mesh: ServingMesh):
    if role == "tp":
        return "model" if "model" in mesh.axis_names else None
    if role in ("fsdp", "ep"):
        return "data" if "data" in mesh.axis_names else None
    return role


def param_spec(path: str, shape: Sequence[int], mesh: ServingMesh) -> Placement:
    """The placement of one parameter at '/'-joined ``path`` (the port's
    trees carry no layer-stack dim: a layer group's leaves are per layer)."""
    for pat, roles in _PARAM_RULES:
        if re.search(pat, path):
            if roles is None:
                return Placement(())
            axes: list = [None] * len(shape)
            for d, role in enumerate(roles):
                if role is None or d >= len(shape):
                    continue
                ax = _resolve_axis(role, mesh)
                if ax is not None and shape[d] % mesh.axis_size(ax) == 0:
                    axes[d] = ax
            return Placement(tuple(axes))
    return Placement(())


def param_sharding_tree(params, mesh: ServingMesh):
    """A tree of ``Placement`` shaped like ``params`` (dicts, the layer
    groups' lists; leaves anything with a global ``shape``)."""

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, prefix) for v in tree]
        return param_spec(prefix, tuple(tree.shape), mesh)

    return walk(params, "")


def input_sharding(mesh: ServingMesh, shape, batch_dim: int = 0) -> Placement:
    """The batch dim over ("pod", "data"), falling back to "data" alone and
    then to none when the batch does not divide (the reference's)."""
    axes: list = [None] * len(shape)
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    if batch_axes:
        for cand in (batch_axes, batch_axes[-1:]):
            if shape[batch_dim] % mesh.axis_size(cand) == 0:
                axes[batch_dim] = cand if len(cand) > 1 else cand[0]
                break
    return Placement(tuple(axes))


def local_tree(tree, placement, mesh: ServingMesh):
    """This rank's shards of a tree of whole tensors (contiguous copies,
    so the whole tensors can be freed)."""
    if isinstance(tree, dict):
        return {k: local_tree(v, placement[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(local_tree(v, p, mesh) for v, p in zip(tree, placement))
    if hasattr(tree, "_fields"):
        return type(tree)(*(local_tree(v, p, mesh) for v, p in zip(tree, placement)))
    return placement.local(tree, mesh).clone()


def activation_spec(shape, mesh: ServingMesh) -> Placement:
    """The reference's "resid" activation rule for a global (B, S, d)
    ``shape``: the batch over ("pod", "data") and the sequence over
    "model" (Megatron's sequence parallelism: the residual stream and the
    norms live on S/tp rows), each only where its size divides."""
    axes: list = [None] * len(shape)
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    if batch_axes and shape[0] % mesh.axis_size(batch_axes) == 0:
        axes[0] = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    if "model" in mesh.axis_names and shape[1] % mesh.tp == 0:
        axes[1] = "model"
    return Placement(tuple(axes))


def shard_activation(x: torch.Tensor, *, partial: bool = False, mesh: Optional[ServingMesh] = None
                     ) -> torch.Tensor:
    """The port's counterpart of the reference's "resid" constraint.
    Outside a mesh, x.  On a train mesh x (B, S, d) holds this rank's batch
    rows and its whole sequence -- the same on every rank of the model
    group, or with ``partial`` each rank's partial sum (a row-parallel
    matmul's output) -- and this returns this rank's S/tp rows: a slice,
    or the sum over the group scattered (``collectives.scatter_dim``).
    ``mesh`` overrides the context's (a layer recomputed in the backward
    may run on autograd's own thread, outside the caller's
    ``sharding_ctx``)."""
    mesh = mesh or get_ctx()
    if mesh is None or mesh.tp == 1:
        return x
    from repro_torch.parallel import collectives

    if activation_spec((0,) + tuple(x.shape[1:]), mesh).axis(1) != "model":
        raise ValueError(f"the sequence of {x.shape[1]} tokens does not split over the model axis of size "
                         f"{mesh.tp}: the port keeps the residual stream on S/tp rows a rank (sequence "
                         "parallelism)")
    if partial:
        return collectives.scatter_dim(x, 1, mesh.group("model"))
    size = x.shape[1] // mesh.tp
    return x.narrow(1, mesh.model_index * size, size)
