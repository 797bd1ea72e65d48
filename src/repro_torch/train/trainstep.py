"""Train, prefill and decode step factories (the port's counterpart of
``repro.train.trainstep``).

Without a mesh a step runs on one device.  On a train mesh
(``launch.mesh.make_test_mesh`` / ``make_production_mesh``) every rank
calls the step with its shards of the parameters and moments (placed as
``bind_train_step``'s ``p_shard`` / ``o_shard`` say) and the same global
batch: ``lm_loss`` runs the FSDP x TP forward inside ``sharding_ctx``
(``models/transformer.py``), the backward reduce-scatters every gathered
shard's gradient, the gradients of leaves held whole along some axes are
summed over those axes, and AdamW updates each rank's shards with the
mesh's gradient norm.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.policy import BF16, QuantPolicy
from repro_torch.models import transformer as tf
from repro_torch.models.config import ArchConfig
from repro_torch.parallel.sharding import Placement, input_sharding, param_sharding_tree, sharding_ctx

from .optimizer import AdamWConfig, OptState, adamw_update
from .tree import tree_leaves, tree_map

__all__ = ["make_train_step", "bind_train_step", "make_prefill_step", "make_decode_step", "DEFAULT_QUANT"]

DEFAULT_QUANT = BF16


def _replicas(mesh, shape) -> int:
    """How many ranks along the batch axes hold the same rows: the batch
    axes the batch does not divide over (``input_sharding``'s fallback)."""
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return mesh.axis_size(batch_axes) // mesh.axis_size(input_sharding(mesh, shape).split_axes())


def make_train_step(cfg: ArchConfig, mesh=None, opt_cfg: AdamWConfig = AdamWConfig(),
                    quant: QuantPolicy = DEFAULT_QUANT, microbatch: int = 0):
    """-> train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): ``lm_loss`` and its gradients, then ``adamw_update`` (in
    place).  ``microbatch`` > 1 splits the batch's leading dim into that
    many microbatches run one after another, their f32 gradients summed
    and divided by the count, their losses and metrics averaged, as the
    reference's scan does.

    On a mesh (``check_train_mesh`` refuses what it cannot split) params and
    opt_state are this rank's shards and ``batch`` is global: each
    microbatch's rows split over the batch axes as ``input_sharding`` says,
    and where they are replicated every replica's gradient is divided by
    their number before the sums over the mesh."""
    placement = None
    if mesh is not None:
        tf.check_train_mesh(cfg, mesh, quant)
        placement = tf.train_placement(cfg, mesh)

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with sharding_ctx(mesh):
            loss, metrics = tf.lm_loss(params, batch, cfg, quant)
            rho = 1 if mesh is None else _replicas(mesh, batch["tokens"].shape)
            grads = torch.autograd.grad(loss if rho == 1 else loss / rho, leaves)
        for p in leaves:
            p.requires_grad_(False)
        it = iter(grads)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, tree_map(lambda _: next(it), params)

    def sum_replicated(grads):
        """Sum each gradient over the axes its leaf is held whole along:
        every rank there differentiated its own rows (and heads)."""
        from repro_torch.parallel.collectives import all_reduce_

        tree_map(lambda g, pl: all_reduce_(g, mesh.group(pl.replicated_over(mesh))), grads, placement)

    def step(params, opt_state: OptState, batch):
        if microbatch and microbatch > 1:
            acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            losses, ms = [], []
            for i in range(microbatch):
                sub = {k: v.reshape(microbatch, v.shape[0] // microbatch, *v.shape[1:])[i] for k, v in batch.items()}
                loss, metrics, g = grads_of(params, sub)
                acc = tree_map(lambda a, b: a + b, acc, g)
                del g
                losses.append(loss)
                ms.append(metrics)
            grads = tree_map(lambda g: g / microbatch, acc)
            loss = torch.mean(torch.stack(losses))
            metrics = {k: torch.mean(torch.stack([m[k] for m in ms])) for k in ms[0]}
        else:
            loss, metrics, grads = grads_of(params, batch)
        if mesh is not None:
            sum_replicated(grads)
        params, opt_state, opt_metrics = adamw_update(params, grads, opt_state, opt_cfg, mesh=mesh,
                                                      placement=placement)
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    return step


def bind_train_step(cfg: ArchConfig, mesh, params_shape=None, opt_cfg: AdamWConfig = AdamWConfig(),
                    quant: QuantPolicy = DEFAULT_QUANT, microbatch: int = 0, donate: bool = True):
    """-> (step, p_shard, o_shard): the mesh's train step and the
    ``Placement`` trees of the parameters and of the optimizer state
    (``OptState`` of placements; the step counter whole).  ``params_shape``
    is a tree of the global parameters (any tensors with their shapes, the
    ``meta`` device will do; by default ``init_params(cfg, device="meta")``).
    The step updates params and moments in place, as the reference's
    donated buffers; ``donate=False`` steps copies, leaving the caller's
    tensors as they were."""
    if mesh is None:
        raise ValueError("bind_train_step places the step on a mesh; make_train_step(cfg, None, ...) runs meshless")
    step = make_train_step(cfg, mesh, opt_cfg, quant, microbatch)
    p_shard = param_sharding_tree(params_shape if params_shape is not None else
                                  tf.init_params(cfg, device="meta"), mesh)
    if p_shard != tf.train_placement(cfg, mesh):
        raise ValueError(f"params_shape is not {cfg.name}'s parameter tree")
    o_shard = OptState(step=Placement(()), m=p_shard, v=p_shard)
    if donate:
        return step, p_shard, o_shard

    def kept(params, opt_state: OptState, batch):
        return step(tree_map(torch.clone, params), tree_map(torch.clone, opt_state), batch)

    return kept, p_shard, o_shard


def make_prefill_step(cfg: ArchConfig, mesh=None, max_len: int = 0, quant: QuantPolicy = DEFAULT_QUANT):
    """-> prefill(params, batch) -> (last logits, caches, enc), inside
    ``sharding_ctx(mesh)``: on a serving mesh ``params`` are this rank's
    tree from ``parallel.sharding.shard_params``."""

    @torch.no_grad()
    def prefill(params, batch):
        with sharding_ctx(mesh):
            return tf.prefill(params, batch["tokens"], cfg, quant, max_len=max_len,
                              positions3=batch.get("positions3"), frontend_embeds=batch.get("frontend_embeds"),
                              enc_frames=batch.get("enc_frames"))

    return prefill


def make_decode_step(cfg: ArchConfig, mesh=None, quant: QuantPolicy = DEFAULT_QUANT):
    """-> decode(params, token, caches, cur_len, enc=None) -> (logits,
    caches), the caches updated in place, inside ``sharding_ctx(mesh)``."""

    @torch.no_grad()
    def decode(params, token, caches, cur_len, enc: Optional[torch.Tensor] = None):
        with sharding_ctx(mesh):
            return tf.decode_step(params, token, caches, cur_len, cfg, quant, enc=enc)

    return decode
