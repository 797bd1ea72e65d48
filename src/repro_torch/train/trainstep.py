"""Train, prefill and decode step factories (the port's counterpart of
``repro.train.trainstep``), meshless: the sharded steps wait for a mesh
with one rank per card (``launch.mesh``), and a mesh other than None
raises."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.policy import BF16, QuantPolicy
from repro_torch.models import transformer as tf
from repro_torch.models.config import ArchConfig

from .optimizer import AdamWConfig, OptState, adamw_update
from .tree import tree_leaves, tree_map

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step", "DEFAULT_QUANT"]

DEFAULT_QUANT = BF16


def _meshless(mesh, what: str) -> None:
    if mesh is not None:
        raise ValueError(f"{what} runs meshless in the port (mesh=None): sharded training and its steps wait for "
                         "a mesh with one rank per card")


def make_train_step(cfg: ArchConfig, mesh=None, opt_cfg: AdamWConfig = AdamWConfig(),
                    quant: QuantPolicy = DEFAULT_QUANT, microbatch: int = 0):
    """-> train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): ``lm_loss`` and its gradients, then ``adamw_update`` (in
    place).  ``microbatch`` > 1 splits the batch's leading dim into that
    many microbatches run one after another, their f32 gradients summed
    and divided by the count, their losses and metrics averaged, as the
    reference's scan does."""
    _meshless(mesh, "make_train_step")

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics = tf.lm_loss(params, batch, cfg, quant)
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        it = iter(grads)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, tree_map(lambda _: next(it), params)

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
        params, opt_state, opt_metrics = adamw_update(params, grads, opt_state, opt_cfg)
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    return step


def make_prefill_step(cfg: ArchConfig, mesh=None, max_len: int = 0, quant: QuantPolicy = DEFAULT_QUANT):
    """-> prefill(params, batch) -> (last logits, caches, enc)."""
    _meshless(mesh, "make_prefill_step")

    @torch.no_grad()
    def prefill(params, batch):
        return tf.prefill(params, batch["tokens"], cfg, quant, max_len=max_len,
                          positions3=batch.get("positions3"), frontend_embeds=batch.get("frontend_embeds"),
                          enc_frames=batch.get("enc_frames"))

    return prefill


def make_decode_step(cfg: ArchConfig, mesh=None, quant: QuantPolicy = DEFAULT_QUANT):
    """-> decode(params, token, caches, cur_len, enc=None) -> (logits,
    caches), the caches updated in place."""
    _meshless(mesh, "make_decode_step")

    @torch.no_grad()
    def decode(params, token, caches, cur_len, enc: Optional[torch.Tensor] = None):
        return tf.decode_step(params, token, caches, cur_len, cfg, quant, enc=enc)

    return decode
