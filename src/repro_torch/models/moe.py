"""Token-choice top-k MoE with grouped, capacity-bounded dispatch (PyTorch
port of ``repro.models.moe``).

Tokens are split into G dispatch groups; within a group a slot's position at
its expert comes from a cumsum over a (slots, E) one-hot, and the dispatch
buffer is (G, E, capacity, d).  Slots past an expert's capacity are dropped
(GShard semantics); an aux load-balance loss is returned.

Expert weights run through one of three paths:
  * packed: ``pack_model_weights`` replaced the banks with stacked wire
    containers (``PackedStackedTensor``) and the expert products go, by
    container type through the format registry, to the grouped packed
    kernel (K6 on the card), never through a dense copy of the bank;
  * dense: an einsum on the banks in the compute dtype (the bf16 draft);
  * fakequant: each expert's (d, f) bank is quantize-dequantized along d at
    forward time (a fakequant draft such as nvfp4).

Under W4A4 the packed path, like the reference's, does not quantize the
expert inputs: the grouped kernel is called directly, not through
``qlinear``, so only the attention linears and the shared experts see the
activation fake-quant.

On a serving mesh (``parallel.sharding``) the dispatch group count follows
the ep axis, and a packed bank trio that ``shard_params`` split into E/ep x
K/tp tiles runs them through ``_expert_ffn``'s expert-parallel strategies.
The router, the dispatch and the combine run replicated on every rank.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import registry
from repro_torch.core.policy import BF16, QuantPolicy
from repro_torch.parallel.sharding import get_ctx

from .config import ArchConfig
from .layers import dense_init, swiglu, swiglu_init

__all__ = ["moe_init", "moe_forward"]


def moe_init(gen: torch.Generator, cfg: ArchConfig, *, device, dtype=torch.float32):
    """Router (d, E), expert banks gate/up (E, d, f) and down (E, f, d), and
    the shared experts' SwiGLU when the config has them."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff

    def bank(k_in, k_out):
        w = torch.randn((e, k_in, k_out), generator=gen, device=device, dtype=dtype)
        return w.mul_(1.0 / math.sqrt(k_in))

    p = {"router": dense_init(gen, d, e, device=device, dtype=dtype),
         "experts": {"gate": bank(d, f), "up": bank(d, f), "down": bank(f, d)}}
    if cfg.n_shared_experts:
        p["shared"] = swiglu_init(gen, d, cfg.n_shared_experts * f, device=device, dtype=dtype)
    return p


def _pick_groups(t: int) -> int:
    """Dispatch group count: gcd(t, ep) on a serving mesh, so the group dim
    splits evenly over the ep axis (1 on a tp-only mesh), else gcd(t, 16).
    The group count sets the capacity, so on a mesh the drops are those of
    the reference under the same mesh."""
    mesh = get_ctx()
    return max(math.gcd(t, mesh.ep if mesh is not None else 16), 1)


def _group_dispatch(xg: torch.Tensor, topi: torch.Tensor, e: int, cap: int):
    """xg (G, tg, d), topi (G, tg, k) -> (buf (G, e, cap, d), slot_expert,
    slot_pos, keep) for the combine.  Slot ``j`` belongs to token ``j // k``
    (the reference's ``slot_token = repeat(arange(tg), k)``).

    Kept slots are unique per (expert, position), so they are written by
    index assignment; dropped slots all land in the sacrificial row ``cap``,
    which is cut off."""
    g, tg, d = xg.shape
    k = topi.shape[-1]
    dev = xg.device
    slot_expert = topi.reshape(g, tg * k)
    slot_token = torch.arange(tg, device=dev).repeat_interleave(k)  # (tg*k,)
    onehot = F.one_hot(slot_expert, e)  # (G, tg*k, e)
    pos = torch.cumsum(onehot, dim=1) * onehot  # position + 1 at the slot's own expert
    slot_pos = pos.sum(dim=-1) - 1
    keep = slot_pos < cap
    safe_pos = torch.where(keep, slot_pos, cap)
    buf = torch.zeros((g, e, cap + 1, d), dtype=xg.dtype, device=dev)
    buf[torch.arange(g, device=dev)[:, None], slot_expert, safe_pos] = xg[:, slot_token]
    return buf[:, :, :cap], slot_expert, safe_pos, keep


def _group_combine(h: torch.Tensor, slot_expert, slot_pos, keep, topw: torch.Tensor) -> torch.Tensor:
    """h (G, e, cap, d) expert outputs -> (G, tg, d) weighted combine.

    A token's k slots sit next to each other, so they are added one after
    another in h's dtype, top choice first: the order the reference's
    scatter-add applies them, with no atomics (``index_add_`` on the card
    adds in a varying order)."""
    g, _, _, d = h.shape
    tg, k = topw.shape[1:]
    h_pad = F.pad(h, (0, 0, 0, 1))  # restore the sacrificial row
    slots = h_pad[torch.arange(g, device=h.device)[:, None], slot_expert, slot_pos]  # (G, tg*k, d)
    w = topw.reshape(g, tg * k) * keep.to(topw.dtype)
    contrib = (slots * w[..., None].to(h.dtype)).reshape(g, tg, k, d)
    out = torch.zeros((g, tg, d), dtype=h.dtype, device=h.device)
    for j in range(k):
        out = out + contrib[:, :, j]
    return out


def _expert_ffn(buf: torch.Tensor, we, gentry) -> torch.Tensor:
    """The packed expert FFN: buf (G, e, cap, d) -> hout (G, e, cap, d).

    On one rank the banks are whole: one grouped launch per bank over the
    per-expert (e, G*cap, d) rows.  On a serving mesh ``shard_params`` may
    have split the trio into this rank's E/ep x K/tp tiles; buf and hout
    are then replicated on every rank.  Under tp > 1 this rank takes buf's
    d/tp columns; gate and up reduce-scatter their partials over f (K8),
    silu * mul runs on the f/tp tile, which is exactly down's K slice, and
    down reduce-scatters back over d; nothing is gathered inside the chain,
    and the d/tp tiles are gathered at the end.  Tokens reach the experts
    by one of:
      * ep > 1 and G % ep == 0: this rank's G/ep groups go to the experts'
        ranks by the all-to-all dispatch and come back by the combine (the
        reference's tiled all-to-alls), then the groups are gathered;
      * ep > 1 otherwise (decode: fewer groups than ranks): every rank
        computes its own experts' slots of the replicated buffer and one
        all-gather over ep rebuilds the expert dim;
      * ep == 1: every rank computes all experts (on its K slice)."""
    from repro_torch.parallel.collectives import (all_gather_first, all_gather_last, combine_from_expert_shards,
                                                  dispatch_to_expert_shards)

    g, e, cap, d = buf.shape
    ep, tp = we["gate"].e_shards, we["gate"].k_shards
    mesh = get_ctx()
    if (ep > 1 or tp > 1) and (mesh is None or (ep > 1 and ep != mesh.ep) or (tp > 1 and tp != mesh.tp)):
        raise ValueError(f"MoE bank tiles split over ({ep}, {tp}) run only inside sharding_ctx of a mesh "
                         f"with those axes")
    le, dl = e // ep, d // tp

    def mm(x, bank):
        if tp > 1:
            return gentry.kshard_grouped_matmul_kernel(x, bank, mesh.tp_group)
        return gentry.grouped_matmul_kernel(x, bank)

    def local_ffn(xe):  # (le, M, dl) -> (le, M, dl)
        hg = mm(xe, we["gate"])
        h = hg * torch.sigmoid(hg) * mm(xe, we["up"])
        return mm(h, we["down"])

    bl = buf[..., mesh.model_index * dl:(mesh.model_index + 1) * dl] if tp > 1 else buf
    if ep == 1:
        ho = local_ffn(bl.permute(1, 0, 2, 3).reshape(e, g * cap, dl)).reshape(e, g, cap, dl).permute(1, 0, 2, 3)
    elif g % ep == 0:
        gl, i = g // ep, mesh.data_index
        x = dispatch_to_expert_shards(bl[i * gl:(i + 1) * gl], mesh.ep_group)  # (g, le, cap, dl)
        ho = local_ffn(x.permute(1, 0, 2, 3).reshape(le, g * cap, dl))
        ho = combine_from_expert_shards(ho.reshape(le, g, cap, dl).permute(1, 0, 2, 3), mesh.ep_group)
        ho = all_gather_first(ho, mesh.ep_group)  # (g, e, cap, dl)
    else:
        i = mesh.data_index
        ho = local_ffn(bl[:, i * le:(i + 1) * le].permute(1, 0, 2, 3).reshape(le, g * cap, dl))
        ho = all_gather_first(ho.reshape(le, g, cap, dl), mesh.ep_group).permute(1, 0, 2, 3)  # (g, e, cap, dl)
    return all_gather_last(ho, mesh.tp_group) if tp > 1 else ho


def moe_forward(x: torch.Tensor, p, cfg: ArchConfig, *,
                quant: QuantPolicy = BF16) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y, aux_loss).  The router runs in f32 (the ``*router*``
    dense rule keeps its weight f32)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.topk
    xf = x.reshape(t, d)

    logits = xf.to(torch.float32) @ p["router"].to(torch.float32)  # (t, e)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)
    topw = topw / torch.clamp(topw.sum(dim=-1, keepdim=True), min=1e-9)

    # Switch-style aux load-balance loss
    frac_tokens = F.one_hot(topi[:, 0], e).to(torch.float32).mean(dim=0)
    frac_probs = probs.mean(dim=0)
    aux = e * torch.sum(frac_tokens * frac_probs)

    g = _pick_groups(t)
    tg = t // g
    cap = max(int(math.ceil(tg * k / e * cfg.capacity_factor)), 1)  # the reference's expression

    buf, se, sp, keep = _group_dispatch(xf.reshape(g, tg, d), topi.reshape(g, tg, k), e, cap)
    twg = topw.reshape(g, tg, k).to(x.dtype)

    we = p["experts"]
    gentries = {r: registry.grouped_entry(we[r]) for r in ("gate", "up", "down")}
    n_grouped = sum(v is not None for v in gentries.values())
    if 0 < n_grouped < 3:
        # pack_model_weights packs a bank trio all or none (both reduction
        # dims must be block multiples); a mixed trio means hand-built params
        kinds = ", ".join(f"{r}={'packed' if v is not None else 'dense'}" for r, v in gentries.items())
        raise ValueError(f"MoE expert bank mixes packed and dense weights: {kinds}")
    gentry = gentries["gate"]
    if gentry is not None:
        if gentry.grouped_matmul_kernel is None:
            raise TypeError(f"format {gentry.name!r} packs stacked banks but registered no "
                            f"grouped_matmul_kernel; cannot run the packed expert einsum")
        hout = _expert_ffn(buf, we, gentry)
    else:
        wspec = quant.weight
        if wspec.quantizes and wspec.mode == "fakequant":
            # each expert quantized on its own along d, with its own tensor
            # scale: what pack_stacked_weights encodes on the wire
            we = {r: torch.stack([wspec.qdq(w_, axis=0) for w_ in v]) for r, v in we.items()}
        hg = torch.einsum("gecd,edf->gecf", buf, we["gate"].to(buf.dtype))
        hu = torch.einsum("gecd,edf->gecf", buf, we["up"].to(buf.dtype))
        h = hg * torch.sigmoid(hg) * hu
        hout = torch.einsum("gecf,efd->gecd", h, we["down"].to(buf.dtype))

    y = _group_combine(hout, se, sp, keep, twg).reshape(b, s, d)
    if "shared" in p:
        y = y + swiglu(x, p["shared"], quant)
    return y, aux
