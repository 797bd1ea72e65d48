"""Token-choice top-k MoE with grouped, capacity-bounded dispatch (PyTorch
port of ``repro.models.moe``, without the mesh).

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

Not ported: the expert-parallel ``shard_map`` path (parallelism slice).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import registry
from repro_torch.core.policy import BF16, QuantPolicy

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
    """Dispatch group count: a small divisor of t (the reference matches a
    mesh's data axis when one is active; there is none here)."""
    return max(math.gcd(t, 16), 1)


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
        grouped_mm = gentry.grouped_matmul_kernel
        if grouped_mm is None:
            raise TypeError(f"format {gentry.name!r} packs stacked banks but registered no "
                            f"grouped_matmul_kernel; cannot run the packed expert einsum")
        # (G, e, cap, d) -> per-expert (e, G*cap, d) rows, one grouped launch each
        xe = buf.permute(1, 0, 2, 3).reshape(e, g * cap, d)
        hg = grouped_mm(xe, we["gate"])
        h = hg * torch.sigmoid(hg) * grouped_mm(xe, we["up"])
        hout = grouped_mm(h, we["down"]).reshape(e, g, cap, d).permute(1, 0, 2, 3)
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
