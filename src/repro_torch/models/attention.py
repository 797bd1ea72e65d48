"""GQA attention (PyTorch port of the dense path of ``repro.models.attention``).

Full-sequence attention is an online-softmax walk over KV chunks written as
plain matmuls, as the JAX package computes it outside any kernel.  Decode
attends one query per sequence against a bf16 cache, or, through
``kernels.ops``, against the RaZeR-packed cache.

Dtypes follow the JAX einsums with ``preferred_element_type=float32``: the
operands are promoted to their common type and multiplied with f32
accumulation, and the probabilities are cast to V's dtype before the PV
product.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.policy import BF16, QuantPolicy
from repro_torch.core.qlinear import qlinear

from .config import ArchConfig
from .layers import apply_rope, rms_norm


def _softmax_scale(hd: int) -> float:
    """1 / sqrt(hd) rounded as float32 arithmetic rounds it (a Python float
    holding that float32 value, so no device copy)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def _pick_chunk(s: int, target: int = 1024) -> int:
    c = min(s, target)
    while s % c:
        c //= 2
    return max(c, 1)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Skv, KVH, hd) with H % KVH == 0 -> (B, Sq, H, hd).

    Query i sits at position i (no offset); the causal mask keeps key
    positions <= i.  Masked scores are -1e30 and the output is
    acc / max(l, 1e-30), as in the JAX package."""
    b, sq, h, hd = q.shape
    _, skv, kvh, _ = k.shape
    g = h // kvh
    kc = _pick_chunk(skv, kv_chunk)
    scale = _softmax_scale(hd)
    op = torch.promote_types(q.dtype, k.dtype)
    qg = q.reshape(b, sq, kvh, g, hd).permute(0, 2, 3, 1, 4).to(op).float()  # (b,kvh,g,sq,hd)
    qpos = torch.arange(sq, device=q.device)
    m = torch.full((b, kvh, g, sq), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, g, sq, hd), dtype=torch.float32, device=q.device)
    for c0 in range(0, skv, kc):
        kblk = k[:, c0:c0 + kc].to(op).float().permute(0, 2, 3, 1)  # (b,kvh,hd,kc)
        vblk = v[:, c0:c0 + kc].permute(0, 2, 1, 3)  # (b,kvh,kc,hd)
        s = (qg @ kblk[:, :, None]) * scale  # (b,kvh,g,sq,kc)
        if causal:
            kpos = c0 + torch.arange(kc, device=q.device)
            s = torch.where(kpos[None, :] <= qpos[:, None], s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = p.to(vblk.dtype).float() @ vblk.float()[:, :, None]
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, cur_len) -> torch.Tensor:
    """One query per sequence: q (B, 1, H, hd) against (B, Smax, KVH, hd)
    caches; positions >= cur_len (int or (B,)) are masked."""
    b, _, h, hd = q.shape
    _, smax, kvh, _ = k_cache.shape
    g = h // kvh
    scale = _softmax_scale(hd)
    qg = q.reshape(b, kvh, g, hd)
    kf = k_cache.to(qg.dtype).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), kf) * scale
    pos = torch.arange(smax, device=q.device)
    cur = torch.as_tensor(cur_len, device=q.device).reshape(-1, 1)
    mask = pos[None, :] < cur
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, -1e30))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


def _qkv(x: torch.Tensor, p, cfg: ArchConfig, quant: QuantPolicy, positions: torch.Tensor):
    b, s, _ = x.shape
    hd = cfg.hd
    q = qlinear(x, p["wq"], quant, p.get("bq")).reshape(b, s, cfg.num_heads, hd)
    k = qlinear(x, p["wk"], quant, p.get("bk")).reshape(b, s, cfg.num_kv_heads, hd)
    v = qlinear(x, p["wv"], quant, p.get("bv")).reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


def gqa_decode(x: torch.Tensor, p, cfg: ArchConfig, cache, cur_len: torch.Tensor, *,
               quant: QuantPolicy = BF16):
    """One-token decode at per-sequence positions ``cur_len`` (B,).

    ``cache`` is a bf16 ``{"k", "v"}`` dict or the RaZeR-packed layout of
    ``serving.kvcache``; the new token's K/V is written into it in place and
    attention runs over ``cur_len + 1`` positions.  Returns (y, cache)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.kvcache import quantized_kv_write

    b = x.shape[0]
    cur = torch.as_tensor(cur_len, device=x.device).reshape(-1).expand(b)
    q, k, v = _qkv(x, p, cfg, quant, cur.reshape(b, 1))
    if "k_codes" in cache:
        cache = quantized_kv_write(cache, k, v, cur)
        out = ops.razer_kv_attention(q, cache, cur + 1)
    else:
        rows = torch.arange(b, device=x.device)
        cache["k"][rows, cur.long()] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, cur.long()] = v[:, 0].to(cache["v"].dtype)
        out = decode_attention(q, cache["k"], cache["v"], cur + 1)
    return qlinear(out.reshape(b, 1, -1), p["wo"], quant), cache
