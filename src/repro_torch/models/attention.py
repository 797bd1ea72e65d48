"""GQA attention (PyTorch port of the dense path of ``repro.models.attention``).

Full-sequence (prefill) attention is an online-softmax walk over KV chunks:
the prefill kernel on the card, and on the CPU plain matmuls, as the JAX
package computes it outside any kernel.  Decode
attends one query per sequence against a bf16 cache, or, through
``kernels.ops``, against the RaZeR-packed cache, contiguous or paged; the
speculative verify step attends T queries per sequence over the paged pool.

Dtypes follow the JAX einsums with ``preferred_element_type=float32``: the
operands are promoted to their common type and multiplied with f32
accumulation, and the probabilities are cast to V's dtype before the PV
product.
"""
from __future__ import annotations

from typing import Optional

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


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                      q_offset: int = 0, kv_chunk: int = 1024) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Skv, KVH, hd) with H % KVH == 0 -> (B, Sq, H, hd).

    Query i sits at position ``q_offset + i`` and key j at position j; the
    causal mask keeps key positions <= the query's.  The prefix-cached
    continuation prefill passes the cached length as ``q_offset``, with K/V
    laid out so that every entry's position is its index.  On the card the
    prefill kernel (K9) walks each row's keys in fixed chunks from position
    0, so a row's bits do not depend on the batch or the padding
    (``kv_chunk`` is the plain version's); on the CPU the plain version runs
    (``kernels.ref.chunked_attention_ref``, the JAX package's computation)."""
    from repro_torch.kernels import ops

    return ops.prefill_attention(q, k, v, causal=causal, q_offset=q_offset, kv_chunk=kv_chunk)


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


def _write_pages(cache, k: torch.Tensor, v: torch.Tensor, pid: torch.Tensor, slot: torch.Tensor) -> None:
    """Quantize K/V (..., KVH, hd) and write each token into pool page
    ``pid`` slot ``slot`` (index tensors of K's leading shape), in place.

    The JAX package writes a new pool and donates the old buffers; here the
    per-layer arrays are views of the pool's buffers, so the bytes land in
    the pool itself.  Idle slots all write to the null page: duplicate
    indices, whose order on the GPU is undefined, which is harmless because
    the null page never holds a valid position."""
    from repro_torch.serving.kvcache import kv_quantize

    kc, km = kv_quantize(k)
    vc, vm = kv_quantize(v)
    pid, slot = pid.long(), slot.long()
    for name, val in (("k_codes", kc), ("k_meta", km), ("v_codes", vc), ("v_meta", vm)):
        cache[name][pid, slot] = val


def gqa_decode(x: torch.Tensor, p, cfg: ArchConfig, cache, cur_len: torch.Tensor, *,
               quant: QuantPolicy = BF16, pages: Optional[torch.Tensor] = None):
    """One-token decode at per-sequence positions ``cur_len`` (B,).

    ``cache`` is a bf16 ``{"k", "v"}`` dict, the RaZeR-packed layout of
    ``serving.kvcache``, or -- with ``pages``, the (B, NP) page table -- one
    layer's slice of the paged pool (``serving.pagepool``).  The new token's
    K/V is written into it in place and attention runs over ``cur_len + 1``
    positions.  Returns (y, cache)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.kvcache import quantized_kv_write

    b = x.shape[0]
    cur = torch.as_tensor(cur_len, device=x.device).reshape(-1).expand(b)
    q, k, v = _qkv(x, p, cfg, quant, cur.reshape(b, 1))
    if pages is not None:
        # idle slots (cur_len 0, all-null page row) land on the null page
        ps = cache["k_codes"].shape[1]
        rows = torch.arange(b, device=x.device)
        _write_pages(cache, k[:, 0], v[:, 0], pages[rows, cur.long() // ps], cur % ps)
        out = ops.razer_paged_kv_attention(q, cache, pages, cur + 1)
    elif "k_codes" in cache:
        cache = quantized_kv_write(cache, k, v, cur)
        out = ops.razer_kv_attention(q, cache, cur + 1)
    else:
        rows = torch.arange(b, device=x.device)
        cache["k"][rows, cur.long()] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, cur.long()] = v[:, 0].to(cache["v"].dtype)
        out = decode_attention(q, cache["k"], cache["v"], cur + 1)
    return qlinear(out.reshape(b, 1, -1), p["wo"], quant), cache


def gqa_decode_verify(x: torch.Tensor, p, cfg: ArchConfig, cache, cur_len: torch.Tensor, *,
                      quant: QuantPolicy = BF16, pages: torch.Tensor):
    """Speculative verify over the paged pool: ``x`` (B, T, d) carries the
    last committed token and the T - 1 drafts of each slot, at positions
    ``cur_len[b] + t``.  All T tokens' K/V are quantized and written into
    their page slots first (over whatever the draft pass wrote there), then
    one multi-query attention masks query t to positions < cur_len + t + 1:
    per query, the write-then-attend order and the reduction of a vanilla
    one-token decode step.  Idle slots (cur_len 0, all-null row) write to
    the null page.  Returns (y (B, T, d), cache)."""
    from repro_torch.kernels import ops

    b, t, _ = x.shape
    cl = torch.as_tensor(cur_len, device=x.device).reshape(-1).expand(b)
    positions = cl[:, None] + torch.arange(t, device=x.device)[None, :]  # (B, T)
    q, k, v = _qkv(x, p, cfg, quant, positions)
    ps = cache["k_codes"].shape[1]
    # the logical page clips to the table's width as write_prefill does: real
    # slots stay inside it by the scheduler's len + max_new + k reservation
    logical = torch.clamp(positions // ps, max=pages.shape[1] - 1)
    pid = pages[torch.arange(b, device=x.device)[:, None], logical.long()]
    _write_pages(cache, k, v, pid, positions % ps)
    out = ops.razer_paged_kv_attention_verify(q, cache, pages, cl)
    return qlinear(out.reshape(b, t, -1), p["wo"], quant), cache
