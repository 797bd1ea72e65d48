"""Attention (PyTorch port of ``repro.models.attention``): GQA (qk-norm,
qkv bias, RoPE or M-RoPE or none), MLA (DeepSeek-V2) and cross-attention
(whisper's decoder).

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

MLA prefills in the materialized form (per-head K/V rebuilt from the latent,
head width ``qk_nope_dim + qk_rope_dim``, V at ``v_head_dim``) and decodes
in the absorbed form over a cache of the latent ``c`` and the shared rope
key ``kr`` only; the absorbed einsums are plain PyTorch ops with f32
accumulation, as the JAX package computes them outside any kernel.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.policy import BF16, QuantPolicy
from repro_torch.core.qlinear import qlinear

from .config import ArchConfig
from .layers import apply_mrope, apply_rope, dense_init, rms_norm


def _softmax_scale(hd: int) -> float:
    """1 / sqrt(hd) rounded as float32 arithmetic rounds it (a Python float
    holding that float32 value, so no device copy)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window: int = 0,
                      q_offset: int = 0, kv_chunk: int = 1024) -> torch.Tensor:
    """q (B, Sq, H, hd); k (B, Skv, KVH, hd); v (B, Skv, KVH, dv) with H %
    KVH == 0 -> (B, Sq, H, dv).  V may be narrower than q and k (MLA's
    v_head_dim): each output dim is its own sum over the same
    probabilities, so this equals the reference's attention over V
    zero-padded to hd, sliced to dv.

    Query i sits at position ``q_offset + i`` and key j at position j; the
    causal mask keeps key positions <= the query's, and ``window`` > 0
    (sliding-window attention) also drops keys at or before the query's
    position - window.  The prefix-cached continuation prefill passes the
    cached length as ``q_offset``, with K/V laid out so that every entry's
    position is its index.  On the card the prefill kernel (K9) walks each
    row's keys in fixed chunks, so a row's bits do not depend on the batch
    or the padding (``kv_chunk`` is the plain version's); on the CPU the
    plain version runs (``kernels.ref.chunked_attention_ref``, the JAX
    package's computation)."""
    from repro_torch.kernels import ops

    return ops.prefill_attention(q, k, v, causal=causal, window=window, q_offset=q_offset, kv_chunk=kv_chunk)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, cur_len, *,
                     window: int = 0) -> torch.Tensor:
    """One query per sequence: q (B, 1, H, hd) against (B, Smax, KVH, hd)
    caches; positions >= cur_len (int or (B,)) are masked, and with
    ``window`` > 0 also positions <= cur_len - 1 - window."""
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
    if window:
        mask &= pos[None, :] > cur - 1 - window
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, -1e30))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


def _qkv(x: torch.Tensor, p, cfg: ArchConfig, quant: QuantPolicy, positions: torch.Tensor,
         positions3: Optional[torch.Tensor] = None):
    """Q, K, V of a GQA block: RoPE at ``positions`` (B, S); under M-RoPE at
    ``positions3`` (3, B, S), by default ``positions`` in all three
    streams; no rotation when the config has no rope (whisper)."""
    b, s, _ = x.shape
    hd = cfg.hd
    q = qlinear(x, p["wq"], quant, p.get("bq")).reshape(b, s, cfg.num_heads, hd)
    k = qlinear(x, p["wk"], quant, p.get("bk")).reshape(b, s, cfg.num_kv_heads, hd)
    v = qlinear(x, p["wv"], quant, p.get("bv")).reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if not cfg.use_rope:
        return q, k, v
    if cfg.mrope:
        pos3 = positions3 if positions3 is not None else positions.expand(3, b, s)
        return (apply_mrope(q, pos3, cfg.mrope_sections, cfg.rope_theta),
                apply_mrope(k, pos3, cfg.mrope_sections, cfg.rope_theta), v)
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


def gqa_forward(x: torch.Tensor, p, cfg: ArchConfig, *, quant: QuantPolicy = BF16, positions: torch.Tensor,
                positions3: Optional[torch.Tensor] = None, window: int = 0, causal: bool = True) -> torch.Tensor:
    """Full-sequence attention block at ``positions`` (B, S) (causal by
    default; whisper's encoder passes ``causal=False``; ``window`` > 0:
    sliding-window attention; ``positions3``: M-RoPE's streams)."""
    b, s, _ = x.shape
    q, k, v = _qkv(x, p, cfg, quant, positions, positions3)
    out = chunked_attention(q, k, v, causal=causal, window=window)
    return qlinear(out.reshape(b, s, -1), p["wo"], quant)


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
               quant: QuantPolicy = BF16, window: int = 0, positions3: Optional[torch.Tensor] = None,
               pages: Optional[torch.Tensor] = None):
    """One-token decode at per-sequence positions ``cur_len`` (B,).

    ``cache`` is a bf16 ``{"k", "v"}`` dict, the RaZeR-packed layout of
    ``serving.kvcache``, or -- with ``pages``, the (B, NP) page table -- one
    layer's slice of the paged pool (``serving.pagepool``).  The new token's
    K/V is written into it in place and attention runs over ``cur_len + 1``
    positions, with ``window`` > 0 over the last ``window`` of them: as in
    the reference, the packed cache is then dequantized whole
    (``quantized_kv_append``) and attended by the plain
    ``decode_attention``, not the fused kernel, and the paged pool refuses
    a window.  ``positions3`` (3, B, 1) are M-RoPE's streams (default:
    ``cur_len`` in all three).  Returns (y, cache)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.kvcache import quantized_kv_append, quantized_kv_write

    b = x.shape[0]
    cur = torch.as_tensor(cur_len, device=x.device).reshape(-1).expand(b)
    if pages is not None and window != 0:
        raise ValueError("paged KV decode does not support sliding windows")
    q, k, v = _qkv(x, p, cfg, quant, cur.reshape(b, 1), positions3)
    if pages is not None:
        # idle slots (cur_len 0, all-null page row) land on the null page
        ps = cache["k_codes"].shape[1]
        rows = torch.arange(b, device=x.device)
        _write_pages(cache, k[:, 0], v[:, 0], pages[rows, cur.long() // ps], cur % ps)
        out = ops.razer_paged_kv_attention(q, cache, pages, cur + 1)
    elif "k_codes" in cache and not window:
        cache = quantized_kv_write(cache, k, v, cur)
        out = ops.razer_kv_attention(q, cache, cur + 1)
    else:
        if "k_codes" in cache:
            k_cache, v_cache, cache = quantized_kv_append(cache, k, v, cur)
        else:
            rows = torch.arange(b, device=x.device)
            cache["k"][rows, cur.long()] = k[:, 0].to(cache["k"].dtype)
            cache["v"][rows, cur.long()] = v[:, 0].to(cache["v"].dtype)
            k_cache, v_cache = cache["k"], cache["v"]
        out = decode_attention(q, k_cache, v_cache, cur + 1, window=window)
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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------
def mla_init(gen: torch.Generator, cfg: ArchConfig, *, device, dtype=torch.float32):
    h, dn, dr, dv = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    w = lambda i, o: dense_init(gen, i, o, device=device, dtype=dtype)  # noqa: E731
    p = {"kv_a": w(cfg.d_model, cfg.kv_lora_rank + dr),
         "kv_norm": torch.zeros(cfg.kv_lora_rank, dtype=dtype, device=device),
         "kv_b": w(cfg.kv_lora_rank, h * (dn + dv)), "wo": w(h * dv, cfg.d_model)}
    if cfg.q_lora_rank:
        p["q_a"] = w(cfg.d_model, cfg.q_lora_rank)
        p["q_norm"] = torch.zeros(cfg.q_lora_rank, dtype=dtype, device=device)
        p["q_b"] = w(cfg.q_lora_rank, h * (dn + dr))
    else:
        p["wq"] = w(cfg.d_model, h * (dn + dr))
    return p


def _mla_q(x: torch.Tensor, p, cfg: ArchConfig, quant: QuantPolicy, positions: torch.Tensor):
    """(q_nope (B, S, H, dn), q_rope (B, S, H, dr)), the rope part rotated."""
    b, s, _ = x.shape
    h, dn, dr = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        q = qlinear(rms_norm(qlinear(x, p["q_a"], quant), p["q_norm"], cfg.norm_eps), p["q_b"], quant)
    else:
        q = qlinear(x, p["wq"], quant)
    q = q.reshape(b, s, h, dn + dr)
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _mla_ckv(x: torch.Tensor, p, cfg: ArchConfig, quant: QuantPolicy, positions: torch.Tensor):
    """(c (B, S, kv_lora_rank) normed, k_rope (B, S, dr) rotated): what
    the MLA cache holds per token."""
    b, s, _ = x.shape
    dr = cfg.qk_rope_dim
    ckv = qlinear(x, p["kv_a"], quant)
    c = rms_norm(ckv[..., :cfg.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(ckv[..., cfg.kv_lora_rank:].reshape(b, s, 1, dr), positions, cfg.rope_theta)
    return c, k_rope.reshape(b, s, dr)


def mla_forward(x: torch.Tensor, p, cfg: ArchConfig, *, quant: QuantPolicy = BF16, positions=None,
                ckv=None) -> torch.Tensor:
    """Materialized MLA over the whole sequence (prefill), causal: per-head
    K = [kv_b's nope part of c, the shared rope key], width dn + dr, and V
    at dv.  ``ckv``: ``_mla_ckv``'s output when the caller has it (the
    prefill writes it into the cache too)."""
    b, s, _ = x.shape
    h, dn, dr, dv = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q_nope, q_rope = _mla_q(x, p, cfg, quant, positions)
    c, k_rope = ckv if ckv is not None else _mla_ckv(x, p, cfg, quant, positions)
    kv = qlinear(c, p["kv_b"], quant).reshape(b, s, h, dn + dv)
    k = torch.cat([kv[..., :dn], k_rope[:, :, None, :].expand(b, s, h, dr)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = chunked_attention(q, k, kv[..., dn:].contiguous(), causal=True)
    return qlinear(out.reshape(b, s, h * dv), p["wo"], quant)


def mla_decode(x: torch.Tensor, p, cfg: ArchConfig, cache, cur_len: torch.Tensor, *, quant: QuantPolicy = BF16):
    """Absorbed MLA decode at per-sequence positions ``cur_len`` (B,): the
    new token's latent and rope key are written into the ``{"c", "kr"}``
    cache in place, the query is absorbed into the latent space through
    kv_b's nope part, attends ``cur_len + 1`` positions of the cache, and
    the context leaves through kv_b's V part.  Every einsum multiplies
    operands cast to the cache's dtype with f32 accumulation.  Returns (y,
    cache)."""
    b = x.shape[0]
    h, dn, dr, dv = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    cur = torch.as_tensor(cur_len, device=x.device).reshape(-1).expand(b)
    positions = cur.reshape(b, 1)
    q_nope, q_rope = _mla_q(x, p, cfg, quant, positions)
    c_new, kr_new = _mla_ckv(x, p, cfg, quant, positions)
    rows = torch.arange(b, device=x.device)
    cache["c"][rows, cur.long()] = c_new[:, 0].to(cache["c"].dtype)
    cache["kr"][rows, cur.long()] = kr_new[:, 0].to(cache["kr"].dtype)
    c_cache, r_cache = cache["c"], cache["kr"]
    cd = c_cache.dtype
    f = lambda t: t.to(cd).float()  # noqa: E731  (an operand in the cache's dtype, multiplied in f32)
    w_kv_b = p["kv_b"].reshape(cfg.kv_lora_rank, h, dn + dv)
    q_eff = torch.einsum("bqhn,rhn->bhr", f(q_nope), f(w_kv_b[..., :dn]))
    s = (torch.einsum("bhr,bsr->bhs", f(q_eff), c_cache.float())
         + torch.einsum("bqhr,bsr->bhs", f(q_rope), r_cache.float())) * _softmax_scale(dn + dr)
    mask = torch.arange(c_cache.shape[1], device=x.device)[None, :] < (cur[:, None] + 1)
    s = torch.where(mask[:, None, :], s, torch.full_like(s, -1e30))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    pattn = e / e.sum(dim=-1, keepdim=True)
    ctx = torch.einsum("bhs,bsr->bhr", f(pattn), c_cache.float())
    out = torch.einsum("bhr,rhv->bhv", f(ctx), f(w_kv_b[..., dn:])).to(x.dtype)
    return qlinear(out.reshape(b, 1, h * dv), p["wo"], quant), cache


def mla_cache_init(cfg: ArchConfig, batch: int, max_len: int, *, device, dtype=torch.bfloat16):
    return {"c": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=device),
            "kr": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# cross-attention (whisper's decoder)
# ---------------------------------------------------------------------------
def cross_init(gen: torch.Generator, cfg: ArchConfig, *, device, dtype=torch.float32):
    hd = cfg.hd
    w = lambda i, o: dense_init(gen, i, o, device=device, dtype=dtype)  # noqa: E731
    return {"wq": w(cfg.d_model, cfg.num_heads * hd), "wk": w(cfg.d_model, cfg.num_kv_heads * hd),
            "wv": w(cfg.d_model, cfg.num_kv_heads * hd), "wo": w(cfg.num_heads * hd, cfg.d_model)}


def cross_forward(x: torch.Tensor, enc: torch.Tensor, p, cfg: ArchConfig, *, quant: QuantPolicy = BF16):
    """x (B, Sd, d) queries against enc (B, Se, d), the encoder's output:
    attention without a causal mask."""
    b, sd, _ = x.shape
    se, hd = enc.shape[1], cfg.hd
    q = qlinear(x, p["wq"], quant).reshape(b, sd, cfg.num_heads, hd)
    k = qlinear(enc, p["wk"], quant).reshape(b, se, cfg.num_kv_heads, hd)
    v = qlinear(enc, p["wv"], quant).reshape(b, se, cfg.num_kv_heads, hd)
    out = chunked_attention(q, k, v, causal=False)
    return qlinear(out.reshape(b, sd, -1), p["wo"], quant)
