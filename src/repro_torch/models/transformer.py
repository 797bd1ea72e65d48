"""Decoder stacks of GQA attention layers with a dense SwiGLU or an MoE
feed-forward (PyTorch port of the dense and MoE paths of
``repro.models.transformer``).

Parameters are a dict: ``embed``, ``final_norm``, optionally ``lm_head``, and
one ``layers_<g>`` list of per-layer dicts per layer group (``layer_groups``:
runs of consecutive layers of one type).  An ``"a"`` layer holds ``ln1``,
``mixer`` {wq, wk, wv, wo}, ``ln2`` and ``mlp`` {gate, up, down}; an ``"m"``
layer holds ``moe`` (router, expert banks, optional shared experts) in place
of ``mlp``.  The keys keep the JAX package's names for its scan-stacked
groups, so the policy rules resolve the same '/'-joined paths
(``layers_0/mixer/wq``, ``layers_1/moe/experts/gate``); the JAX ``lax.scan``
over a group is a loop here.  Caches are one per layer, in layer order
across the groups.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.core.policy import BF16, QuantPolicy
from repro_torch.core.qlinear import qlinear
from repro_torch.device import resolve_device

from . import attention as attn
from . import moe as moe_mod
from .config import ArchConfig
from .layers import dense_init, embed, embedding_init, rms_norm, swiglu, swiglu_init, unembed

__all__ = ["layer_groups", "init_params", "prefill", "prefill_paged_suffix", "decode_step",
           "decode_verify"]


def layer_groups(cfg: ArchConfig) -> List[Tuple[str, int]]:
    """[(block_type, count)] for runs of consecutive same-type layers: "a"
    attention + dense MLP, "m" attention + MoE (after ``first_dense_layers``
    dense ones)."""
    if cfg.moe:
        nd = cfg.first_dense_layers
        types = ["a"] * nd + ["m"] * (cfg.num_layers - nd)
    else:
        types = ["a"] * cfg.num_layers
    groups: List[Tuple[str, int]] = []
    for t in types:
        if groups and groups[-1][0] == t:
            groups[-1] = (t, groups[-1][1] + 1)
        else:
            groups.append((t, 1))
    return groups


def _layers(params, cfg: ArchConfig) -> Iterator[Tuple[str, Dict[str, Any]]]:
    """(block type, layer params) of every layer, in order across groups."""
    for gi, (ltype, _) in enumerate(layer_groups(cfg)):
        for lp in params[f"layers_{gi}"]:
            yield ltype, lp


def _ffn(x: torch.Tensor, lp, ltype: str, cfg: ArchConfig, quant: QuantPolicy) -> torch.Tensor:
    """The residual feed-forward half of a layer: SwiGLU or MoE."""
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if ltype == "m":
        y, _ = moe_mod.moe_forward(h2, lp["moe"], cfg, quant=quant)
        return x + y
    return x + swiglu(h2, lp["mlp"], quant)


def _layer_init(gen: torch.Generator, cfg: ArchConfig, ltype: str, device) -> Dict[str, Any]:
    d, hd, dt = cfg.d_model, cfg.hd, cfg.pdtype
    w = lambda i, o: dense_init(gen, i, o, device=device, dtype=dt)
    mixer = {"wq": w(d, cfg.num_heads * hd), "wk": w(d, cfg.num_kv_heads * hd),
             "wv": w(d, cfg.num_kv_heads * hd), "wo": w(cfg.num_heads * hd, d)}
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.num_heads), ("bk", cfg.num_kv_heads), ("bv", cfg.num_kv_heads)):
            mixer[name] = torch.zeros(width * hd, dtype=dt, device=device)
    if cfg.qk_norm:
        mixer["q_norm"] = torch.zeros(hd, dtype=dt, device=device)
        mixer["k_norm"] = torch.zeros(hd, dtype=dt, device=device)
    p = {"ln1": torch.zeros(d, dtype=dt, device=device), "mixer": mixer,
         "ln2": torch.zeros(d, dtype=dt, device=device)}
    if ltype == "m":
        p["moe"] = moe_mod.moe_init(gen, cfg, device=device, dtype=dt)
    else:
        p["mlp"] = swiglu_init(gen, d, cfg.d_ff, device=device, dtype=dt)
    return p


def init_params(cfg: ArchConfig, *, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random full-precision parameters drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``.  (The JAX package draws other
    numbers from its keys; tests carry its weights over with ``bridge``.)"""
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"the port runs dense and MoE decoders only, got family {cfg.family!r}")
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    p: Dict[str, Any] = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, device=device, dtype=cfg.pdtype),
        "final_norm": torch.zeros(cfg.d_model, dtype=cfg.pdtype, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = embedding_init(gen, cfg.vocab_size, cfg.d_model, device=device, dtype=cfg.pdtype)
    for gi, (ltype, count) in enumerate(layer_groups(cfg)):
        p[f"layers_{gi}"] = [_layer_init(gen, cfg, ltype, device) for _ in range(count)]
    return p


def _head(params) -> torch.Tensor:
    return params["lm_head"] if "lm_head" in params else params["embed"]


def _qdq_kv(x: torch.Tensor, hd: int) -> torch.Tensor:
    """Quantize-dequantize through the KV wire format (App. C.1)."""
    from repro_torch.serving.kvcache import kv_dequantize, kv_quantize

    return kv_dequantize(*kv_quantize(x), hd)


def prefill(params, tokens: torch.Tensor, cfg: ArchConfig, quant: QuantPolicy = BF16, *,
            max_len: int, last_positions: Optional[torch.Tensor] = None, qdq_kv: bool = False):
    """Run the whole prompt (B, S) and build bf16 KV caches.

    Returns (last_logits (B, V), caches): one ``{"k", "v"}`` dict of
    (B, max_len, KVH, hd) per layer.  ``last_positions`` (B,) are the true
    prompt lengths of a right-padded batch.  With ``qdq_kv`` attention reads
    the quantize-dequantized K/V, the values the packed cache will hold."""
    b, s = tokens.shape
    dev = tokens.device
    x = embed(tokens, params["embed"], cfg.cdtype)
    positions = torch.arange(s, device=dev).expand(b, s)
    caches: List[Dict[str, torch.Tensor]] = []
    for ltype, lp in _layers(params, cfg):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = attn._qkv(h, lp["mixer"], cfg, quant, positions)
        k = k.to(cfg.cdtype)
        v = v.to(cfg.cdtype)
        if qdq_kv:
            k_att, v_att = _qdq_kv(k, cfg.hd), _qdq_kv(v, cfg.hd)
        else:
            k_att, v_att = k, v
        mix = attn.chunked_attention(q, k_att, v_att, causal=True)
        x = x + qlinear(mix.reshape(b, s, -1), lp["mixer"]["wo"], quant)
        cache = {n: torch.zeros((b, max_len, cfg.num_kv_heads, cfg.hd), dtype=cfg.cdtype, device=dev)
                 for n in ("k", "v")}
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
        caches.append(cache)
        x = _ffn(x, lp, ltype, cfg, quant)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if last_positions is not None:
        idx = torch.as_tensor(last_positions, device=dev).long() - 1
        x_last = x[torch.arange(b, device=dev), idx][:, None]
    else:
        x_last = x[:, -1:]
    return unembed(x_last, _head(params))[:, 0], caches


def prefill_paged_suffix(params, tokens: torch.Tensor, pool_caches, page_row: torch.Tensor, pre_len: int,
                         sfx_len: int, cfg: ArchConfig, quant: QuantPolicy = BF16):
    """Continuation prefill of a prefix-cached request.

    ``tokens`` (1, S_b) is the uncached suffix padded to a bucket, at
    positions ``[pre_len, pre_len + sfx_len)``; ``page_row`` (NP_b,) holds
    the leading pages of this sequence, enough to cover the cached prefix;
    ``pool_caches`` is the pool's per-layer list of views.  Per layer the
    attended buffer is ``[gathered pages | suffix bucket]``: the pages are
    gathered and dequantized into a ``C = NP_b * page_size`` prefix, and the
    suffix K/V, quantize-dequantized through the wire format as
    ``prefill(qdq_kv=True)`` does, is written at offset ``pre_len``.  Every
    entry's position is its index, so causal masking with ``q_offset =
    pre_len`` hides the stale page bytes, the bucket padding and the copied
    page's stale tail: all sit past the last valid query.

    Returns (last logits (1, V), the suffix K/V caches), which the caller
    writes with ``write_prefill(..., start=pre_len)``."""
    from repro_torch.serving.kvcache import kv_dequantize

    b, s = tokens.shape
    dev = tokens.device
    kvh, hd = cfg.num_kv_heads, cfg.hd
    rows = page_row.long()
    c_width = rows.shape[0] * pool_caches[0]["k_codes"].shape[1]
    x = embed(tokens, params["embed"], cfg.cdtype)
    positions = pre_len + torch.arange(s, device=dev).expand(b, s)
    caches: List[Dict[str, torch.Tensor]] = []
    for (ltype, lp), pool in zip(_layers(params, cfg), pool_caches):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = attn._qkv(h, lp["mixer"], cfg, quant, positions)
        k = k.to(cfg.cdtype)
        v = v.to(cfg.cdtype)

        def kv_buffer(sfx, codes, meta):
            pre = kv_dequantize(codes[rows], meta[rows], hd).reshape(1, c_width, kvh, hd)
            buf = torch.cat([pre, torch.zeros_like(sfx, dtype=pre.dtype)], dim=1)
            buf[:, pre_len:pre_len + s] = sfx
            return buf

        k_all = kv_buffer(_qdq_kv(k, hd), pool["k_codes"], pool["k_meta"])
        v_all = kv_buffer(_qdq_kv(v, hd), pool["v_codes"], pool["v_meta"])
        mix = attn.chunked_attention(q, k_all, v_all, causal=True, q_offset=pre_len)
        x = x + qlinear(mix.reshape(b, s, -1), lp["mixer"]["wo"], quant)
        x = _ffn(x, lp, ltype, cfg, quant)
        caches.append({"k": k, "v": v})
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x[:, sfx_len - 1:sfx_len], _head(params))[:, 0], caches


def decode_step(params, token: torch.Tensor, caches, cur_len: torch.Tensor, cfg: ArchConfig,
                quant: QuantPolicy = BF16, *, pages: Optional[torch.Tensor] = None):
    """token (B,) at positions ``cur_len`` (B,) -> (logits (B, V), caches);
    the caches are updated in place.  With ``pages`` (B, NP) the caches are
    the paged pool's per-layer views and every layer shares the table."""
    x = embed(token[:, None], params["embed"], cfg.cdtype)
    for i, (ltype, lp) in enumerate(_layers(params, cfg)):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        mix, caches[i] = attn.gqa_decode(h, lp["mixer"], cfg, caches[i], cur_len, quant=quant, pages=pages)
        x = _ffn(x + mix, lp, ltype, cfg, quant)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x, _head(params))[:, 0], caches


def decode_verify(params, tokens: torch.Tensor, caches, cur_len: torch.Tensor, cfg: ArchConfig,
                  quant: QuantPolicy = BF16, *, pages: torch.Tensor):
    """Speculative verify step over the paged pool: ``tokens`` (B, T) -- the
    last committed token and the T - 1 drafts per slot -> (logits (B, T, V),
    caches).  Position t's logits predict the token at ``cur_len + t + 1``;
    each layer goes through ``attn.gqa_decode_verify``."""
    x = embed(tokens, params["embed"], cfg.cdtype)  # (B, T, d)
    for i, (ltype, lp) in enumerate(_layers(params, cfg)):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        mix, caches[i] = attn.gqa_decode_verify(h, lp["mixer"], cfg, caches[i], cur_len, quant=quant,
                                                pages=pages)
        x = _ffn(x + mix, lp, ltype, cfg, quant)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x, _head(params)), caches
