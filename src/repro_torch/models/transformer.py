"""Dense GQA decoder stack (PyTorch port of the dense path of
``repro.models.transformer``).

Parameters are a dict: ``embed``, ``final_norm``, optionally ``lm_head``, and
``layers_0``, a list of per-layer dicts (``ln1``, ``mixer`` {wq, wk, wv, wo},
``ln2``, ``mlp`` {gate, up, down}).  The key keeps the JAX package's name for
its scan-stacked group, so the policy rules resolve the same '/'-joined paths
(``layers_0/mixer/wq``); the JAX ``lax.scan`` over the stack is a loop here.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.core.policy import BF16, QuantPolicy
from repro_torch.core.qlinear import qlinear
from repro_torch.device import resolve_device

from . import attention as attn
from .config import ArchConfig
from .layers import dense_init, embed, embedding_init, rms_norm, swiglu, unembed

__all__ = ["init_params", "prefill", "decode_step"]


def _layer_init(gen: torch.Generator, cfg: ArchConfig, device) -> Dict[str, Any]:
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
    return {
        "ln1": torch.zeros(d, dtype=dt, device=device),
        "mixer": mixer,
        "ln2": torch.zeros(d, dtype=dt, device=device),
        "mlp": {"gate": w(d, cfg.d_ff), "up": w(d, cfg.d_ff), "down": w(cfg.d_ff, d)},
    }


def init_params(cfg: ArchConfig, *, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random full-precision parameters drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``.  (The JAX package draws other
    numbers from its keys; tests carry its weights over with ``bridge``.)"""
    if cfg.family != "dense":
        raise ValueError(f"the port runs dense decoders only, got family {cfg.family!r}")
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    p: Dict[str, Any] = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, device=device, dtype=cfg.pdtype),
        "final_norm": torch.zeros(cfg.d_model, dtype=cfg.pdtype, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = embedding_init(gen, cfg.vocab_size, cfg.d_model, device=device, dtype=cfg.pdtype)
    p["layers_0"] = [_layer_init(gen, cfg, device) for _ in range(cfg.num_layers)]
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
    for lp in params["layers_0"]:
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
        x = x + swiglu(rms_norm(x, lp["ln2"], cfg.norm_eps), lp["mlp"], quant)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if last_positions is not None:
        idx = torch.as_tensor(last_positions, device=dev).long() - 1
        x_last = x[torch.arange(b, device=dev), idx][:, None]
    else:
        x_last = x[:, -1:]
    return unembed(x_last, _head(params))[:, 0], caches


def decode_step(params, token: torch.Tensor, caches, cur_len: torch.Tensor, cfg: ArchConfig,
                quant: QuantPolicy = BF16):
    """token (B,) at positions ``cur_len`` (B,) -> (logits (B, V), caches);
    the caches are updated in place."""
    x = embed(token[:, None], params["embed"], cfg.cdtype)
    for i, lp in enumerate(params["layers_0"]):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        mix, caches[i] = attn.gqa_decode(h, lp["mixer"], cfg, caches[i], cur_len, quant=quant)
        x = x + mix
        x = x + swiglu(rms_norm(x, lp["ln2"], cfg.norm_eps), lp["mlp"], quant)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x, _head(params))[:, 0], caches
