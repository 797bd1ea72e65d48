"""Plain PyTorch versions of the port's CUDA kernels (the counterparts of
``repro.kernels.ref``).  ``kernels.ops`` runs them for tensors on the CPU;
``chip_smoke.py`` holds each kernel against them on the card."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.formats import device_constant
from repro_torch.core.packing import PackedRazerWeight, PackedStackedTensor
from repro_torch.core.razer import razer_quantize

__all__ = ["razer_matmul_ref", "razer_grouped_matmul_ref", "razer_act_qdq_ref", "razer_kv_attention_ref",
           "paged_kv_attention_ref", "paged_kv_attention_verify_ref", "chunked_attention_ref", "rms_norm_ref"]


def razer_matmul_ref(x: torch.Tensor, pw: PackedRazerWeight) -> torch.Tensor:
    """(M, K) @ dequant(pw) -> (M, N) f32; the f32 weight includes the tensor
    scale."""
    return x.to(torch.float32) @ pw.dequantize()


def razer_grouped_matmul_ref(x: torch.Tensor, pst: PackedStackedTensor) -> torch.Tensor:
    """y[e] = x[e] @ dequant(pst[e]): (E, M, K) -> (E, M, N) f32; the f32
    bank includes each entry's tensor scale."""
    return torch.einsum("emk,ekn->emn", x.to(torch.float32), pst.dequantize())


def razer_act_qdq_ref(x: torch.Tensor, svs=(5.0, -5.0), block: int = 16) -> torch.Tensor:
    """Dynamic activation fake-quant: per-block E4M3 scale, no tensor scale."""
    out = razer_quantize(
        x.to(torch.float32), special_values=svs, block_size=block, scale_fmt="e4m3", axis=-1,
        tensor_scale=device_constant(np.array(1.0, np.float32), x.device),
    ).dequantize()
    return out.to(x.dtype)


def razer_kv_attention_ref(q, k_codes, k_meta, v_codes, v_meta, cur_len) -> torch.Tensor:
    """Dequantize the whole cache, then single-query attention: q (B, H, hd)
    -> (B, H, hd) f32."""
    from repro_torch.models.attention import decode_attention
    from repro_torch.serving.kvcache import kv_dequantize

    b, h, hd = q.shape
    k = kv_dequantize(k_codes, k_meta, hd)
    v = kv_dequantize(v_codes, v_meta, hd)
    return decode_attention(q.reshape(b, 1, h, hd).to(torch.float32), k, v, cur_len)[:, 0]


def _gathered(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """(P, ps, KVH, x) pool -> each sequence's (B, NP * ps, KVH, x) view."""
    b, npages = page_table.shape
    g = pool[page_table.long()]  # (B, NP, ps, KVH, x)
    return g.reshape(b, npages * pool.shape[1], *pool.shape[2:])


def paged_kv_attention_ref(q, k_codes, k_meta, v_codes, v_meta, page_table, cur_len) -> torch.Tensor:
    """Gather each sequence's pages into a contiguous view and run the
    contiguous version: q (B, H, hd) -> (B, H, hd) f32.  Positions past
    cur_len (null-page tails included) add exactly 0."""
    return razer_kv_attention_ref(q, *(_gathered(t, page_table) for t in (k_codes, k_meta, v_codes, v_meta)),
                                  cur_len)


def paged_kv_attention_verify_ref(q, k_codes, k_meta, v_codes, v_meta, page_table, cur_len) -> torch.Tensor:
    """q (B, T, H, hd): query t of sequence b attends positions
    < cur_len[b] + t + 1.  Each (b, t) folds into the batch of the
    single-query version with its own length, the reduction a vanilla decode
    step at that position performs.  -> (B, T, H, hd) f32."""
    b, t, h, hd = q.shape
    caches = [torch.repeat_interleave(_gathered(x, page_table), t, dim=0)  # row b*T+i is seq b
              for x in (k_codes, k_meta, v_codes, v_meta)]
    cur = (torch.as_tensor(cur_len, device=q.device).reshape(-1, 1).to(torch.int32)
           + torch.arange(t, dtype=torch.int32, device=q.device)[None, :] + 1).reshape(-1)
    return razer_kv_attention_ref(q.reshape(b * t, h, hd), *caches, cur).reshape(b, t, h, hd)


def _pick_chunk(s: int, target: int = 1024) -> int:
    c = min(s, target)
    while s % c:
        c //= 2
    return max(c, 1)


def chunked_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                          q_offset: int = 0, kv_chunk: int = 1024) -> torch.Tensor:
    """Prefill attention as the JAX package computes it: an online-softmax
    walk over KV chunks of ``kv_chunk`` (halved until it divides Skv), each
    a batched matmul.  q (B, Sq, H, hd); k, v (B, Skv, KVH, hd) -> (B, Sq,
    H, hd) in q's dtype.  Masked scores are -1e30, P is cast to V's dtype
    before the PV product, and the output is acc / max(l, 1e-30)."""
    from repro_torch.models.attention import _softmax_scale

    b, sq, h, hd = q.shape
    _, skv, kvh, _ = k.shape
    g = h // kvh
    kc = _pick_chunk(skv, kv_chunk)
    scale = _softmax_scale(hd)
    op = torch.promote_types(q.dtype, k.dtype)
    qg = q.reshape(b, sq, kvh, g, hd).permute(0, 2, 3, 1, 4).to(op).float()  # (b,kvh,g,sq,hd)
    qpos = q_offset + torch.arange(sq, device=q.device)
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


def rms_norm_ref(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the ``(1 + gamma)`` gain convention, computed in f32, as
    the JAX package computes it."""
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + gamma.to(torch.float32))).to(dt)
