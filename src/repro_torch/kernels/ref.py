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
           "paged_kv_attention_ref", "paged_kv_attention_verify_ref"]


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
