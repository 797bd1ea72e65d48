"""Plain PyTorch versions of the port's three CUDA kernels (the counterparts
of ``repro.kernels.ref``).  ``kernels.ops`` runs them for tensors on the CPU;
``chip_smoke.py`` holds each kernel against them on the card."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.formats import device_constant
from repro_torch.core.packing import PackedRazerWeight
from repro_torch.core.razer import razer_quantize

__all__ = ["razer_matmul_ref", "razer_act_qdq_ref", "razer_kv_attention_ref"]


def razer_matmul_ref(x: torch.Tensor, pw: PackedRazerWeight) -> torch.Tensor:
    """(M, K) @ dequant(pw) -> (M, N) f32; the f32 weight includes the tensor
    scale."""
    return x.to(torch.float32) @ pw.dequantize()


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
