"""Decode attention over a RaZeR-packed KV cache on Hopper: the wrapper of
``csrc/razer_kv_attention.cu`` (which replaces the Pallas
``razer_kv_attention_pallas``) and its plain version."""
from __future__ import annotations

import ctypes

import torch

from . import attention_plan, build
from .ref import razer_kv_attention_ref as plain

__all__ = ["razer_kv_attention_cuda", "plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 9 + [_I] * 5 + [_P]  # q, caches, cur_len, out, ws, counters, B, S, KVH, G, hd, stream


def razer_kv_attention_cuda(q, k_codes, k_meta, v_codes, v_meta, cur_len) -> torch.Tensor:
    """q (B, H, hd) f32 against caches (B, S, KVH, hd/2 | hd/16) uint8 and
    cur_len (B,) int32, all CUDA and contiguous -> (B, H, hd) f32."""
    tensors = (q, k_codes, k_meta, v_codes, v_meta, cur_len)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("razer_kv_attention_cuda takes CUDA tensors; kernels.ops.razer_kv_attention "
                         "routes CPU tensors to the plain version")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("razer_kv_attention_cuda needs contiguous tensors")
    if q.dtype != torch.float32 or q.dim() != 3:
        raise ValueError(f"q must be (B, H, hd) float32, got {q.dtype} {tuple(q.shape)}")
    b, h, hd = q.shape
    if k_codes.dim() != 4:
        raise ValueError(f"caches must be (B, S, KVH, x), got {tuple(k_codes.shape)}")
    _, s, kvh, _ = k_codes.shape
    if h % kvh or not 1 <= h // kvh <= attention_plan.MAX_G or hd not in attention_plan.HEAD_DIMS:
        raise ValueError(f"unsupported heads H={h}, KVH={kvh}, hd={hd} (G = H/KVH <= 8, hd in {attention_plan.HEAD_DIMS})")
    for t, width in ((k_codes, hd // 2), (v_codes, hd // 2), (k_meta, hd // 16), (v_meta, hd // 16)):
        if t.dtype != torch.uint8 or tuple(t.shape) != (b, s, kvh, width):
            raise ValueError(f"cache tensor {t.dtype} {tuple(t.shape)} != uint8 {(b, s, kvh, width)}")
    if cur_len.dtype != torch.int32 or tuple(cur_len.shape) != (b,):
        raise ValueError(f"cur_len must be (B,) int32, got {cur_len.dtype} {tuple(cur_len.shape)}")
    out = torch.empty((b, h, hd), dtype=torch.float32, device=q.device)
    ws, tickets = attention_plan.workspace(q.device, *attention_plan.workspace_size(b, kvh, s, h // kvh, hd))
    fn = build.function("razer_kv_attention", "razer_kv_attention_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        status = fn(q.data_ptr(), k_codes.data_ptr(), k_meta.data_ptr(), v_codes.data_ptr(),
                    v_meta.data_ptr(), cur_len.data_ptr(), out.data_ptr(), ws.data_ptr(), tickets.data_ptr(),
                    b, s, kvh, h // kvh, hd, torch.cuda.current_stream().cuda_stream)
    build.check(status, "razer_kv_attention")
    razer_kv_attention_cuda.launches += 1
    return out


razer_kv_attention_cuda.launches = 0
