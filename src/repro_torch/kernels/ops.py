"""Dispatch layer over the port's kernels (counterpart of
``repro.kernels.ops``).

A CUDA tensor goes to the hand-written kernel and a CPU tensor to its plain
version; for a CUDA tensor nothing falls back, so a failed build or launch
raises.  The wrappers here also flatten leading batch dims and, for the
matmul, apply the tensor scale in the epilogue and cast back to x's dtype.
Rows past M in the matmul's last tile are masked inside the kernel, which
stands in for the JAX wrapper's M padding.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import PackedRazerWeight

from . import ref
from .razer_kv_attention import razer_kv_attention_cuda
from .razer_matmul import razer_matmul_cuda
from .razer_quantize import razer_act_qdq_cuda

__all__ = ["razer_matmul", "razer_act_qdq", "razer_kv_attention"]


def razer_matmul(x: torch.Tensor, pw: PackedRazerWeight) -> torch.Tensor:
    """y = x @ dequant(pw) for x (..., K) -> (..., N) in x's dtype."""
    k, n = pw.shape
    if x.shape[-1] != k:
        raise ValueError(f"x {tuple(x.shape)} does not match packed weight {pw.shape}")
    lead = x.shape[:-1]
    xf = x.reshape(-1, k)
    if x.is_cuda:
        y = razer_matmul_cuda(xf.contiguous(), pw.codes, pw.scale_meta,
                              m0=pw.sv_magnitudes[0], m1=pw.sv_magnitudes[1])
        y = y * pw.tensor_scale
    else:
        y = ref.razer_matmul_ref(xf, pw)  # the tensor scale is inside the f32 weight
    return y.reshape(*lead, n).to(x.dtype)


def razer_act_qdq(x: torch.Tensor, *, svs=(5.0, -5.0), block: int = 16) -> torch.Tensor:
    """Fused dynamic activation fake-quant over the last dim (any batch shape)."""
    if x.is_cuda:
        if block != 16:
            raise ValueError(f"the activation kernel quantizes 16-element blocks, not {block}")
        return razer_act_qdq_cuda(x.contiguous(), svs)
    return ref.razer_act_qdq_ref(x, svs=svs, block=block)


def razer_kv_attention(q: torch.Tensor, cache, cur_len) -> torch.Tensor:
    """Decode attention over a packed KV cache dict (serving.kvcache layout).

    q: (B, 1, H, hd) or (B, H, hd); cur_len: int or (B,) valid lengths.
    Returns q's shape and dtype."""
    squeeze = q.dim() == 4
    qf = q[:, 0] if squeeze else q
    caches = (cache["k_codes"], cache["k_meta"], cache["v_codes"], cache["v_meta"])
    if q.is_cuda:
        b = qf.shape[0]
        cl = torch.as_tensor(cur_len, dtype=torch.int32, device=q.device).reshape(-1).expand(b)
        out = razer_kv_attention_cuda(qf.to(torch.float32).contiguous(),
                                      *(c.contiguous() for c in caches), cl.contiguous())
    else:
        out = ref.razer_kv_attention_ref(qf, *caches, cur_len)
    out = out.to(q.dtype)
    return out[:, None] if squeeze else out
