"""Causal GQA prefill attention on Hopper: the wrapper of
``csrc/prefill_attention.cu`` (K9, which has no Pallas counterpart: the JAX
package's ``chunked_attention`` is jnp) and its plain version.

The kernel walks each query row's keys from position 0 in chunks of a fixed
width up to its causal limit, so a row's bits depend only on its own query,
the keys at or before its position and that position: not on B, Sq, the
padded Skv, ``kv_chunk`` or where the row sits in a tile.  That is what
makes a prompt served alone at its bucket equal the same prompt generated
inside a padded batch.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .ref import chunked_attention_ref as plain

__all__ = ["prefill_attention_cuda", "plain", "HEAD_DIMS"]

HEAD_DIMS = (16, 32, 64, 128)  # the head widths the kernel is built for
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, out, three dtype flags, B, Sq, Skv, H, KVH, hd, q_offset, causal, scale, stream
_ARGTYPES = [_P] * 4 + [_I] * 11 + [_F, _P]


def prefill_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                           q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Skv, KVH, hd); each a contiguous bf16 or
    f32 CUDA tensor -> (B, Sq, H, hd) in q's dtype.  Query i sits at
    position ``q_offset + i`` and key j at j; ``causal`` keeps keys j <=
    q_offset + i.  The scores and sums are f32 and P is rounded to V's dtype
    before the PV product, as in the plain version."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("prefill_attention_cuda takes CUDA tensors; kernels.ops.prefill_attention routes "
                         "CPU tensors to the plain version")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in (torch.bfloat16, torch.float32) or t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-D bf16/f32 tensor, got {t.dtype} {tuple(t.shape)}")
    b, sq, h, hd = q.shape
    _, skv, kvh, _ = k.shape
    if tuple(k.shape) != (b, skv, kvh, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if h % kvh or hd not in HEAD_DIMS:
        raise ValueError(f"unsupported heads H={h}, KVH={kvh}, hd={hd} (H % KVH == 0, hd in {HEAD_DIMS})")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    out = torch.empty_like(q)
    if out.numel() == 0 or skv == 0:
        return out.zero_()
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    bf = lambda t: int(t.dtype == torch.bfloat16)  # noqa: E731
    fn = build.function("prefill_attention", "prefill_attention_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bf(q), bf(k), bf(v), b, sq, skv, h,
                    kvh, hd, int(q_offset), int(causal), scale, torch.cuda.current_stream().cuda_stream)
    build.check(status, "prefill_attention")
    prefill_attention_cuda.launches += 1
    return out


prefill_attention_cuda.launches = 0
