"""The backward of GQA prefill attention on Hopper: the wrapper of
``csrc/prefill_attention_bwd.cu`` (K9's backward, no Pallas counterpart: the
JAX package differentiates its jnp ``chunked_attention``) and its plain
version, autograd through ``ref.chunked_attention_ref``.

It takes what the trained paths need: q and k at head width 16, 32, 64 or
128 with V as wide, causal or not, with or without a sliding window, at any
``q_offset``; MLA's hd 192 with V at 128 and hd 256 (the forward's other
widths) raise.  Each call is two kernels (a query-major pass for dq, a
key-major pass for dk and dv) and counts one launch.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .ref import chunked_attention_ref

__all__ = ["prefill_attention_bwd_cuda", "plain", "HEAD_DIMS", "check_args", "kernel_names"]

HEAD_DIMS = (16, 32, 64, 128)  # the q/k (and V) head widths the backward is built for
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, o, dout, dq, dk, dv, ws, three dtype flags, B, Sq, Skv, H, KVH, hd, q_offset, causal, window, scale, stream
_ARGTYPES = [_P] * 9 + [_I] * 12 + [_F, _P]


def kernel_names() -> tuple:
    """The ``__global__`` names a call launches, in order, as a profiler
    lists them (a template's name starts with them)."""
    return ("prefill_attention_bwd_dq_kernel", "prefill_attention_bwd_dkdv_kernel")


def plain(q, k, v, dout, *, causal: bool = True, window: int = 0, q_offset: int = 0):
    """(dq, dk, dv) by autograd through the plain forward."""
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    with torch.enable_grad():
        o = chunked_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return torch.autograd.grad(o, (q, k, v), dout)


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise for what the backward kernel does not take, naming what it
    does: the trained paths' widths (``HEAD_DIMS``) with V as wide as q."""
    hd = q.shape[-1]
    if hd not in HEAD_DIMS or v.shape[-1] != hd:
        raise ValueError(f"the prefill attention backward (K9's) takes q/k head widths {HEAD_DIMS} with V as "
                         f"wide, got q/k {hd} and V {v.shape[-1]}: training this arch on the card is not ported")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"{name} must be bf16 or f32, got {t.dtype}")


def prefill_attention_bwd_cuda(q, k, v, o, dout, *, causal: bool = True, window: int = 0, q_offset: int = 0):
    """(dq, dk, dv) of o = K9(q, k, v) for the gradient ``dout`` of o: q, o,
    dout (B, Sq, H, hd), k, v (B, Skv, KVH, hd), contiguous CUDA tensors;
    o and dout in q's dtype.  The softmax statistics are recomputed (K9's
    forward writes none), every sum is f32 in a fixed order."""
    check_args(q, k, v)
    if not all(t.is_cuda for t in (q, k, v, o, dout)):
        raise ValueError("prefill_attention_bwd_cuda takes CUDA tensors; the CPU path is autograd through the plain "
                         "version")
    b, sq, h, hd = q.shape
    _, skv, kvh, _ = k.shape
    if h % kvh or tuple(k.shape) != (b, skv, kvh, hd) or tuple(v.shape) != (b, skv, kvh, hd):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if o.shape != q.shape or dout.shape != q.shape or o.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} and dout {tuple(dout.shape)} {dout.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if q_offset < 0 or window < 0:
        raise ValueError(f"q_offset and window must be >= 0, got {q_offset} and {window}")
    q, k, v, o, dout = (t.contiguous() for t in (q, k, v, o, dout))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    ws = torch.empty((3, b, h, sq), dtype=torch.float32, device=q.device)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    bf = lambda t: int(t.dtype == torch.bfloat16)  # noqa: E731
    fn = build.function("prefill_attention_bwd", "prefill_attention_bwd_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), ws.data_ptr(), bf(q), bf(k), bf(v), b, sq, skv, h, kvh, hd,
                    int(q_offset), int(causal), int(window), scale, torch.cuda.current_stream().cuda_stream)
    build.check(status, "prefill_attention_bwd")
    prefill_attention_bwd_cuda.launches += 1
    return dq, dk, dv


prefill_attention_bwd_cuda.launches = 0
