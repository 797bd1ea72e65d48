"""The backward of GQA prefill attention on Hopper: the wrapper of
``csrc/prefill_attention_bwd.cu`` (K9's backward, no Pallas counterpart: the
JAX package differentiates its jnp ``chunked_attention``) and its plain
version, autograd through ``ref.chunked_attention_ref``.

It takes the forward's widths (``HEAD_DIMS`` with V at
``prefill_attention.v_width``): q and k at head width 16, 32, 64, 128 or
256 with V as wide, and MLA's hd 192 (qk_nope 128 + qk_rope 64) with V at
128; causal or not, with or without a sliding window, at any ``q_offset``.
o and dout have V's width.  Each call is two kernels (a query-major pass for
dq, a key-major pass for dk and dv) and counts one launch.

It has two bodies, chosen by the dtypes alone (``kernel_body``): bf16 q, k
and v -- the training path's, whose compute dtype is bf16 -- run on the
tensor cores (``wgmma``, bf16 operands, f32 accumulators, P and dS rounded
to bf16 before their products); any f32 input runs the f32 body on the
CUDA cores, whose error holds the f32 tolerance that bf16 operands cannot.
The choice is by dtype, not a fallback: a build or launch failure raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .prefill_attention import HEAD_DIMS, v_width  # the backward is built for the forward's widths
from .ref import chunked_attention_ref

__all__ = ["prefill_attention_bwd_cuda", "plain", "HEAD_DIMS", "check_args", "kernel_body", "kernel_names"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, o, dout, dq, dk, dv, ws, three dtype flags, B, Sq, Skv, H, KVH, hd, dv, q_offset, causal, window, scale,
# stream
_ARGTYPES = [_P] * 9 + [_I] * 13 + [_F, _P]


def kernel_body(q_dtype: torch.dtype, kv_bf16: bool = True) -> str:
    """The body a launch runs (the C entry chooses the same way):
    ``"tensor_core"`` for bf16 q, k and v, else ``"f32"``."""
    if q_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the prefill attention backward takes a bf16 or f32 q, got {q_dtype}")
    return "tensor_core" if q_dtype == torch.bfloat16 and kv_bf16 else "f32"


def kernel_names(q_dtype: torch.dtype, kv_bf16: bool = True) -> tuple:
    """The ``__global__`` names a call launches, in order, as a profiler
    lists them (a template's name holds them): the query-major pass, then
    the key-major pass, of the body ``kernel_body`` picks."""
    return {"tensor_core": ("prefill_attention_bwd_tc_dq_kernel", "prefill_attention_bwd_tc_dkdv_kernel"),
            "f32": ("prefill_attention_bwd_dq_kernel", "prefill_attention_bwd_dkdv_kernel")}[
        kernel_body(q_dtype, kv_bf16)]


def plain(q, k, v, dout, *, causal: bool = True, window: int = 0, q_offset: int = 0):
    """(dq, dk, dv) by autograd through the plain forward."""
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    with torch.enable_grad():
        o = chunked_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return torch.autograd.grad(o, (q, k, v), dout)


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise for what the backward kernel does not take, naming what it
    does: the forward's widths, q/k at ``HEAD_DIMS`` with V at ``v_width``
    (as wide, or 128 at MLA's 192)."""
    hd = q.shape[-1]
    if hd not in HEAD_DIMS or v.shape[-1] != v_width(hd):
        pairs = ", ".join(f"({w}, {v_width(w)})" for w in HEAD_DIMS)
        raise ValueError(f"the prefill attention backward (K9's) takes (q/k, V) head widths {pairs}, got q/k {hd} "
                         f"and V {v.shape[-1]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"{name} must be bf16 or f32, got {t.dtype}")


def prefill_attention_bwd_cuda(q, k, v, o, dout, *, causal: bool = True, window: int = 0, q_offset: int = 0):
    """(dq, dk, dv) of o = K9(q, k, v) for the gradient ``dout`` of o: q (B,
    Sq, H, hd), k (B, Skv, KVH, hd), v (B, Skv, KVH, dv), o and dout (B,
    Sq, H, dv), dv = ``v_width(hd)``, contiguous CUDA tensors; o and dout in
    q's dtype.  The softmax statistics are recomputed (K9's
    forward writes none), every sum is f32 in a fixed order.  bf16 q, k
    and v run the tensor-core body (``kernel_body``), which reads its
    inputs in 16-byte pieces: one whose data is not 16-byte aligned is
    copied first."""
    check_args(q, k, v)
    b, sq, h, hd = q.shape
    _, skv, kvh, _ = k.shape
    dv_width = v.shape[-1]
    if h % kvh or tuple(k.shape) != (b, skv, kvh, hd) or tuple(v.shape) != (b, skv, kvh, dv_width):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if (tuple(o.shape) != (b, sq, h, dv_width) or tuple(dout.shape) != (b, sq, h, dv_width) or o.dtype != q.dtype
            or dout.dtype != q.dtype):
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} and dout {tuple(dout.shape)} {dout.dtype} must be "
                         f"{(b, sq, h, dv_width)} (V's width) in q's dtype {q.dtype}")
    if q_offset < 0 or window < 0:
        raise ValueError(f"q_offset and window must be >= 0, got {q_offset} and {window}")
    if not all(t.is_cuda for t in (q, k, v, o, dout)):
        raise ValueError("prefill_attention_bwd_cuda takes CUDA tensors; the CPU path is autograd through the plain "
                         "version")
    q, k, v, o, dout = (t.contiguous() for t in (q, k, v, o, dout))
    if kernel_body(q.dtype, k.dtype == v.dtype == torch.bfloat16) == "tensor_core":
        q, k, v, o, dout = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v, o, dout))
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
                    dv_width, int(q_offset), int(causal), int(window), scale, torch.cuda.current_stream().cuda_stream)
    build.check(status, "prefill_attention_bwd")
    prefill_attention_bwd_cuda.launches += 1
    return dq, dk, dv


prefill_attention_bwd_cuda.launches = 0
