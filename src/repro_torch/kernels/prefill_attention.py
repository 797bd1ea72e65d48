"""Causal GQA prefill attention on Hopper: the wrapper of
``csrc/prefill_attention.cu`` (K9, which has no Pallas counterpart: the JAX
package's ``chunked_attention`` is jnp) and its plain version.

The kernel walks each query row's keys from position 0 in chunks of a fixed
width up to its causal limit, so a row's bits depend only on its own query,
the keys at or before its position and that position: not on B, Sq, the
padded Skv, ``kv_chunk``, the GQA group around it or where the row sits in a
tile.  That is what makes a prompt served alone at its bucket equal the same
prompt generated inside a padded batch.

It has two bodies, chosen by q's dtype alone (``kernel_body``): a bf16 q,
the serving path's, runs on the tensor cores with f32 K/V/P split into
three bf16 parts (products exact, only the f32 summation order differs
from the plain version: each chunk's P V is summed from zero on the tensor
cores and added to the running output by an f32 fma; the parts of
bf16-exact K/V, as the KV wire format gives them, are zero and their
products skipped); an f32 q
runs on the CUDA cores in f32, because the split arithmetic does not reach
the f32 tolerance against the plain version.  The choice is by dtype, not a
fallback: a build or launch failure raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .ref import chunked_attention_ref as plain

__all__ = ["prefill_attention_cuda", "plain", "HEAD_DIMS", "kernel_body", "kernel_names", "workspace_shapes"]

HEAD_DIMS = (16, 32, 64, 128)  # the head widths the kernel is built for
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, out, ws, flags, three dtype flags, B, Sq, Skv, H, KVH, hd, q_offset, causal, scale, stream
_ARGTYPES = [_P] * 6 + [_I] * 11 + [_F, _P]
CHUNK = 64  # keys per chunk of the kernel's walk


def workspace_shapes(b: int, skv: int, kvh: int, hd: int):
    """The tensor-core body's scratch: per (b, kv head, 64-key chunk) the
    six bf16 part tiles of its K and V^T (hi, mid, lo), as bytes, and one
    int flag saying whether its mid and lo tiles are non-zero."""
    slots = b * kvh * -(-skv // CHUNK)
    return (slots * 6 * CHUNK * hd * 2,), (slots,)


def kernel_body(q_dtype: torch.dtype) -> str:
    """The body a launch with this q dtype runs: ``"tensor_core"`` for bf16,
    ``"f32"`` for f32 (the C entry chooses the same way)."""
    if q_dtype == torch.bfloat16:
        return "tensor_core"
    if q_dtype == torch.float32:
        return "f32"
    raise ValueError(f"prefill attention takes a bf16 or f32 q, got {q_dtype}")


def kernel_names(q_dtype: torch.dtype) -> tuple:
    """The ``__global__`` names a call with this q dtype launches, in order,
    as a profiler lists them: the tensor-core body splits K/V into bf16
    tiles first, then attends."""
    return {"tensor_core": ("prefill_attention_tc_split_kernel", "prefill_attention_tc_kernel"),
            "f32": ("prefill_attention_f32_kernel",)}[kernel_body(q_dtype)]


def _check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int) -> None:
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
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("prefill_attention_cuda takes CUDA tensors; kernels.ops.prefill_attention routes "
                         "CPU tensors to the plain version")
    if q.data_ptr() % 16 or k.data_ptr() % 8 or v.data_ptr() % 8:
        raise ValueError("prefill_attention_cuda reads q in 16-byte and k, v in 8-byte pieces: their data must "
                         "be aligned to those sizes")


def prefill_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                           q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Skv, KVH, hd); each a contiguous bf16 or
    f32 CUDA tensor -> (B, Sq, H, hd) in q's dtype.  Query i sits at
    position ``q_offset + i`` and key j at j; ``causal`` keeps keys j <=
    q_offset + i.  The scores and sums are f32 and P is rounded to V's dtype
    before the PV product, as in the plain version.  A bf16 q runs the
    tensor-core body, an f32 q the f32 body (``kernel_body``)."""
    _check_args(q, k, v, q_offset)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0 or skv == 0:
        return out.zero_()
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    bf = lambda t: int(t.dtype == torch.bfloat16)  # noqa: E731
    ws = flags = None
    if kernel_body(q.dtype) == "tensor_core":
        ws_shape, flags_shape = workspace_shapes(b, skv, kvh, hd)
        ws = torch.empty(ws_shape, dtype=torch.uint8, device=q.device)
        flags = torch.empty(flags_shape, dtype=torch.int32, device=q.device)
    fn = build.function("prefill_attention", "prefill_attention_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ws.data_ptr() if ws is not None else None,
                    flags.data_ptr() if flags is not None else None, bf(q), bf(k), bf(v), b, sq, skv, h, kvh, hd,
                    int(q_offset), int(causal), scale, torch.cuda.current_stream().cuda_stream)
    build.check(status, "prefill_attention")
    prefill_attention_cuda.launches += 1
    return out


prefill_attention_cuda.launches = 0
