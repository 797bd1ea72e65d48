"""RaZeR packed-weight GEMM on Hopper: the wrappers of ``csrc/razer_matmul.cu``
-- K1, which replaces the Pallas ``razer_matmul_pallas``, and its K-shard
form K7 (``razer_matmul_kshard_pallas``) -- and its plain version.

``razer_matmul_cuda`` and ``razer_matmul_kshard_cuda`` take CUDA tensors
only; ``kernels.ops`` sends CPU tensors to ``plain`` instead.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import razer_matmul_ref as plain

__all__ = ["razer_matmul_cuda", "razer_matmul_kshard_cuda", "plain", "BK"]

BK = 64  # K step of the kernel; K must be a multiple of it
_BN = 64
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P]
_KSHARD_ARGTYPES = [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P]


# blocks the split-K grid aims for at decode-sized M: two per SM of an H100
# SXM (132 SMs).  A constant, not the card's SM count, so that the split
# boundaries -- and with them every output bit -- depend on (N, K) alone.
_TARGET_BLOCKS = 2 * 132


def _splits(n: int, k: int):
    """(splits, k_tiles_per_split) from the weight's shape alone: split K
    until N's column tiles fill about ``_TARGET_BLOCKS`` blocks, with no
    empty split.  The row count M never enters, so one activation row sums
    its K in the same grouping whatever the batch (decode, padded serve
    slots, a verify pass, prefill), and its output is bit for bit the same."""
    k_tiles = k // BK
    want = min(max(1, -(-_TARGET_BLOCKS // -(-n // _BN))), k_tiles)
    per = -(-k_tiles // want)
    return -(-k_tiles // per), per


def _check(x: torch.Tensor, codes: torch.Tensor, scale_meta: torch.Tensor, what: str, k_shards: int = 1):
    """Validate a K1/K7 call; returns (M, K, N)."""
    if not (x.is_cuda and codes.is_cuda and scale_meta.is_cuda):
        raise ValueError(f"{what} takes CUDA tensors; kernels.ops routes CPU tensors to the plain version")
    if x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 2-D bf16/f32 tensor, got {x.dtype} {tuple(x.shape)}")
    m, k = x.shape
    if codes.dtype != torch.uint8 or scale_meta.dtype != torch.uint8:
        raise ValueError("codes and scale_meta must be uint8")
    n = codes.shape[1]
    if k % BK and k_shards > 1:
        raise ValueError(f"{what}: the local K of this rank's shard is {k} (K {k * k_shards} over tp "
                         f"{k_shards}), and the kernel steps K by {BK}: it needs local K % {BK} == 0")
    if k % BK or codes.shape != (k // 2, n) or scale_meta.shape != (k // 16, n):
        raise ValueError(f"shapes x {tuple(x.shape)}, codes {tuple(codes.shape)}, scale_meta "
                         f"{tuple(scale_meta.shape)} do not form a packed (K, N) GEMM with K % {BK} == 0")
    if not (codes.is_contiguous() and scale_meta.is_contiguous()):
        raise ValueError("codes and scale_meta must be contiguous")
    return m, k, n


def razer_matmul_cuda(x: torch.Tensor, codes: torch.Tensor, scale_meta: torch.Tensor, *,
                      m0: float, m1: float) -> torch.Tensor:
    """x (M, K) bf16 or f32 @ the packed (K, N) weight -> (M, N) f32, without
    the tensor scale."""
    m, k, n = _check(x, codes, scale_meta, "razer_matmul_cuda")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    splits, per = _splits(n, k)
    partial = torch.empty((splits, m, n), dtype=torch.float32, device=x.device) if splits > 1 else out
    fn = build.function("razer_matmul", "razer_matmul_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(),
                    scale_meta.data_ptr(), partial.data_ptr(), out.data_ptr(), m, k, n, splits,
                    per, float(m0), float(m1), torch.cuda.current_stream().cuda_stream)
    build.check(status, "razer_matmul")
    razer_matmul_cuda.launches += 1
    return out


razer_matmul_cuda.launches = 0


def razer_matmul_kshard_cuda(x: torch.Tensor, codes: torch.Tensor, scale_meta: torch.Tensor, *,
                             m0: float, m1: float, out_chunks: int) -> torch.Tensor:
    """K7: x (M, K_local) @ this rank's packed (K_local, N) shard -> its
    full-N f32 partial, without the tensor scale, laid out for the
    reduce-scatter as (out_chunks, M, N/out_chunks): chunk r holds columns
    [r N/c, (r+1) N/c).  The split count is K1's on the local shape, so the
    result is K1's on the same shard, permuted, bit for bit."""
    m, k, n = _check(x, codes, scale_meta, "razer_matmul_kshard_cuda", out_chunks)
    if out_chunks <= 0 or n % out_chunks:
        raise ValueError(f"N {n} does not split into {out_chunks} output chunks")
    out = torch.empty((out_chunks, m, n // out_chunks), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    splits, per = _splits(n, k)
    partial = torch.empty((splits, m, n), dtype=torch.float32, device=x.device) if splits > 1 else out
    fn = build.function("razer_matmul", "razer_matmul_kshard_launch", _KSHARD_ARGTYPES)
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(),
                    scale_meta.data_ptr(), partial.data_ptr(), out.data_ptr(), m, k, n, splits,
                    per, out_chunks, float(m0), float(m1), torch.cuda.current_stream().cuda_stream)
    build.check(status, "razer_matmul_kshard")
    razer_matmul_kshard_cuda.launches += 1
    return out


razer_matmul_kshard_cuda.launches = 0
