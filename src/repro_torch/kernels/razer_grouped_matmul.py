"""Grouped RaZeR packed GEMM over stacked expert banks on Hopper: the
wrappers of ``csrc/razer_grouped_matmul.cu`` -- K6, which replaces the Pallas
``razer_grouped_matmul_pallas``, and its K-shard form K8
(``razer_grouped_matmul_kshard_pallas``) -- and its plain version.

``razer_grouped_matmul_cuda`` and ``razer_grouped_matmul_kshard_cuda`` take
CUDA tensors only; ``kernels.ops`` sends CPU tensors to ``plain`` instead.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .razer_matmul import BK, launch_plan
from .ref import razer_grouped_matmul_ref as plain

__all__ = ["razer_grouped_matmul_cuda", "razer_grouped_matmul_kshard_cuda", "plain"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P]
_KSHARD_ARGTYPES = [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P]


def _check(x: torch.Tensor, codes: torch.Tensor, scale_meta: torch.Tensor, what: str, k_shards: int = 1):
    """Validate a K6/K8 call; returns (E, M, K, N)."""
    if not (x.is_cuda and codes.is_cuda and scale_meta.is_cuda):
        raise ValueError(f"{what} takes CUDA tensors; kernels.ops routes CPU tensors to the plain version")
    if x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 3-D bf16/f32 tensor, got {x.dtype} {tuple(x.shape)}")
    e, m, k = x.shape
    if codes.dtype != torch.uint8 or scale_meta.dtype != torch.uint8:
        raise ValueError("codes and scale_meta must be uint8")
    n = codes.shape[-1]
    if k % BK and k_shards > 1:
        raise ValueError(f"{what}: the local K of this rank's bank tile is {k} (K {k * k_shards} over tp "
                         f"{k_shards}), and the kernel steps K by {BK}: it needs local K % {BK} == 0")
    if k % BK or codes.shape != (e, k // 2, n) or scale_meta.shape != (e, k // 16, n):
        raise ValueError(f"shapes x {tuple(x.shape)}, codes {tuple(codes.shape)}, scale_meta "
                         f"{tuple(scale_meta.shape)} do not form a grouped packed (E, K, N) GEMM with "
                         f"K % {BK} == 0")
    if not (codes.is_contiguous() and scale_meta.is_contiguous()):
        raise ValueError("codes and scale_meta must be contiguous")
    return e, m, k, n


def razer_grouped_matmul_cuda(x: torch.Tensor, codes: torch.Tensor, scale_meta: torch.Tensor, *,
                              m0: float, m1: float) -> torch.Tensor:
    """x (E, M, K) bf16 or f32 @ the packed (E, K, N) bank -> (E, M, N) f32,
    without the per-expert tensor scale.  The K split count is K1's
    (``razer_matmul.launch_plan``, from (N, K) alone), so expert e returns K1's
    bits on entry e and a row's bits do not depend on M."""
    e, m, k, n = _check(x, codes, scale_meta, "razer_grouped_matmul_cuda")
    out = torch.empty((e, m, n), dtype=torch.float32, device=x.device)
    if m == 0 or e == 0:
        return out
    plan = launch_plan(e, m, n, k)
    fn = build.function("razer_grouped_matmul", "razer_grouped_matmul_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(), scale_meta.data_ptr(),
                    out.data_ptr(), e, m, k, n, plan.nt, plan.splits, plan.k_tiles_per_split, float(m0), float(m1),
                    torch.cuda.current_stream().cuda_stream)
    build.check(status, "razer_grouped_matmul")
    razer_grouped_matmul_cuda.launches += 1
    return out


razer_grouped_matmul_cuda.launches = 0


def razer_grouped_matmul_kshard_cuda(x: torch.Tensor, codes: torch.Tensor, scale_meta: torch.Tensor, *,
                                     m0: float, m1: float, out_chunks: int) -> torch.Tensor:
    """K8: x (E_local, M, K_local) @ this rank's packed (E_local, K_local, N)
    bank tile -> its full-N f32 partial, without the per-expert tensor
    scale, laid out for the reduce-scatter as (out_chunks, E_local, M,
    N/out_chunks).  Bit for bit K6's output on the same tile, permuted."""
    e, m, k, n = _check(x, codes, scale_meta, "razer_grouped_matmul_kshard_cuda", out_chunks)
    if out_chunks <= 0 or n % out_chunks:
        raise ValueError(f"N {n} does not split into {out_chunks} output chunks")
    out = torch.empty((out_chunks, e, m, n // out_chunks), dtype=torch.float32, device=x.device)
    if m == 0 or e == 0:
        return out
    plan = launch_plan(e, m, n, k)
    fn = build.function("razer_grouped_matmul", "razer_grouped_matmul_kshard_launch", _KSHARD_ARGTYPES)
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(), scale_meta.data_ptr(),
                    out.data_ptr(), e, m, k, n, plan.nt, plan.splits, plan.k_tiles_per_split, out_chunks, float(m0),
                    float(m1), torch.cuda.current_stream().cuda_stream)
    build.check(status, "razer_grouped_matmul_kshard")
    razer_grouped_matmul_kshard_cuda.launches += 1
    return out


razer_grouped_matmul_kshard_cuda.launches = 0
