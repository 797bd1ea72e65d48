"""Grouped RaZeR packed GEMM over stacked expert banks on Hopper: the
wrapper of ``csrc/razer_grouped_matmul.cu`` (K6, which replaces the Pallas
``razer_grouped_matmul_pallas``) and its plain version.

``razer_grouped_matmul_cuda`` takes CUDA tensors only;
``kernels.ops.razer_grouped_matmul`` sends CPU tensors to ``plain`` instead.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .razer_matmul import BK, _splits
from .ref import razer_grouped_matmul_ref as plain

__all__ = ["razer_grouped_matmul_cuda", "plain"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P]


def razer_grouped_matmul_cuda(x: torch.Tensor, codes: torch.Tensor, scale_meta: torch.Tensor, *,
                              m0: float, m1: float) -> torch.Tensor:
    """x (E, M, K) bf16 or f32 @ the packed (E, K, N) bank -> (E, M, N) f32,
    without the per-expert tensor scale.  The K split count is K1's
    (``razer_matmul._splits``, from (N, K) alone), so expert e returns K1's
    bits on entry e and a row's bits do not depend on M."""
    if not (x.is_cuda and codes.is_cuda and scale_meta.is_cuda):
        raise ValueError("razer_grouped_matmul_cuda takes CUDA tensors; kernels.ops.razer_grouped_matmul "
                         "routes CPU tensors to the plain version")
    if x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 3-D bf16/f32 tensor, got {x.dtype} {tuple(x.shape)}")
    e, m, k = x.shape
    if codes.dtype != torch.uint8 or scale_meta.dtype != torch.uint8:
        raise ValueError("codes and scale_meta must be uint8")
    n = codes.shape[-1]
    if k % BK or codes.shape != (e, k // 2, n) or scale_meta.shape != (e, k // 16, n):
        raise ValueError(f"shapes x {tuple(x.shape)}, codes {tuple(codes.shape)}, scale_meta "
                         f"{tuple(scale_meta.shape)} do not form a grouped packed (E, K, N) GEMM with "
                         f"K % {BK} == 0")
    if not (codes.is_contiguous() and scale_meta.is_contiguous()):
        raise ValueError("codes and scale_meta must be contiguous")
    splits, per = _splits(n, k)
    if e * splits > 65535:
        raise ValueError(f"{e} experts x {splits} K splits exceed the grid's z limit of 65535")
    out = torch.empty((e, m, n), dtype=torch.float32, device=x.device)
    if m == 0 or e == 0:
        return out
    partial = torch.empty((splits, e, m, n), dtype=torch.float32, device=x.device) if splits > 1 else out
    fn = build.function("razer_grouped_matmul", "razer_grouped_matmul_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(), scale_meta.data_ptr(),
                    partial.data_ptr(), out.data_ptr(), e, m, k, n, splits, per, float(m0), float(m1),
                    torch.cuda.current_stream().cuda_stream)
    build.check(status, "razer_grouped_matmul")
    razer_grouped_matmul_cuda.launches += 1
    return out


razer_grouped_matmul_cuda.launches = 0
