"""RaZeR packed-weight GEMM on Hopper: the wrapper of ``csrc/razer_matmul.cu``
(which replaces the Pallas ``razer_matmul_pallas``) and its plain version.

``razer_matmul_cuda`` takes CUDA tensors only; ``kernels.ops.razer_matmul``
sends CPU tensors to ``plain`` instead.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ref import razer_matmul_ref as plain

__all__ = ["razer_matmul_cuda", "plain", "BK"]

BK = 64  # K step of the kernel; K must be a multiple of it
_BN = 64
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P]


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _splits(m: int, n: int, k: int, device: torch.device):
    """(splits, k_tiles_per_split): split K until the grid holds about two
    blocks per SM, with no empty split."""
    k_tiles = k // BK
    bm = 4 if m <= 4 else 16  # the kernel's row tile
    tiles = -(-n // _BN) * -(-m // bm)
    sms = _sm_count(device.index if device.index is not None else torch.cuda.current_device())
    want = min(max(1, -(-2 * sms // tiles)), k_tiles)
    per = -(-k_tiles // want)
    return -(-k_tiles // per), per


def razer_matmul_cuda(x: torch.Tensor, codes: torch.Tensor, scale_meta: torch.Tensor, *,
                      m0: float, m1: float) -> torch.Tensor:
    """x (M, K) bf16 or f32 @ the packed (K, N) weight -> (M, N) f32, without
    the tensor scale."""
    if not (x.is_cuda and codes.is_cuda and scale_meta.is_cuda):
        raise ValueError("razer_matmul_cuda takes CUDA tensors; kernels.ops.razer_matmul "
                         "routes CPU tensors to the plain version")
    if x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 2-D bf16/f32 tensor, got {x.dtype} {tuple(x.shape)}")
    m, k = x.shape
    if codes.dtype != torch.uint8 or scale_meta.dtype != torch.uint8:
        raise ValueError("codes and scale_meta must be uint8")
    n = codes.shape[1]
    if k % BK or codes.shape != (k // 2, n) or scale_meta.shape != (k // 16, n):
        raise ValueError(f"shapes x {tuple(x.shape)}, codes {tuple(codes.shape)}, scale_meta "
                         f"{tuple(scale_meta.shape)} do not form a packed (K, N) GEMM with K % {BK} == 0")
    if not (codes.is_contiguous() and scale_meta.is_contiguous()):
        raise ValueError("codes and scale_meta must be contiguous")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    splits, per = _splits(m, n, k, x.device)
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
