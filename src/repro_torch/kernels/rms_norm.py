"""RMSNorm on Hopper: the wrapper of ``csrc/rms_norm.cu`` (K10, which has no
Pallas counterpart: the JAX package's ``rms_norm`` is jnp) and its plain
version.

The kernel sums each row's squares in one fixed order, whatever the number
of rows, so a row's bits do not depend on the batch: a prompt prefilled
alone and the same prompt inside a padded batch are normalized alike (the
library reduction of the plain version picks its split by shape).
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import rms_norm_ref as plain

__all__ = ["rms_norm_cuda", "plain"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _L, _I, _I, _I, _F, _P]  # x, gamma, y, rows, d, x bf16, gamma bf16, eps, stream


def rms_norm_cuda(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim of a bf16/f32 CUDA tensor with the (1 +
    gamma) gain (gamma (d,) bf16/f32), computed in f32 -> x's shape and
    dtype."""
    if not (x.is_cuda and gamma.is_cuda):
        raise ValueError("rms_norm_cuda takes CUDA tensors; kernels.ops.rms_norm routes CPU tensors to the "
                         "plain version")
    for name, t in (("x", x), ("gamma", gamma)):
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"{name} must be bf16 or f32, got {t.dtype}")
    d = x.shape[-1]
    if gamma.shape != (d,):
        raise ValueError(f"gamma {tuple(gamma.shape)} does not match the last dim {d} of x")
    x, gamma = x.contiguous(), gamma.contiguous()
    y = torch.empty_like(x)
    fn = build.function("rms_norm", "rms_norm_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), gamma.data_ptr(), y.data_ptr(), x.numel() // d if d else 0, d,
                    int(x.dtype == torch.bfloat16), int(gamma.dtype == torch.bfloat16), float(eps),
                    torch.cuda.current_stream().cuda_stream)
    build.check(status, "rms_norm")
    rms_norm_cuda.launches += 1
    return y


rms_norm_cuda.launches = 0
