"""The backward of RMSNorm on Hopper: the wrapper of ``csrc/rms_norm_bwd.cu``
(K10's backward, no Pallas counterpart: the JAX package differentiates its
jnp ``rms_norm``) and its plain version, autograd through
``ref.rms_norm_ref``.

dgamma is summed over rows in two passes in a fixed order (per-block
partials, then the blocks in order), so a step's bits repeat.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import rms_norm_ref

__all__ = ["rms_norm_bwd_cuda", "plain"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# x, gamma, dy, dx, dgamma, partial, rows, d, x bf16, gamma bf16, eps, stream
_ARGTYPES = [_P] * 6 + [_L, _I, _I, _I, _F, _P]


def plain(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6):
    """(dx, dgamma) by autograd through the plain forward."""
    x, gamma = x.detach().requires_grad_(True), gamma.detach().requires_grad_(True)
    with torch.enable_grad():
        y = rms_norm_ref(x, gamma, eps)
    return torch.autograd.grad(y, (x, gamma), dy)


def rms_norm_bwd_cuda(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6):
    """(dx in x's dtype, dgamma in gamma's) of y = K10(x, gamma) for the
    gradient ``dy`` of y; x and dy (..., d) bf16/f32 of one dtype, gamma (d,)
    bf16/f32, all CUDA tensors."""
    if not (x.is_cuda and gamma.is_cuda and dy.is_cuda):
        raise ValueError("rms_norm_bwd_cuda takes CUDA tensors; the CPU path is autograd through the plain version")
    if x.dtype not in (torch.bfloat16, torch.float32) or gamma.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x and gamma must be bf16 or f32, got {x.dtype} and {gamma.dtype}")
    d = x.shape[-1]
    if gamma.shape != (d,) or dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"gamma {tuple(gamma.shape)} and dy {tuple(dy.shape)} {dy.dtype} do not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    x, gamma, dy = x.contiguous(), gamma.contiguous(), dy.contiguous()
    rows = x.numel() // d if d else 0
    dx, dgamma = torch.empty_like(x), torch.empty_like(gamma)
    if rows == 0:
        return dx, dgamma.zero_()
    blocks = build.function("rms_norm_bwd", "rms_norm_bwd_blocks", [_L])(rows)
    partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    fn = build.function("rms_norm_bwd", "rms_norm_bwd_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), gamma.data_ptr(), dy.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
                    partial.data_ptr(), rows, d, int(x.dtype == torch.bfloat16), int(gamma.dtype == torch.bfloat16),
                    float(eps), torch.cuda.current_stream().cuda_stream)
    build.check(status, "rms_norm_bwd")
    rms_norm_bwd_cuda.launches += 1
    return dx, dgamma


rms_norm_bwd_cuda.launches = 0
