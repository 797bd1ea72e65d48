"""Baseline 4-bit formats the paper compares against (§5.1, App. B.1),
PyTorch port of ``repro.core.baselines``.

  * MXFP4        -- OCP MX: block 32, E8M0 (power-of-two) scale, FP4 elements.
  * INT4         -- symmetric integer grid, fp16-rounded block scale.
  * NF4          -- QLoRA NormalFloat-4 lookup table, absmax block scale.
  * FourOverSix  -- per block, scale to the full FP4 range (max 6) or the
                    narrower one (max 4), whichever has the lower error.

Each returns the port's ``BlockQuantized`` and computes on its input's
device.  Every division is by a float32 tensor on that device, never by a
Python number: CUDA divides by a scalar as a multiply by its reciprocal,
which can land an ulp off the quotient the CPU (and the reference) gives.

MXFP4's exponent and scale are the reference's bit for bit
(``formats.floor_log2`` and ``formats.exp2_int``): XLA's float32 log2 steps
to k up to 123 ulps away from 2^k, and its exp2 is tens of ulps off a power
of two for most exponents.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .formats import (FP4_VALUES, device_constant, exp2_int, floor_log2, positive_format_values,
                      round_to_values)
from .nvfp4 import BlockQuantized, _block_scales, _safe_div, _tensor_scale_divisor, block_reshape
from .razer import block_sse

__all__ = ["NF4_VALUES", "mxfp4_quantize", "int4_quantize", "nf4_quantize", "fouroversix_quantize"]

_FP4_GRID = np.unique(FP4_VALUES)
_FP4_GRID_NARROW = _FP4_GRID[np.abs(_FP4_GRID) <= 4.0]  # FourOverSix's narrow range

# QLoRA NF4 lookup table (Dettmers et al. 2023): quantiles of N(0, 1)
# normalized to [-1, 1].
NF4_VALUES = np.array(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
        -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
        0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
        0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
        0.7229568362236023, 1.0,
    ],
    np.float32,
)

def _divisor(value: float, device) -> torch.Tensor:
    """``value`` as a 0-d float32 tensor on ``device`` (see the module note)."""
    return device_constant(np.array([value], np.float32), device).reshape(())


def _unit_scale(x: torch.Tensor) -> torch.Tensor:
    return torch.ones((), dtype=x.dtype, device=x.device)


def mxfp4_quantize(x: torch.Tensor, *, block_size: int = 32, axis: int = -1, **_) -> BlockQuantized:
    """OCP MXFP4: shared scale 2^(floor(log2(absmax)) - emax_fp4), emax_fp4 = 2."""
    xb = block_reshape(x, block_size, axis)
    absmax = xb.abs().amax(dim=-1)
    exp = floor_log2(torch.where(absmax == 0, torch.ones_like(absmax), absmax)) - 2
    scale = exp2_int(exp.clamp(-127, 127))  # the E8M0 range
    q = round_to_values(_safe_div(xb, scale[..., None]), _FP4_GRID)
    return BlockQuantized(q=q, block_scale=scale, tensor_scale=_unit_scale(x), axis=axis)


def int4_quantize(x: torch.Tensor, *, block_size: int = 32, axis: int = -1, **_) -> BlockQuantized:
    """Symmetric INT4 {-7..7} with an fp16-rounded block scale."""
    xb = block_reshape(x, block_size, axis)
    absmax = xb.abs().amax(dim=-1)
    scale = (absmax / _divisor(7.0, x.device)).to(torch.float16).to(x.dtype)
    q = torch.round(_safe_div(xb, scale[..., None])).clamp(-7, 7)
    return BlockQuantized(q=q, block_scale=scale, tensor_scale=_unit_scale(x), axis=axis)


def nf4_quantize(x: torch.Tensor, *, block_size: int = 32, axis: int = -1, **_) -> BlockQuantized:
    """QLoRA NF4: absmax-normalized lookup-table quantization (the absmax
    stored in fp16)."""
    xb = block_reshape(x, block_size, axis)
    scale = xb.abs().amax(dim=-1).to(torch.float16).to(x.dtype)
    q = round_to_values(_safe_div(xb, scale[..., None]), NF4_VALUES)
    return BlockQuantized(q=q, block_scale=scale, tensor_scale=_unit_scale(x), axis=axis)


def fouroversix_quantize(x: torch.Tensor, *, block_size: int = 16, scale_fmt: str = "e4m3", axis: int = -1,
                         tensor_scale: Optional[torch.Tensor] = None, **_) -> BlockQuantized:
    """FourOverSix (Cook et al. 2025): each block tries its absmax mapped to
    6 (the full FP4 range) and to 4 (elements then limited to |q| <= 4) and
    keeps the one with the lower squared error; the first wins a tie."""
    xb = block_reshape(x, block_size, axis)
    if tensor_scale is None:
        scale_grid_max = float(positive_format_values(scale_fmt)[-1])
        tensor_scale = x.abs().amax() / _tensor_scale_divisor(scale_grid_max, x.device)
        tensor_scale = torch.where(tensor_scale == 0, torch.ones_like(tensor_scale), tensor_scale)
    best = None
    for elem_max, grid in ((6.0, _FP4_GRID), (4.0, _FP4_GRID_NARROW)):
        d8 = _block_scales(xb, scale_fmt, elem_max, tensor_scale)
        scaled = _safe_div(xb, (tensor_scale * d8)[..., None])
        q = round_to_values(scaled, grid)
        err = block_sse(q * (tensor_scale * d8)[..., None], xb)
        if best is None:
            best = q, d8, err
        else:
            take = err < best[2]
            best = (torch.where(take[..., None], q, best[0]), torch.where(take, d8, best[1]),
                    torch.where(take, err, best[2]))
    return BlockQuantized(q=best[0], block_scale=best[1], tensor_scale=tensor_scale, axis=axis)
