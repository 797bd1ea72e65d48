"""NVFP4 block scaling (paper §3, Eq. 1-3), PyTorch port of ``repro.core.nvfp4``.

A tensor is blocked along one axis into groups of ``block_size``; each block
gets a scale on a positive ExMy grid and a float32 tensor-wide scale sits on
top.  Dequantization is ``q * block_scale * tensor_scale``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .formats import FP4_MAX, FP4_VALUES, device_constant, positive_format_values, round_to_values

__all__ = ["BlockQuantized", "block_reshape", "block_unreshape", "nvfp4_quantize", "nvfp4_qdq"]


def block_reshape(x: torch.Tensor, block_size: int, axis: int = -1) -> torch.Tensor:
    """(.., K, ..) -> (..., K//B, B) with the blocked axis moved last."""
    x = torch.movedim(x, axis, -1)
    k = x.shape[-1]
    if k % block_size != 0:
        raise ValueError(f"axis size {k} not divisible by block_size {block_size}")
    return x.reshape(*x.shape[:-1], k // block_size, block_size)


def block_unreshape(xb: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of ``block_reshape``."""
    x = xb.reshape(*xb.shape[:-2], xb.shape[-2] * xb.shape[-1])
    return torch.movedim(x, -1, axis)


@dataclass
class BlockQuantized:
    """A block-quantized tensor in value space (not yet bit-packed).

    q            : elements on the element grid, blocked shape (..., nblk, B)
    block_scale  : per-block scale on the scale grid, (..., nblk)
    tensor_scale : 0-d float32 tensor
    sv, sv_index : RaZeR's chosen special value and its index (-1 = none)
    """

    q: torch.Tensor
    block_scale: torch.Tensor
    tensor_scale: torch.Tensor
    axis: int = -1
    sv: Optional[torch.Tensor] = None
    sv_index: Optional[torch.Tensor] = None

    def dequantize(self) -> torch.Tensor:
        x = self.q * (self.block_scale * self.tensor_scale)[..., None]
        return block_unreshape(x, self.axis)


def _safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a / torch.where(b == 0, torch.ones_like(b), b)


def _tensor_scale_divisor(scale_grid_max: float, device) -> torch.Tensor:
    """``scale_grid_max * 6`` as a float32 tensor on ``device``, the divisor
    of the default tensor scale.  A tensor, not a Python number: CUDA
    divides by a CPU scalar as a multiply by its reciprocal, which can land
    one ulp off the quotient, and so off the reference's (and the CPU's)
    tensor scale and wire bytes."""
    return device_constant(np.array([scale_grid_max * FP4_MAX], np.float32), device).reshape(())


def _block_scales(xb: torch.Tensor, scale_fmt: str, elem_max: float, tensor_scale) -> torch.Tensor:
    """Eq. 2: per-block scale rounded onto the positive scale grid; a nonzero
    block whose scale rounds to 0 gets the grid's smallest positive value."""
    absmax = xb.abs().amax(dim=-1)
    raw = _safe_div(absmax, tensor_scale * elem_max)
    grid = positive_format_values(scale_fmt)
    scale = round_to_values(raw, grid)
    smallest = float(grid[grid > 0][0])
    return torch.where((scale == 0) & (absmax > 0), torch.full_like(scale, smallest), scale)


def nvfp4_quantize(x: torch.Tensor, *, block_size: int = 16, scale_fmt: str = "e4m3", axis: int = -1,
                   tensor_scale: Optional[torch.Tensor] = None) -> BlockQuantized:
    """Eq. 1-3 on a float32 tensor: the quantized representation (not
    dequantized).  ``tensor_scale`` defaults to ``max|x| / (scale_grid_max *
    6)`` (1 when x is all zeros)."""
    xb = block_reshape(x, block_size, axis)
    scale_grid_max = float(positive_format_values(scale_fmt)[-1])
    if tensor_scale is None:
        tensor_scale = x.abs().amax() / _tensor_scale_divisor(scale_grid_max, x.device)
        tensor_scale = torch.where(tensor_scale == 0, torch.ones_like(tensor_scale), tensor_scale)
    d8 = _block_scales(xb, scale_fmt, FP4_MAX, tensor_scale)
    scaled = _safe_div(xb, (tensor_scale * d8)[..., None])
    q = round_to_values(scaled, np.unique(FP4_VALUES))
    return BlockQuantized(q=q, block_scale=d8, tensor_scale=tensor_scale, axis=axis)


def nvfp4_qdq(x: torch.Tensor, **kw) -> torch.Tensor:
    """Quantize-dequantize (fake-quant) convenience."""
    return nvfp4_quantize(x, **kw).dequantize()
