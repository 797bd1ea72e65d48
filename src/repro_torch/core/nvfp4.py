"""NVFP4 block scaling (paper §3, Eq. 1-3), PyTorch port of ``repro.core.nvfp4``.

A tensor is blocked along one axis into groups of ``block_size``; each block
gets a scale on a positive ExMy grid and a float32 tensor-wide scale sits on
top.  Dequantization is ``q * block_scale * tensor_scale``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .formats import positive_format_values, round_to_values

__all__ = ["BlockQuantized", "block_reshape", "block_unreshape"]


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


def _block_scales(xb: torch.Tensor, scale_fmt: str, elem_max: float, tensor_scale) -> torch.Tensor:
    """Eq. 2: per-block scale rounded onto the positive scale grid; a nonzero
    block whose scale rounds to 0 gets the grid's smallest positive value."""
    absmax = xb.abs().amax(dim=-1)
    raw = _safe_div(absmax, tensor_scale * elem_max)
    grid = positive_format_values(scale_fmt)
    scale = round_to_values(raw, grid)
    smallest = float(grid[grid > 0][0])
    return torch.where((scale == 0) & (absmax > 0), torch.full_like(scale, smallest), scale)
