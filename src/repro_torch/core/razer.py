"""RaZeR: Redundant Zero Remapping (paper §4, Eq. 6-7), PyTorch port of
``repro.core.razer``.

Each block's redundant FP4 -0 code is remapped to the special value (SV) from
a small allowed set that minimizes the block's squared error.  Candidates are
tried in the set's order against the plain FP4 rounding, and only a strictly
smaller block SSE takes one.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .formats import FP4_MAX, FP4_VALUES, positive_format_values, round_to_values
from .nvfp4 import BlockQuantized, _block_scales, _safe_div, _tensor_scale_divisor, block_reshape

__all__ = [
    "WEIGHT_SPECIAL_VALUES",
    "ACT_SPECIAL_VALUES",
    "FP4_GRID",
    "grid_with_sv",
    "block_sse",
    "razer_quantize",
    "sv_pairs_to_set",
]

WEIGHT_SPECIAL_VALUES: Tuple[float, ...] = (5.0, -5.0, 8.0, -8.0)
ACT_SPECIAL_VALUES: Tuple[float, ...] = (5.0, -5.0)

FP4_GRID = np.unique(FP4_VALUES)  # the 15 signed FP4 values


def sv_pairs_to_set(*magnitudes: float) -> Tuple[float, ...]:
    """(5, 8) -> (5, -5, 8, -8): SVs always come in additive-inverse pairs."""
    out = []
    for m in magnitudes:
        out += [float(m), float(-m)]
    return tuple(out)


@functools.lru_cache(maxsize=None)
def grid_with_sv(v: float) -> np.ndarray:
    """The FP4 grid with special value ``v`` added (sorted, float32)."""
    if float(v) in set(float(g) for g in FP4_GRID):
        raise ValueError(f"special value {v} collides with the FP4 grid")
    if abs(v) * 2 != int(abs(v) * 2):
        raise ValueError(f"special value {v} must be a multiple of 0.5 (§4.2)")
    return np.unique(np.concatenate([FP4_GRID, [np.float32(v)]]))


def block_sse(q: torch.Tensor, scaled: torch.Tensor) -> torch.Tensor:
    """Sum of squared errors over the last (block) dim, added left to right.

    The order is fixed so that the activation kernel's CUDA twin
    (``csrc/razer_quantize.cu``) reproduces every sum bit for bit."""
    d = q - scaled
    sq = d * d
    err = sq[..., 0]
    for i in range(1, sq.shape[-1]):
        err = err + sq[..., i]
    return err


def razer_quantize(
    x: torch.Tensor,
    *,
    special_values: Sequence[float] = WEIGHT_SPECIAL_VALUES,
    block_size: int = 16,
    scale_fmt: str = "e3m3",
    axis: int = -1,
    tensor_scale: Optional[torch.Tensor] = None,
) -> BlockQuantized:
    """Eq. 6-7 on top of the NVFP4 scaling pipeline; ``x`` is float32.

    ``tensor_scale`` defaults to ``max|x| / (scale_grid_max * 6)`` (1 when x
    is all zeros)."""
    svs = tuple(float(v) for v in special_values)
    xb = block_reshape(x, block_size, axis)
    scale_grid_max = float(positive_format_values(scale_fmt)[-1])
    if tensor_scale is None:
        tensor_scale = x.abs().amax() / _tensor_scale_divisor(scale_grid_max, x.device)
        tensor_scale = torch.where(tensor_scale == 0, torch.ones_like(tensor_scale), tensor_scale)
    d8 = _block_scales(xb, scale_fmt, FP4_MAX, tensor_scale)
    scaled = _safe_div(xb, (tensor_scale * d8)[..., None])

    best_q = round_to_values(scaled, FP4_GRID)
    best_err = block_sse(best_q, scaled)
    best_idx = torch.full(best_err.shape, -1, dtype=torch.int32, device=x.device)
    best_sv = torch.zeros_like(best_err)
    for i, v in enumerate(svs):
        q_v = round_to_values(scaled, grid_with_sv(v))
        err_v = block_sse(q_v, scaled)
        take = err_v < best_err
        best_q = torch.where(take[..., None], q_v, best_q)
        best_err = torch.where(take, err_v, best_err)
        best_idx = torch.where(take, torch.full_like(best_idx, i), best_idx)
        best_sv = torch.where(take, torch.full_like(best_sv, v), best_sv)
    return BlockQuantized(
        q=best_q, block_scale=d8, tensor_scale=tensor_scale, axis=axis,
        sv=best_sv, sv_index=best_idx,
    )
