"""Bit-level packing for RaZeR tensors (paper §4.1), PyTorch port of
``repro.core.packing``.

Wire format of one 16-element block:
  * 16 FP4 codes, two per byte, the low nibble holding the even element;
  * one byte ``meta(2b) << 6 | E3M3 scale code`` for weights, where
    meta = select << 1 | sign picks +-m0 or +-m1, or ``sign << 7 | E4M3 code``
    for activations and the KV cache (the single +-5 pair).
16 * 4 + 8 = 72 bits per block, 4.5 bits per value.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .formats import (FP4_NEG_ZERO_CODE, device_constant, fp4_decode, fp4_encode, grid_midpoints,
                      positive_format_values)
from .razer import razer_quantize, sv_pairs_to_set

__all__ = [
    "pack_fp4_codes",
    "unpack_fp4_codes",
    "pack_scale_meta",
    "unpack_scale_meta",
    "PackedRazerWeight",
    "pack_weight",
]


def pack_fp4_codes(codes: torch.Tensor) -> torch.Tensor:
    """(..., K) uint8 nibbles -> (..., K//2) bytes. Low nibble = even index."""
    if codes.shape[-1] % 2:
        raise ValueError("K must be even to pack nibbles")
    lo = codes[..., 0::2].to(torch.uint8)
    hi = codes[..., 1::2].to(torch.uint8)
    return lo | (hi << 4)


def unpack_fp4_codes(packed: torch.Tensor) -> torch.Tensor:
    """(..., K//2) bytes -> (..., K) uint8 nibbles."""
    lo = packed & 0xF
    hi = packed >> 4
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def _scale_code(scale: torch.Tensor, fmt: str) -> torch.Tensor:
    mids = device_constant(grid_midpoints(positive_format_values(fmt)), scale.device)
    return torch.searchsorted(mids, scale.contiguous(), right=False).to(torch.uint8)


def pack_scale_meta(scale, sv_index, *, weight: bool = True, scale_fmt: str | None = None):
    """(scale values on the grid, sv_index in [-1, nsv)) -> one byte per block.

    sv_index follows (+m0, -m0, +m1, -m1): select = idx >> 1, sign = idx & 1.
    Blocks without an SV (-1) carry meta 0."""
    fmt = scale_fmt or ("e3m3" if weight else "e4m3")
    code = _scale_code(scale, fmt)
    idx = sv_index.clamp(min=0).to(torch.uint8)
    if weight:
        if fmt != "e3m3":
            raise ValueError("weight scale + 2-bit meta needs the 6-bit E3M3 scale format")
        return ((idx & 0b11) << 6) | code
    if fmt != "e4m3":
        raise ValueError("activation scale + 1-bit meta needs the 7-bit E4M3 scale format")
    return ((idx & 0b1) << 7) | code


def unpack_scale_meta(byte: torch.Tensor, *, weight: bool = True,
                      sv_magnitudes: Tuple[float, ...] = (5.0, 8.0)):
    """byte -> (scale value f32, special value f32)."""
    dev = byte.device
    if weight:
        scale = device_constant(positive_format_values("e3m3"), dev)[(byte & 0x3F).long()]
        meta = byte >> 6
        mags = device_constant(np.array(sv_magnitudes, np.float32), dev)
        sv = mags[((meta >> 1) & 1).long()] * torch.where((meta & 1) == 1, -1.0, 1.0)
    else:
        scale = device_constant(positive_format_values("e4m3"), dev)[(byte & 0x7F).long()]
        sv = sv_magnitudes[0] * torch.where((byte >> 7) == 1, -1.0, 1.0)
    return scale, sv.to(torch.float32)


@dataclass
class PackedRazerWeight:
    """RaZeR-quantized weight W (K, N), blocked along K (the reduction dim).

    codes        : (K//2, N) uint8 -- two FP4 codes per byte along K
    scale_meta   : (K//16, N) uint8 -- E3M3 scale + 2-bit SV metadata
    tensor_scale : () float32
    sv_magnitudes: (m0, m1)
    shape        : logical (K, N)
    """

    codes: torch.Tensor
    scale_meta: torch.Tensor
    tensor_scale: torch.Tensor
    sv_magnitudes: Tuple[float, float]
    shape: Tuple[int, int]

    def dequantize(self) -> torch.Tensor:
        """(K, N) float32, tensor scale included."""
        k, n = self.shape
        codes = unpack_fp4_codes(self.codes.T).reshape(n, k)
        scale, sv = unpack_scale_meta(self.scale_meta.T, weight=True, sv_magnitudes=self.sv_magnitudes)
        vals = fp4_decode(codes.reshape(n, k // 16, 16), sv[..., None])
        w = vals * (scale * self.tensor_scale)[..., None]
        return w.reshape(n, k).T

    def to(self, device) -> "PackedRazerWeight":
        return PackedRazerWeight(self.codes.to(device), self.scale_meta.to(device),
                                 self.tensor_scale.to(device), self.sv_magnitudes, self.shape)


def pack_weight(w: torch.Tensor, *, sv_magnitudes: Tuple[float, float] = (5.0, 8.0),
                block_size: int = 16) -> PackedRazerWeight:
    """RaZeR-quantize a float32 (K, N) weight along K and bit-pack it."""
    if w.ndim != 2:
        raise ValueError("pack_weight expects a 2-D (K, N) weight")
    k, n = w.shape
    svs = sv_pairs_to_set(*sv_magnitudes)
    bq = razer_quantize(w.to(torch.float32), special_values=svs, block_size=block_size,
                        scale_fmt="e3m3", axis=0)
    q = bq.q  # (N, K//B, B)
    uses_sv = (bq.sv_index >= 0)[..., None] & (q == bq.sv[..., None])
    codes = torch.where(uses_sv, torch.full_like(q, FP4_NEG_ZERO_CODE, dtype=torch.uint8),
                        fp4_encode(q))
    packed = pack_fp4_codes(codes.reshape(n, k)).T.contiguous()  # (K//2, N)
    scale_meta = pack_scale_meta(bq.block_scale, bq.sv_index, weight=True).T.contiguous()
    return PackedRazerWeight(
        codes=packed,
        scale_meta=scale_meta,
        tensor_scale=bq.tensor_scale.to(torch.float32),
        sv_magnitudes=tuple(float(m) for m in sv_magnitudes),
        shape=(k, n),
    )

