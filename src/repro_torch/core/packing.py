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

from dataclasses import dataclass, replace
from typing import Tuple, Union

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
    "unpack_scale_meta_fields",
    "PackedRazerWeight",
    "PackedStackedTensor",
    "pack_weight",
    "pack_stacked_weights",
    "take_shard",
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


def unpack_scale_meta_fields(byte: torch.Tensor, *, weight: bool = True):
    """byte -> (scale_code, sv_select, sv_sign), the raw bit fields.

    The numerics audit's read path (``obs.numerics``): the scale CODE for
    the clipping/underflow counts (code 0 is the grid minimum, the top code
    the grid maximum) and the SV select/sign bits for the per-block remap
    histogram.  Activation bytes have no select bit (a single pair): select
    is returned as 0."""
    if weight:
        meta = byte >> 6
        return byte & 0x3F, (meta >> 1) & 1, meta & 1
    return byte & 0x7F, torch.zeros_like(byte), byte >> 7


@dataclass
class PackedRazerWeight:
    """RaZeR-quantized weight W (K, N), blocked along K (the reduction dim).

    codes        : (K//2, N) uint8 -- two FP4 codes per byte along K
    scale_meta   : (K//16, N) uint8 -- E3M3 scale + 2-bit SV metadata
    tensor_scale : () float32
    sv_magnitudes: (m0, m1)
    shape        : logical (K, N)
    k_shards     : 1 for a whole weight; tp for one rank's K/tp shard of it
                   (``local_shard``), whose ``shape`` is then the local one
    """

    codes: torch.Tensor
    scale_meta: torch.Tensor
    tensor_scale: torch.Tensor
    sv_magnitudes: Tuple[float, float]
    shape: Tuple[int, int]
    k_shards: int = 1

    def local_shard(self, k_shards: int) -> "PackedRazerWeight":
        """Metadata for a K/k_shards tensor-parallel shard of this weight,
        whose leaves already hold the local wire rows: block scales live
        along K, so whole 16-element blocks of codes (K/tp/2, N) and
        scale_meta (K/tp/16, N) are themselves a valid wire tensor, and the
        per-tensor scale replicates.  Only ``shape`` and ``k_shards``
        change."""
        k, n = self.shape
        if k_shards <= 0 or k % (k_shards * 16):
            raise ValueError(
                f"cannot tensor-parallel-shard packed K={k} over tp={k_shards} "
                f"devices: K must be divisible by tp*quant_block = "
                f"{k_shards}*16 so every shard holds whole 16-element quant "
                f"blocks (see docs/parallelism.md)")
        return replace(self, shape=(k // k_shards, n), k_shards=k_shards)

    def dequantize(self) -> torch.Tensor:
        """(K, N) float32, tensor scale included."""
        k, n = self.shape
        codes = unpack_fp4_codes(self.codes.T).reshape(n, k)
        scale, sv = unpack_scale_meta(self.scale_meta.T, weight=True, sv_magnitudes=self.sv_magnitudes)
        vals = fp4_decode(codes.reshape(n, k // 16, 16), sv[..., None])
        w = vals * (scale * self.tensor_scale)[..., None]
        return w.reshape(n, k).T

    def to(self, device) -> "PackedRazerWeight":
        return replace(self, codes=self.codes.to(device), scale_meta=self.scale_meta.to(device),
                       tensor_scale=self.tensor_scale.to(device))


@dataclass
class PackedStackedTensor:
    """A stacked bank of E independent RaZeR-packed (K, N) weights: the MoE
    expert-bank container, consumed whole by the grouped matmul kernel.

    codes        : (E, K//2, N) uint8 -- two FP4 codes per byte along K
    scale_meta   : (E, K//16, N) uint8 -- E3M3 scale + 2-bit SV metadata
    tensor_scale : (E,) float32 -- each entry's own tensor scale
    sv_magnitudes: (m0, m1), shared by the bank
    shape        : logical (E, K, N)
    e_shards, k_shards: 1 for a whole bank; ep and tp for one rank's
                   (E/ep, K/tp) tile of it (``local_shard``), whose ``shape``
                   is then the local one
    """

    codes: torch.Tensor
    scale_meta: torch.Tensor
    tensor_scale: torch.Tensor
    sv_magnitudes: Tuple[float, float]
    shape: Tuple[int, int, int]
    e_shards: int = 1
    k_shards: int = 1

    def __getitem__(self, e: int) -> PackedRazerWeight:
        """Bank entry ``e`` as a plain 2-D packed weight."""
        _, k, n = self.shape
        return PackedRazerWeight(self.codes[e], self.scale_meta[e], self.tensor_scale[e],
                                 self.sv_magnitudes, (k, n), self.k_shards)

    def local_shard(self, n_shards: int, k_shards: int = 1) -> "PackedStackedTensor":
        """Metadata for an (E/n_shards, K/k_shards) tile of this bank, whose
        leaves already hold the local expert rows and wire rows: an expert
        split falls between packed (K, N) entries and a K split between
        whole 16-element blocks, so every local entry is a valid wire
        tensor.  Only ``shape``, ``e_shards`` and ``k_shards`` change."""
        e, k, n = self.shape
        if n_shards <= 0 or e % n_shards:
            raise ValueError(
                f"cannot split a packed bank of E={e} expert rows into "
                f"{n_shards} equal expert-parallel shards: E must be divisible "
                f"by the ep axis size")
        if k_shards <= 0 or k % (k_shards * 16):
            raise ValueError(
                f"cannot tensor-parallel-shard packed K={k} over tp={k_shards} "
                f"devices: K must be divisible by tp*quant_block = "
                f"{k_shards}*16 so every shard holds whole 16-element quant "
                f"blocks (see docs/parallelism.md)")
        return replace(self, shape=(e // n_shards, k // k_shards, n), e_shards=n_shards, k_shards=k_shards)

    def dequantize(self) -> torch.Tensor:
        """(E, K, N) float32, each entry's tensor scale included."""
        return torch.stack([self[e].dequantize() for e in range(self.shape[0])])

    def to(self, device) -> "PackedStackedTensor":
        return replace(self, codes=self.codes.to(device), scale_meta=self.scale_meta.to(device),
                       tensor_scale=self.tensor_scale.to(device))


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


def pack_stacked_weights(w: torch.Tensor, *, sv_magnitudes: Tuple[float, float] = (5.0, 8.0),
                         block_size: int = 16) -> PackedStackedTensor:
    """RaZeR-quantize a stacked (E, K, N) bank entry by entry and bit-pack it.

    Each entry is packed by ``pack_weight`` on its own (its own tensor
    scale), so ``pack_stacked_weights(w)[e]`` holds the bytes of
    ``pack_weight(w[e])``; one entry at a time also keeps the quantizer's
    temporaries to one (K, N) slice of the bank."""
    if w.ndim != 3:
        raise ValueError("pack_stacked_weights expects a 3-D (E, K, N) bank")
    e, k, n = w.shape
    parts = [pack_weight(w[i], sv_magnitudes=sv_magnitudes, block_size=block_size) for i in range(e)]
    return PackedStackedTensor(
        codes=torch.stack([p.codes for p in parts]),
        scale_meta=torch.stack([p.scale_meta for p in parts]),
        tensor_scale=torch.stack([p.tensor_scale for p in parts]).reshape(e),
        sv_magnitudes=tuple(float(m) for m in sv_magnitudes),
        shape=(e, k, n),
    )


def take_shard(c: Union[PackedRazerWeight, PackedStackedTensor], *, tp: int = 1, tp_index: int = 0,
               ep: int = 1, ep_index: int = 0):
    """Rank (ep_index, tp_index)'s tile of a whole container, as its own
    contiguous tensors: wire rows ``[j K/tp, (j + 1) K/tp)`` of codes and
    scale_meta (and, for a bank, expert rows ``[i E/ep, (i + 1) E/ep)`` of
    every leaf), the tensor scales as they are.  The bytes equal packing
    that sub-tensor directly under the whole tensor's tensor scale."""
    if c.k_shards != 1 or getattr(c, "e_shards", 1) != 1:
        raise ValueError("take_shard takes a whole container, not a shard of one")
    if isinstance(c, PackedStackedTensor):
        local = c.local_shard(ep, tp)  # validates both splits
        el, kl, _ = local.shape
        ex = slice(ep_index * el, (ep_index + 1) * el)
        return replace(local, codes=c.codes[ex, tp_index * kl // 2:(tp_index + 1) * kl // 2].contiguous(),
                       scale_meta=c.scale_meta[ex, tp_index * kl // 16:(tp_index + 1) * kl // 16].contiguous(),
                       tensor_scale=c.tensor_scale[ex].contiguous())
    local = c.local_shard(tp)
    kl = local.shape[0]
    return replace(local, codes=c.codes[tp_index * kl // 2:(tp_index + 1) * kl // 2].contiguous(),
                   scale_meta=c.scale_meta[tp_index * kl // 16:(tp_index + 1) * kl // 16].contiguous())
