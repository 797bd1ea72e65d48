"""RaZeR-packed KV cache (paper App. C.1), PyTorch port of
``repro.serving.kvcache``.

Per (token, kv head) the head dim splits into 16-element blocks, each stored
as hd/2 code bytes (two FP4 codes per byte, low nibble first) and one meta
byte: the SV sign bit over a 7-bit E4M3 scale code, with the SV pair fixed at
+-5.  4.5 bits per value.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.formats import FP4_NEG_ZERO_CODE, device_constant, fp4_encode
from repro_torch.core.packing import pack_fp4_codes, pack_scale_meta, unpack_fp4_codes
from repro_torch.core.policy import TensorSpec
from repro_torch.models.config import ArchConfig

__all__ = ["KV_SV", "kv_quantize", "kv_dequantize", "quantized_gqa_cache_init", "quantized_kv_write",
           "quantized_kv_append", "quantized_kv_prefill"]

KV_SV = (5.0, -5.0)
KV_SPEC = TensorSpec.kv()

_FP4_MAG = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0], np.float32)
# all 128 7-bit E4M3 codes decoded arithmetically (bias 7, subnormals
# 2^-6 * m/8), code 127 included, as the JAX package's decoder reads them
_E4M3_BY_CODE = np.array([2.0**-6 * (c & 7) / 8 if c >> 3 == 0 else 2.0 ** ((c >> 3) - 7) * (1 + (c & 7) / 8)
                          for c in range(128)], np.float32)


def quantized_gqa_cache_init(cfg: ArchConfig, batch: int, max_len: int, device) -> Dict[str, torch.Tensor]:
    hd = cfg.hd
    if hd % 16:
        raise ValueError("quantized KV needs head_dim % 16 == 0")
    kvh = cfg.num_kv_heads
    z = lambda w: torch.zeros((batch, max_len, kvh, w), dtype=torch.uint8, device=device)
    return {"k_codes": z(hd // 2), "k_meta": z(hd // 16), "v_codes": z(hd // 2), "v_meta": z(hd // 16)}


def _check_kv_spec(spec: TensorSpec) -> TensorSpec:
    """The KV wire format is fixed: razer, E4M3 scales, 16-element blocks,
    the single +-5 pair."""
    if (spec.format != "razer" or spec.scale_fmt != "e4m3" or spec.block_size != 16
            or tuple(spec.special_values or ()) != KV_SV):
        raise ValueError(f"unsupported KV-cache spec {spec}; the packed KV wire format requires "
                         f"format='razer', scale_fmt='e4m3', block_size=16, special_values={KV_SV}")
    return spec


def kv_quantize(x: torch.Tensor, spec: Optional[TensorSpec] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., hd) -> (codes (..., hd//2), meta (..., hd//16)) uint8."""
    spec = _check_kv_spec(spec or KV_SPEC)
    one = device_constant(np.array(1.0, np.float32), x.device)
    bq = spec.quantize(x.to(torch.float32), axis=-1, tensor_scale=one)
    uses_sv = (bq.sv_index >= 0)[..., None] & (bq.q == bq.sv[..., None])
    codes = torch.where(uses_sv, torch.full_like(bq.q, FP4_NEG_ZERO_CODE, dtype=torch.uint8),
                        fp4_encode(bq.q))
    codes = pack_fp4_codes(codes.reshape(*x.shape))
    meta = pack_scale_meta(bq.block_scale, bq.sv_index, weight=False, scale_fmt=spec.scale_fmt)
    return codes, meta


def kv_dequantize(codes: torch.Tensor, meta: torch.Tensor, hd: int) -> torch.Tensor:
    """Inverse of ``kv_quantize`` -> (..., hd) float32."""
    dev = codes.device
    c = unpack_fp4_codes(codes).long()
    mag = device_constant(_FP4_MAG, dev)[c & 7]
    val = torch.where((c >> 3) == 1, -mag, mag)
    scale = device_constant(_E4M3_BY_CODE, dev)[(meta & 0x7F).long()]
    sv = torch.where((meta >> 7) == 1, -5.0, 5.0).to(torch.float32)
    lead = codes.shape[:-1]
    nblk = hd // 16
    valb = val.reshape(*lead, nblk, 16)
    valb = torch.where(c.reshape(*lead, nblk, 16) == FP4_NEG_ZERO_CODE, sv[..., None], valb)
    return (valb * scale[..., None]).reshape(*lead, hd)


def quantized_kv_write(cache: Dict[str, torch.Tensor], k_new: torch.Tensor, v_new: torch.Tensor,
                       cur_len: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Quantize one token's K/V (B, 1, KVH, hd) and write it at each
    sequence's position ``cur_len`` (B,), in place."""
    b = k_new.shape[0]
    rows = torch.arange(b, device=k_new.device)
    pos = torch.as_tensor(cur_len, device=k_new.device).reshape(-1).expand(b).long()
    kc, km = kv_quantize(k_new[:, 0])
    vc, vm = kv_quantize(v_new[:, 0])
    for name, val in (("k_codes", kc), ("k_meta", km), ("v_codes", vc), ("v_meta", vm)):
        cache[name][rows, pos] = val
    return cache


def quantized_kv_append(cache: Dict[str, torch.Tensor], k_new: torch.Tensor, v_new: torch.Tensor,
                        cur_len: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Write one token's K/V (B, 1, KVH, hd) at ``cur_len`` (B,) as
    ``quantized_kv_write`` does, then dequantize the whole caches -> (K, V
    in the new K/V's dtypes, the cache).  The windowed decode reads these
    through the plain ``decode_attention``, as the reference's does."""
    hd = k_new.shape[-1]
    cache = quantized_kv_write(cache, k_new, v_new, cur_len)
    k_full = kv_dequantize(cache["k_codes"], cache["k_meta"], hd)
    v_full = kv_dequantize(cache["v_codes"], cache["v_meta"], hd)
    return k_full.to(k_new.dtype), v_full.to(v_new.dtype), cache


def quantized_kv_prefill(cache: Dict[str, torch.Tensor], k: torch.Tensor, v: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Quantize a whole prefill's K/V (B, S, KVH, hd) and write it into
    positions [0, S) of every sequence, in place."""
    kc, km = kv_quantize(k)
    vc, vm = kv_quantize(v)
    s = k.shape[1]
    for name, val in (("k_codes", kc), ("k_meta", km), ("v_codes", vc), ("v_meta", vm)):
        cache[name][:, :s] = val.to(cache[name].dtype)
    return cache
