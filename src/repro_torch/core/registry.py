"""Quantization-format registry (PyTorch port of ``repro.core.registry``).

A format names its quantize function and, optionally, how a weight is packed
into a wire container, the matmul kernel that consumes that container and the
fused activation fake-quant kernel.  ``qlinear`` dispatches a packed weight by
its container type.  This slice registers the ``razer`` format only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

__all__ = ["FormatEntry", "register_format", "get_format", "packed_entry", "spec_kwargs"]


@dataclass(frozen=True)
class FormatEntry:
    name: str
    quantize: Callable  # (x, axis=..., **kw) -> BlockQuantized-like
    pack_fn: Optional[Callable] = None  # (w, spec) -> packed container
    matmul_kernel: Optional[Callable] = None  # (x, packed) -> y
    act_kernel: Optional[Callable] = None  # (x, spec) -> fake-quantized x
    packed_type: Optional[type] = None  # container class for type dispatch


_REGISTRY: Dict[str, FormatEntry] = {}


def register_format(name: str, quantize_fn: Callable, pack_fn=None, matmul_kernel=None,
                    act_kernel=None, *, packed_type=None) -> FormatEntry:
    entry = FormatEntry(name=name, quantize=quantize_fn, pack_fn=pack_fn,
                        matmul_kernel=matmul_kernel, act_kernel=act_kernel, packed_type=packed_type)
    _REGISTRY[name] = entry
    return entry


def get_format(name: str) -> FormatEntry:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown quantization format {name!r}; registered: {sorted(_REGISTRY)}") from None


def packed_entry(obj) -> Optional[FormatEntry]:
    """The entry whose packed container type matches ``obj`` (or None)."""
    for entry in _REGISTRY.values():
        if entry.packed_type is not None and isinstance(obj, entry.packed_type):
            return entry
    return None


def spec_kwargs(spec) -> dict:
    """The keyword arguments a format's quantize function receives for a
    TensorSpec (the razer quantizer takes all three)."""
    kw = {"block_size": spec.block_size}
    if spec.scale_fmt is not None:
        kw["scale_fmt"] = spec.scale_fmt
    if spec.special_values is not None:
        kw["special_values"] = spec.special_values
    return kw


def _razer_pack(w, spec):
    from .packing import pack_weight

    return pack_weight(w, sv_magnitudes=spec.sv_magnitudes, block_size=spec.block_size)


def _razer_matmul(x, pw):
    from repro_torch.kernels import ops

    return ops.razer_matmul(x, pw)


def _razer_act_qdq(x, spec):
    if spec.scale_fmt not in (None, "e4m3"):
        # the fused act kernel hardcodes the E4M3 block scale
        return spec.qdq(x, axis=-1)
    from repro_torch.kernels import ops

    return ops.razer_act_qdq(x, svs=spec.special_values, block=spec.block_size)


def _register_builtins() -> None:
    from .packing import PackedRazerWeight
    from .razer import razer_quantize

    register_format("razer", razer_quantize, pack_fn=_razer_pack, matmul_kernel=_razer_matmul,
                    act_kernel=_razer_act_qdq, packed_type=PackedRazerWeight)


_register_builtins()
