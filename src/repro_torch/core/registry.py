"""Quantization-format registry (PyTorch port of ``repro.core.registry``).

A format names its quantize function and, optionally, how a weight is packed
into a wire container, the matmul kernel that consumes that container and the
fused activation fake-quant kernel, and for stacked MoE banks the stacked
container and its grouped kernel.  ``qlinear`` dispatches a packed weight by
its container type, ``moe_forward`` a packed bank by its stacked type; under
W4A4 the matmul kernel receives the activation spec and fake-quantizes x
itself.  A format that can be split over a serving mesh names how a rank
takes its shard of a packed weight (``shard_packed_fn``, a K/tp shard) and
of a stacked bank (``shard_stacked_fn``, an E/ep x K/tp tile).  A format
may name its numerics audit (``audit_fn``, ``obs.numerics``); one that does
not is audited by ``obs.numerics.generic_audit``.  The port registers
``razer`` (packed, with kernels and its wire-byte audit) and ``nvfp4``
(quantize only: the default draft format of speculative serving).
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

__all__ = ["FormatEntry", "register_format", "unregister_format", "get_format", "format_names", "packed_entry",
           "grouped_entry", "spec_kwargs"]


@dataclass(frozen=True)
class FormatEntry:
    name: str
    quantize: Callable  # (x, axis=..., **kw) -> BlockQuantized-like
    pack_fn: Optional[Callable] = None  # (w, spec) -> packed container
    matmul_kernel: Optional[Callable] = None  # (x, packed, act=None) -> y; act: the W4A4 activation spec
    act_kernel: Optional[Callable] = None  # (x, spec) -> fake-quantized x
    packed_type: Optional[type] = None  # container class for type dispatch
    # stacked-bank (E, K, N) hooks: an MoE expert bank packs into ONE grouped
    # container that a grouped kernel consumes whole (moe_forward)
    pack_stacked_fn: Optional[Callable] = None  # (w, spec) -> stacked container
    grouped_matmul_kernel: Optional[Callable] = None  # (x (E, M, K), packed) -> y
    packed_stacked_type: Optional[type] = None  # stacked container class
    # mesh hooks (parallel/sharding.py): this rank's local container, and
    # the K-shard matmuls that consume it and reduce-scatter over the group
    shard_packed_fn: Optional[Callable] = None  # (packed, tp, tp_index) -> K/tp shard
    shard_stacked_fn: Optional[Callable] = None  # (bank, ep, ep_index, tp, tp_index) -> tile
    kshard_matmul_kernel: Optional[Callable] = None  # (x (.., K/tp), shard, group, act=None) -> (.., N/tp)
    kshard_grouped_matmul_kernel: Optional[Callable] = None  # (x (E, M, K/tp), tile, group) -> (E, M, N/tp)
    # numerics audit: fn(obj, ref, spec, axis=...) with ``obj`` the format's
    # packed container(s) or a raw weight and ``ref`` the reference weight
    # (or None) -> a JSON-able dict of code-usage / error / drift stats
    audit_fn: Optional[Callable] = None


_REGISTRY: Dict[str, FormatEntry] = {}


def register_format(name: str, quantize_fn: Callable, pack_fn=None, matmul_kernel=None,
                    act_kernel=None, *, packed_type=None, pack_stacked_fn=None,
                    grouped_matmul_kernel=None, packed_stacked_type=None, shard_packed_fn=None,
                    shard_stacked_fn=None, kshard_matmul_kernel=None,
                    kshard_grouped_matmul_kernel=None, audit_fn=None) -> FormatEntry:
    entry = FormatEntry(name=name, quantize=quantize_fn, pack_fn=pack_fn,
                        matmul_kernel=matmul_kernel, act_kernel=act_kernel, packed_type=packed_type,
                        pack_stacked_fn=pack_stacked_fn, grouped_matmul_kernel=grouped_matmul_kernel,
                        packed_stacked_type=packed_stacked_type, shard_packed_fn=shard_packed_fn,
                        shard_stacked_fn=shard_stacked_fn, kshard_matmul_kernel=kshard_matmul_kernel,
                        kshard_grouped_matmul_kernel=kshard_grouped_matmul_kernel, audit_fn=audit_fn)
    _REGISTRY[name] = entry
    return entry


def unregister_format(name: str) -> None:
    """Remove a format (tests register throwaway formats)."""
    _REGISTRY.pop(name, None)


def get_format(name: str) -> FormatEntry:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown quantization format {name!r}; registered: {sorted(_REGISTRY)}") from None


def format_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def packed_entry(obj) -> Optional[FormatEntry]:
    """The entry whose packed container type matches ``obj`` (or None)."""
    for entry in _REGISTRY.values():
        if entry.packed_type is not None and isinstance(obj, entry.packed_type):
            return entry
    return None


def grouped_entry(obj) -> Optional[FormatEntry]:
    """The entry whose STACKED container type matches ``obj`` (or None):
    how ``moe_forward`` routes an expert bank to its grouped kernel."""
    for entry in _REGISTRY.values():
        if entry.packed_stacked_type is not None and isinstance(obj, entry.packed_stacked_type):
            return entry
    return None


def spec_kwargs(entry: FormatEntry, spec) -> dict:
    """The keyword arguments ``entry.quantize`` receives for a TensorSpec:
    only those its signature names (nvfp4 takes no special values), as the
    JAX package forwards them."""
    params = inspect.signature(entry.quantize).parameters
    kw = {"block_size": spec.block_size}
    if "scale_fmt" in params and spec.scale_fmt is not None:
        kw["scale_fmt"] = spec.scale_fmt
    if "special_values" in params and spec.special_values is not None:
        kw["special_values"] = spec.special_values
    return kw


def _razer_pack(w, spec):
    from .packing import pack_weight

    return pack_weight(w, sv_magnitudes=spec.sv_magnitudes, block_size=spec.block_size)


def _razer_kernels_take(spec) -> bool:
    """Whether the razer activation kernels compute ``spec``'s fake-quant:
    a razer spec with E4M3 block scales, which they hardcode (on the card
    in 16-value blocks: ``kernels.ops`` checks the block).  Both the GEMM's
    hand-off (``_razer_act_svs``) and the act kernel route by it."""
    return spec.format == "razer" and spec.scale_fmt in (None, "e4m3")


def _razer_act_svs(x, act):
    """(x, special values, block) for the razer GEMM under activation spec
    ``act``: a spec the razer kernels take goes to the GEMM, which
    fake-quantizes x itself (fused into its load at decode-sized M); any
    other is applied here first, through its format's act kernel."""
    if act is None:
        return x, None, 16
    if _razer_kernels_take(act):
        return x, act.special_values, act.block_size
    entry = act.entry
    return (entry.act_kernel(x, act) if entry.act_kernel is not None else act.qdq(x, axis=-1)), None, 16


def _razer_matmul(x, pw, act=None):
    from repro_torch.kernels import ops

    x, svs, block = _razer_act_svs(x, act)
    return ops.razer_matmul(x, pw, act_svs=svs, act_block=block)


def _razer_pack_stacked(w, spec):
    from .packing import pack_stacked_weights

    return pack_stacked_weights(w, sv_magnitudes=spec.sv_magnitudes, block_size=spec.block_size)


def _razer_grouped_matmul(x, pst):
    from repro_torch.kernels import ops

    return ops.razer_grouped_matmul(x, pst)


def _razer_shard_packed(pw, tp: int, tp_index: int):
    """Rank ``tp_index``'s K/tp wire rows of a ``PackedRazerWeight``; the
    scalar tensor scale replicates."""
    from .packing import take_shard

    return take_shard(pw, tp=tp, tp_index=tp_index)


def _razer_shard_stacked(bank, ep: int, ep_index: int, tp: int = 1, tp_index: int = 0):
    """Rank (ep_index, tp_index)'s E/ep expert rows and K/tp wire rows of a
    ``PackedStackedTensor``; the per-expert tensor scales follow the
    expert rows."""
    from .packing import take_shard

    return take_shard(bank, ep=ep, ep_index=ep_index, tp=tp, tp_index=tp_index)


def _razer_kshard_matmul(x, pw, group, act=None):
    from repro_torch.kernels import ops

    x, svs, block = _razer_act_svs(x, act)
    return ops.razer_matmul_kshard(x, pw, group=group, act_svs=svs, act_block=block)


def _razer_kshard_grouped_matmul(x, pst, group):
    from repro_torch.kernels import ops

    return ops.razer_grouped_matmul_kshard(x, pst, group=group)


def _razer_audit(obj, ref, spec, axis: int = 0):
    # lazy: repro_torch.obs imports repro_torch.core
    from repro_torch.obs.numerics import razer_audit

    return razer_audit(obj, ref, spec, axis=axis)


def _razer_act_qdq(x, spec):
    if not _razer_kernels_take(spec):
        return spec.qdq(x, axis=-1)
    from repro_torch.kernels import ops

    return ops.razer_act_qdq(x, svs=spec.special_values, block=spec.block_size)


def _register_builtins() -> None:
    from .nvfp4 import nvfp4_quantize
    from .packing import PackedRazerWeight, PackedStackedTensor
    from .razer import razer_quantize

    register_format("nvfp4", nvfp4_quantize)
    register_format("razer", razer_quantize, pack_fn=_razer_pack, matmul_kernel=_razer_matmul,
                    act_kernel=_razer_act_qdq, packed_type=PackedRazerWeight,
                    pack_stacked_fn=_razer_pack_stacked, grouped_matmul_kernel=_razer_grouped_matmul,
                    packed_stacked_type=PackedStackedTensor, shard_packed_fn=_razer_shard_packed,
                    shard_stacked_fn=_razer_shard_stacked, kshard_matmul_kernel=_razer_kshard_matmul,
                    kshard_grouped_matmul_kernel=_razer_kshard_grouped_matmul, audit_fn=_razer_audit)


_register_builtins()
