"""Carry weights from the JAX package into the port, as numpy arrays.

The port never imports JAX: a caller that holds a JAX parameter tree first
turns it into nested dicts of numpy arrays (``jax.tree_util.tree_map(
np.asarray, tree)``) and hands that to ``params_from_numpy``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.packing import PackedRazerWeight, PackedStackedTensor
from repro_torch.device import resolve_device

__all__ = ["params_from_numpy", "packed_from_numpy", "packed_stacked_from_numpy"]


def _tensor(a, device) -> torch.Tensor:
    """numpy -> torch on ``device``; uint8 stays uint8, floats keep their width."""
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def params_from_numpy(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The JAX package's parameter tree -> the port's.

    Scan-stacked groups (``layers_<g>`` dicts of (L, ...) arrays) become
    lists of L per-layer dicts; every other leaf converts as it is."""
    device = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _tensor(t, device)

    def unstack(t, i):
        if isinstance(t, dict):
            return {k: unstack(v, i) for k, v in t.items()}
        return _tensor(np.asarray(t)[i], device)

    out: Dict[str, Any] = {}
    for key, sub in tree.items():
        if key.startswith("layers_") and isinstance(sub, dict):
            n = len(np.asarray(_first_leaf(sub)))
            out[key] = [unstack(sub, i) for i in range(n)]
        else:
            out[key] = conv(sub)
    return out


def _first_leaf(t):
    while isinstance(t, dict):
        t = next(iter(t.values()))
    return t


def packed_from_numpy(codes, scale_meta, tensor_scale, sv_magnitudes: Tuple[float, float],
                      shape: Tuple[int, int], device="cuda") -> PackedRazerWeight:
    """Wire arrays of a JAX ``PackedRazerWeight`` -> the port's container."""
    device = resolve_device(device)
    return PackedRazerWeight(
        codes=_tensor(codes, device),
        scale_meta=_tensor(scale_meta, device),
        tensor_scale=_tensor(np.asarray(tensor_scale, np.float32), device),
        sv_magnitudes=tuple(float(m) for m in sv_magnitudes),
        shape=tuple(int(s) for s in shape),
    )


def packed_stacked_from_numpy(codes, scale_meta, tensor_scale, sv_magnitudes: Tuple[float, float],
                              shape: Tuple[int, int, int], device="cuda") -> PackedStackedTensor:
    """Wire arrays of a JAX ``PackedStackedTensor`` (one expert bank) -> the
    port's container."""
    device = resolve_device(device)
    return PackedStackedTensor(
        codes=_tensor(codes, device),
        scale_meta=_tensor(scale_meta, device),
        tensor_scale=_tensor(np.asarray(tensor_scale, np.float32), device),
        sv_magnitudes=tuple(float(m) for m in sv_magnitudes),
        shape=tuple(int(s) for s in shape),
    )
