"""Quantized linear layer (PyTorch port of ``repro.core.qlinear``).

A packed weight container dispatches to its format's matmul kernel, after the
activation fake-quant kernel when the policy quantizes activations (W4A4).  A
dense weight runs a plain matmul, fake-quantized first under a ``fakequant``
weight spec.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import registry
from .policy import QuantPolicy

__all__ = ["qdq_activation", "qlinear"]


def qdq_activation(x: torch.Tensor, policy: QuantPolicy) -> torch.Tensor:
    """Dynamic activation fake-quant along the feature dim, through the
    format's act kernel (per-block scale, no tensor scale)."""
    spec = policy.act
    if spec is None:
        raise ValueError("qdq_activation called but the policy has no activation spec")
    entry = spec.entry
    if entry.act_kernel is not None:
        return entry.act_kernel(x, spec)
    return spec.qdq(x, axis=-1)


def qlinear(x: torch.Tensor, w, policy: QuantPolicy, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = quant(x) @ quant(W) + b under ``policy``; W is (d_in, d_out) or a
    packed container."""
    entry = registry.packed_entry(w)
    if entry is not None:
        if entry.matmul_kernel is None:
            raise TypeError(f"format {entry.name!r} has a packed container but no matmul_kernel")
        if policy.act is not None:
            x = qdq_activation(x, policy)
        y = entry.matmul_kernel(x, w)
    else:
        spec = policy.weight
        if spec.quantizes and spec.mode == "fakequant":
            w = spec.qdq(w, axis=0)
            if policy.act is not None:
                x = qdq_activation(x, policy)
        y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y

