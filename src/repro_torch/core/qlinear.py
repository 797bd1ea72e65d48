"""Quantized linear layer (PyTorch port of ``repro.core.qlinear``).

A packed weight container dispatches to its format's matmul kernel, which
receives the activation spec when the policy quantizes activations (W4A4) and
fake-quantizes x itself (razer: inside the GEMM's x load at decode-sized M
on the card, else the activation kernel first).  A dense weight runs a plain
matmul, fake-quantized first under a ``fakequant`` weight spec.

On a serving mesh a packed weight may be this rank's K/tp shard
(``k_shards`` > 1, placed by ``parallel.sharding.shard_params``): then the
matmul runs on this rank's K slice and reduce-scatters the partial sums over
the tp group (``_tp_packed_matmul``), leaving N/tp columns per rank.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import registry
from .policy import QuantPolicy, TensorSpec, as_policy
from .razer import ACT_SPECIAL_VALUES, WEIGHT_SPECIAL_VALUES

__all__ = ["QuantConfig", "QuantizedLinear", "FakeQuantWeight", "qdq_weight", "qdq_activation", "qdq_spec",
           "qlinear", "is_kshard"]


@dataclass(frozen=True)
class QuantConfig:
    """The flat quantization config of the JAX package, a convenience
    constructor over the policy API: ``QuantConfig(...).to_policy()``."""

    mode: str = "bf16"  # bf16 | fakequant | packed
    weight_format: str = "razer"
    act_format: Optional[str] = None  # None = weight-only quantization
    weight_svs: Tuple[float, ...] = WEIGHT_SPECIAL_VALUES
    act_svs: Tuple[float, ...] = ACT_SPECIAL_VALUES
    block_size: int = 16
    weight_scale_fmt: str = "e3m3"  # §4.1: E3M3 for weights
    act_scale_fmt: str = "e4m3"  # §4.1: activations keep E4M3
    kv_format: Optional[str] = None  # e.g. 'razer' to quantize the KV cache
    ste: bool = False  # straight-through estimator (QAT)

    def to_policy(self) -> QuantPolicy:
        """The equivalent QuantPolicy, with the default dense rules."""
        weight = TensorSpec(format=self.weight_format, mode=self.mode, block_size=self.block_size,
                            scale_fmt=self.weight_scale_fmt, special_values=self.weight_svs, ste=self.ste)
        act = None
        if self.act_format is not None:
            act = TensorSpec(format=self.act_format, mode="fakequant", block_size=self.block_size,
                             scale_fmt=self.act_scale_fmt, special_values=self.act_svs, ste=self.ste)
        kv = TensorSpec.kv(self.kv_format) if self.kv_format is not None else None
        return QuantPolicy(weight=weight, act=act, kv=kv)

    @property
    def sv_magnitudes(self) -> Tuple[float, float]:
        """Wire-format pair magnitudes; 1 pair duplicates, >2 is an error."""
        return self.to_policy().weight.sv_magnitudes


@dataclass
class QuantizedLinear:
    """A linear layer's parameter bundle under a quantization policy: a
    dense weight (bf16 / fakequant) or its format's packed container, and
    an optional bias.  ``qlinear`` takes one in place of the weight."""

    w: object  # torch.Tensor | packed container (registry packed_type)
    b: Optional[torch.Tensor] = None

    @staticmethod
    def create(w: torch.Tensor, cfg, b: Optional[torch.Tensor] = None) -> "QuantizedLinear":
        spec = as_policy(cfg).weight
        if spec.quantizes and spec.mode == "packed":
            return QuantizedLinear(w=spec.pack(w.to(torch.float32)), b=b)
        return QuantizedLinear(w=w, b=b)


@dataclass
class FakeQuantWeight:
    """A slice of a dense weight fake-quantized whole under the policy's
    weight spec: ``qlinear`` multiplies by it as it is (and fake-quantizes
    x under W4A4, as for any fake-quantized weight)."""

    w: torch.Tensor


def qdq_weight(w: torch.Tensor, cfg) -> torch.Tensor:
    """Fake-quantize a (d_in, d_out) weight along the reduction dim (axis 0)
    under the weight spec of ``cfg`` (a QuantPolicy or a QuantConfig)."""
    return as_policy(cfg).weight.qdq(w, axis=0)


def qdq_spec(x: torch.Tensor, spec) -> torch.Tensor:
    """Dynamic activation fake-quant of x along the feature dim under the
    TensorSpec ``spec``, through its format's act kernel (per-block scale,
    no tensor scale)."""
    entry = spec.entry
    if entry.act_kernel is not None:
        return entry.act_kernel(x, spec)
    return spec.qdq(x, axis=-1)


def qdq_activation(x: torch.Tensor, policy: QuantPolicy) -> torch.Tensor:
    """``qdq_spec`` under the policy's activation spec.  With ``ste`` the
    gradient passes straight through: ``x + (qdq(x) - x).detach()``, the
    reference's ``stop_gradient`` expression, so the values are its bits and
    the fake-quant itself (K2 on the card, which has no backward) runs on a
    detached x."""
    spec = policy.act
    if spec is None:
        raise ValueError("qdq_activation called but the policy has no activation spec")
    if spec.ste:
        return x + (qdq_spec(x.detach(), spec) - x).detach()
    return qdq_spec(x, spec)


def is_kshard(w) -> bool:
    """Whether ``w`` is one rank's K/tp shard of a packed weight."""
    return getattr(w, "k_shards", 1) > 1


def _tp_packed_matmul(x: torch.Tensor, w, entry, b, *, sharded_in: bool, gather: bool, act=None):
    """The K-shard matmul of this rank: x's K slice (unless the caller
    already holds it, ``sharded_in``) against the local wire rows, the
    full-N partial reduce-scattered over the tp group into this rank's N/tp
    columns, all-gathered to the full width when ``gather``; ``act``, the
    W4A4 activation spec, fake-quantizes the slice.  Returns (y, the bias
    matching y's columns)."""
    from repro_torch.parallel.collectives import all_gather_last
    from repro_torch.parallel.sharding import get_ctx

    mesh = get_ctx()
    if mesh is None or mesh.tp != w.k_shards:
        raise ValueError(f"a K/{w.k_shards} weight shard runs only inside sharding_ctx of its "
                         f"tp={w.k_shards} mesh")
    if entry.kshard_matmul_kernel is None:
        raise TypeError(f"format {entry.name!r} shards packed weights but registered no kshard_matmul_kernel")
    kl = w.shape[0]
    if not sharded_in:
        j = mesh.model_index
        x = x[..., j * kl:(j + 1) * kl]
    y = entry.kshard_matmul_kernel(x, w, mesh.tp_group, act=act)
    if gather:
        return all_gather_last(y, mesh.tp_group), b
    nl = y.shape[-1]
    return y, None if b is None else b[mesh.model_index * nl:(mesh.model_index + 1) * nl]


def qlinear(x: torch.Tensor, w, policy: QuantPolicy, b: Optional[torch.Tensor] = None, *,
            sharded_in: bool = False, gather: bool = True) -> torch.Tensor:
    """y = quant(x) @ quant(W) + b under ``policy``; W is (d_in, d_out) or a
    packed container.

    For a K/tp weight shard: under W4A4 the activation fake-quant runs on
    this rank's K slice of x (its 16-element blocks never straddle a shard,
    so the bits are those of quantizing x whole); ``sharded_in`` says x
    already is this rank's K slice (a chain's second matmul, whose input is
    the first's N/tp tile); ``gather=False``
    returns this rank's N/tp columns, else they are all-gathered over the
    tp group to the full width.  A replicated weight ignores both.  ``w``
    may be a ``QuantizedLinear``, whose bias then takes the place of ``b``."""
    if isinstance(w, QuantizedLinear):
        w, b = w.w, w.b
    entry = registry.packed_entry(w)
    if entry is not None:
        if entry.matmul_kernel is None:
            raise TypeError(f"format {entry.name!r} has a packed container but no matmul_kernel")
        if is_kshard(w):
            y, b = _tp_packed_matmul(x, w, entry, b, sharded_in=sharded_in, gather=gather, act=policy.act)
        else:
            y = entry.matmul_kernel(x, w, act=policy.act)
    else:
        spec = policy.weight
        if isinstance(w, FakeQuantWeight):
            w = w.w
            if policy.act is not None:
                x = qdq_activation(x, policy)
        elif spec.quantizes and spec.mode == "fakequant":
            w = spec.qdq(w, axis=0)
            if policy.act is not None:
                x = qdq_activation(x, policy)
        y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y
