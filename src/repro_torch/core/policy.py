"""Quantization policy (PyTorch port of ``repro.core.policy``).

``TensorSpec`` says how one tensor role (weights, activations, KV cache) is
quantized; ``LayerRule`` maps param-tree paths (fnmatch globs, or regexes with
a ``re:`` prefix) to a spec or to dense; ``QuantPolicy`` bundles the role
specs with an ordered rule list where the first match wins.
"""
from __future__ import annotations

import fnmatch
import re
from dataclasses import dataclass, field, replace
from typing import Any, Optional, Sequence, Tuple

import torch

from . import registry
from .razer import ACT_SPECIAL_VALUES, WEIGHT_SPECIAL_VALUES

__all__ = ["TensorSpec", "LayerRule", "QuantPolicy", "DEFAULT_DENSE_RULES", "BF16", "as_policy", "tree_paths"]

_MODES = ("bf16", "fakequant", "packed")


@dataclass(frozen=True)
class TensorSpec:
    format: Optional[str] = "razer"
    mode: str = "fakequant"  # bf16 | fakequant | packed
    block_size: int = 16
    scale_fmt: Optional[str] = "e3m3"
    special_values: Optional[Tuple[float, ...]] = WEIGHT_SPECIAL_VALUES
    # straight-through estimator (QAT): an activation spec passes the
    # gradient around its fake-quant (``qlinear.qdq_activation``); a weight
    # spec carries the flag as the reference does, whose weight qdq has no
    # STE (ROADMAP caveat 10)
    ste: bool = False
    # the tensor is a stacked bank of independent (K, N) matrices (a leading
    # E dim: MoE expert weights); packed mode packs it into the format's
    # stacked container, one operand of the grouped matmul kernel
    stacked: bool = False

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"mode {self.mode!r} not in {_MODES}")
        if self.special_values is not None:
            object.__setattr__(self, "special_values", tuple(float(v) for v in self.special_values))

    @classmethod
    def weight(cls, format: str = "razer", mode: str = "fakequant", **kw) -> "TensorSpec":
        """Weight role: E3M3 scales, |V|=4 SV set (§4.1/§4.2)."""
        kw.setdefault("scale_fmt", "e3m3")
        kw.setdefault("special_values", WEIGHT_SPECIAL_VALUES)
        return cls(format=format, mode=mode, **kw)

    @classmethod
    def act(cls, format: str = "razer", **kw) -> "TensorSpec":
        """Activation role: E4M3 scales, |V|=2 SV set, always dynamic."""
        kw.setdefault("scale_fmt", "e4m3")
        kw.setdefault("special_values", ACT_SPECIAL_VALUES)
        return cls(format=format, mode="fakequant", **kw)

    @classmethod
    def kv(cls, format: str = "razer", **kw) -> "TensorSpec":
        """KV-cache role (App. C.1): the activation-style wire format."""
        kw.setdefault("scale_fmt", "e4m3")
        kw.setdefault("special_values", ACT_SPECIAL_VALUES)
        return cls(format=format, mode="packed", **kw)

    @classmethod
    def dense(cls) -> "TensorSpec":
        return cls(format=None, mode="bf16", scale_fmt=None, special_values=None)

    @property
    def quantizes(self) -> bool:
        return self.format is not None and self.mode in ("fakequant", "packed")

    @property
    def entry(self) -> registry.FormatEntry:
        if self.format is None:
            raise ValueError("dense TensorSpec has no format entry")
        return registry.get_format(self.format)

    @property
    def effective_block_size(self) -> int:
        """The block size the quantize fn uses: the spec's, floored at the
        format's minimum (OCP MXFP4 blocks are >= 32)."""
        return max(self.block_size, self.entry.min_block_size)

    @property
    def sv_magnitudes(self) -> Tuple[float, float]:
        """The (m0, m1) magnitudes the packed wire format encodes; one pair
        is duplicated, more than two pairs do not fit the 2 meta bits."""
        mags = sorted({abs(float(v)) for v in (self.special_values or ())})
        if not mags:
            raise ValueError("TensorSpec has no special values to derive sv_magnitudes from")
        if len(mags) == 1:
            return (mags[0], mags[0])
        if len(mags) == 2:
            return (mags[0], mags[1])
        raise ValueError(f"the packed wire format encodes at most 2 SV pairs; got {tuple(mags)}")

    def quantize(self, x: torch.Tensor, axis: int = -1, **kw):
        entry = self.entry
        merged = registry.spec_kwargs(entry, self)
        merged.update(kw)
        return entry.quantize(x, axis=axis, **merged)

    def qdq(self, x: torch.Tensor, axis: int = -1) -> torch.Tensor:
        """Quantize-dequantize, preserving dtype."""
        return self.quantize(x.to(torch.float32), axis=axis).dequantize().to(x.dtype)

    def pack(self, w: torch.Tensor):
        entry = self.entry
        if entry.pack_fn is None:
            raise ValueError(f"format {self.format!r} has no pack_fn registered")
        return entry.pack_fn(w, self)

    def pack_stacked(self, w: torch.Tensor):
        """Bit-pack a stacked (E, K, N) bank into the format's grouped
        container."""
        entry = self.entry
        if entry.pack_stacked_fn is None:
            raise ValueError(f"format {self.format!r} has no pack_stacked_fn registered")
        return entry.pack_stacked_fn(w, self)


@dataclass(frozen=True)
class LayerRule:
    """``pattern`` -> ``spec`` (None keeps the matched tensors dense), or
    ``overrides``: fields replaced in the policy's weight spec.

    ``pattern`` is a glob matched against the '/'-joined param path, or a
    regex searched in it when prefixed with ``re:``."""

    pattern: str
    spec: Optional[TensorSpec] = None
    overrides: Tuple[Tuple[str, Any], ...] = ()

    @staticmethod
    def dense(pattern: str) -> "LayerRule":
        return LayerRule(pattern)

    @staticmethod
    def override(pattern: str, **fields) -> "LayerRule":
        norm = tuple((k, tuple(v) if isinstance(v, (list, tuple)) else v) for k, v in sorted(fields.items()))
        return LayerRule(pattern, overrides=norm)

    def resolve(self, base: Optional[TensorSpec]) -> Optional[TensorSpec]:
        if self.overrides:
            src = self.spec if self.spec is not None else base
            if src is None:
                raise ValueError(f"rule {self.pattern!r} overrides fields but there is no base spec")
            return replace(src, **dict(self.overrides))
        return self.spec

    def matches(self, path: str) -> bool:
        if self.pattern.startswith("re:"):
            return re.search(self.pattern[3:], path) is not None
        return fnmatch.fnmatchcase(path, self.pattern)


# Embeddings, lm_head, router, norms, biases and SSM parameters stay high
# precision; the patterns are the JAX package's, so paths resolve alike.
# Stacked (E, d, f) MoE expert banks quantize like any weight but carry the
# ``stacked`` marker: packed mode packs the whole bank into the format's
# stacked container, which ``moe_forward`` sends to the grouped kernel.
DEFAULT_DENSE_RULES: Tuple[LayerRule, ...] = (
    LayerRule.dense("*embed*"),
    LayerRule.dense("*lm_head*"),
    LayerRule.dense("*router*"),
    LayerRule.dense("*norm*"),
    LayerRule.dense("*ln*"),
    LayerRule.dense("*conv*"),
    LayerRule.override("*experts*", stacked=True),
    LayerRule.dense("re:(^|/)a_param$"),
    LayerRule.dense("re:(^|/)A_log$"),
    LayerRule.dense("re:(^|/)D$"),
    LayerRule.dense("re:(^|/)dt_bias$"),
    LayerRule.dense("re:(^|/)b[qkv]?$"),
    LayerRule.dense("re:(^|/)\\w*_b$"),
)


@dataclass(frozen=True)
class QuantPolicy:
    weight: TensorSpec = field(default_factory=TensorSpec.dense)
    act: Optional[TensorSpec] = None
    kv: Optional[TensorSpec] = None
    rules: Tuple[LayerRule, ...] = DEFAULT_DENSE_RULES

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))

    @classmethod
    def bf16(cls) -> "QuantPolicy":
        return cls()

    @classmethod
    def fakequant(cls, weight_format: str = "razer", act_format: Optional[str] = None, *,
                  weight_scale_fmt: str = "e3m3", act_scale_fmt: str = "e4m3",
                  weight_svs: Sequence[float] = WEIGHT_SPECIAL_VALUES,
                  act_svs: Sequence[float] = ACT_SPECIAL_VALUES, block_size: int = 16, ste: bool = False,
                  rules: Tuple[LayerRule, ...] = DEFAULT_DENSE_RULES) -> "QuantPolicy":
        """Accuracy-experiment policy: dense weights quantize-dequantized at
        every forward (and activations, with ``act_format``); ``ste`` marks
        both specs for QAT."""
        act = None
        if act_format is not None:
            act = TensorSpec.act(act_format, scale_fmt=act_scale_fmt, special_values=tuple(act_svs),
                                 block_size=block_size, ste=ste)
        return cls(
            weight=TensorSpec.weight(weight_format, mode="fakequant", scale_fmt=weight_scale_fmt,
                                     special_values=tuple(weight_svs), block_size=block_size, ste=ste),
            act=act,
            rules=rules,
        )

    @classmethod
    def packed(cls, format: str = "razer", *, weight_svs: Sequence[float] = WEIGHT_SPECIAL_VALUES,
               block_size: int = 16, kv_quant: bool = False,
               rules: Tuple[LayerRule, ...] = DEFAULT_DENSE_RULES) -> "QuantPolicy":
        """Deployment policy: 4.5-bit wire-format weights (+ optional KV)."""
        return cls(
            weight=TensorSpec.weight(format, mode="packed", special_values=tuple(weight_svs),
                                     block_size=block_size),
            kv=TensorSpec.kv(format) if kv_quant else None,
            rules=rules,
        )

    def with_rules(self, *rules: LayerRule, prepend: bool = True) -> "QuantPolicy":
        """A copy with extra rules (prepended by default: first match wins)."""
        return replace(self, rules=tuple(rules) + self.rules if prepend else self.rules + tuple(rules))

    def resolve(self, path: str) -> Optional[TensorSpec]:
        """The weight spec for a param-tree path (None: keep dense)."""
        spec: Optional[TensorSpec] = self.weight
        for rule in self.rules:
            if rule.matches(path):
                spec = rule.resolve(self.weight)
                break
        if spec is None or not spec.quantizes:
            return None
        return spec

    @property
    def mode(self) -> str:
        w = self.weight
        return "bf16" if (w is None or w.format is None) else w.mode

    @property
    def ste(self) -> bool:
        return bool(self.weight.ste or (self.act is not None and self.act.ste))


BF16 = QuantPolicy.bf16()


def as_policy(q) -> QuantPolicy:
    """Any quant argument -- a QuantPolicy, a flat ``QuantConfig`` (through
    its ``to_policy()``) or None (bf16) -- as a QuantPolicy."""
    if q is None:
        return BF16
    if isinstance(q, QuantPolicy):
        return q
    to_policy = getattr(q, "to_policy", None)
    if callable(to_policy):
        return to_policy()
    raise TypeError(f"cannot interpret {type(q).__name__} as a QuantPolicy")


def tree_paths(tree, sep: str = "/"):
    """(path, leaf) pairs of a nested-dict param tree, '/'-joined: the path
    vocabulary LayerRules match against."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            for p, leaf in tree_paths(v, sep):
                yield (f"{k}{sep}{p}" if p else str(k)), leaf
    else:
        yield "", tree
