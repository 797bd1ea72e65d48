"""ArchConfig for the port's dense decoder (counterpart of
``repro.models.config``): the fields the dense GQA path reads."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # this slice runs "dense"
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False  # qwen1.5 / qwen2 style
    qk_norm: bool = False  # qwen3
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests (the JAX package's sizes)."""
        hd = 16
        heads = max(2, min(4, self.num_heads))
        kvh = max(1, min(heads, self.num_kv_heads if self.num_kv_heads else heads))
        if kvh > 1 and heads % kvh:
            kvh = 1
        return replace(self, num_layers=min(self.num_layers, 3), d_model=heads * hd,
                       num_heads=heads, num_kv_heads=kvh, head_dim=hd, d_ff=4 * heads * hd,
                       vocab_size=256)
