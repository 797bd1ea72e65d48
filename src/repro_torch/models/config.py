"""ArchConfig for the port's decoders (counterpart of
``repro.models.config``): the fields the dense GQA and MoE paths read."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # the port runs "dense" and "moe"
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

    # MoE
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    topk: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25

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
        kw = dict(num_layers=min(self.num_layers, 3), d_model=heads * hd, num_heads=heads,
                  num_kv_heads=kvh, head_dim=hd, d_ff=4 * heads * hd, vocab_size=256)
        if self.moe:
            # capacity_factor high enough that the reduced config never drops
            # a slot (drops depend on which tokens share a group, and would
            # break the serving invariants); full configs keep theirs
            kw.update(n_experts=4, topk=min(self.topk, 2), moe_d_ff=2 * heads * hd,
                      n_shared_experts=min(self.n_shared_experts, 1),
                      first_dense_layers=min(self.first_dense_layers, 1), capacity_factor=8.0)
        return replace(self, **kw)
