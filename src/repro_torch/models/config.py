"""ArchConfig for the port's models (counterpart of
``repro.models.config``): the fields the dense GQA, MoE, MLA, M-RoPE,
encoder-decoder, Mamba-2 (SSD) and RG-LRU hybrid paths read."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False  # qwen1.5 / qwen2 style
    qk_norm: bool = False  # qwen3
    use_rope: bool = True  # whisper: sinusoid embeddings instead
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # M-RoPE (qwen2-vl)
    mrope: bool = False
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)

    # MoE
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    topk: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25

    # MLA (deepseek-v2)
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # SSM (mamba2)
    ssm: bool = False
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    conv_kernel: int = 4

    # hybrid (recurrentgemma): per-layer types, 'r' = RG-LRU, 'a' = local attention
    block_pattern: Tuple[str, ...] = ()
    window: int = 0  # local attention window (0 = full)
    lru_width: Optional[int] = None

    # encoder-decoder (whisper)
    encoder_decoder: bool = False
    enc_layers: int = 0
    enc_frames: int = 1500
    act_fn: str = "swiglu"  # swiglu | gelu (whisper)

    # modality frontend stub
    frontend: str = "none"  # none | vision | audio

    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # which input shapes an arch takes (``configs.cells``)
    supports_decode: bool = True
    supports_long_context: bool = False  # sub-quadratic archs (ssm, hybrid)

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def layer_types(self) -> Tuple[str, ...]:
        """Per-layer block type: "a" attention, "r" RG-LRU, "s" Mamba-2."""
        if self.block_pattern:
            pat = self.block_pattern
            return tuple(pat[i % len(pat)] for i in range(self.num_layers))
        if self.ssm:
            return ("s",) * self.num_layers
        return ("a",) * self.num_layers

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests (the JAX package's sizes)."""
        hd = 16
        heads = max(2, min(4, self.num_heads))
        kvh = max(1, min(heads, self.num_kv_heads if self.num_kv_heads else heads))
        if kvh > 1 and heads % kvh:
            kvh = 1
        kw = dict(num_layers=min(self.num_layers, 3), d_model=heads * hd, num_heads=heads,
                  num_kv_heads=kvh, head_dim=hd, d_ff=4 * heads * hd, vocab_size=256)
        if self.mrope:
            kw.update(mrope_sections=(2, 3, 3))  # sums to hd // 2 = 8
        if self.moe:
            # capacity_factor high enough that the reduced config never drops
            # a slot (drops depend on which tokens share a group, and would
            # break the serving invariants); full configs keep theirs
            kw.update(n_experts=4, topk=min(self.topk, 2), moe_d_ff=2 * heads * hd,
                      n_shared_experts=min(self.n_shared_experts, 1),
                      first_dense_layers=min(self.first_dense_layers, 1), capacity_factor=8.0)
        if self.mla:
            kw.update(kv_lora_rank=32, q_lora_rank=0, qk_nope_dim=hd, qk_rope_dim=8, v_head_dim=hd)
        if self.ssm:
            kw.update(ssm_state=16, ssm_head_dim=8, ssm_chunk=8)
        if self.block_pattern:
            kw.update(window=8, lru_width=heads * hd)
        if self.encoder_decoder:
            kw.update(enc_layers=2, enc_frames=12)
        return replace(self, **kw)
