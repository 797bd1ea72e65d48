"""Qwen2-VL-7B [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
M-RoPE (t/h/w rotary sections); the vision frontend is a stub that takes
precomputed patch embeddings (the JAX package's ``configs/qwen2_vl_7b``)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,  # qwen2 keeps qkv bias
    mrope=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    frontend="vision",
)
