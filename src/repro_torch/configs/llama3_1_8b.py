"""Llama-3.1-8B — from the paper's own eval set (Tables 1-5, kernel
microbenchmarks).  32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama3.1-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=5e5,
)
