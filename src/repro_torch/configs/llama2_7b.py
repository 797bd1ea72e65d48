"""Llama-2-7B — from the paper's eval set (Table 3).  32L d_model=4096 MHA
32H d_ff=11008 vocab=32000."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama2-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=32000,
    rope_theta=1e4,
)
