"""DeepSeek-Coder-33B [dense]: 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256, llama-arch. [arXiv:2401.14196; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    rope_theta=1e5,
)
