"""CodeQwen1.5-7B [dense]: 32L d_model=4096 32H (GQA kv=32 = MHA) d_ff=13440
vocab=92416, qwen1.5-arch (qkv bias). [hf:Qwen/CodeQwen1.5-7B; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,
    rope_theta=1e6,
)
