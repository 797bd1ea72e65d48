"""RecurrentGemma-2B [hybrid]: 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000, RG-LRU + local attention pattern (r,r,a), window 2048
(the JAX package's ``configs/recurrentgemma_2b``)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("r", "r", "a"),
    window=2048,
    lru_width=2560,
    rope_theta=1e4,
    tie_embeddings=True,
    supports_long_context=True,
)
