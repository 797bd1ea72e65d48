"""DBRX-132B [moe]: 40L d_model=6144 48H (GQA kv=8) MoE 16 experts top-4
(fine-grained), expert d_ff=10752, vocab=100352 (the JAX package's
``configs/dbrx_132b``)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    moe=True,
    n_experts=16,
    topk=4,
    moe_d_ff=10752,
    rope_theta=5e5,
)
