"""DeepSeek-V2-236B [moe]: 60L d_model=5120 128H MLA (kv_lora=512),
MoE: 2 shared + 160 routed experts top-6, expert d_ff=1536; first layer dense
(d_ff=12288) (the JAX package's ``configs/deepseek_v2_236b``)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,   # MLA: per-head KV reconstructed from the 512-d latent
    d_ff=12288,         # dense (first) layer
    vocab_size=102400,
    mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    moe=True,
    n_experts=160,
    n_shared_experts=2,
    topk=6,
    moe_d_ff=1536,
    first_dense_layers=1,
    rope_theta=1e4,
)
