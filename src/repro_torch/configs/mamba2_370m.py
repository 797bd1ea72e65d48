"""Mamba2-370M [ssm]: 48L d_model=1024 (attention-free) vocab=50280,
ssm_state=128, SSD state-space duality (the JAX package's
``configs/mamba2_370m``)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=16,  # unused by the SSD mixer (see ssm_head_dim)
    num_kv_heads=16,
    d_ff=0,  # mamba blocks have no separate MLP
    vocab_size=50280,
    ssm=True,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=64,
    conv_kernel=4,
    tie_embeddings=True,
    supports_long_context=True,
)
