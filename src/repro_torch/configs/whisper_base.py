"""Whisper-base [audio]: enc-dec, 6L each, d_model=512 8H d_ff=2048
vocab=51865.  The conv frontend is a stub that takes precomputed frame
embeddings (1500 frames); sinusoid positions, no rope, GELU MLPs (the JAX
package's ``configs/whisper_base``)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    encoder_decoder=True,
    enc_layers=6,
    enc_frames=1500,
    use_rope=False,
    act_fn="gelu",
    frontend="audio",
)
