"""SeamlessM4T-medium — enc-dec, multimodal [arXiv:2308.11596; hf].

12L enc + 12L dec, d_model=1024 16H (MHA kv=16) d_ff=4096 vocab=256206.
The speech frontend is a STUB, as in the reference: the encoder takes
precomputed frame embeddings (B, frames, d_model).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, head_dim=64,
    encoder_layers=12, audio_frames=1024,
    dtype="bfloat16",
)

SMOKE = CONFIG.scaled_down(dtype="float32")
