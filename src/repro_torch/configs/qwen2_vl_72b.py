"""Qwen2-VL-72B — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064; head_dim=128.
M-RoPE sections (t, h, w) = (16, 24, 24) over hd/2=64 slots. The vision
tower is a STUB: input_specs() provides precomputed patch embeddings.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064, head_dim=128,
    mrope_sections=(16, 24, 24), n_vision_tokens=256,
    dtype="bfloat16",
)

SMOKE = CONFIG.scaled_down(dtype="float32", head_dim=16,
                           mrope_sections=(2, 3, 3), n_vision_tokens=8)
