"""Mixtral 8x22B — 8 experts top-2, SWA [arXiv:2401.04088; hf].

56L d_model=6144 48H (GQA kv=8) expert d_ff=16384 vocab=32768.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    head_dim=128,
    sliding_window=4096,
    n_experts=8,
    top_k=2,
    expert_d_ff=16384,
    dtype="bfloat16",
)

SMOKE = CONFIG.scaled_down(n_experts=4, top_k=2, dtype="float32")
