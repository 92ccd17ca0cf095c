"""Kimi K2 — trillion-param MoE, 32B active [arXiv:2501.kimi2 paper-table].

61L d_model=7168 64H (GQA kv=8) vocab=163840, MoE 384 experts top-8,
expert d_ff=2048. Assignment specifies GQA (the production model uses MLA;
the assignment's config is authoritative here).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163840,
    head_dim=112,
    n_experts=384,
    top_k=8,
    expert_d_ff=2048,
    dtype="bfloat16",
    stream_weights=True,   # AIRES expert streaming applies (DESIGN §6)
)

SMOKE = CONFIG.scaled_down(n_experts=4, top_k=2, dtype="float32")
