"""Gemma 2 27B — local+global alternating, logit softcaps [arXiv:2408.00118].

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000; head_dim=128;
sliding window 4096 on local layers; attn softcap 50, final logit softcap 30.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab=256000,
    head_dim=128,
    sliding_window=4096,
    local_global_pattern=2,     # local, global, local, global, ...
    attn_softcap=50.0,
    logit_softcap=30.0,
    dtype="bfloat16",
)

SMOKE = CONFIG.scaled_down(dtype="float32")
