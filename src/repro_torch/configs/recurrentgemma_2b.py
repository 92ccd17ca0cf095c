"""RecurrentGemma-2B — RG-LRU + local attention, 2:1 [arXiv:2402.19427; hf].

26L d_model=2560 10H (GQA kv=1, i.e. MQA) d_ff=7680 vocab=256000;
block pattern (rglru, rglru, local) per Griffin; lru_width=2560;
local window 2048.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab=256000, head_dim=256,
    sliding_window=2048, lru_width=2560, conv_width=4,
    block_pattern=("rglru", "rglru", "local"),
    dtype="bfloat16",
)

SMOKE = CONFIG.scaled_down(dtype="float32", head_dim=16,
                           block_pattern=("rglru", "local"))
