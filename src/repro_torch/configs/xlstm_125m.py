"""xLSTM-125M — sLSTM + mLSTM blocks [arXiv:2405.04517].

12L d_model=768 4H d_ff=0 vocab=50304. Block pattern 1:3 sLSTM:mLSTM
(xLSTM[1:3] per the paper family naming); d_ff=0 — xLSTM blocks carry
their own up-projection, no separate FFN.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    head_dim=192,
    block_pattern=("slstm", "mlstm", "mlstm", "mlstm"),
    dtype="bfloat16",
)

SMOKE = CONFIG.scaled_down(vocab=256, block_pattern=("slstm", "mlstm"),
                           dtype="float32", head_dim=16)
