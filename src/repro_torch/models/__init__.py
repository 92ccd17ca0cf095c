"""Models served by the port: the paper's GCN and the LM zoo (decoder
stacks of every block kind and the encoder-decoder).

`params_from_numpy` is the GCN's; the LM's is
`repro_torch.models.transformer.params_from_numpy`.
"""
from repro_torch.models.config import ArchConfig, BlockKind
from repro_torch.models.gcn import (
    GCNConfig,
    gcn_forward,
    gcn_init,
    gcn_loss,
    params_from_numpy,
)
from repro_torch.models.transformer import (
    decode_step,
    encode,
    forward,
    init_decode_state,
    init_params,
    lm_loss,
    param_count,
)

__all__ = ["ArchConfig", "BlockKind",
           "init_params", "encode", "forward", "lm_loss",
           "init_decode_state", "decode_step", "param_count",
           "GCNConfig", "gcn_forward", "gcn_init", "gcn_loss",
           "params_from_numpy"]
