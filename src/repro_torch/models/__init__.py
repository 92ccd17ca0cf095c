"""Models served by the port: the paper's GCN."""
from repro_torch.models.gcn import (
    GCNConfig,
    gcn_forward,
    gcn_init,
    gcn_loss,
    params_from_numpy,
)

__all__ = ["GCNConfig", "gcn_forward", "gcn_init", "gcn_loss",
           "params_from_numpy"]
