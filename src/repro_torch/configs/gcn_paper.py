"""The paper's own architecture: GCN with F=256 features (§V-A), served
with out-of-core AIRES SpGEMM. The same widths as
`repro.configs.gcn_paper`."""
from repro_torch.models.gcn import GCNConfig

CONFIG = GCNConfig(
    name="gcn_paper",
    feature_dim=256,
    hidden_dims=(256, 256),
    n_classes=64,
    out_of_core=True,
)

SMOKE = GCNConfig(
    name="gcn_paper_smoke",
    feature_dim=32,
    hidden_dims=(32,),
    n_classes=8,
    out_of_core=True,
)
