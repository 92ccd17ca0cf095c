"""Synthetic paper datasets (Table II statistics) and the seekable token
pipeline."""
from repro_torch.data.graphs import (
    SUITESPARSE_SPECS,
    GraphSpec,
    generate_graph,
    generate_sbm_graph,
    normalized_adjacency,
    scaled_spec,
)
from repro_torch.data.tokens import TokenPipeline, synthetic_token_batches

__all__ = [
    "SUITESPARSE_SPECS", "GraphSpec", "generate_graph", "generate_sbm_graph",
    "normalized_adjacency", "scaled_spec",
    "TokenPipeline", "synthetic_token_batches",
]
