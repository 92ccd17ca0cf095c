"""Synthetic paper datasets (Table II statistics)."""
from repro_torch.data.graphs import (
    SUITESPARSE_SPECS,
    GraphSpec,
    generate_graph,
    generate_sbm_graph,
    normalized_adjacency,
    scaled_spec,
)

__all__ = [
    "SUITESPARSE_SPECS", "GraphSpec", "generate_graph", "generate_sbm_graph",
    "normalized_adjacency", "scaled_spec",
]
