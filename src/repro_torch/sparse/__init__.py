"""Sparse matrix substrate: host formats, tile densification, oracles,
edge-delta updates and connectivity partitioning.

Host-side structures are numpy (they live on the CPU tier of the memory
hierarchy, like the paper's CSR-A host staging); the stream uploads
BlockELL bricks as torch tensors.
"""
from repro_torch.sparse.formats import (
    CSR,
    CSC,
    COO,
    BlockELL,
    csr_from_dense,
    csc_from_dense,
    csr_to_dense,
    csc_to_dense,
    csr_to_csc,
    csr_transpose,
    csr_row_slice,
    csr_fingerprint,
    segment_fingerprint,
    graph_cache_prefix,
)
from repro_torch.sparse.blocking import (
    tile_csr_to_block_ell,
    block_ell_to_dense,
    round_up,
)
from repro_torch.sparse.ref_spgemm import (
    spgemm_csr_dense,
    spgemm_csr_csc,
    spmm_dense_ref,
)
from repro_torch.sparse.updates import EdgeDelta, apply_edge_updates
from repro_torch.sparse.partition import (
    Partition,
    map_clusters_to_shards,
    partition_graph,
)

__all__ = [
    "CSR", "CSC", "COO", "BlockELL",
    "csr_from_dense", "csc_from_dense", "csr_to_dense", "csc_to_dense",
    "csr_to_csc", "csr_transpose", "csr_row_slice",
    "csr_fingerprint", "segment_fingerprint", "graph_cache_prefix",
    "tile_csr_to_block_ell", "block_ell_to_dense", "round_up",
    "spgemm_csr_dense", "spgemm_csr_csc", "spmm_dense_ref",
    "EdgeDelta", "apply_edge_updates",
    "Partition", "map_clusters_to_shards", "partition_graph",
]
