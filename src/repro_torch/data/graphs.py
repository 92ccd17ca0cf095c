"""Graph dataset generators matched to paper Table II statistics.

SuiteSparse is unavailable offline, so graphs are synthesized with the same
(vertices, edges, degree-distribution family) per dataset:
  * road/kmer (rUSA, k*) — near-uniform low degree → banded uniform random.
  * soc-LiveJournal1 — power-law (RMAT).
`scaled_spec` scales N down by `scale`.

The random streams are `repro.data.graphs`'s, draw for draw, so the same
seed gives the same CSR. The per-row loops of the reference's dedup and
normalization are vectorized here; the tests hold the CSRs array-equal.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Literal

import numpy as np

from repro_torch.sparse.formats import COO, CSR


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    name: str
    n_vertices: int
    n_edges: int
    family: Literal["uniform", "powerlaw"]
    mem_req_gb: float      # Table II "Memory Req."
    mem_constraint_gb: float  # Table II "Memory Constraint"


# Paper Table II, verbatim statistics.
SUITESPARSE_SPECS: Dict[str, GraphSpec] = {
    "rUSA":   GraphSpec("rUSA",   23_940_000, 57_700_000,  "uniform",  3.31, 3.0),
    "kV2a":   GraphSpec("kV2a",   55_040_000, 117_210_000, "uniform",  6.87, 6.0),
    "kU1a":   GraphSpec("kU1a",   67_710_000, 138_770_000, "uniform",  8.20, 8.0),
    "socLJ1": GraphSpec("socLJ1",  4_840_000, 68_990_000,  "powerlaw", 12.14, 11.0),
    "kP1a":   GraphSpec("kP1a",  139_350_000, 297_820_000, "uniform", 17.45, 16.0),
    "kA2a":   GraphSpec("kA2a",  170_720_000, 360_580_000, "uniform", 21.18, 18.0),
    "kV1r":   GraphSpec("kV1r",  214_000_000, 465_410_000, "uniform", 27.18, 23.0),
}


def scaled_spec(spec: GraphSpec, scale: float) -> GraphSpec:
    """Scale vertices/edges down by `scale`, keeping degree structure."""
    return dataclasses.replace(
        spec,
        n_vertices=max(64, int(spec.n_vertices * scale)),
        n_edges=max(128, int(spec.n_edges * scale)),
        mem_req_gb=spec.mem_req_gb * scale,
        mem_constraint_gb=spec.mem_constraint_gb * scale,
    )


def _uniform_edges(n: int, m: int, rng: np.random.Generator):
    rows = rng.integers(0, n, size=m, dtype=np.int64)
    # Road/kmer locality: most edges connect nearby ids (bandable matrix).
    span = max(1, n // 64)
    offs = rng.integers(-span, span + 1, size=m, dtype=np.int64)
    cols = np.clip(rows + offs, 0, n - 1)
    return rows, cols


def _rmat_edges(n: int, m: int, rng: np.random.Generator,
                a=0.57, b=0.19, c=0.19):
    """RMAT power-law generator (socLJ1-like)."""
    scale = int(np.ceil(np.log2(max(n, 2))))
    rows = np.zeros(m, dtype=np.int64)
    cols = np.zeros(m, dtype=np.int64)
    for _ in range(scale):
        r = rng.random(m)
        quad_b = (r >= a) & (r < a + b)
        quad_c = (r >= a + b) & (r < a + b + c)
        quad_d = r >= a + b + c
        rows = rows * 2 + (quad_c | quad_d)
        cols = cols * 2 + (quad_b | quad_d)
    return rows % n, cols % n


def generate_graph(spec: GraphSpec, seed: int = 0,
                   dtype=np.float32) -> CSR:
    """Adjacency CSR with spec's vertex/edge counts and degree family."""
    rng = np.random.default_rng(seed)
    n, m = spec.n_vertices, spec.n_edges
    if spec.family == "powerlaw":
        rows, cols = _rmat_edges(n, m, rng)
    else:
        rows, cols = _uniform_edges(n, m, rng)
    data = np.ones(m, dtype=dtype)
    coo = COO(rows=rows, cols=cols, data=data, shape=(n, n))
    # Deduplicate parallel edges (keep structure simple & exact).
    return _dedup_csr(coo.to_csr(), dtype)


def generate_sbm_graph(n_vertices: int, n_edges: int, n_blocks: int = 4,
                       p_in: float = 0.9, seed: int = 0,
                       dtype=np.float32) -> CSR:
    """Stochastic-block-model adjacency: `n_blocks` contiguous vertex
    blocks, a `p_in` fraction of edges endpoint-confined to one block and
    the rest crossing blocks uniformly.

    This is the clustered-community structure partition-aware sharding
    exploits (`repro_torch.sparse.partition`): connectivity clustering
    recovers the blocks, so a cluster-aligned owner map keeps each block's
    bricks on one shard. Parallel edges are deduplicated exactly like
    `generate_graph`; the same seed draws the reference's graph.
    """
    if n_blocks < 1:
        raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
    if not 0.0 <= p_in <= 1.0:
        raise ValueError(f"p_in must be in [0, 1], got {p_in}")
    rng = np.random.default_rng(seed)
    n, m = int(n_vertices), int(n_edges)
    block = max(1, n // int(n_blocks))
    rows = rng.integers(0, n, size=m, dtype=np.int64)
    # In-block endpoints: a uniform column inside the row's own block.
    b_lo = (rows // block) * block
    b_hi = np.minimum(b_lo + block, n)
    in_cols = b_lo + (rng.integers(0, block, size=m, dtype=np.int64)
                      % (b_hi - b_lo))
    out_cols = rng.integers(0, n, size=m, dtype=np.int64)
    cols = np.where(rng.random(m) < p_in, in_cols, out_cols)
    coo = COO(rows=rows, cols=cols, data=np.ones(m, dtype=dtype),
              shape=(n, n))
    return _dedup_csr(coo.to_csr(), dtype)


def _dedup_csr(a: CSR, dtype) -> CSR:
    """Drop parallel edges, unit weights: each row's column ids become
    their sorted unique set."""
    row_of = np.repeat(np.arange(a.n_rows, dtype=np.int64), np.diff(a.indptr))
    order = np.lexsort((a.indices, row_of))
    rows, cols = row_of[order], a.indices[order]
    first = np.ones(rows.shape[0], dtype=bool)
    first[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
    rows, cols = rows[first], cols[first]
    indptr = np.zeros(a.n_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=a.n_rows), out=indptr[1:])
    return CSR(indptr=indptr, indices=cols.astype(a.indices.dtype),
               data=np.ones(cols.shape[0], dtype=dtype), shape=a.shape)


def normalized_adjacency(a: CSR) -> CSR:
    """Ã = D̂^{-1/2} (A + I) D̂^{-1/2} — paper Eq. (2), kept in CSR.

    A row that lacks its self-loop gets it inserted and is sorted; a row
    that has one keeps its column order (the reference's exact rule).
    """
    n = a.n_rows
    row_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(a.indptr))
    has_self = np.zeros(n, dtype=bool)
    has_self[row_of[a.indices == row_of]] = True
    missing = np.nonzero(~has_self)[0]
    rows = np.concatenate([row_of, missing])
    cols = np.concatenate([a.indices, missing.astype(a.indices.dtype)])
    # Within a row: sorted by column where the self-loop was inserted,
    # original position otherwise (lexsort is stable).
    pos = np.concatenate([np.arange(a.nnz, dtype=np.int64),
                          np.zeros(missing.shape[0], dtype=np.int64)])
    second = np.where(has_self[rows], pos, cols)
    order = np.lexsort((second, rows))
    rows, indices = rows[order], cols[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    deg = np.diff(indptr).astype(np.float64)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1.0))
    data = (dinv[rows] * dinv[indices]).astype(a.data.dtype)
    return CSR(indptr=indptr, indices=indices, data=data, shape=a.shape)
