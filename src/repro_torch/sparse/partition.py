"""Connectivity-clustered graph partitioning for partition-aware sharding.

The sharded segment cache's default owner map is a CRC hash per
`SegmentKey` (`repro_torch.io.shard_cache.shard_of`): uniform over shards,
which is ideal for aggregate capacity and terrible for locality — neighboring
row blocks land on arbitrary shards, so every warm epoch pays ICI ships
that pure topology could avoid. This module is the Cluster-GCN-style cure
(as in DGL's Cluster-GCN example and Accel-GCN's block-level
partitioning, arXiv:2308.11825):

  1. `partition_graph` clusters the CSR adjacency's rows by connectivity
     with a streaming Linear Deterministic Greedy (LDG) pass — pure
     NumPy, no METIS dependency, deterministic (no RNG);
  2. `map_clusters_to_shards` assigns clusters to cache shards by nnz
     under a *bounded-imbalance* nearest-first rule: the local shard (and
     then the topologically nearest shards) fill first, each capped at
     ``balance ×`` the mean per-shard nnz. Exact balance would make every
     owner map ICI-equivalent for a worker that streams the whole plan;
     the bounded local surplus — kept under the analyzer's 2× mean
     `lint/shard-imbalance` threshold — is precisely where the warm-epoch
     ICI win comes from;
  3. the resulting `Partition` derives per-RoBW-segment owner maps
     (`owners_for_plan`) that `ShardedSegmentCache.install_owner_map`
     consumes, cluster ids (`clusters_for_plan`) that
     `ShardPlacementPass` co-places, and row `boundaries()` that
     `robw_partition` tiles over so segments stop straddling cluster
     boundaries.

Edge deltas re-cluster touched rows only (`Partition.refine`): untouched
rows keep their labels and the cluster → shard map is preserved verbatim,
so partition-derived owners survive `apply_edge_update` instead of
snapping back to CRC.

A copy of `repro.sparse.partition`; the tests hold the labels, the
cluster → shard maps and the plan projections array-equal.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.io.tiers import ICI_ALL_TO_ALL, ICITopology
from repro_torch.sparse.formats import CSR, graph_cache_prefix

__all__ = [
    "Partition",
    "map_clusters_to_shards",
    "partition_graph",
]


@dataclasses.dataclass(frozen=True)
class Partition:
    """A connectivity clustering of one graph's rows, mapped onto shards.

    `cluster_of[i]` is row i's cluster id; `cluster_to_shard[c]` the cache
    shard that owns cluster c's bricks. `row_nnz` (the source CSR's row
    lengths) makes the per-segment majority votes self-contained — a
    `Partition` prices plans without holding its graph alive.
    """

    cluster_of: np.ndarray          # (n_rows,) int64 cluster id per row
    cluster_to_shard: np.ndarray    # (n_clusters,) int64 shard per cluster
    n_shards: int
    row_nnz: np.ndarray             # (n_rows,) int64 nnz per row
    graph_prefix: str = ""          # graph lineage (graph_cache_prefix)
    token: int = dataclasses.field(default=0)

    def __post_init__(self):
        if self.token == 0:
            blob = (np.ascontiguousarray(self.cluster_of).tobytes()
                    + np.ascontiguousarray(self.cluster_to_shard).tobytes())
            object.__setattr__(self, "token",
                               zlib.crc32(blob) or 1)

    # ---- shape -----------------------------------------------------------

    @property
    def n_rows(self) -> int:
        return int(self.cluster_of.shape[0])

    @property
    def n_clusters(self) -> int:
        return int(self.cluster_to_shard.shape[0])

    @property
    def cluster_nnz(self) -> np.ndarray:
        """Total nnz per cluster — the balance metric shards are packed by."""
        return np.bincount(self.cluster_of, weights=self.row_nnz,
                           minlength=self.n_clusters).astype(np.int64)

    @property
    def shard_nnz(self) -> np.ndarray:
        """Total nnz owned per shard under the cluster → shard map."""
        return np.bincount(self.cluster_to_shard, weights=self.cluster_nnz,
                           minlength=self.n_shards).astype(np.int64)

    # ---- what the placement stack consumes -------------------------------

    def boundaries(self) -> np.ndarray:
        """Row indices where the cluster label changes — the tiling grid
        `robw_partition(boundaries=...)` clamps segment ends to, so no
        RoBW segment straddles a cluster boundary."""
        if self.n_rows == 0:
            return np.empty(0, dtype=np.int64)
        return (np.nonzero(np.diff(self.cluster_of))[0] + 1).astype(np.int64)

    def row_permutation(self) -> np.ndarray:
        """Optional bandwidth-reducing permutation: rows stably sorted by
        cluster id. Relabeling a scattered graph with this makes clusters
        contiguous (fewer, coarser `boundaries()`); the permuted graph is
        a *different* graph (new fingerprint, new cache namespaces)."""
        return np.argsort(self.cluster_of, kind="stable").astype(np.int64)

    def clusters_for_plan(self, plan,
                          row_nnz: Optional[np.ndarray] = None) -> List[int]:
        """Majority-nnz cluster of every RoBW segment in `plan` (row-count
        vote when a segment's rows are all empty). Pass `row_nnz` of the
        actually-streamed matrix for a transposed plan."""
        rn = self.row_nnz if row_nnz is None else np.asarray(row_nnz)
        k = self.n_clusters
        out: List[int] = []
        for seg in plan.segments:
            labs = self.cluster_of[seg.row_start:seg.row_end]
            counts = np.bincount(labs, weights=rn[seg.row_start:seg.row_end],
                                 minlength=k)
            if counts.max(initial=0.0) <= 0.0:
                counts = np.bincount(labs, minlength=k)
            out.append(int(counts.argmax()))
        return out

    def owners_for_plan(self, plan,
                        row_nnz: Optional[np.ndarray] = None) -> List[int]:
        """Owner shard of every RoBW segment in `plan`: its majority
        cluster's shard — the owner map `ShardedSegmentCache.
        install_owner_map` takes, indexed by segment id."""
        return [int(self.cluster_to_shard[c])
                for c in self.clusters_for_plan(plan, row_nnz=row_nnz)]

    # ---- evolving graphs -------------------------------------------------

    def refine(self, a_new: CSR, touched_rows) -> "Partition":
        """Delta re-clustering: re-label only `touched_rows` (majority
        label of their current neighbors; unassignable rows keep their
        label), keeping every other row's cluster AND the cluster → shard
        map verbatim — partition-derived owners survive edge deltas with
        work proportional to the delta, not the graph."""
        if a_new.n_rows != self.n_rows:
            raise ValueError(
                f"refine: graph has {a_new.n_rows} rows, partition covers "
                f"{self.n_rows}")
        labels = self.cluster_of.copy()
        touched = np.unique(np.asarray(touched_rows, dtype=np.int64).ravel())
        if touched.size and (touched[0] < 0 or touched[-1] >= self.n_rows):
            raise IndexError(f"touched rows outside [0, {self.n_rows})")
        k = self.n_clusters
        for i in touched:
            lo, hi = int(a_new.indptr[i]), int(a_new.indptr[i + 1])
            nbrs = a_new.indices[lo:hi]
            nbrs = nbrs[nbrs < self.n_rows]
            if nbrs.size == 0:
                continue
            counts = np.bincount(labels[nbrs], minlength=k)
            labels[i] = int(counts.argmax())
        return Partition(
            cluster_of=labels,
            cluster_to_shard=self.cluster_to_shard.copy(),
            n_shards=self.n_shards,
            row_nnz=np.diff(a_new.indptr).astype(np.int64),
            graph_prefix=self.graph_prefix)

    def describe(self) -> str:
        nnz = self.cluster_nnz
        return (f"Partition({self.n_rows} rows -> {self.n_clusters} "
                f"clusters -> {self.n_shards} shards; cluster nnz "
                f"[{int(nnz.min(initial=0))}, {int(nnz.max(initial=0))}], "
                f"shard nnz {self.shard_nnz.tolist()})")


def map_clusters_to_shards(
    cluster_nnz: Sequence[int],
    n_shards: int,
    topology: ICITopology = ICI_ALL_TO_ALL,
    local_shard: int = 0,
    balance: float = 1.75,
) -> np.ndarray:
    """Pack clusters onto shards: nearest shard first, bounded imbalance.

    Clusters (heaviest nnz first, ties toward the lower id) go to the
    topologically nearest shard — `topology.hops` from `local_shard`, ties
    toward the lower index — that still has room under ``cap = balance ×
    total_nnz / n_shards``; a cluster no shard can take under the cap
    falls back to the least-loaded shard. ``balance`` must stay below the
    analyzer's 2× `lint/shard-imbalance` threshold; the default 1.75
    gives the local shard a 75% surplus over exact balance — the surplus
    is the warm-epoch ICI win — without tripping the lint, and with
    enough slack that near-equal clusters (e.g. ``2 × n_shards`` LDG
    clusters of ~total/2s nnz each) don't sit on the cap's knife edge:
    at 1.5 exactly, ±1% cluster-size jitter decides whether the local
    shard takes its third cluster or bounces it one hop out.
    """
    nnz = np.asarray(cluster_nnz, dtype=np.float64)
    k = int(nnz.shape[0])
    if n_shards <= 1:
        return np.zeros(k, dtype=np.int64)
    if not 0 <= local_shard < n_shards:
        raise ValueError(f"local_shard {local_shard} outside [0, {n_shards})")
    if balance < 1.0:
        raise ValueError(f"balance {balance} < 1: total nnz cannot fit")
    cap = balance * float(nnz.sum()) / n_shards
    by_distance = sorted(
        range(n_shards),
        key=lambda s: (topology.hops(s, local_shard, n_shards), s))
    load = np.zeros(n_shards, dtype=np.float64)
    out = np.zeros(k, dtype=np.int64)
    for c in sorted(range(k), key=lambda c: (-nnz[c], c)):
        w = float(nnz[c])
        dst = next((s for s in by_distance if load[s] + w <= cap), None)
        if dst is None:
            dst = min(range(n_shards),
                      key=lambda s: (load[s],
                                     topology.hops(s, local_shard, n_shards),
                                     s))
        load[dst] += w
        out[c] = dst
    return out


def partition_graph(
    a: CSR,
    n_clusters: int,
    n_shards: int = 1,
    topology: ICITopology = ICI_ALL_TO_ALL,
    local_shard: int = 0,
    balance: float = 1.75,
) -> Partition:
    """Cluster `a`'s rows by connectivity and map clusters onto shards.

    Streaming LDG (Linear Deterministic Greedy) over the rows in order:
    row i scores every cluster by ``(# already-assigned neighbors in it) ×
    (1 − size/capacity)`` and joins the argmax (ties toward the lower
    cluster id); rows with no scored cluster stay with the previous row's
    cluster while it has room (bandable row order is the one prior every
    graph family here satisfies), else seed the least-loaded one.
    Capacity is ``ceil(n_rows / n_clusters)``, so cluster sizes stay
    near-uniform while connected runs of rows co-cluster — one pass,
    O(nnz), deterministic.
    """
    if n_clusters < 1:
        raise ValueError(f"n_clusters must be >= 1, got {n_clusters}")
    n = a.n_rows
    k = max(1, min(int(n_clusters), n)) if n else 1
    capacity = max(1, -(-n // k)) if n else 1
    labels = np.full(n, -1, dtype=np.int64)
    sizes = np.zeros(k, dtype=np.int64)
    indptr, indices = a.indptr, a.indices
    for i in range(n):
        nbrs = indices[indptr[i]:indptr[i + 1]]
        nbr_labels = labels[nbrs[nbrs < n]]
        nbr_labels = nbr_labels[nbr_labels >= 0]
        c = -1
        if nbr_labels.size:
            counts = np.bincount(nbr_labels, minlength=k)
            score = counts * (1.0 - sizes / capacity)
            best = int(score.argmax())
            if score[best] > 0.0:
                c = best
        if c < 0 and i > 0 and sizes[labels[i - 1]] < capacity:
            # Locality prior, NOT least-loaded seeding: a row whose
            # neighbors are all unlabeled (or whose scored clusters are
            # full) stays with its predecessor while that cluster has
            # room. CSR row order is bandable for every family we model
            # (road/kmer locality, SBM blocks, RoBW-friendly orderings),
            # and least-loaded seeding would round-robin the first k
            # rows into k different clusters — smearing every community
            # across all clusters before connectivity has any votes.
            c = int(labels[i - 1])
        if c < 0:
            c = int(sizes.argmin())
        labels[i] = c
        sizes[c] += 1
    row_nnz = np.diff(indptr).astype(np.int64)
    cluster_nnz = np.bincount(labels, weights=row_nnz, minlength=k)
    return Partition(
        cluster_of=labels,
        cluster_to_shard=map_clusters_to_shards(
            cluster_nnz, n_shards, topology=topology,
            local_shard=local_shard, balance=balance),
        n_shards=max(1, int(n_shards)),
        row_nnz=row_nnz,
        graph_prefix=graph_cache_prefix(a))
