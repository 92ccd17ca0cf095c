"""Compressed sparse formats (paper §II-B, Fig. 2) — host containers.

CSR/CSC/COO are host-tier containers (numpy): they model the paper's host-memory
staging of compressed data. BlockELL (see blocking.py) is the device-tier
format produced by RoBW preprocessing; its arrays stay numpy on the host and
are uploaded as tensors by the stream.

A faithful copy of `repro.sparse.formats`: the fingerprints key the segment
cache, so they must match the reference string for string.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class CSR:
    """Compressed sparse row: A[i, indices[indptr[i]:indptr[i+1]]] = data[...]."""

    indptr: np.ndarray   # (n_rows + 1,) int
    indices: np.ndarray  # (nnz,) int — column ids
    data: np.ndarray     # (nnz,) value dtype
    shape: Tuple[int, int]
    # Lineage token for evolving graphs; None (static graphs) →
    # `graph_cache_prefix` derives the content-addressed prefix.
    graph_key: Optional[str] = None

    def __post_init__(self):
        # CSRs are immutable once constructed: every cache layer (the
        # fingerprint memo, AiresSpGEMM's prepared LRU, the segment cache)
        # keys on content captured at first sight, so an in-place mutation
        # would silently serve stale bricks. Freezing makes it fail loudly.
        for arr in (self.indptr, self.indices, self.data):
            if isinstance(arr, np.ndarray):
                arr.setflags(write=False)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    def nbytes(self, index_bytes: int = 4) -> int:
        """Host/device footprint of the compressed representation."""
        return int(
            self.indptr.shape[0] * index_bytes
            + self.indices.shape[0] * index_bytes
            + self.data.shape[0] * self.data.dtype.itemsize
        )

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    def validate(self) -> None:
        if not (self.indptr.ndim == 1
                and self.indptr.shape[0] == self.shape[0] + 1):
            raise ValueError("indptr must have n_rows + 1 entries")
        if not (self.indptr[0] == 0 and self.indptr[-1] == self.nnz):
            raise ValueError("indptr must start at 0 and end at nnz")
        if not np.all(np.diff(self.indptr) >= 0):
            raise ValueError("indptr must be monotone")
        if self.nnz and not (self.indices.min() >= 0
                             and self.indices.max() < self.shape[1]):
            raise ValueError("column ids out of range")


@dataclasses.dataclass
class CSC:
    """Compressed sparse column (the paper's format for matrix B / features)."""

    indptr: np.ndarray   # (n_cols + 1,)
    indices: np.ndarray  # (nnz,) row ids
    data: np.ndarray     # (nnz,)
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def nbytes(self, index_bytes: int = 4) -> int:
        return int(
            self.indptr.shape[0] * index_bytes
            + self.indices.shape[0] * index_bytes
            + self.data.shape[0] * self.data.dtype.itemsize
        )


@dataclasses.dataclass
class COO:
    rows: np.ndarray
    cols: np.ndarray
    data: np.ndarray
    shape: Tuple[int, int]

    def to_csr(self) -> CSR:
        order = np.lexsort((self.cols, self.rows))
        rows, cols, data = self.rows[order], self.cols[order], self.data[order]
        indptr = np.zeros(self.shape[0] + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr)
        return CSR(indptr=indptr, indices=cols.astype(np.int64), data=data,
                   shape=self.shape)


@dataclasses.dataclass
class BlockELL:
    """Device-tier block-ELL: the RoBW tile-densified format.

    A row-block segment holds, for each of its `n_row_blocks` row blocks of
    `bm` rows, a fixed budget of `ell_width` column tiles of `bk` columns:

      blocks:   (n_row_blocks, ell_width, bm, bk)  dense value bricks
      col_tile: (n_row_blocks, ell_width) int32    column-tile index (-1 = pad)
      n_tiles:  (n_row_blocks,) int32              valid tiles per row block

    Padding bricks are zero, so the product is exact. ell_width is the
    bucket capacity chosen by the memory model.
    """

    blocks: np.ndarray
    col_tile: np.ndarray
    n_tiles: np.ndarray
    bm: int
    bk: int
    n_rows: int   # un-padded logical rows covered by this segment
    n_cols: int   # logical column count of A

    @property
    def n_row_blocks(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def ell_width(self) -> int:
        return int(self.blocks.shape[1])

    def nbytes(self) -> int:
        return int(self.blocks.nbytes + self.col_tile.nbytes
                   + self.n_tiles.nbytes)


def csr_fingerprint(a: CSR) -> str:
    """Content fingerprint of a CSR: shape, nnz, and a CRC over the row
    pointers, column ids AND values (cached bricks embed the values).
    Stable across processes; memoized on the instance, which is safe
    because CSR freezes its arrays at construction."""
    memo = getattr(a, "_fingerprint", None)
    if memo is not None:
        return memo
    crc = zlib.crc32(np.ascontiguousarray(a.indptr).tobytes())
    crc = zlib.crc32(np.ascontiguousarray(a.indices).tobytes(), crc)
    crc = zlib.crc32(np.ascontiguousarray(a.data).tobytes(), crc)
    fp = f"{a.shape[0]}x{a.shape[1]}n{a.nnz}c{crc:08x}"
    a._fingerprint = fp
    return fp


def segment_fingerprint(a: CSR, row_start: int, row_end: int) -> str:
    """Content fingerprint of rows [row_start, row_end) of `a`.

    Position-independent: the row pointers are hashed relative to the
    segment start, so the same rows at another nnz offset fingerprint
    identically.
    """
    lo = int(a.indptr[row_start])
    hi = int(a.indptr[row_end])
    rel = np.ascontiguousarray(a.indptr[row_start:row_end + 1] - lo)
    crc = zlib.crc32(rel.tobytes())
    crc = zlib.crc32(np.ascontiguousarray(a.indices[lo:hi]).tobytes(), crc)
    crc = zlib.crc32(np.ascontiguousarray(a.data[lo:hi]).tobytes(), crc)
    return f"s{row_end - row_start}n{hi - lo}c{crc:08x}"


def graph_cache_prefix(a: CSR) -> str:
    """Identity prefix shared by every segment-cache namespace derived for
    `a` (any direction, plan width, or budget): `graph_key` when the CSR
    carries a lineage token, else the content-addressed
    ``g{fingerprint}:{nnz}:{rows}x{cols}``."""
    if a.graph_key:
        return a.graph_key
    return f"g{csr_fingerprint(a)}:{a.nnz}:{a.shape[0]}x{a.shape[1]}"


def csr_from_dense(dense: np.ndarray) -> CSR:
    rows, cols = np.nonzero(dense)
    data = dense[rows, cols]
    indptr = np.zeros(dense.shape[0] + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return CSR(indptr=indptr, indices=cols.astype(np.int64), data=data,
               shape=dense.shape)


def csc_from_dense(dense: np.ndarray) -> CSC:
    csr_t = csr_from_dense(dense.T)
    return CSC(indptr=csr_t.indptr, indices=csr_t.indices, data=csr_t.data,
               shape=dense.shape)


def csr_to_dense(a: CSR) -> np.ndarray:
    out = np.zeros(a.shape, dtype=a.data.dtype)
    for i in range(a.shape[0]):
        lo, hi = a.indptr[i], a.indptr[i + 1]
        out[i, a.indices[lo:hi]] = a.data[lo:hi]
    return out


def csc_to_dense(b: CSC) -> np.ndarray:
    out = np.zeros(b.shape, dtype=b.data.dtype)
    for j in range(b.shape[1]):
        lo, hi = b.indptr[j], b.indptr[j + 1]
        out[b.indices[lo:hi], j] = b.data[lo:hi]
    return out


def csr_transpose(a: CSR) -> CSR:
    """CSR of Aᵀ — the backward-pass adjacency (dH = Aᵀ dX).

    Vectorized counting sort by column: a stable argsort of the column ids
    groups each output row's entries in source-row order, so the result is
    canonical CSR.
    """
    counts = np.bincount(a.indices, minlength=a.n_cols)
    indptr = np.zeros(a.n_cols + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    order = np.argsort(a.indices, kind="stable")
    row_of = np.repeat(
        np.arange(a.n_rows, dtype=np.int64), np.diff(a.indptr))
    return CSR(indptr=indptr, indices=row_of[order],
               data=a.data[order], shape=(a.n_cols, a.n_rows))


def csr_to_csc(a: CSR) -> CSC:
    """CSR→CSC re-index. CSC of A stores exactly the arrays of CSR of Aᵀ."""
    t = csr_transpose(a)
    return CSC(indptr=t.indptr, indices=t.indices, data=t.data, shape=a.shape)


def csr_row_slice(a: CSR, start: int, stop: int) -> CSR:
    """Complete-row slice a[start:stop, :] — the RoBW segment extractor.

    By construction this never splits a row: the returned segment is the
    paper's 'complete and unfragmented' block (Fig. 4 bottom).
    """
    stop = min(stop, a.n_rows)
    lo, hi = a.indptr[start], a.indptr[stop]
    indptr = (a.indptr[start : stop + 1] - lo).astype(a.indptr.dtype)
    return CSR(indptr=indptr, indices=a.indices[lo:hi].copy(),
               data=a.data[lo:hi].copy(), shape=(stop - start, a.n_cols))
