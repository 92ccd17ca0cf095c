"""Edge-delta updates for evolving graphs.

The paper's motivating workloads (recommendation, PPI) mutate their graphs
continuously. CSRs here are frozen at construction — in-place mutation
raises — so the only mutation path is `apply_edge_updates`, which returns a
*fresh* CSR plus an `EdgeDelta` describing exactly which rows and columns
changed. Downstream, the delta drives the incremental re-tile
(`repro_torch.core.robw.robw_delta_partition`) and segment-key invalidation
(`ServingEngine.update_graph`): update cost scales with the delta, not the
graph.

Untouched rows are preserved **bit-exactly** — the new arrays splice the
old row spans verbatim around rebuilt touched rows — so untouched segments
keep their `segment_fingerprint` and their cached bricks stay valid.

A copy of `repro.sparse.updates`; the tests hold the updated CSRs and
deltas array-equal.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.sparse.formats import CSR, graph_cache_prefix


@dataclasses.dataclass(frozen=True)
class EdgeDelta:
    """What one `apply_edge_updates` call changed.

    `touched_rows` / `touched_cols` are sorted unique index arrays: the
    rows of A whose CSR content changed, and the columns — i.e. the rows of
    Aᵀ — that changed (backward/transposed plans re-tile by column).
    """

    touched_rows: np.ndarray
    touched_cols: np.ndarray
    n_inserted: int
    n_updated: int    # inserts that overwrote an existing edge's value
    n_deleted: int

    def __post_init__(self):
        for arr in (self.touched_rows, self.touched_cols):
            arr.setflags(write=False)

    @property
    def n_changed(self) -> int:
        return self.n_inserted + self.n_updated + self.n_deleted


def _check_bounds(r: int, c: int, shape: Tuple[int, int], what: str) -> None:
    if not (0 <= r < shape[0] and 0 <= c < shape[1]):
        raise IndexError(
            f"{what} ({r}, {c}) outside graph shape {shape[0]}x{shape[1]}")


def apply_edge_updates(
    a: CSR,
    inserts: Optional[Sequence[Tuple[int, int, float]]] = None,
    deletes: Optional[Sequence[Tuple[int, int]]] = None,
) -> Tuple[CSR, EdgeDelta]:
    """Apply edge inserts/deletes to `a`, returning (new CSR, EdgeDelta).

    * `inserts` — (row, col, value) triples. Inserting over an existing
      edge overwrites its value in place (counted in `n_updated`, not
      `n_inserted`). Duplicate (row, col) within one call is an error.
    * `deletes` — (row, col) pairs; deleting an absent edge is an error
      (`KeyError`), as is deleting an edge also being inserted.

    Work is proportional to the touched rows, not the graph: untouched row
    spans are spliced into the output verbatim (bit-exact, including any
    unsorted column order they had), so their segment fingerprints — and
    cached bricks — survive. Rebuilt rows keep surviving entries in their
    original order with overwrites applied; strictly-new edges are merged
    in ascending column order (appended in column order if the row was not
    sorted to begin with). The new CSR inherits `a`'s cache-namespace
    lineage via `graph_key`.
    """
    inserts = list(inserts or ())
    deletes = list(deletes or ())
    if not inserts and not deletes:
        empty = np.zeros(0, dtype=np.int64)
        return a, EdgeDelta(empty, empty.copy(), 0, 0, 0)

    ins_by_pos: Dict[Tuple[int, int], float] = {}
    for r, c, v in inserts:
        r, c = int(r), int(c)
        _check_bounds(r, c, a.shape, "insert")
        if (r, c) in ins_by_pos:
            raise ValueError(f"duplicate insert of edge ({r}, {c})")
        ins_by_pos[(r, c)] = v
    del_set: set = set()
    for r, c in deletes:
        r, c = int(r), int(c)
        _check_bounds(r, c, a.shape, "delete")
        if (r, c) in del_set:
            raise ValueError(f"duplicate delete of edge ({r}, {c})")
        if (r, c) in ins_by_pos:
            raise ValueError(
                f"edge ({r}, {c}) both inserted and deleted in one update")
        del_set.add((r, c))

    by_row: Dict[int, List[Tuple[str, int, float]]] = {}
    for (r, c), v in ins_by_pos.items():
        by_row.setdefault(r, []).append(("ins", c, v))
    for r, c in del_set:
        by_row.setdefault(r, []).append(("del", c, 0.0))

    indptr, indices, data = a.indptr, a.indices, a.data
    row_lengths = np.diff(indptr)
    touched_rows = sorted(by_row)
    touched_cols: set = set()
    n_inserted = n_updated = n_deleted = 0

    # Rebuild each touched row; untouched spans between them are spliced
    # from the old arrays verbatim.
    new_rows: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for r in touched_rows:
        lo, hi = int(indptr[r]), int(indptr[r + 1])
        cols = indices[lo:hi].copy()
        vals = data[lo:hi].copy()
        was_sorted = bool(np.all(np.diff(cols) > 0)) if cols.size > 1 else True
        col_pos = {int(c): i for i, c in enumerate(cols)}
        keep = np.ones(cols.shape[0], dtype=bool)
        fresh: List[Tuple[int, float]] = []
        for op, c, v in by_row[r]:
            if op == "del":
                pos = col_pos.get(c)
                if pos is None:
                    raise KeyError(
                        f"delete of absent edge ({r}, {c})")
                keep[pos] = False
                n_deleted += 1
            else:
                pos = col_pos.get(c)
                if pos is not None:
                    vals[pos] = v
                    n_updated += 1
                else:
                    fresh.append((c, v))
                    n_inserted += 1
            touched_cols.add(c)
        cols, vals = cols[keep], vals[keep]
        if fresh:
            fresh.sort()
            f_cols = np.array([c for c, _ in fresh], dtype=indices.dtype)
            f_vals = np.array([v for _, v in fresh], dtype=data.dtype)
            cols = np.concatenate([cols, f_cols])
            vals = np.concatenate([vals, f_vals])
            if was_sorted:
                order = np.argsort(cols, kind="stable")
                cols, vals = cols[order], vals[order]
        new_rows[r] = (cols, vals)

    # Splice: alternate untouched spans (old-array views) and rebuilt rows.
    idx_parts: List[np.ndarray] = []
    val_parts: List[np.ndarray] = []
    prev = 0
    new_lengths = row_lengths.copy()
    for r in touched_rows:
        lo, hi = int(indptr[r]), int(indptr[r + 1])
        if prev < lo:
            idx_parts.append(indices[prev:lo])
            val_parts.append(data[prev:lo])
        cols, vals = new_rows[r]
        idx_parts.append(cols)
        val_parts.append(vals)
        new_lengths[r] = cols.shape[0]
        prev = hi
    if prev < int(indptr[-1]):
        idx_parts.append(indices[prev:])
        val_parts.append(data[prev:])

    new_indptr = np.zeros(a.n_rows + 1, dtype=indptr.dtype)
    np.cumsum(new_lengths, out=new_indptr[1:])
    new_indices = (np.concatenate(idx_parts) if idx_parts
                   else np.zeros(0, dtype=indices.dtype))
    new_data = (np.concatenate(val_parts) if val_parts
                else np.zeros(0, dtype=data.dtype))

    new = CSR(indptr=new_indptr, indices=new_indices, data=new_data,
              shape=a.shape, graph_key=graph_cache_prefix(a))
    delta = EdgeDelta(
        touched_rows=np.asarray(touched_rows, dtype=np.int64),
        touched_cols=np.asarray(sorted(touched_cols), dtype=np.int64),
        n_inserted=n_inserted, n_updated=n_updated, n_deleted=n_deleted)
    return new, delta
