"""RoBW — Row Block-Wise partitioning (paper Algorithm 1 + Fig. 4).

Given CSR A and a per-segment device budget M_A, greedily pack *complete
rows* into segments such that calcMem(k, q) ≤ M_A. Segment boundaries never
split a row, and concatenating the segments reproduces A exactly — this is
what removes the merge overhead of Fig. 3.

Segment boundaries are additionally aligned to a row-block multiple `align`
so every streamed segment densifies into whole BlockELL bricks. Alignment
can only shrink a segment, so the calcMem budget still holds.

The baselines' naive split (`naive_partition`) and the host merge of the
rows it splits (`merge_partial_rows`) live here too: they are what the
paper's Fig. 3 measures AIRES against.

Plans can tile over a partition's cluster boundaries, bricks can pad to an
explicit ELL bucket ladder (the autotuner's), and an edge delta re-plans
only the segments it touched (`robw_delta_partition`).

A copy of `repro.core.robw`; the tests hold the plans, widths and bricks
equal.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import numpy as np

from repro_torch.core.memory_model import calc_mem, ell_bucket_capacity
from repro_torch.sparse.blocking import tile_csr_to_block_ell
from repro_torch.sparse.formats import (
    CSR, BlockELL, csr_row_slice, csr_transpose,
)


@dataclasses.dataclass
class RoBWSegment:
    """One aligned segment: complete rows [row_start, row_end)."""

    row_start: int
    row_end: int
    nnz: int
    nbytes: int

    @property
    def n_rows(self) -> int:
        return self.row_end - self.row_start


@dataclasses.dataclass
class RoBWPlan:
    segments: List[RoBWSegment]
    align: int
    budget_bytes: int

    @property
    def n_segments(self) -> int:
        return len(self.segments)

    def max_rows(self) -> int:
        return max((s.n_rows for s in self.segments), default=0)

    def max_nnz(self) -> int:
        return max((s.nnz for s in self.segments), default=0)


def robw_partition(
    a: CSR,
    m_a_bytes: int,
    align: int = 1,
    value_bytes: Optional[int] = None,
    index_bytes: int = 4,
    boundaries=None,
) -> RoBWPlan:
    """Algorithm 1, vectorized per segment.

    Walks rows, extending the block while calcMem(k, q) ≤ M_A; emits the
    block, then continues from the next row (never mid-row). With align>1,
    the emitted boundary is rounded *down* to the alignment grid unless that
    would make the block empty.

    `boundaries` is an optional row-index tiling grid (e.g.
    `Partition.boundaries()`, the rows where the cluster label changes): a
    segment's end is clamped down to the first boundary strictly inside
    it, so no segment straddles a cluster boundary. Clamping only shrinks
    segments; ``boundaries=None`` gives the unclamped plan.
    """
    if value_bytes is None:
        value_bytes = int(a.data.dtype.itemsize)
    n = a.n_rows
    cuts = None
    if boundaries is not None:
        cuts = np.unique(np.asarray(boundaries, dtype=np.int64).ravel())
        cuts = cuts[(cuts > 0) & (cuts < n)]
    segments: List[RoBWSegment] = []
    start = 0
    indptr = a.indptr
    while start < n:
        # Largest end with calcMem(end-start, indptr[end]-indptr[start]) <= M_A.
        k = np.arange(1, n - start + 1, dtype=np.int64)
        q = indptr[start + 1 : n + 1] - indptr[start]
        mem = (k + 1) * index_bytes + q * (index_bytes + value_bytes)
        fits = np.nonzero(mem <= m_a_bytes)[0]
        if fits.shape[0] == 0:
            # A single row exceeds the budget: emit it alone (callers check
            # plan feasibility upstream).
            end = start + 1
        else:
            end = start + int(fits[-1]) + 1
            if align > 1 and end < n:
                aligned = start + ((end - start) // align) * align
                if aligned > start:
                    end = aligned
            if cuts is not None and cuts.size:
                # Clamp to the first tiling boundary strictly inside
                # (start, end): cuts[j] > start keeps the block non-empty.
                j = int(np.searchsorted(cuts, start, side="right"))
                if j < cuts.size and int(cuts[j]) < end:
                    end = int(cuts[j])
        nnz = int(indptr[end] - indptr[start])
        segments.append(RoBWSegment(
            row_start=start, row_end=end, nnz=nnz,
            nbytes=calc_mem(end - start, nnz, value_bytes, index_bytes)))
        start = end
    return RoBWPlan(segments=segments, align=align, budget_bytes=m_a_bytes)


def robw_transpose_plan(
    a: CSR,
    m_a_bytes: int,
    align: int = 1,
    value_bytes: Optional[int] = None,
    index_bytes: int = 4,
    a_t: Optional[CSR] = None,
    boundaries=None,
) -> tuple:
    """RoBW plan over Aᵀ — the backward-pass streaming schedule.

    Complete *columns* of A become complete rows of Aᵀ, so the no-merge
    invariant carries over to the backward stream. Returns (a_t, plan);
    pass a precomputed `a_t` to skip the transpose.
    """
    if a_t is None:
        a_t = csr_transpose(a)
    plan = robw_partition(a_t, m_a_bytes, align=align,
                          value_bytes=value_bytes, index_bytes=index_bytes,
                          boundaries=boundaries)
    return a_t, plan


def naive_partition(a: CSR, m_a_bytes: int, value_bytes: Optional[int] = None,
                    index_bytes: int = 4) -> List[tuple]:
    """The MaxMemory baseline split: cut at *nnz* budget ignoring row
    boundaries. Returns [(nnz_start, nnz_end, first_partial, last_partial)].

    Segments generally begin and end mid-row; the scheduler must merge
    partial rows on the host (the Fig. 3 overhead AIRES removes).
    """
    if value_bytes is None:
        value_bytes = int(a.data.dtype.itemsize)
    per_nnz = index_bytes + value_bytes
    budget_nnz = max(1, (m_a_bytes - 2 * index_bytes) // per_nnz)
    cuts = []
    pos = 0
    row_of = np.searchsorted(a.indptr, np.arange(a.nnz + 1), side="right") - 1
    while pos < a.nnz:
        end = min(pos + budget_nnz, a.nnz)
        first_partial = pos != a.indptr[row_of[min(pos, a.nnz - 1)]]
        last_partial = end < a.nnz and end != a.indptr[row_of[end]]
        cuts.append((int(pos), int(end), bool(first_partial),
                     bool(last_partial)))
        pos = end
    return cuts


def densify_segment(
    a: CSR,
    seg: RoBWSegment,
    bm: int = 128,
    bk: int = 128,
    dtype: np.dtype = np.float32,
    buckets: Optional[List[int]] = None,
) -> BlockELL:
    """Tile-densify one RoBW segment of `a` into a BlockELL brick.

    The one re-tile primitive of the full pass (`segments_to_block_ell`)
    and the delta path (`AiresSpGEMM.apply_edge_update`): both give
    bit-identical bricks for the same rows. ell_width is padded to its
    bucket (`ell_bucket_capacity`): the power-of-two ladder, or the
    explicit `buckets` ladder when one is given.
    """
    sub = csr_row_slice(a, seg.row_start, seg.row_end)
    ell = tile_csr_to_block_ell(sub, bm=bm, bk=bk, ell_width=None, dtype=dtype)
    cap = ell_bucket_capacity(ell.ell_width, buckets)
    if cap != ell.ell_width:
        pad = cap - ell.ell_width
        ell.blocks = np.pad(ell.blocks, ((0, 0), (0, pad), (0, 0), (0, 0)))
        ell.col_tile = np.pad(ell.col_tile, ((0, 0), (0, pad)),
                              constant_values=-1)
    return ell


def segments_to_block_ell(
    a: CSR,
    plan: RoBWPlan,
    bm: int = 128,
    bk: int = 128,
    dtype: np.dtype = np.float32,
    buckets: Optional[List[int]] = None,
) -> Iterator[BlockELL]:
    """Phase-I host preprocessing: stream of tile-densified segments, each
    padded to its bucket of the power-of-two or explicit `buckets` ladder
    (`densify_segment`)."""
    for seg in plan.segments:
        yield densify_segment(a, seg, bm=bm, bk=bk, dtype=dtype,
                              buckets=buckets)


def segment_ell_widths(a: CSR, plan: RoBWPlan, bm: int = 128,
                       bk: int = 128) -> List[int]:
    """True (pre-padding) BlockELL tile width of every segment in `plan`:
    the max over its row blocks of distinct populated column tiles, read
    off the CSR index structure with no densification. The autotuner
    prices candidate bucket sets with it (`core.autotune.bucket_set_bytes`).
    """
    widths: List[int] = []
    for seg in plan.segments:
        w = 0
        for rb_start in range(seg.row_start, seg.row_end, bm):
            lo = int(a.indptr[rb_start])
            hi = int(a.indptr[min(rb_start + bm, seg.row_end)])
            if hi > lo:
                w = max(w, int(np.unique(a.indices[lo:hi] // bk).size))
        widths.append(max(1, w))
    return widths


def robw_delta_partition(
    a_new: CSR,
    old_plan: RoBWPlan,
    touched_rows,
    value_bytes: Optional[int] = None,
    index_bytes: int = 4,
) -> tuple:
    """Incremental RoBW re-partition after an edge delta.

    `a_new` is the updated CSR (same row count as the graph `old_plan`
    partitioned); `touched_rows` are the rows whose content changed
    (`EdgeDelta.touched_rows`, or `.touched_cols` for a transposed plan).
    Returns ``(plan, reuse)``: ``reuse[i]`` is the old segment whose rows,
    and bricks, new segment ``i`` reuses verbatim, or None if it covers
    touched rows and must re-tile.

    Untouched segments are copied boundary for boundary. Each maximal run
    of touched segments is merged into one span and re-partitioned by
    `robw_partition` under the old plan's budget and alignment, so the
    work is proportional to the touched span, not the graph.
    """
    if value_bytes is None:
        value_bytes = int(a_new.data.dtype.itemsize)
    segs_old = old_plan.segments
    touched = np.unique(np.asarray(touched_rows, dtype=np.int64).ravel())
    if touched.size and (touched[0] < 0 or touched[-1] >= a_new.n_rows):
        raise IndexError(f"touched rows outside [0, {a_new.n_rows})")
    row_starts = np.array([s.row_start for s in segs_old], dtype=np.int64)
    touched_mask = np.zeros(len(segs_old), dtype=bool)
    if touched.size:
        hit = np.searchsorted(row_starts, touched, side="right") - 1
        touched_mask[np.unique(hit)] = True
    segments: List[RoBWSegment] = []
    reuse: List[Optional[int]] = []
    i = 0
    while i < len(segs_old):
        if not touched_mask[i]:
            segments.append(dataclasses.replace(segs_old[i]))
            reuse.append(i)
            i += 1
            continue
        j = i
        while j < len(segs_old) and touched_mask[j]:
            j += 1
        span_start = segs_old[i].row_start
        span_end = segs_old[j - 1].row_end
        sub = csr_row_slice(a_new, span_start, span_end)
        sub_plan = robw_partition(sub, old_plan.budget_bytes,
                                  align=old_plan.align,
                                  value_bytes=value_bytes,
                                  index_bytes=index_bytes)
        for s in sub_plan.segments:
            segments.append(RoBWSegment(
                row_start=s.row_start + span_start,
                row_end=s.row_end + span_start,
                nnz=s.nnz, nbytes=s.nbytes))
            reuse.append(None)
        i = j
    return (RoBWPlan(segments=segments, align=old_plan.align,
                     budget_bytes=old_plan.budget_bytes), reuse)


def merge_partial_rows(prev_tail: np.ndarray, head: np.ndarray) -> np.ndarray:
    """Host-side merge of a split row (baseline schedulers only): the
    paper's 'packed with the last portion of data already transferred ...
    for merging and staging in the host memory'. Returns the merged row
    values; the cost of this call is what Fig. 3 measures."""
    return np.concatenate([prev_tail, head])
