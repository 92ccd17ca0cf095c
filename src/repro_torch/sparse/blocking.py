"""RoBW tile densification: CSR row blocks → BlockELL bricks.

The Phase-I CPU preprocessing of the paper (Fig. 5): instead of shipping
ragged CSR triples, the host scatters each row block's nonzeros into dense
(bm, bk) column-tile bricks and records the tile topology (col_tile ids)
that the SpMM kernel gathers by.

`tile_csr_to_block_ell` is vectorized over all nonzeros at once; it
produces arrays equal to `repro.sparse.blocking.tile_csr_to_block_ell`'s
per-row loop, which the tests hold it to.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.sparse.formats import CSR, BlockELL


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def tile_csr_to_block_ell(
    a: CSR,
    bm: int = 128,
    bk: int = 128,
    ell_width: Optional[int] = None,
    dtype: np.dtype = np.float32,
) -> BlockELL:
    """Densify CSR into block-ELL.

    ell_width: max nonzero column tiles kept per row block. None → the true
    max over this segment (exact). If a row block has more populated tiles
    than ell_width, the least-populated tiles are dropped — callers that
    need exactness pass ell_width=None or a verified bucket capacity.
    """
    n_rows, n_cols = a.shape
    n_row_blocks = max(1, (n_rows + bm - 1) // bm)
    n_col_tiles = (n_cols + bk - 1) // bk

    row_of = np.repeat(np.arange(n_rows, dtype=np.int64),
                       np.diff(a.indptr).astype(np.int64))
    indices = np.asarray(a.indices, dtype=np.int64)
    rb_of = row_of // bm
    tile_of = indices // bk
    # One key per (row block, column tile) pair; np.unique sorts them by
    # row block, then tile — the order the per-row reference assigns slots.
    pair_key, pair_of, counts = np.unique(
        rb_of * max(n_col_tiles, 1) + tile_of,
        return_inverse=True, return_counts=True)
    pair_rb = pair_key // max(n_col_tiles, 1)
    pair_tile = pair_key % max(n_col_tiles, 1)
    per_rb = np.bincount(pair_rb, minlength=n_row_blocks)

    true_width = int(per_rb.max(initial=0))
    if ell_width is None:
        ell_width = max(1, true_width)
    ell_width = max(1, min(ell_width, n_col_tiles))

    keep = np.ones(pair_key.shape[0], dtype=bool)
    first = np.concatenate(([0], np.cumsum(per_rb)[:-1]))
    for rb in np.nonzero(per_rb > ell_width)[0]:
        # Keep the most-populated tiles (drop the tail). AIRES schedules
        # never take this branch (bucket capacity ≥ true width).
        lo, hi = first[rb], first[rb] + per_rb[rb]
        kept = np.argsort(-counts[lo:hi], kind="stable")[:ell_width]
        mask = np.zeros(hi - lo, dtype=bool)
        mask[kept] = True
        keep[lo:hi] = mask
    kept_per_rb = np.bincount(pair_rb[keep], minlength=n_row_blocks)
    # Slot of each kept pair: its rank among the kept pairs of its row block.
    rank = np.cumsum(keep) - 1
    kept_first = np.concatenate(([0], np.cumsum(kept_per_rb)[:-1]))
    slot = rank - kept_first[pair_rb]

    blocks = np.zeros((n_row_blocks, ell_width, bm, bk), dtype=dtype)
    col_tile = np.full((n_row_blocks, ell_width), -1, dtype=np.int32)
    n_tiles = kept_per_rb.astype(np.int32)
    col_tile[pair_rb[keep], slot[keep]] = pair_tile[keep]

    nz = keep[pair_of]
    blocks[rb_of[nz], slot[pair_of[nz]], row_of[nz] - rb_of[nz] * bm,
           indices[nz] - tile_of[nz] * bk] = a.data[nz]
    return BlockELL(blocks=blocks, col_tile=col_tile, n_tiles=n_tiles,
                    bm=bm, bk=bk, n_rows=n_rows, n_cols=n_cols)


def block_ell_to_dense(e: BlockELL) -> np.ndarray:
    """Inverse of tile_csr_to_block_ell (for oracles/tests)."""
    n_rows_pad = e.n_row_blocks * e.bm
    n_cols_pad = round_up(e.n_cols, e.bk)
    out = np.zeros((n_rows_pad, n_cols_pad), dtype=e.blocks.dtype)
    for rb in range(e.n_row_blocks):
        for s in range(int(e.n_tiles[rb])):
            t = int(e.col_tile[rb, s])
            out[rb * e.bm : (rb + 1) * e.bm, t * e.bk : (t + 1) * e.bk] += \
                e.blocks[rb, s]
    return out[: e.n_rows, : e.n_cols]
