"""Public wrapper around the Block-ELL SpMM kernel: natural shapes in, the
padding rows stripped on the way out."""
from __future__ import annotations

import torch

from repro_torch.kernels.bcsr_spmm import bcsr_spmm_blocks
from repro_torch.sparse.formats import BlockELL


def bcsr_spmm(ell: BlockELL, h: torch.Tensor) -> torch.Tensor:
    """X = A @ H for a BlockELL segment of A and dense H (n_cols, F).

    `ell.blocks`, `ell.col_tile` and `ell.n_tiles` are tensors on H's
    device (numpy arrays are taken as CPU tensors). H needs no padding:
    column tiles that reach past its last row read zeros, as the reference
    wrapper's zero-padding makes them. Returns (ell.n_rows, F) float32.
    """
    blocks, col_tile, n_tiles = (torch.as_tensor(x) for x in
                                 (ell.blocks, ell.col_tile, ell.n_tiles))
    out = bcsr_spmm_blocks(blocks, col_tile, n_tiles, h.contiguous(),
                           bm=ell.bm, bk=ell.bk)
    return out[: ell.n_rows]
