"""Public wrappers around the Block-ELL kernels: natural shapes in, the
padding rows stripped on the way out."""
from __future__ import annotations

import torch

from repro_torch.kernels.bcsr_spmm import (
    bcsr_spmm_blocks,
    fused_gcn_layer_blocks,
)
from repro_torch.sparse.formats import BlockELL


def _brick_tensors(ell: BlockELL) -> tuple:
    return tuple(torch.as_tensor(x) for x in
                 (ell.blocks, ell.col_tile, ell.n_tiles))


def bcsr_spmm(ell: BlockELL, h: torch.Tensor) -> torch.Tensor:
    """X = A @ H for a BlockELL segment of A and dense H (n_cols, F).

    `ell.blocks`, `ell.col_tile` and `ell.n_tiles` are tensors on H's
    device (numpy arrays are taken as CPU tensors). H needs no padding:
    column tiles that reach past its last row read zeros, as the reference
    wrapper's zero-padding makes them. Returns (ell.n_rows, F) float32.
    """
    out = bcsr_spmm_blocks(*_brick_tensors(ell), h.contiguous(),
                           bm=ell.bm, bk=ell.bk)
    return out[: ell.n_rows]


def fused_gcn_layer(ell: BlockELL, h: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """relu((A @ H) @ W + b) fused per row block, X never written to device
    memory. Float32 bricks, H (n_cols, F), W (F, F_out) and b (F_out,), on
    one device; H needs no padding, as in `bcsr_spmm`. Returns
    (ell.n_rows, F_out) float32.
    """
    out = fused_gcn_layer_blocks(*_brick_tensors(ell), h.contiguous(),
                                 w.contiguous(), b.contiguous(),
                                 bm=ell.bm, bk=ell.bk)
    return out[: ell.n_rows]
