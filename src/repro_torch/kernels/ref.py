"""Torch oracles for the Block-ELL kernels (ground truth for tests).

Densifies the bricks into one matrix, then multiplies: the kernels' exact
semantics, at a memory cost only small test shapes can afford. The plain
versions that `kernels.bcsr_spmm` keeps beside the kernels compute the same
functions without densifying.
"""
from __future__ import annotations

import torch


def bcsr_spmm_ref(blocks: torch.Tensor, col_tile: torch.Tensor,
                  n_tiles: torch.Tensor, h: torch.Tensor, *,
                  bm: int, bk: int) -> torch.Tensor:
    """X = A @ H for Block-ELL A; slots with s >= n_tiles[rb] or a
    negative col_tile contribute nothing. H: (K_pad, F), K_pad % bk == 0."""
    n_rb, ell_w = blocks.shape[0], blocks.shape[1]
    k_pad = h.shape[0]
    a_dense = torch.zeros((n_rb * bm, k_pad), dtype=torch.float32,
                          device=h.device)
    for rb in range(n_rb):
        for s in range(ell_w):
            t = int(col_tile[rb, s])
            if s < int(n_tiles[rb]) and t >= 0:
                a_dense[rb * bm:(rb + 1) * bm, t * bk:(t + 1) * bk] += \
                    blocks[rb, s].to(torch.float32)
    return a_dense @ h.to(torch.float32)


def fused_gcn_layer_ref(blocks: torch.Tensor, col_tile: torch.Tensor,
                        n_tiles: torch.Tensor, h: torch.Tensor,
                        w: torch.Tensor, b: torch.Tensor, *,
                        bm: int, bk: int) -> torch.Tensor:
    """relu((A @ H) @ W + b) for Block-ELL A, through `bcsr_spmm_ref`."""
    x = bcsr_spmm_ref(blocks, col_tile, n_tiles, h, bm=bm, bk=bk)
    return torch.clamp_min(x @ w.to(torch.float32) + b.to(torch.float32),
                           0.0)
