"""Torch oracles for every kernel (ground truth for tests), the same
functions as `repro.kernels.ref`.

The Block-ELL oracles densify the bricks into one matrix, then multiply:
the kernels' exact semantics, at a memory cost only small test shapes can
afford. The attention oracles are the plain versions kept beside their
kernels: a full float32 softmax over all scores, 0 for a row with no valid
key (the reference's jnp oracle gives NaN there, its kernels 0).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attn import (  # noqa: F401
    decode_attention_plain as decode_attention_ref,
)
from repro_torch.kernels.flash_attn import (  # noqa: F401
    flash_attention_plain as flash_attention_ref,
)


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
