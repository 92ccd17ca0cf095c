"""int8 error-feedback gradient compression, the port of
`repro.train.compression`.

Each gradient leaf, with the residual of the step before added back, is
quantized to int8 by one f32 scale per leaf (max |x| / 127 + 1e-12), and
the new residual is what the quantization lost. Error feedback keeps the
compression unbiased over time: SGD and Adam see a telescoping sum whose
error stays bounded. Under a data-parallel reduce the int8 tree is what
crosses the wire; on one card `make_train_step` quantizes and dequantizes
in place of it.

Trees are dicts and lists of tensors (the port's parameter trees). The
arithmetic is the reference's, elementwise PyTorch: `torch.round` rounds
half to even, as `jnp.round` does.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.train.optim import _unzip, tree_map


def ef_init(params):
    """A zero f32 residual for every leaf of `params`."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_grads(grads, ef):
    """Returns (int8 tree, f32 scale tree, new error-feedback tree)."""
    def comp(g, e):
        corrected = g.to(torch.float32) + e
        q, scale = _quantize(corrected)
        recon = q.to(torch.float32) * scale
        return q, scale, corrected - recon

    return _unzip(grads, tree_map(comp, grads, ef), 3)


@torch.no_grad()
def decompress_grads(q_tree, scale_tree, dtype=torch.float32):
    """q · scale per leaf, in f32 (`dtype` is accepted and, as in the
    reference, not read)."""
    return tree_map(lambda q, s: q.to(torch.float32) * s, q_tree, scale_tree)
