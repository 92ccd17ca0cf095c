"""Public wrappers around the kernels: natural shapes in, the padding rows
of the Block-ELL kernels stripped on the way out, the GQA grouping of the
decode kernel done inside."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attn as _decode_mod
from repro_torch.kernels import flash_attn as _flash_mod
from repro_torch.kernels.bcsr_spmm import (
    bcsr_spmm_blocks,
    fused_gcn_layer_blocks,
)
from repro_torch.kernels.decode_attn import decode_attention_blocks
from repro_torch.kernels.flash_attn import flash_attention_blocks
from repro_torch.sparse.formats import BlockELL


_DTENSOR_RULES = []


def register_dtensor_rules() -> None:
    """The attention operators' DTensor sharding rules, registered once,
    by the first caller that works with DTensors (`transformer.
    register_dtensor_rules`): importing DTensor takes about a second, which
    a process that never uses it does not pay."""
    if not _DTENSOR_RULES:
        _flash_mod.register_sharding()
        _decode_mod.register_sharding()
        _DTENSOR_RULES.append(True)


def fit_groups(t: torch.Tensor, dim: int, groups: int) -> torch.Tensor:
    """t with `dim` replicated on each mesh axis whose shards would cut
    one of its `groups` groups (a DTensor's; a plain tensor as it is):
    DTensor cannot split a dim sharded over more ranks than it has groups
    (Yi-6B's 4 KV heads, Mixtral's 8, over a model axis of 16)."""
    mesh = getattr(t, "device_mesh", None)
    if mesh is None:
        return t
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if p.is_shard(dim) and groups % mesh.size(i) else p
          for i, p in enumerate(t.placements)]
    return t if pl == list(t.placements) else t.redistribute(mesh, pl)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(..., H, hd) → (..., H · hd), the heads side by side. A DTensor
    whose heads are not sharded (`fit_groups` replicated them) is merged
    by concatenation, whose backward slices the gradient, where a
    reshape's backward would split a gradient DTensor may have sharded
    over more ranks than there are heads; anything else by a reshape."""
    if hasattr(t, "placements") and not any(
            p.is_shard(t.dim() - 2) for p in t.placements):
        return torch.cat(t.unbind(-2), dim=-1)
    return t.reshape(*t.shape[:-2], t.shape[-2] * t.shape[-1])


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


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lens: torch.Tensor,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """GQA flash-decode. q (B, n_q_heads, d), k and v (B, n_kv_heads, S, d),
    lens (B,) valid positions per sequence; `softcap` c turns each score x
    into c · tanh(x / c) (None: no softcap). Returns (B, n_q_heads, d) in
    q's dtype.

    The reference's `block_s` and `interpret` arguments are TPU-only and
    not taken; nor is the cache padded to a block multiple, as the
    reference wrapper does: the kernel masks by `lens`.
    """
    b_sz, n_q, d = q.shape
    n_kv = k.shape[1]
    if n_q % n_kv:
        raise ValueError(f"{n_q} query heads do not group over {n_kv} KV "
                         "heads")
    qg = fit_groups(q, 1, n_kv).reshape(b_sz, n_kv, n_q // n_kv,
                                        d).contiguous()
    out = decode_attention_blocks(
        qg, k.contiguous(), v.contiguous(),
        lens.to(device=q.device, dtype=torch.int32).contiguous(), softcap)
    return out.reshape(b_sz, n_q, d)


def decode_scores(q: torch.Tensor, k: torch.Tensor,
                  lens: torch.Tensor) -> torch.Tensor:
    """The decode's scores over a slice of the head dim: q (B, n_kv, group,
    d'), k (B, n_kv, S, d') the slice's d' head dims, lens (B,) valid
    positions per sequence; (B, n_kv, group, S) float32, q · k unscaled at
    positions < lens[b], 0 past them. Summed over the slices, they are the
    scores `decode_softmax_v` takes."""
    return _decode_mod.decode_scores(
        q.contiguous(), k.contiguous(),
        lens.to(device=q.device, dtype=torch.int32).contiguous())


def decode_softmax_v(s: torch.Tensor, v: torch.Tensor, lens: torch.Tensor,
                     scale: float,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """The rest of the decode over a slice of the head dim: the summed
    scores s (B, n_kv, group, S) float32 times `scale`, softcapped by
    `softcap` (None: none), softmaxed over the first lens[b] positions and
    applied to v (B, n_kv, S, d'); (B, n_kv, group, d') in v's dtype."""
    return _decode_mod.decode_softmax_v(
        s.contiguous(), v.contiguous(),
        lens.to(device=v.device, dtype=torch.int32).contiguous(), scale,
        softcap)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: Optional[float] = None,
                    prefix: int = 0) -> torch.Tensor:
    """Flash attention of q (B, H, Sq, d) over k, v (B, H, Sk, d) — the
    prefill hot spot. Query i sits at key position i + Sk - Sq: with
    `causal` key j is valid for it iff j <= i + Sk - Sq (Sk >= Sq; Sk > Sq
    is attention against a KV cache of Sk - Sq earlier positions), and
    with a `window` w iff also j > i + Sk - Sq - w; without `causal` every
    key is valid (the encoder-decoder's encoder at Sq = Sk and its
    cross-attention at Sq != Sk). `softcap` c turns each score x into
    c · tanh(x / c) (None: no softcap; under autograd the backward kernel
    carries the cap); with `causal` and Sq = Sk, the first `prefix`
    positions attend to each other in both directions (key j valid for
    query i iff j <= max(i, prefix - 1): the reference's M-RoPE vision
    block; 0 is plain causal attention). Returns (B, H, Sq, d) in q's
    dtype.

    The reference's `block_q`, `block_k` and `interpret` arguments are
    TPU-only and not taken, and its kernel takes one S; neither length
    need be a multiple of any block here.
    """
    return flash_attention_blocks(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal,
                                  window=window, softcap=softcap,
                                  prefix=prefix)
