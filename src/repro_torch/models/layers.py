"""Transformer building blocks of the dense LM path: RMSNorm, RoPE, GQA
self-attention through the flash kernel (differentiable: its backward is
the hand-written backward kernel), within a sliding window and with an
attention softcap where the config asks (Gemma-2), SwiGLU MLP.

Conventions, as in `repro.models.layers`:
  * params are dicts of tensors; weights stored (in_dim, out_dim).
  * activations (B, S, D); attention internals (B, H, S, hd).
  * every function takes `cfg` first where it needs one.

Not ported yet (ROADMAP.md queue 1 item 8), each raising where the
reference would take it: M-RoPE (`apply_mrope`), the MoE feed-forward
(`moe_ffn`), attention with a KV cache (`cache=`; the decode path attends
through `transformer.decode_step`) or with encoder K/V (`cross_kv=`), and
the softcap's backward (a softcapped attention under autograd raises).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig

_ITEM = "ROADMAP.md queue 1 item 8"


def matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Matmul in the activation dtype: bf16 in, bf16 out, the products
    summed in f32 by cuBLAS on the card (the reference pins its dot to the
    activation dtype for the same wire width)."""
    return torch.matmul(a, w)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + eps) * (1.0 + scale)).to(x.dtype)


def _rope_freqs(hd: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, H, S, hd), positions (B, S) int — rotary embedding over the two
    halves of the head dim (not interleaved)."""
    hd = x.shape[-1]
    freqs = _rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[:, None, :, None].float() * freqs         # (B,1,S,hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions, theta, sections):
    raise NotImplementedError(f"M-RoPE is not ported yet ({_ITEM})")


def attention(
    cfg: ArchConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                     # (B, S, D)
    positions: torch.Tensor,             # (B, S)
    *,
    sliding_window: Optional[int] = None,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cross_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, None]:
    """Causal GQA self-attention over the whole sequence through
    `ops.flash_attention`. KV heads are repeated to hq as in the
    reference (`repeat_interleave`, so autograd sums dK and dV over each
    group, as `jnp.repeat`'s transpose does); the kernel never materializes
    the S×S scores, so the reference's query chunking has no counterpart.

    `positions` are the tokens' positions 0..S-1 (`transformer.
    _build_positions`): RoPE reads them; the causal mask, and with
    `sliding_window` w the window (keys j > i - w), are by index. The
    kernel softcaps the scores by `cfg.attn_softcap` before the mask, as
    the reference's `_attn_core` does. Returns (out (B, S, D), None): there
    is no cache to return.
    """
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1, got "
                         f"{sliding_window}")
    if cache is not None:
        raise NotImplementedError(
            f"attention with a KV cache is not ported yet ({_ITEM}); "
            "decode through transformer.decode_step")
    if cross_kv is not None or cross_mask is not None:
        raise NotImplementedError(
            f"cross-attention (encoder-decoder) is not ported yet ({_ITEM})")
    if cfg.mrope_sections is not None:
        apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    group = hq // hkv

    q = matmul(x, p["wq"]).reshape(b, s, hq, hd).transpose(1, 2)
    k = matmul(x, p["wk"]).reshape(b, s, hkv, hd).transpose(1, 2)
    v = matmul(x, p["wv"]).reshape(b, s, hkv, hd).transpose(1, 2)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if group > 1:
        k = torch.repeat_interleave(k, group, dim=1)
        v = torch.repeat_interleave(v, group, dim=1)
    out = ops.flash_attention(q, k, v, causal=True,
                              window=sliding_window or 0,
                              softcap=cfg.attn_softcap)
    out = out.transpose(1, 2).reshape(b, s, hq * hd)
    return matmul(out.to(x.dtype), p["wo"]), None


def mlp(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """SwiGLU feed-forward."""
    return matmul(F.silu(matmul(x, p["w_gate"])) * matmul(x, p["w_up"]),
                  p["w_down"])


def moe_ffn(cfg: ArchConfig, p, x, mesh_axes=None):
    raise NotImplementedError(f"the MoE feed-forward is not ported yet "
                              f"({_ITEM})")
