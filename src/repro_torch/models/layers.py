"""Transformer building blocks of the LM path: RMSNorm, RoPE and
Qwen2-VL's multimodal M-RoPE, GQA attention through the flash kernel
(differentiable: its backward is the hand-written backward kernel), within
a sliding window and with an attention softcap where the config asks
(Gemma-2), with the vision block's bidirectional prefix under M-RoPE
(Qwen2-VL), against a KV cache (`cache=`) or an encoder's K/V
(`cross_kv=`, the encoder-decoder's cross-attention and SeamlessM4T's
bidirectional encoder), SwiGLU MLP, and the top-k MoE feed-forward with
the reference's capacity-bounded dispatch (Mixtral 8x22B, Kimi K2).

Conventions, as in `repro.models.layers`:
  * params are dicts of tensors; weights stored (in_dim, out_dim).
  * activations (B, S, D); attention internals (B, H, S, hd).
  * every function takes `cfg` first where it needs one.
  * mixed operands promote as JAX promotes them (`matmul`, `mm`): a f32
    activation times a bf16 weight is a f32 product.

Left out, raising where the reference would take it: a key mask for
cross-attention (`cross_mask`; no reference caller passes one, and the
kernels take no per-row key mask).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the promoted dtype of the two, as `jnp.matmul` (the
    reference's `@`) computes a product of mixed operands: f32 times bf16
    is a f32 product. `torch.matmul` itself refuses mixed dtypes."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return a @ b


def matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Matmul in the activation dtype: bf16 in, bf16 out, the products
    summed in f32 by cuBLAS on the card (the reference pins its dot to the
    activation dtype for the same wire width). Mixed operands multiply in
    their promoted dtype, as `jnp.dot` promotes them, and the product
    takes a's dtype (the reference's preferred_element_type): the encoder
    of a bf16 SeamlessM4T runs in f32 on the f32 frames `serve` feeds it."""
    if a.dtype != w.dtype:
        return mm(a, w).to(a.dtype)
    return torch.matmul(a, w)


def split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """t (B, S, heads·hd) → (B, heads, S, hd). Under DTensor a last dim
    sharded over more ranks than it has heads cannot be split (a shard
    would hold part of a head: Yi-6B's 4 KV heads over a model axis of
    16), so that dim is replicated first, as GSPMD re-lays it out."""
    b, s, width = t.shape
    return ops.fit_groups(t, 2, heads).reshape(
        b, s, heads, width // heads).transpose(1, 2)


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


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE: x (B, H, S, hd), positions (3, B, S)
    int, the temporal, height and width ids. The hd/2 frequency slots are
    split into `sections` (t, h, w); each slot rotates by its section's
    position stream, the angles in f32 as the reference's. Where the three
    ids are equal (text) it is `apply_rope`."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2 or len(sections) != 3:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must be three "
                         f"that sum to hd/2 = {hd // 2}")
    if positions.dim() != 3 or positions.shape[0] != 3:
        raise ValueError(f"M-RoPE positions must be (3, B, S), got "
                         f"{tuple(positions.shape)}")
    freqs = _rope_freqs(hd, theta, x.device)                  # (hd/2,)
    # Each slot's id stream, by slicing (a DTensor takes no tensor index).
    pos = positions.float()
    pos_per_slot = torch.cat([pos[i:i + 1].expand(n, -1, -1)
                              for i, n in enumerate(sections)])  # (hd/2,B,S)
    ang = pos_per_slot.permute(1, 2, 0)[:, None] * freqs      # (B,1,S,hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mrope_prefix(cfg: ArchConfig, positions: torch.Tensor) -> int:
    """The flash kernels' bidirectional prefix P for M-RoPE `positions`
    (3, B, S): `cfg.n_vision_tokens`. The reference masks by the temporal
    ids (key j valid for query i iff t_j <= t_i); its `_build_positions`
    gives the first P positions t = 0 and text position i t = i - P + 1,
    for which that is key j <= max(i, P - 1) by index, the kernels' mask.
    Raises ValueError for temporal ids of any other layout, and for S < P,
    where the reference cannot build positions either. Under a trace
    (`torch.compile`, the dry run), where the ids are values the trace
    cannot read and the model's own `_build_positions` made them, the
    layout is not checked: P is the config's."""
    if positions.dim() != 3 or positions.shape[0] != 3:
        raise ValueError(f"{cfg.name}: M-RoPE positions must be (3, B, S), "
                         f"got {tuple(positions.shape)}")
    nv, s = cfg.n_vision_tokens, positions.shape[-1]
    if s < nv:
        raise ValueError(f"{cfg.name}: {s} positions, fewer than the "
                         f"{nv} vision tokens")
    if torch.compiler.is_compiling():
        return nv
    want = torch.clamp_min(torch.arange(s, device=positions.device) - nv + 1,
                           0)
    if not torch.equal(positions[0], want.to(positions.dtype).expand_as(
            positions[0])):
        raise ValueError(f"{cfg.name}: the temporal position ids are not "
                         f"{nv} zeros then 1, 2, ... (_build_positions): "
                         "the flash kernels mask by index, which equals the "
                         "reference's mask by temporal id only for that "
                         "layout")
    return nv


def attention(
    cfg: ArchConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                     # (B, S, D)
    positions: torch.Tensor,             # (B, S) or (3, B, S) for M-RoPE
    *,
    sliding_window: Optional[int] = None,
    cache: Optional[Dict[str, Any]] = None,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cross_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """GQA attention through `ops.flash_attention`, as the reference's
    `attention`: causal self-attention over the sequence, or against a KV
    cache (`cache`), or cross-attention over an encoder's K/V (`cross_kv`).
    KV heads are repeated to hq as in the reference (`repeat_interleave`,
    so autograd sums dK and dV over each group, as `jnp.repeat`'s
    transpose does); the kernel never materializes the scores, so the
    reference's query chunking has no counterpart. The kernel softcaps the
    scores by `cfg.attn_softcap` before the mask, as the reference's
    `_attn_core` does. Returns (out (B, S, D) in x's dtype, the new cache
    or None).

    Self-attention: `positions` are the tokens' positions 0..S-1
    (`transformer._build_positions`): RoPE reads them; the causal mask, and
    with `sliding_window` w the window (keys j > i - w), are by index.
    Under M-RoPE (`cfg.mrope_sections`) positions are (3, B, S), q and k
    rotate by `apply_mrope`, and the causal mask has the bidirectional
    prefix of `mrope_prefix`: the reference's mask by temporal id, which
    makes the vision block attend to itself in both directions.

    `cross_kv` = (k, v), each (B, n_kv_heads, Sk, hd), already projected:
    no RoPE on q or k, no mask (every key is valid), `cache` ignored, as
    in the reference. q is projected from x; the kernel runs in the
    promoted dtype of q, k and v (f32 K/V from a f32 encoder output give a
    f32 q, exactly its bf16 values, on the f32 route), as `_attn_core`
    computes the scores in f32 and the probabilities in v's dtype. At
    S = 1 without autograd (the decode step) the decode kernel takes it,
    one query per head over lens = Sk keys; otherwise the flash kernel,
    non-causal, with a key length of its own. `cross_mask` (a per-row key
    mask, which no reference caller passes) raises NotImplementedError.

    `cache` = {"k", "v": (B, n_kv_heads, L, hd), "len": an int or a 0-d
    tensor, read on the host once a call}: this call's K and V (after
    RoPE) are written at [len, len + S) of the cache tensors, in place, and
    the returned cache holds the same tensors with "len" = len + S (the
    reference returns new arrays). The queries attend causally over the
    first len + S keys, query i at key position len + i (the reference's
    mask kv_pos <= q_pos & kv_pos < len + S), within the window where
    given. The kernel masks by index and the reference by position, so
    positions other than len + arange(S) raise ValueError (for M-RoPE, the
    temporal ids), as does len + S past the cache.
    """
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1, got "
                         f"{sliding_window}")
    if cross_mask is not None:
        raise NotImplementedError(
            "cross_mask (a per-row key mask for cross-attention) is not "
            "ported: no caller of the reference passes one, and the flash "
            "and decode kernels take no per-row key mask")
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    group = hq // hkv
    softcap = cfg.attn_softcap

    q = split_heads(matmul(x, p["wq"]), hq)
    new_cache = None
    window, causal, prefix = sliding_window or 0, True, 0
    if cross_kv is not None:
        k, v = cross_kv
        dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                 v.dtype)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
        if s == 1 and not (torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v))):
            lens = torch.full((b,), k.shape[2], dtype=torch.int32,
                              device=q.device)
            out = ops.decode_attention(q[:, :, 0], k, v, lens,
                                       softcap=softcap)
            out = out.reshape(b, 1, hq * hd)
            return matmul(out.to(x.dtype), p["wo"]), None
        window, causal = 0, False
    else:
        k = split_heads(matmul(x, p["wk"]), hkv)
        v = split_heads(matmul(x, p["wv"]), hkv)
        if cfg.mrope_sections is not None:
            if cache is None:
                prefix = mrope_prefix(cfg, positions)
            q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
            k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        if cache is not None:
            k, v, new_cache = _cache_write(cache, k, v, positions)
            dt = torch.promote_types(q.dtype, k.dtype)
            q, k, v = q.to(dt), k.to(dt), v.to(dt)
    if group > 1:
        k, v = _repeat_kv(k, group), _repeat_kv(v, group)
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap, prefix=prefix)
    out = ops.merge_heads(out.transpose(1, 2))
    return matmul(out.to(x.dtype), p["wo"]), new_cache


def _repeat_kv(t: torch.Tensor, group: int) -> torch.Tensor:
    """Each KV head of t (B, n_kv, S, hd) repeated `group` times along the
    heads. Under DTensor the repeated heads keep t's layout, so that their
    gradient comes back to it before the repeat's backward folds the group
    (DTensor cannot fold heads sharded over more ranks than there are KV
    heads); a no-op forward."""
    out = torch.repeat_interleave(t, group, dim=1)
    if hasattr(t, "device_mesh"):
        from torch.distributed.tensor import Replicate
        out = out.redistribute(t.device_mesh, [
            Replicate() if p.is_partial() else p for p in t.placements])
    return out


def _replicate(t: torch.Tensor) -> torch.Tensor:
    """A DTensor replicated on every mesh axis; a plain tensor as it is."""
    mesh = getattr(t, "device_mesh", None)
    if mesh is None:
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(mesh, [Replicate()] * mesh.ndim)


def _cache_write(cache: Dict[str, Any], k: torch.Tensor, v: torch.Tensor,
                 positions: torch.Tensor) -> tuple:
    """Write k, v (B, n_kv, S, hd) at [len, len + S) of the cache, in
    place: (the cache's first len + S keys and values, the new cache).
    Raises ValueError where the kernel's mask by index would not be the
    reference's mask by position, or the cache is too short."""
    idx = cache["len"]
    n, s = int(idx), k.shape[2]
    cap = cache["k"].shape[2]
    if n < 0 or n + s > cap:
        raise ValueError(f"a cache of {cap} positions cannot take {s} more "
                         f"at len {n}")
    q_pos = positions if positions.dim() == 2 else positions[0]
    want = torch.arange(n, n + s, device=q_pos.device)
    if not torch.equal(q_pos, want.to(q_pos.dtype).expand_as(q_pos)):
        raise ValueError(f"attention with a cache takes the positions len + "
                         f"arange(S) = {n}..{n + s - 1} (the kernel masks by "
                         f"index, the reference by position), got "
                         f"{q_pos.tolist()}")
    ck, cv = cache["k"], cache["v"]
    ck[:, :, n:n + s] = k.to(ck.dtype)
    cv[:, :, n:n + s] = v.to(cv.dtype)
    return (ck[:, :, :n + s], cv[:, :, :n + s],
            {"k": ck, "v": cv, "len": idx + s})


def mlp(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """SwiGLU feed-forward."""
    return matmul(F.silu(matmul(x, p["w_gate"])) * matmul(x, p["w_up"]),
                  p["w_down"])


def moe_ffn(cfg: ArchConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
            mesh_axes=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE with the reference's sort-based, capacity-bounded
    dispatch: returns (out (B, S, D) in x's dtype, Switch aux loss f32).

    Step by step as `repro.models.layers.moe_ffn`: the router softmax in
    f32, top-k (ties to the lower expert), the k weights renormalised; aux = e·Σ(me·ce)/k; capacity
    cap = max(1, int(cf·T·k/e)) rounded up to a multiple of 64; each
    (token, slot) assignment's rank in its expert from a stable argsort,
    the histogram and its starts; an assignment ranked at or past cap is
    dropped (weight 0, its row the last slot's); each slot gathers its
    token (the zero row for an empty slot); the experts run as three
    batched products; each token sums its k weighted rows in slot order,
    which is the reference's `.at[tok_id].add` with tok_id = repeat(
    arange(T), k), with no atomics. The histogram is a scatter-add into E
    counts, the same integers as `bincount`, of a shape that does not
    depend on the data (so a trace takes it, and the card does not wait).
    With `mesh_axes` the dispatched rows and the experts' outputs (E, cap,
    d) are hinted experts over "model", slots over the data axes, as the
    reference's two `with_sharding_constraint`s (`transformer._shard`).
    """
    from repro_torch.models.transformer import _shard
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    # Under the hints xf stays at x's layout (tokens over the data axes;
    # a no-op forward) so that its gradient comes back there: DTensor's
    # reshape cannot take a gradient split over both mesh axes back to
    # (B, S, D).
    xf = _shard(x.reshape(t, d), mesh_axes, ("data", None))
    dev = x.device

    gate_logits = matmul(xf, p["w_router"])                      # (T, E)
    probs = torch.softmax(gate_logits.float(), dim=-1)
    # top-k as `lax.top_k` breaks ties, the lower expert first (a stable
    # sort; `torch.topk` promises no order among equal values, and bf16
    # router logits tie often).
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]                    # (T, k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    flat_e = top_e.reshape(-1)                                   # (T·k,)
    flat_w = top_p.reshape(-1)
    hist = torch.zeros(e, dtype=torch.int64, device=dev).scatter_add(
        0, flat_e, torch.ones_like(flat_e))
    # Load-balancing auxiliary loss (Switch-style); ce is the mean over
    # tokens of each expert's one-hot count.
    me = probs.mean(dim=0)
    ce = hist.float() / t
    aux = e * torch.sum(me * ce) / k

    cap = max(1, int(cfg.capacity_factor * t * k / e))
    cap = ((cap + 63) // 64) * 64
    order = torch.argsort(flat_e, stable=True)
    starts = torch.cumsum(hist, 0) - hist
    ranks_sorted = torch.arange(t * k, device=dev) - starts[flat_e[order]]
    pos = torch.empty_like(ranks_sorted).index_put((order,), ranks_sorted)
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(pos, e * cap))
    # Token ids into slots (kept slots are distinct), the dropped ones
    # into the pad slot e·cap, which no expert reads; then gather rows.
    token_for_slot = torch.full((e * cap + 1,), t, dtype=torch.long,
                                device=dev).index_put(
        (slot,), torch.arange(t, device=dev).repeat_interleave(k))
    # An empty slot holds token id t and takes the zero row, as the
    # reference's gather from [xf; 0] gives it (a where, not that
    # concatenation: T + 1 rows do not shard evenly under the hints).
    token_for_slot = token_for_slot[:e * cap]
    dispatched = torch.where((token_for_slot < t)[:, None],
                             xf[token_for_slot.clamp_max(t - 1)], 0.0)
    dispatched = ops.fit_groups(dispatched, 0, e).reshape(e, cap, d)
    dispatched = _shard(dispatched, mesh_axes, ("model", "data", None))

    hidden = F.silu(torch.bmm(dispatched, p["w_gate"])) \
        * torch.bmm(dispatched, p["w_up"])
    expert_out = _shard(torch.bmm(hidden, p["w_down"]), mesh_axes,
                        ("model", "data", None))
    # Row (expert, rank) of each kept assignment; a dropped one reads the
    # last slot's row, weighted by 0, as the reference's gather clamps its
    # out-of-range slot e·cap. Two indices, not the flat slot: the (E, cap)
    # axes are sharded over two mesh axes under the hints; and under
    # DTensor both replicated (T·k integers), as torch 2.11's DTensor
    # cannot gather by an index sharded over two mesh axes beside another.
    rows = [_replicate(i) for i in (torch.where(keep, flat_e, e - 1),
                                    torch.where(keep, pos, cap - 1))]
    gathered = expert_out[rows[0], rows[1]] \
        * (flat_w * keep)[:, None].to(x.dtype)
    gathered = gathered.reshape(t, k, d)
    out = gathered[:, 0]
    for j in range(1, k):                # the reference's order of adds
        out = out + gathered[:, j]
    return out.reshape(b, s, d), aux
