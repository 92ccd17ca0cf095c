"""GQA flash-decode: the hand-written CUDA kernels (`csrc/decode_attn.cu`,
replaces the TPU kernel `repro.kernels.decode_attn.decode_attention_pallas`)
beside their plain PyTorch version.

    out[b, h, g] = Σ_{t < lens[b]} softmax_t(q[b, h, g] · k[b, h, t] / √d)
                   v[b, h, t]

softmax and accumulator in float32, the output in q's dtype; a sequence
with lens[b] = 0 gives 0. q is (B, n_kv, group, d), k and v (B, n_kv, S, d),
one dtype (float32, float16 or bfloat16), lens (B,) int32; d <= 256,
group <= 16. Positions at or past lens[b] are masked, never read: the cache
needs no padding. With an attention softcap c each valid score x becomes
c · tanh(x / c) before the softmax, as in the reference's `_decode_attn`.
The kernel only serves, so it takes no gradient (`no_grad_guard`).

On the card the cache axis is cut into splits, each a thread block, and a
second kernel combines them; `DECODE_LAUNCHES` counts the pair as one. f16
and bf16 take the tensor-core split kernel, f32 the f32 FMA one
(`flash_attn.ROUTES`).
The kernels are the operator `torch.ops.repro_torch.decode_attn`, which
dispatches on where the tensors lie: CPU tensors take the plain version,
CUDA tensors launch the kernels or raise, meta and fake tensors get a
shape, and a DTensor's local shards take one of those.

Where the caches are sharded along the head dim, a rank holds q, k and v
for d' of the d head dims, and the decode is cut at the sum of the scores
over the ranks (`csrc/decode_attn_hd.cu`, the same TPU kernel's other
half):

    decode_scores     s[b, h, g, t] = q[b, h, g] · k[b, h, t]  (t < lens[b],
                                      else 0), float32
    decode_softmax_v  out[b, h, g] = Σ_{t < lens[b]} softmax_t(cap(s·scale))
                                     v[b, h, t], in v's dtype

with the caller's all-reduce of s between them (`models.transformer.
_decode_attn_split_hd`). Each is an operator as `decode_attn` is, counted
once a call in `DECODE_HD_LAUNCHES`: `decode_scores` blocks over chunks of
positions, by the route its C entry point picks (`HD_SCORES_ROUTES`: "mma",
the tensor cores, for f16 and bf16 at d' a multiple of 16, else "fma"),
`decode_softmax_v` a split kernel over the positions and the decode's
combine kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.build import entry
from repro_torch.kernels.flash_attn import (
    DTYPE_CODES,
    MAX_HEAD_DIM,
    ROUTES,
    apply_softcap,
    no_grad_guard,
    softcap_value,
)

# Calls of `decode_attention_cuda` in this process (split + combine each),
# in all, by route, with a softcap and at d > 128.
DECODE_LAUNCHES = 0
DECODE_ROUTE_LAUNCHES = {"tensor_core": 0, "f32_fma": 0}
DECODE_SOFTCAP_LAUNCHES = 0
DECODE_WIDE_LAUNCHES = 0     # at head dims 129-256 (NC = 16)
# Launches of the head-dim-slice kernels (csrc/decode_attn_hd.cu), and of
# decode_scores by the route its C entry point took (`HD_SCORES_ROUTES`).
DECODE_HD_LAUNCHES = {"decode_scores": 0, "decode_softmax_v": 0}
HD_SCORES_ROUTES = ("fma", "mma")
DECODE_HD_SCORES_ROUTE_LAUNCHES = dict.fromkeys(HD_SCORES_ROUTES, 0)

MAX_GROUP = 16         # must match MAX_GROUP in csrc/decode_attn.cu
TILE = 64              # cache positions per shared tile (TILE in the source)
# Split blocks wanted for each SM of the card: two 16-bit split blocks fit
# on an SM at d <= 128 (100 KiB of shared memory each at d = 128), so 8 is
# four waves, and the last, partly filled wave costs a quarter of one at
# most. At d = 256 a block takes 200 KiB (three stages of 64-position K and
# V tiles, each twice as wide; two stages would still not fit twice), one
# block an SM, so 4 is the same four waves.
BLOCKS_PER_SM = 8
BLOCKS_PER_SM_WIDE = 4
_MAX_CHUNK = 4096      # positions per split, so long caches split anyway
# The head-dim-slice kernels' blocks (256 threads; eight fit on an SM)
# wanted for each SM: two waves. decode_scores' chunks are multiples of
# HD_SCORES_STEP positions (a block's step); decode_softmax_v's splits are
# multiples of 32 and at most HD_SPLIT_MAX, their group x chunk f32 scores
# in at most HD_SPLIT_SMEM bytes of shared memory.
HD_BLOCKS_PER_SM = 16
HD_SCORES_STEP = 256
HD_SPLIT_MAX = 512
HD_SPLIT_SMEM = 48 * 1024


def _check(q, k, v, lens) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, n_kv, group, d) and k, v "
                         f"(B, n_kv, S, d), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, n_kv, _, d = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, n_kv, d):
        raise ValueError(f"k, v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k.shape[2] < 1:
        raise ValueError("the cache must hold at least one position")
    if tuple(lens.shape) != (b,) or lens.dtype != torch.int32:
        raise ValueError(f"lens must be ({b},) int32, got "
                         f"{tuple(lens.shape)} {lens.dtype}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(DTYPE_CODES)}, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device, lens.device}) != 1:
        raise ValueError("q, k, v and lens must lie on one device")


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lens: torch.Tensor,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """The plain PyTorch version: all S scores in float32, softcapped where
    asked, positions at or past lens[b] masked, the kernel's guard for
    lens[b] = 0."""
    _check(q, k, v, lens)
    s_len, d = k.shape[2], q.shape[3]
    logits = torch.einsum("bhgd,bhsd->bhgs", q.float(), k.float()) \
        * (1.0 / d ** 0.5)
    logits = apply_softcap(logits, softcap_value(softcap))
    valid = torch.arange(s_len, device=q.device)[None, :] < lens[:, None]
    logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - torch.where(torch.isfinite(m), m, 0.0))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return (torch.einsum("bhgs,bhsd->bhgd", p, v.float()) / denom).to(q.dtype)


@functools.lru_cache(maxsize=None)
def split_plan(b: int, n_kv: int, s_len: int, n_sm: int,
               d: int = 128) -> tuple:
    """(chunk, n_splits): positions per split, a multiple of TILE, and the
    number of splits. Enough splits for BLOCKS_PER_SM blocks
    (BLOCKS_PER_SM_WIDE at head dims d > 128) on each of the card's `n_sm`
    SMs, and none longer than _MAX_CHUNK, but never less than one tile
    each. Cached per shape: a decode step asks once per layer."""
    per_sm = BLOCKS_PER_SM if d <= 128 else BLOCKS_PER_SM_WIDE
    tiles = -(-s_len // TILE)
    want = max(-(-per_sm * n_sm // (b * n_kv)),
               -(-s_len // _MAX_CHUNK))
    chunk = max(1, tiles // want) * TILE
    return chunk, -(-s_len // chunk)


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The card's SM count, read once per device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _launch_fn():
    return entry("decode_attn_launch",
                 [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                 + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            lens: torch.Tensor, softcap: float) -> torch.Tensor:
    """Launch the split and combine kernels on PyTorch's current stream (no
    synchronise): the CUDA implementation of `decode_attn`. Returns (B,
    n_kv, group, d) in q's dtype; raises on any operand the kernels do not
    take. `lens` stays on the card: no host sync. The SM count and the
    split plan are cached, and the scratch is one allocation from PyTorch's
    caching allocator (allocations were the largest part of the wrapper's
    host time, as scripts/decode_wrapper_time.py measures it)."""
    global DECODE_LAUNCHES, DECODE_SOFTCAP_LAUNCHES, DECODE_WIDE_LAUNCHES
    _check(q, k, v, lens)
    cap = softcap_value(softcap or None)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    for name, t in (("q", q), ("k", k), ("v", v), ("lens", lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, n_kv, group, d = q.shape
    s_len = k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}")
    if group > MAX_GROUP:
        raise ValueError(f"{group} query heads per KV head > {MAX_GROUP}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    chunk, n_splits = split_plan(b, n_kv, s_len, sm_count(q.device.index), d)
    # One f32 scratch allocation (its parts are read and written as scalars):
    # m_part and l_part (b, n_kv, n_splits, group), acc_part (..., d).
    n_part = b * n_kv * n_splits * group
    scratch = torch.empty(n_part * (2 + d), dtype=torch.float32,
                          device=q.device)
    m_part, l_part = scratch.data_ptr(), scratch.data_ptr() + 4 * n_part
    fn = _launch_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                 m_part, l_part, l_part + 4 * n_part, out.data_ptr(), b,
                 n_kv, group, s_len, d, chunk, n_splits, 1.0 / d ** 0.5, cap,
                 DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"decode_attn kernel launch failed: CUDA error "
                           f"{err}")
    DECODE_LAUNCHES += 1
    DECODE_ROUTE_LAUNCHES[ROUTES[q.dtype]] += 1
    if cap:
        DECODE_SOFTCAP_LAUNCHES += 1
    if d > 128:
        DECODE_WIDE_LAUNCHES += 1
    return out


# The kernels as the operator `torch.ops.repro_torch.decode_attn` (q, k, v,
# lens, softcap) → out, softcap 0.0 for none: the kernels as its CUDA
# implementation (counted), the plain version as its CPU one, a fake
# implementation, a FLOP formula and a DTensor sharding rule, as
# `flash_attn.LIB` registers the flash kernels. It has no autograd formula:
# the kernel only serves, and `decode_attention_cuda` refuses a graph.
LIB = torch.library.Library("repro_torch", "FRAGMENT")
LIB.define("decode_attn(Tensor q, Tensor k, Tensor v, Tensor lens, "
           "float softcap) -> Tensor")
LIB.impl("decode_attn", _launch, "CUDA")
LIB.impl("decode_attn", lambda q, k, v, lens, softcap: decode_attention_plain(
    q, k, v, lens, softcap or None), "CPU")


@torch.library.register_fake("repro_torch::decode_attn")
def _decode_attn_fake(q, k, v, lens, softcap):
    _check(q, k, v, lens)
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.decode_attn)
def _decode_flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    """4·B·Hq·S·d, S the cache's length: the two products of the
    reference's `_decode_attn`, every cache position included. The kernel
    reads only the first lens[b] positions, so this is the reference's
    count, not the kernel's work."""
    b, n_kv, group, d = q_shape
    return 4 * b * n_kv * group * k_shape[2] * d


def register_sharding() -> None:
    """The operator's DTensor sharding rule (`ops.register_dtensor_rules`
    calls it once): batch (lens with it) and KV heads may be sharded; the
    cache's length and the head dim are not."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.decode_attn.default)
    def _rule(q, k, v, lens, softcap):
        r, b, h = Replicate(), Shard(0), Shard(1)
        return [([r], [r, r, r, r, None]), ([b], [b, b, b, b, None]),
                ([h], [h, h, h, r, None])]


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lens: torch.Tensor,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """The kernels through `decode_attn` on CUDA tensors: (B, n_kv, group,
    d) in q's dtype. Raises on CPU tensors and where autograd would record
    the call, before any launch."""
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    return decode_attention_blocks(q, k, v, lens, softcap)


def decode_attention_blocks(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, lens: torch.Tensor,
                            softcap: Optional[float] = None) -> torch.Tensor:
    """`decode_attn`: the kernels for CUDA tensors, the plain version for CPU
    tensors, a shape for meta and fake ones, each local shard for a
    DTensor; refuses a graph (`no_grad_guard`)."""
    no_grad_guard("decode_attention_cuda", q, k, v)
    return torch.ops.repro_torch.decode_attn(q, k, v, lens,
                                             softcap_value(softcap))


# --------------------------------------------------------------------------
# The decode over a slice of the head dim: scores, then softmax · V.
# --------------------------------------------------------------------------

def _check_hd(q, k, lens) -> None:
    """q (B, n_kv, group, d) against k or v (B, n_kv, S, d) and lens (B,)
    int32, as `_check` holds them, with group <= MAX_GROUP and d <=
    MAX_HEAD_DIM."""
    _check(q, k, k, lens)
    if q.shape[2] > MAX_GROUP or q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"{q.shape[2]} query heads per KV head (at most "
                         f"{MAX_GROUP}) at head dim {q.shape[3]} (at most "
                         f"{MAX_HEAD_DIM})")


def _valid(lens: torch.Tensor, s_len: int) -> torch.Tensor:
    """(B, 1, 1, S): position t is valid for sequence b (t < lens[b])."""
    return (torch.arange(s_len, device=lens.device)[None, :]
            < lens[:, None])[:, None, None, :]


def decode_scores_plain(q: torch.Tensor, k: torch.Tensor,
                        lens: torch.Tensor) -> torch.Tensor:
    """The plain version of `decode_scores`: q · k over this slice of the
    head dim in float32, (B, n_kv, group, S), 0 at positions >= lens[b]."""
    _check_hd(q, k, lens)
    s = torch.einsum("bhgd,bhsd->bhgs", q.float(), k.float())
    return s.masked_fill(~_valid(lens, k.shape[2]), 0.0)


def decode_softmax_v_plain(s: torch.Tensor, v: torch.Tensor,
                           lens: torch.Tensor, scale: float,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """The plain version of `decode_softmax_v`: the summed scores s (B,
    n_kv, group, S) float32 scaled and softcapped, masked past lens[b],
    softmaxed and applied to v (B, n_kv, S, d); (B, n_kv, group, d) in v's
    dtype, 0 where lens[b] is 0."""
    _check_softmax_v(s, v, lens)
    logits = apply_softcap(s * scale, softcap_value(softcap))
    logits = logits.masked_fill(~_valid(lens, v.shape[2]), float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - torch.where(torch.isfinite(m), m, 0.0))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return (torch.einsum("bhgs,bhsd->bhgd", p, v.float()) / denom).to(v.dtype)


def _check_softmax_v(s, v, lens) -> None:
    if s.dim() != 4 or s.dtype != torch.float32 or v.dim() != 4 or \
            (s.shape[0], s.shape[1], s.shape[3]) != (v.shape[0], v.shape[1],
                                                     v.shape[2]):
        raise ValueError(f"s must be (B, n_kv, group, S) float32 over v "
                         f"(B, n_kv, S, d), got {tuple(s.shape)} {s.dtype}, "
                         f"{tuple(v.shape)}")
    if s.shape[2] > MAX_GROUP or v.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"{s.shape[2]} query heads per KV head (at most "
                         f"{MAX_GROUP}) at head dim {v.shape[3]} (at most "
                         f"{MAX_HEAD_DIM})")
    if tuple(lens.shape) != (s.shape[0],) or lens.dtype != torch.int32:
        raise ValueError(f"lens must be ({s.shape[0]},) int32, got "
                         f"{tuple(lens.shape)} {lens.dtype}")
    if v.dtype not in DTYPE_CODES:
        raise TypeError(f"v must be one of {list(DTYPE_CODES)}, got "
                        f"{v.dtype}")
    if len({s.device, v.device, lens.device}) != 1:
        raise ValueError("s, v and lens must lie on one device")


def _launch_hd(name: str, argtypes: list, out: torch.Tensor, *args):
    """Launch `name`'s kernel on PyTorch's current stream of out's card (no
    synchronise) and count it."""
    fn = entry(f"{name}_launch", argtypes)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    DECODE_HD_LAUNCHES[name] += 1
    return out


def _cuda_operands(name: str, *tensors) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name} needs CUDA tensors, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}'s operands must be contiguous")


@functools.lru_cache(maxsize=None)
def hd_scores_chunk(b: int, n_kv: int, s_len: int, n_sm: int) -> int:
    """Positions a `decode_scores` block takes: a multiple of
    HD_SCORES_STEP, short enough for HD_BLOCKS_PER_SM blocks on each of the
    card's `n_sm` SMs."""
    want = -(-HD_BLOCKS_PER_SM * n_sm // (b * n_kv))
    return -(-(-(-s_len // want)) // HD_SCORES_STEP) * HD_SCORES_STEP


@functools.lru_cache(maxsize=None)
def hd_split_plan(b: int, n_kv: int, group: int, s_len: int,
                  n_sm: int) -> tuple:
    """(chunk, n_splits) of `decode_softmax_v`: positions a split, a
    multiple of 32, at most HD_SPLIT_MAX and HD_SPLIT_SMEM bytes of scores,
    short enough for HD_BLOCKS_PER_SM blocks on each SM."""
    most = min(HD_SPLIT_MAX, HD_SPLIT_SMEM // (4 * group) // 32 * 32)
    want = -(-HD_BLOCKS_PER_SM * n_sm // (b * n_kv))
    chunk = min(most, -(-(-(-s_len // want)) // 32) * 32)
    return chunk, -(-s_len // chunk)


def _launch_scores(q, k, lens) -> torch.Tensor:
    """The CUDA implementation of `decode_scores`; counts the route its C
    entry point took."""
    _check_hd(q, k, lens)
    _cuda_operands("decode_scores", q, k, lens)
    b, n_kv, group, d = q.shape
    s_len = k.shape[2]
    out = torch.empty((b, n_kv, group, s_len), dtype=torch.float32,
                      device=q.device)
    chunk = hd_scores_chunk(b, n_kv, s_len, sm_count(q.device.index))
    route = ctypes.c_int(-1)
    _launch_hd(
        "decode_scores", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p], out,
        q.data_ptr(), k.data_ptr(), lens.data_ptr(), out.data_ptr(), b, n_kv,
        group, s_len, d, chunk, DTYPE_CODES[q.dtype], ctypes.byref(route))
    DECODE_HD_SCORES_ROUTE_LAUNCHES[HD_SCORES_ROUTES[route.value]] += 1
    return out


def _launch_softmax_v(s, v, lens, scale, softcap) -> torch.Tensor:
    """The CUDA implementation of `decode_softmax_v`: the split kernel and
    the combine, their f32 scratch one allocation."""
    _check_softmax_v(s, v, lens)
    _cuda_operands("decode_softmax_v", s, v, lens)
    b, n_kv, group, s_len = s.shape
    d = v.shape[3]
    out = torch.empty((b, n_kv, group, d), dtype=v.dtype, device=v.device)
    chunk, n_splits = hd_split_plan(b, n_kv, group, s_len,
                                    sm_count(v.device.index))
    # m_part and l_part (b, n_kv, n_splits, group), acc_part (..., d).
    n_part = b * n_kv * n_splits * group
    scratch = torch.empty(n_part * (2 + d), dtype=torch.float32,
                          device=v.device)
    m_part = scratch.data_ptr()
    return _launch_hd(
        "decode_softmax_v", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
        + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p], out,
        s.data_ptr(), v.data_ptr(), lens.data_ptr(), m_part,
        m_part + 4 * n_part, m_part + 8 * n_part, out.data_ptr(), b, n_kv,
        group, s_len, d, chunk, n_splits, float(scale),
        softcap_value(softcap or None), DTYPE_CODES[v.dtype])


# The two kernels as the operators `torch.ops.repro_torch.decode_scores` (q,
# k, lens) → s and `decode_softmax_v` (s, v, lens, scale, softcap) → out,
# softcap 0.0 for none: as `decode_attn`, the kernels for CUDA tensors, the
# plain versions for CPU ones, fake implementations and FLOP formulas. A
# caller gives them a rank's local tensors, so they need no DTensor rule.
LIB.define("decode_scores(Tensor q, Tensor k, Tensor lens) -> Tensor")
LIB.define("decode_softmax_v(Tensor s, Tensor v, Tensor lens, float scale, "
           "float softcap) -> Tensor")
LIB.impl("decode_scores", _launch_scores, "CUDA")
LIB.impl("decode_scores", decode_scores_plain, "CPU")
LIB.impl("decode_softmax_v", _launch_softmax_v, "CUDA")
LIB.impl("decode_softmax_v", lambda s, v, lens, scale, softcap:
         decode_softmax_v_plain(s, v, lens, scale, softcap or None), "CPU")


@torch.library.register_fake("repro_torch::decode_scores")
def _decode_scores_fake(q, k, lens):
    _check_hd(q, k, lens)
    return q.new_empty((*q.shape[:3], k.shape[2]), dtype=torch.float32)


@torch.library.register_fake("repro_torch::decode_softmax_v")
def _decode_softmax_v_fake(s, v, lens, scale, softcap):
    _check_softmax_v(s, v, lens)
    return v.new_empty((*s.shape[:3], v.shape[3]))


@register_flop_formula(torch.ops.repro_torch.decode_scores)
def _decode_scores_flops(q_shape, k_shape, *args, out_shape=None,
                         **kwargs) -> int:
    """2·B·Hq·S·d' for the slice's d' head dims, every cache position
    included, as `_decode_flops` counts; the two operators' sum over the
    ranks of the head dim is `decode_attn`'s count."""
    b, n_kv, group, d = q_shape
    return 2 * b * n_kv * group * k_shape[2] * d


@register_flop_formula(torch.ops.repro_torch.decode_softmax_v)
def _decode_softmax_v_flops(s_shape, v_shape, *args, out_shape=None,
                            **kwargs) -> int:
    """2·B·Hq·S·d': P · V over the slice, every cache position
    included."""
    b, n_kv, group, s_len = s_shape
    return 2 * b * n_kv * group * s_len * v_shape[3]


def decode_scores(q: torch.Tensor, k: torch.Tensor,
                  lens: torch.Tensor) -> torch.Tensor:
    """`decode_scores`: the kernel for CUDA tensors, the plain version for
    CPU ones, a shape for meta and fake ones; refuses a graph."""
    no_grad_guard("decode_scores", q, k)
    return torch.ops.repro_torch.decode_scores(q, k, lens)


def decode_softmax_v(s: torch.Tensor, v: torch.Tensor, lens: torch.Tensor,
                     scale: float,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """`decode_softmax_v`: as `decode_scores` dispatches."""
    no_grad_guard("decode_softmax_v", s, v)
    return torch.ops.repro_torch.decode_softmax_v(s, v, lens, float(scale),
                                                  softcap_value(softcap))
