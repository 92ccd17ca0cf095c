"""Flash attention (prefill and training): the hand-written CUDA kernels
(`csrc/flash_attn.cu`, replacing the TPU kernel
`repro.kernels.flash_attn.flash_attention_pallas`, and its backward
`csrc/flash_attn_bwd.cu`, replacing the XLA autodiff of
`repro.models.layers._attn_core`) beside their plain PyTorch versions.

    out[b, h, i] = Σ_j softmax_j(q[b, h, i] · k[b, h, j] / √d) v[b, h, j]

q is (B, H, Sq, d) and k, v (B, H, Sk, d), of one dtype (float32,
float16 or bfloat16), d <= 256 in both directions; neither length need be
a multiple of any block. With off = Sk - Sq, query i sits at key position
i + off, and key j is valid for it iff j <= max(i + off, P - 1) (causal,
with a bidirectional prefix of P >= 0 positions; P = 0 is plain causal
attention) and j > i + off - window (window > 0); softmax and accumulator
in float32, the output in q's dtype; a row with no valid key gives 0. For
Sq = Sk that is the mask of one S. A key length of its own serves the
encoder-decoder: its cross-attention is non-causal with Sq != Sk, its
encoder non-causal with Sq = Sk, and `layers.attention(cache=)` causal
with off the cache's length before the call. Causal attention with Sk <
Sq (a row would have no key) and a prefix with Sq != Sk are refused
before any launch (`check_lengths`). The prefix is Qwen2-VL's vision block: the
reference's `attention` masks by M-RoPE's temporal ids, which
`_build_positions` makes 0 for the first P positions and i - P + 1 for
text position i, so by index a key j is valid for query i iff j <=
max(i, P - 1). For training
the forward also writes each row's log-sum-exp `lse` (B, H, Sq) f32,
m + log l in natural-log units (-inf for a row with no valid key), from
which the backward recomputes the probabilities:

    D_i = Σ_d dO_i · O_i,  P_ij = exp(s q_i · k_j - lse_i),
    dS_ij = P_ij (dO_i · v_j - D_i),
    dV_j = Σ_i P_ij dO_i,  dK_j = s Σ_i dS_ij q_i,  dQ_i = s Σ_j dS_ij k_j.

With an attention softcap c (Gemma-2's; the reference's `_softcap` in
`_attn_core`), each valid score x = q · k / √d becomes c · t, t =
tanh(x / c), before the softmax, and lse is taken over the softcapped
scores. Both directions take it on both routes; the backward's dS carries
the cap's derivative:

    P_ij = exp(c t_ij - lse_i),  dS_ij = P_ij (dO_i · v_j - D_i)(1 - t_ij²),

and dK, dQ as above from that dS (D is unchanged).

On the card both directions take their tensor-core kernels for f16 and
bf16 and their f32 FMA kernels for f32 (`ROUTES`, `BWD_ROUTES`; the
sources say why).
Both directions are operators, `torch.ops.repro_torch.flash_attn` and
`flash_attn_bwd` (below), and the forward's backward is the backward
operator. The operators dispatch on where the tensors lie: CPU tensors take
the plain versions, CUDA tensors launch the kernels or raise, meta and fake
tensors get shapes alone, and a DTensor's local shards take one of those.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.build import entry

# Kernel launches made in this process, in all, by route, with a softcap,
# at d > 128, with a prefix P > 0, with Sq != Sk (cross) and without the
# causal mask: the forward by `flash_attn`'s CUDA implementation (inference
# and training, the recompute of a checkpointed layer among them), the
# backward by `flash_attn_bwd`'s.
FLASH_LAUNCHES = 0
FLASH_ROUTE_LAUNCHES = {"tensor_core": 0, "f32_fma": 0}
FLASH_SOFTCAP_LAUNCHES = 0
FLASH_WIDE_LAUNCHES = 0      # the forward at head dims 129-256 (NC = 16)
FLASH_PREFIX_LAUNCHES = 0
FLASH_CROSS_LAUNCHES = 0
FLASH_NONCAUSAL_LAUNCHES = 0
FLASH_BWD_LAUNCHES = 0
FLASH_BWD_ROUTE_LAUNCHES = {"tensor_core": 0, "f32_fma": 0}
FLASH_BWD_SOFTCAP_LAUNCHES = 0
FLASH_BWD_WIDE_LAUNCHES = 0  # the backward at head dims 129-256
FLASH_BWD_PREFIX_LAUNCHES = 0
FLASH_BWD_CROSS_LAUNCHES = 0
FLASH_BWD_NONCAUSAL_LAUNCHES = 0

DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# The kernel each dtype takes in csrc/flash_attn.cu and csrc/decode_attn.cu.
ROUTES = {torch.float32: "f32_fma", torch.float16: "tensor_core",
          torch.bfloat16: "tensor_core"}
# ... and in csrc/flash_attn_bwd.cu.
BWD_ROUTES = dict(ROUTES)
MAX_HEAD_DIM = 256     # must match attn::MAX_HEAD_DIM in csrc/attention.cuh
BWD_MAX_HEAD_DIM = 256  # ... and attn::MAX_BWD_HEAD_DIM
WIDE_HEAD_DIM = 128     # above it both directions take their NC = 16 plans


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           *more: torch.Tensor) -> None:
    """q (B, H, Sq, d) and `more` (the backward's out and dout) of q's
    shape, k and v (B, H, Sk, d) with Sk >= 1, all of one dtype and
    device."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or \
            k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] or \
            k.shape[2] < 1 or any(t.shape != q.shape for t in more):
        raise ValueError(f"q (and out, dout) must be (B, H, Sq, d) and k, v "
                         f"(B, H, Sk, d) with Sk >= 1, got "
                         f"{[tuple(t.shape) for t in (q, k, v, *more)]}")
    if q.dtype not in DTYPE_CODES or any(t.dtype != q.dtype
                                         for t in (k, v, *more)):
        raise TypeError(f"q, k, v must share one of {list(DTYPE_CODES)}, "
                        f"got {[t.dtype for t in (q, k, v, *more)]}")
    if len({t.device for t in (q, k, v, *more)}) != 1:
        raise ValueError("q, k, v must lie on one device")


def check_lengths(sq: int, sk: int, causal: bool, prefix: int = 0) -> None:
    """Refuse what neither kernel takes, before any launch: causal
    attention with Sk < Sq (query i sits at key position i + Sk - Sq, so
    the first rows would have no key) and a prefix with Sq != Sk."""
    if causal and sk < sq:
        raise ValueError(f"causal attention needs Sk >= Sq (query i sits at "
                         f"key position i + Sk - Sq), got Sq {sq}, Sk {sk}")
    if prefix and sq != sk:
        raise ValueError(f"a prefix needs Sq == Sk, got Sq {sq}, Sk {sk} "
                         f"and prefix {prefix}")


def softcap_value(softcap: Optional[float]) -> float:
    """The softcap as the kernels take it: 0.0 for none (None), else a
    finite value > 0."""
    if softcap is None:
        return 0.0
    cap = float(softcap)
    if not 0.0 < cap < float("inf"):
        raise ValueError(f"softcap must be None or finite and > 0, got "
                         f"{softcap}")
    return cap


def apply_softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    """cap · tanh(logits / cap) where cap > 0; the logits as they are for
    cap 0."""
    return cap * torch.tanh(logits / cap) if cap else logits


def prefix_value(prefix: int) -> int:
    """The prefix as the kernels take it: an int >= 0."""
    if int(prefix) != prefix or prefix < 0:
        raise ValueError(f"prefix must be an int >= 0, got {prefix}")
    return int(prefix)


def _mask(sq: int, sk: int, causal: bool, window: int, device,
          prefix: int = 0) -> torch.Tensor:
    """(Sq, Sk) bool: key j is valid for query i, which sits at key
    position i + Sk - Sq."""
    pos = torch.arange(sq, device=device) + (sk - sq)
    key = torch.arange(sk, device=device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= key[None, :] <= torch.clamp_min(pos[:, None], prefix - 1)
    if window > 0:
        mask &= key[None, :] > pos[:, None] - window
    return mask


def flash_attention_plain_lse(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int = 0,
                              softcap: Optional[float] = None,
                              prefix: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: the full Sq×Sk scores in float32,
    softcapped where asked, the kernel's masks and its guard for rows with
    no valid key. Returns (out in q's dtype, lse (B, H, Sq) f32)."""
    _check(q, k, v)
    prefix = prefix_value(prefix)
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    check_lengths(sq, sk, causal, prefix)
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) \
        * (1.0 / d ** 0.5)
    logits = apply_softcap(logits, softcap_value(softcap))
    logits = logits.masked_fill(
        ~_mask(sq, sk, causal, window, q.device, prefix), float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - torch.where(torch.isfinite(m), m, 0.0))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = (torch.einsum("bhst,bhtd->bhsd", p, v.float()) / denom).to(q.dtype)
    lse = torch.where(torch.isfinite(m), m + torch.log(denom),
                      float("-inf"))[..., 0]
    return out, lse


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          softcap: Optional[float] = None,
                          prefix: int = 0) -> torch.Tensor:
    """`flash_attention_plain_lse`'s output alone."""
    return flash_attention_plain_lse(q, k, v, causal=causal, window=window,
                                     softcap=softcap, prefix=prefix)[0]


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              dout: torch.Tensor, lse: torch.Tensor,
                              causal: bool = True, window: int = 0,
                              softcap: Optional[float] = None,
                              prefix: int = 0
                              ) -> Tuple[torch.Tensor, ...]:
    """The plain version of the backward, step by step in f32 from the
    forward's `out` and `lse` (taken over the softcapped scores where a
    softcap is given), under the forward's masks: (dq, dk, dv) in q's
    dtype (dq like q, dk and dv like k). A row whose lse is -inf (no valid
    key) contributes nothing."""
    _check(q, k, v, out, dout)
    cap = softcap_value(softcap)
    prefix = prefix_value(prefix)
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    check_lengths(sq, sk, causal, prefix)
    scale = 1.0 / d ** 0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    of, dof, lse = out.float(), dout.float(), lse.float()
    logits = torch.einsum("bhsd,bhtd->bhst", qf, kf) * scale
    if cap:
        t = torch.tanh(logits / cap)
        logits = cap * t
    valid = _mask(sq, sk, causal, window, q.device, prefix) \
        & torch.isfinite(lse)[..., None]
    p = torch.where(valid, torch.exp(logits - lse[..., None]), 0.0)
    dv = torch.einsum("bhst,bhsd->bhtd", p, dof)
    dp = torch.einsum("bhsd,bhtd->bhst", dof, vf)
    delta = (dof * of).sum(dim=-1)
    ds = p * (dp - delta[..., None])
    if cap:
        ds = ds * (1.0 - t * t)
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kf) * scale
    dk = torch.einsum("bhst,bhsd->bhtd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _launch_fn():
    return entry("flash_attn_launch",
                 [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                 + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])


def _bwd_launch_fn():
    return entry("flash_attn_bwd_launch",
                 [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                 + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])


def no_grad_guard(name: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would record a kernel's output that has no
    backward (the decode kernel, which only serves): a ctypes launch
    records nothing, so a gradient would be silently lost."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: the decode kernel serves decode steps "
            "only, and LM training attends through the flash kernels. Call "
            "it under torch.no_grad() or torch.inference_mode(), or on "
            "inputs that do not require grad")


def refuse_wide_backward(d: int) -> None:
    """The backward kernels stop at d = BWD_MAX_HEAD_DIM, as the forward
    does: raise, before any launch, for a wider head."""
    if d > BWD_MAX_HEAD_DIM:
        raise NotImplementedError(
            f"the flash backward kernels take head dims up to "
            f"{BWD_MAX_HEAD_DIM}, as the forward and decode kernels do; got "
            f"{d} (no configuration of the reference goes past 256)")


def _check_cuda(name: str, causal: bool, window: int,
                softcap: Optional[float], prefix: int = 0,
                **tensors: torch.Tensor) -> float:
    """What the kernels take beyond `_check`: CUDA, contiguous tensors,
    d <= MAX_HEAD_DIM, window >= 0, prefix >= 0, a softcap None or finite
    and > 0, the lengths `check_lengths` allows (tensors by name, q and k
    first). Returns the softcap as the kernels take it."""
    cap = softcap_value(softcap)
    q, k = list(tensors.values())[:2]
    check_lengths(q.shape[2], k.shape[2], causal, prefix_value(prefix))
    if q.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {q.device}")
    for label, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{label} must be contiguous")
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[3]} > {MAX_HEAD_DIM}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    return cap


def _launch_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, window: int, softcap: float,
                    prefix: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forward launch on PyTorch's current stream (no synchronise),
    writing out and lse: the CUDA implementation of `flash_attn`."""
    global FLASH_LAUNCHES, FLASH_SOFTCAP_LAUNCHES, FLASH_WIDE_LAUNCHES, \
        FLASH_PREFIX_LAUNCHES, FLASH_CROSS_LAUNCHES, FLASH_NONCAUSAL_LAUNCHES
    _check(q, k, v)
    cap = _check_cuda("flash_attention_cuda", causal, window, softcap or None,
                      prefix, q=q, k=k, v=v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    fn = _launch_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, h, sq, sk, d, int(causal), window,
                 int(prefix), 1.0 / d ** 0.5, cap, DTYPE_CODES[q.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"flash_attn kernel launch failed: CUDA error "
                           f"{err}")
    FLASH_LAUNCHES += 1
    FLASH_ROUTE_LAUNCHES[ROUTES[q.dtype]] += 1
    if cap:
        FLASH_SOFTCAP_LAUNCHES += 1
    if d > WIDE_HEAD_DIM:
        FLASH_WIDE_LAUNCHES += 1
    if prefix:
        FLASH_PREFIX_LAUNCHES += 1
    if sq != sk:
        FLASH_CROSS_LAUNCHES += 1
    if not causal:
        FLASH_NONCAUSAL_LAUNCHES += 1
    return out, lse


def _launch_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     out: torch.Tensor, dout: torch.Tensor,
                     lse: torch.Tensor, causal: bool, window: int,
                     softcap: float, prefix: int) -> Tuple[torch.Tensor, ...]:
    """The backward kernels (D pre-pass, dK/dV, dQ) on PyTorch's current
    stream, counted as one launch: the CUDA implementation of
    `flash_attn_bwd`. Refuses d > BWD_MAX_HEAD_DIM before any launch."""
    global FLASH_BWD_LAUNCHES, FLASH_BWD_SOFTCAP_LAUNCHES, \
        FLASH_BWD_WIDE_LAUNCHES, FLASH_BWD_PREFIX_LAUNCHES, \
        FLASH_BWD_CROSS_LAUNCHES, FLASH_BWD_NONCAUSAL_LAUNCHES
    refuse_wide_backward(q.shape[-1])
    _check(q, k, v, out, dout)
    cap = _check_cuda("flash_attention_bwd_cuda", causal, window,
                      softcap or None, prefix, q=q, k=k, v=v, out=out,
                      dout=dout, lse=lse)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    _check_lse(lse, q)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _bwd_launch_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(t.data_ptr() for t in (q, k, v, out, dout, lse, delta,
                                          dq, dk, dv)),
                 b, h, sq, sk, d, int(causal), window, int(prefix),
                 1.0 / d ** 0.5, cap, DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd kernel launch failed: CUDA error "
                           f"{err}")
    FLASH_BWD_LAUNCHES += 1
    FLASH_BWD_ROUTE_LAUNCHES[BWD_ROUTES[q.dtype]] += 1
    if cap:
        FLASH_BWD_SOFTCAP_LAUNCHES += 1
    if d > WIDE_HEAD_DIM:
        FLASH_BWD_WIDE_LAUNCHES += 1
    if prefix:
        FLASH_BWD_PREFIX_LAUNCHES += 1
    if sq != sk:
        FLASH_BWD_CROSS_LAUNCHES += 1
    if not causal:
        FLASH_BWD_NONCAUSAL_LAUNCHES += 1
    return dq, dk, dv


def _check_lse(lse: torch.Tensor, q: torch.Tensor) -> None:
    b, h, sq, _ = q.shape
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 or \
            lse.device != q.device:
        raise ValueError(f"lse must be ({b}, {h}, {sq}) float32 on "
                         f"{q.device}, got {tuple(lse.shape)} {lse.dtype} "
                         f"on {lse.device}")


# --------------------------------------------------------------------------
# The kernels as operators: `torch.ops.repro_torch.flash_attn` (q, k, v,
# causal, window, softcap, prefix) → (out, lse) and `flash_attn_bwd` (q, k,
# v, out, dout, lse, causal, window, softcap, prefix) → (dq, dk, dv), with
# softcap 0.0 for none. Each has the kernel as its CUDA implementation
# (counted), the plain version as its CPU one, a fake (shape-only)
# implementation for meta and fake tensors, a FLOP formula and a DTensor
# sharding rule; the forward's backward is the backward operator. So a trace
# (`torch.compile`, the dry run) keeps each call as one node, and a DTensor
# call runs the operator on each rank's local shard.
# --------------------------------------------------------------------------

LIB = torch.library.Library("repro_torch", "FRAGMENT")
LIB.define("flash_attn(Tensor q, Tensor k, Tensor v, bool causal, int window, "
           "float softcap, int prefix) -> (Tensor, Tensor)")
LIB.define("flash_attn_bwd(Tensor q, Tensor k, Tensor v, Tensor out, "
           "Tensor dout, Tensor lse, bool causal, int window, float softcap, "
           "int prefix) -> (Tensor, Tensor, Tensor)")
LIB.impl("flash_attn", _launch_forward, "CUDA")
LIB.impl("flash_attn_bwd", _launch_backward, "CUDA")
LIB.impl("flash_attn", lambda q, k, v, causal, window, softcap, prefix:
         flash_attention_plain_lse(q, k, v, causal=causal, window=window,
                                   softcap=softcap or None, prefix=prefix),
         "CPU")
LIB.impl("flash_attn_bwd", lambda q, k, v, out, dout, lse, causal, window,
         softcap, prefix: flash_attention_bwd_plain(
             q, k, v, out, dout, lse, causal, window, softcap or None,
             prefix), "CPU")


@torch.library.register_fake("repro_torch::flash_attn")
def _flash_attn_fake(q, k, v, causal, window, softcap, prefix):
    _check(q, k, v)
    check_lengths(q.shape[2], k.shape[2], causal, prefix_value(prefix))
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


@torch.library.register_fake("repro_torch::flash_attn_bwd")
def _flash_attn_bwd_fake(q, k, v, out, dout, lse, causal, window, softcap,
                         prefix):
    _check(q, k, v, out, dout)
    _check_lse(lse, q)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _flash_setup_context(ctx, inputs, output):
    q, k, v, causal, window, softcap, prefix = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.mark_non_differentiable(lse)
    ctx.args = (causal, window, softcap, prefix)


def _flash_backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = torch.ops.repro_torch.flash_attn_bwd(
        q, k, v, out, dout.contiguous(), lse, *ctx.args)
    return dq, dk, dv, None, None, None, None


torch.library.register_autograd("repro_torch::flash_attn", _flash_backward,
                                setup_context=_flash_setup_context)


@register_flop_formula(torch.ops.repro_torch.flash_attn)
def _flash_flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    """4·B·H·Sq·Sk·d: the two products of the reference's `_attn_core`
    (scores and probabilities times V), masked pairs included. The kernel
    skips masked tiles, so this is the reference's count, not the kernel's
    work."""
    b, h, sq, d = q_shape
    return 4 * b * h * sq * k_shape[2] * d


@register_flop_formula(torch.ops.repro_torch.flash_attn_bwd)
def _flash_bwd_flops(q_shape, k_shape, *args, out_shape=None,
                     **kwargs) -> int:
    """8·B·H·Sq·Sk·d: the transposes of `_attn_core`'s two products (dQ, dK
    from the scores', dP, dV from the values'), masked pairs included, as
    `jax.grad` of the reference counts them; the kernels' recompute of the
    scores is not counted, as the reference's autodiff keeps them."""
    b, h, sq, d = q_shape
    return 8 * b * h * sq * k_shape[2] * d


def register_sharding() -> None:
    """The operators' DTensor sharding rules (`ops.register_dtensor_rules`
    calls it once): batch and heads may be sharded, sequence and head dim
    are not, since each (batch, head) row of attention is independent of
    every other."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.flash_attn.default)
    def _fwd(q, k, v, causal, window, softcap, prefix):
        rest = [None] * 4
        return [([p, p], [p, p, p, *rest])
                for p in (Replicate(), Shard(0), Shard(1))]

    @register_sharding(torch.ops.repro_torch.flash_attn_bwd.default)
    def _bwd(q, k, v, out, dout, lse, causal, window, softcap, prefix):
        rest = [None] * 4
        return [([p, p, p], [p] * 6 + rest)
                for p in (Replicate(), Shard(0), Shard(1))]


def _cuda_args(name: str, q, k, v, causal, window, softcap, prefix) -> float:
    """The checks of a CUDA entry before the operator is called (so that a
    CPU tensor raises and counts nothing): the softcap as the operator
    takes it."""
    _check(q, k, v)
    return _check_cuda(name, causal, window, softcap, prefix, q=q, k=k, v=v)


def flash_attention_lse_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: int = 0,
                             softcap: Optional[float] = None,
                             prefix: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel through `flash_attn`: (out, lse (B, H, Sq) f32)."""
    cap = _cuda_args("flash_attention_cuda", q, k, v, causal, window,
                     softcap, prefix)
    return torch.ops.repro_torch.flash_attn(q, k, v, causal, window, cap,
                                            prefix)


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, lse: torch.Tensor,
                             causal: bool = True, window: int = 0,
                             softcap: Optional[float] = None,
                             prefix: int = 0
                             ) -> Tuple[torch.Tensor, ...]:
    """The backward kernels through `flash_attn_bwd`: (dq, dk, dv), dq like
    q, dk and dv like k. `causal`, `window`, `softcap` and `prefix` are the
    forward's, whose lse (over the softcapped scores) this takes. Raises on
    any operand the kernels do not take, d > BWD_MAX_HEAD_DIM first
    (`refuse_wide_backward`)."""
    refuse_wide_backward(q.shape[-1])
    _check(q, k, v, out, dout)
    cap = _check_cuda("flash_attention_bwd_cuda", causal, window, softcap,
                      prefix, q=q, k=k, v=v, out=out, dout=dout, lse=lse)
    return torch.ops.repro_torch.flash_attn_bwd(q, k, v, out, dout, lse,
                                                causal, window, cap, prefix)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: Optional[float] = None,
                         prefix: int = 0) -> torch.Tensor:
    """The forward kernel through `flash_attn` on PyTorch's current stream
    (no synchronise): (B, H, Sq, d) in q's dtype; raises on any operand the
    kernel does not take. Under autograd its backward is `flash_attn_bwd`."""
    return flash_attention_lse_cuda(q, k, v, causal=causal, window=window,
                                    softcap=softcap, prefix=prefix)[0]


def flash_attention_blocks(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           window: int = 0,
                           softcap: Optional[float] = None,
                           prefix: int = 0) -> torch.Tensor:
    """`flash_attn`'s output: the kernels for CUDA tensors, their plain
    versions for CPU tensors, a shape for meta and fake ones, each local
    shard for a DTensor."""
    return torch.ops.repro_torch.flash_attn(
        q, k, v, causal, window, softcap_value(softcap),
        prefix_value(prefix))[0]
