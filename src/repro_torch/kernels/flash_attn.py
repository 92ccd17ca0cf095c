"""Flash attention (prefill): the hand-written CUDA kernel
(`csrc/flash_attn.cu`, replaces the TPU kernel
`repro.kernels.flash_attn.flash_attention_pallas`) beside its plain PyTorch
version.

    out[b, h, i] = Σ_j softmax_j(q[b, h, i] · k[b, h, j] / √d) v[b, h, j]

over the keys j <= i (causal) and j > i - window (window > 0), softmax and
accumulator in float32, the output in q's dtype; a row with no valid key
gives 0. q, k, v are (B, H, S, d) of one dtype (float32, float16 or
bfloat16), d <= 128; S need not be a multiple of any block.

On the card f16 and bf16 take the tensor-core kernel and f32 the f32 FMA
kernel (`ROUTES`; the source says why). `flash_attention_blocks`
dispatches on where the tensors lie: CPU tensors take the plain version,
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import entry

# Kernel launches made by `flash_attention_cuda` in this process, in all
# and by route.
FLASH_LAUNCHES = 0
FLASH_ROUTE_LAUNCHES = {"tensor_core": 0, "f32_fma": 0}

DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# The kernel each dtype takes in csrc/flash_attn.cu and csrc/decode_attn.cu.
ROUTES = {torch.float32: "f32_fma", torch.float16: "tensor_core",
          torch.bfloat16: "tensor_core"}
MAX_HEAD_DIM = 128     # must match attn::MAX_HEAD_DIM in csrc/attention.cuh


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must all be (B, H, S, d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(DTYPE_CODES)}, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k, v must lie on one device")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """The plain PyTorch version: the full S×S scores in float32, the
    kernel's masks and its guard for rows with no valid key."""
    _check(q, k, v)
    s_len, d = q.shape[2], q.shape[3]
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) \
        * (1.0 / d ** 0.5)
    pos = torch.arange(s_len, device=q.device)
    mask = torch.ones((s_len, s_len), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - torch.where(torch.isfinite(m), m, 0.0))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return (torch.einsum("bhst,bhtd->bhsd", p, v.float()) / denom).to(q.dtype)


def _launch_fn():
    return entry("flash_attn_launch",
                 [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def no_grad_guard(name: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would record the kernel's output: a ctypes
    launch has no backward, so a gradient would be silently lost."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward yet (LM training is ROADMAP.md queue 1 "
            "item 8): call it under torch.no_grad() or "
            "torch.inference_mode(), or on inputs that do not require grad")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream (no synchronise).
    Returns (B, H, S, d) in q's dtype; raises on any operand the kernel does
    not take."""
    global FLASH_LAUNCHES
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    no_grad_guard("flash_attention_cuda", q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, h, s_len, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _launch_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, h, s_len, d, int(causal), window, 1.0 / d ** 0.5,
                 DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attn kernel launch failed: CUDA error "
                           f"{err}")
    FLASH_LAUNCHES += 1
    FLASH_ROUTE_LAUNCHES[ROUTES[q.dtype]] += 1
    return out


def flash_attention_blocks(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           window: int = 0) -> torch.Tensor:
    """The kernel for CUDA tensors, its plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    return flash_attention_cuda(q, k, v, causal=causal, window=window)
