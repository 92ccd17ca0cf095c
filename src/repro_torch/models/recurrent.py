"""Recurrent sequence blocks: mLSTM / sLSTM (xLSTM) and RG-LRU (Griffin),
as `repro.models.recurrent` computes them.

Each block has a parallel `*_train` form over (B, S, D) and a single-step
`*_step` form with explicit state for decode; the state is O(1) in the
sequence length. None of them is a kernel of the reference: the port runs
them as plain PyTorch on either device.

Dtypes follow the reference's JAX promotion step by step. `torch.matmul`
does not promote mixed operands, so `_mm` casts both to the promoted type
where they differ: in bf16 decode the sLSTM's first step multiplies the
f32 initial `h` by bf16 weights in f32, as `jnp.matmul` does, and every
later step in bf16. Elementwise ops promote alike in both libraries.

`rglru_train`'s `lax.associative_scan` is a log-depth (Hillis-Steele)
scan here: ceil(log2 S) rounds of (a1·a2, a2·b1 + b2), the same
recurrence summed in another order. `slstm_train`'s `lax.scan` is a loop
over time, the four input projections computed for every position before
it, so that only h_prev @ R stays inside.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
_RGLRU_C = 8.0


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the promoted dtype of the two, as `jnp.matmul` computes a
    product of mixed operands."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return a @ b


# --------------------------------------------------------------------------
# mLSTM: matrix memory, parallel (stabilized quadratic form) + recurrent step
# --------------------------------------------------------------------------

def rms_head_norm(h: torch.Tensor, scale: torch.Tensor,
                  n_heads: int) -> torch.Tensor:
    """Per-head RMS group norm used by xLSTM outputs."""
    shape = h.shape
    hh = h.reshape(*shape[:-1], n_heads, shape[-1] // n_heads)
    var = torch.mean(torch.square(hh.float()), dim=-1, keepdim=True)
    hh = hh * torch.rsqrt(var + 1e-6)
    return (hh.reshape(shape) * (1.0 + scale)).to(h.dtype)


def mlstm_train(p: Params, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """x (B, S, D) → (B, S, D). Stabilized parallel form (xLSTM eq. 2x):
    the (B, H, S, S) decay matrix and scores in f32."""
    b, s, d = x.shape
    hd = d // n_heads

    def split(w):
        return (x @ w).reshape(b, s, n_heads, hd).transpose(1, 2)

    q, k, v = split(p["wq"]), split(p["wk"]), split(p["wv"])
    i_pre = (x @ p["wi"]).reshape(b, s, n_heads).transpose(1, 2)  # (B,H,S)
    f_pre = (x @ p["wf"]).reshape(b, s, n_heads).transpose(1, 2)

    log_f = F.logsigmoid(f_pre.float())
    csum = torch.cumsum(log_f, dim=-1)
    # D[t, u] = sum_{u<j<=t} log f_j + i_u  (u <= t)
    dmat = csum[..., :, None] - csum[..., None, :] \
        + i_pre.float()[..., None, :]
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    dmat = dmat.masked_fill(~causal, float("-inf"))
    m = torch.clamp_min(dmat.amax(dim=-1, keepdim=True), -1e30)
    dexp = torch.exp(dmat - m)

    logits = torch.einsum("bhtd,bhud->bhtu", q.float(), k.float()) \
        / (hd ** 0.5)
    w = logits * dexp
    norm = torch.maximum(torch.abs(w.sum(dim=-1, keepdim=True)),
                         torch.exp(-m))
    h = torch.einsum("bhtu,bhud->bhtd", w / norm, v.float())
    h = h.transpose(1, 2).reshape(b, s, d).to(x.dtype)
    return rms_head_norm(h, p["gn"], n_heads) @ p["wo"]


def mlstm_init_state(batch: int, n_heads: int, hd: int,
                     dtype: torch.dtype = torch.float32, *,
                     device: "str | torch.device" = "cpu"
                     ) -> Dict[str, torch.Tensor]:
    return {
        "c": torch.zeros((batch, n_heads, hd, hd), dtype=dtype,
                         device=device),
        "n": torch.zeros((batch, n_heads, hd), dtype=dtype, device=device),
        "m": torch.full((batch, n_heads), -1e30, dtype=dtype, device=device),
    }


def mlstm_step(p: Params, x: torch.Tensor, state: Dict[str, torch.Tensor],
               n_heads: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, 1, D) one token; returns (y (B, 1, D), new state)."""
    b, _, d = x.shape
    hd = d // n_heads
    xt = x[:, 0]

    def split(w):
        return (xt @ w).reshape(b, n_heads, hd)

    q, k, v = split(p["wq"]), split(p["wk"]), split(p["wv"])
    i_pre = (xt @ p["wi"]).reshape(b, n_heads).float()
    f_pre = (xt @ p["wf"]).reshape(b, n_heads).float()
    log_f = F.logsigmoid(f_pre)

    m_new = torch.maximum(log_f + state["m"], i_pre)
    i_g = torch.exp(i_pre - m_new)[..., None]
    f_g = torch.exp(log_f + state["m"] - m_new)[..., None]

    kq_scale = 1.0 / (hd ** 0.5)
    c = f_g[..., None] * state["c"] + i_g[..., None] * torch.einsum(
        "bhd,bhe->bhde", v.float(), k.float())
    n = f_g * state["n"] + i_g * k.float()
    qs = q.float() * kq_scale
    num = torch.einsum("bhde,bhe->bhd", c, qs)
    den = torch.maximum(torch.abs(torch.einsum("bhe,bhe->bh", n, qs)),
                        torch.exp(-m_new))[..., None]
    h = (num / den).reshape(b, 1, d).to(x.dtype)
    y = rms_head_norm(h, p["gn"], n_heads) @ p["wo"]
    return y, {"c": c, "n": n, "m": m_new}


# --------------------------------------------------------------------------
# sLSTM: scalar memory with recurrent gate mixing (sequential scan)
# --------------------------------------------------------------------------

_SLSTM_IN = ("wz", "wi_g", "wf_g", "wo_g")
_SLSTM_REC = ("rz", "ri", "rf", "ro")


def slstm_init_state(batch: int, d: int, dtype: torch.dtype = torch.float32,
                     *, device: "str | torch.device" = "cpu"
                     ) -> Dict[str, torch.Tensor]:
    def full(v):
        return torch.full((batch, d), v, dtype=dtype, device=device)
    return {"c": full(0.0), "n": full(1.0), "h": full(0.0), "m": full(0.0)}


def _slstm_cell(p: Params, state: Dict[str, torch.Tensor], xt: torch.Tensor,
                xw: Tuple[torch.Tensor, ...] = ()
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One sLSTM step; xt (B, D), and `xw` its four input projections
    xt @ (wz, wi_g, wf_g, wo_g) where already computed."""
    h_prev = state["h"]
    if not xw:
        xw = tuple(xt @ p[name] for name in _SLSTM_IN)
    zi, ii, ff, oo = (xg + _mm(h_prev, p[name])
                      for xg, name in zip(xw, _SLSTM_REC))
    ii, ff = ii.float(), ff.float()

    log_f = F.logsigmoid(ff)
    m_new = torch.maximum(log_f + state["m"], ii)
    i_g = torch.exp(ii - m_new)
    f_g = torch.exp(log_f + state["m"] - m_new)

    c = f_g * state["c"] + i_g * torch.tanh(zi).float()
    n = torch.clamp_min(f_g * state["n"] + i_g, 1e-6)
    h = torch.sigmoid(oo).float() * (c / n)
    h = h.to(xt.dtype)
    return {"c": c, "n": n, "h": h, "m": m_new}, h


def slstm_train(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) → (B, S, D); a loop over time."""
    b, s, d = x.shape
    state = slstm_init_state(b, d, torch.float32, device=x.device)
    # The carried h is in the emitted h's dtype (the activation dtype).
    state["h"] = state["h"].to(x.dtype)
    xw = [x @ p[name] for name in _SLSTM_IN]           # every position
    hs = []
    for t in range(s):
        state, h = _slstm_cell(p, state, x[:, t], tuple(w[:, t] for w in xw))
        hs.append(h)
    return torch.stack(hs, dim=1) @ p["wo"]


def slstm_step(p: Params, x: torch.Tensor, state: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    new_state, h = _slstm_cell(p, state, x[:, 0])
    return (h @ p["wo"])[:, None], new_state


# --------------------------------------------------------------------------
# RG-LRU (RecurrentGemma / Griffin): gated linear recurrence + temporal conv
# --------------------------------------------------------------------------

def _rglru_gates(p: Params, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, beta · x · i) in f32 for x (..., W): the decay and the gated
    input, softplus(lambda) taken in its own dtype before it meets the
    f32 gate, as the reference orders it."""
    r = torch.sigmoid((x @ p["w_rec_gate"]).float())
    i = torch.sigmoid((x @ p["w_in_gate"]).float())
    log_a = -_RGLRU_C * F.softplus(p["lambda"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, beta * (x.float() * i)


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t · h_{t-1} + b_t over dim 1 (h_{-1} = 0): the inclusive
    scan of (a1, b1) ∘ (a2, b2) = (a1·a2, a2·b1 + b2), in ceil(log2 S)
    rounds, each combining every position with the one `off` before it."""
    off = 1
    while off < a.shape[1]:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], 1)
        off *= 2
    return b


def rglru_train(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Parallel RG-LRU over (B, S, W) by `linear_scan`."""
    a, b_term = _rglru_gates(p, x)
    return linear_scan(a, b_term).to(x.dtype)


def rglru_init_state(batch: int, width: int,
                     dtype: torch.dtype = torch.float32, *,
                     device: "str | torch.device" = "cpu") -> torch.Tensor:
    """f32 whatever `dtype`, as the reference's."""
    return torch.zeros((batch, width), dtype=torch.float32, device=device)


def rglru_step(p: Params, x: torch.Tensor, state: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, 1, W); state (B, W) f32."""
    a, b_term = _rglru_gates(p, x[:, 0])
    h = a * state + b_term
    return h[:, None].to(x.dtype), h


def temporal_conv_train(p: Params, x: torch.Tensor,
                        width: int) -> torch.Tensor:
    """Causal depthwise conv1d (B, S, W), kernel (width, W), summed tap by
    tap in x's dtype from the integer 0, as the reference's `sum`."""
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = 0
    for i in range(width):
        out = out + pad[:, i:i + x.shape[1]] * p["conv_w"][i]
    return out + p["conv_b"]


def temporal_conv_step(p: Params, x: torch.Tensor, state: torch.Tensor,
                       width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, 1, W); state (B, width-1, W) holds the trailing window."""
    window = torch.cat([state, x], dim=1)                 # (B, width, W)
    out = torch.einsum("bkw,kw->bw", window, p["conv_w"]) + p["conv_b"]
    return out[:, None], window[:, 1:]
