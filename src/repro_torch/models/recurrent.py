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
it, so that only h_prev @ R stays inside. Under a trace (`torch.compile`,
the dry run) the loop is one operator, `torch.ops.repro_torch.slstm_scan`,
with its backward `slstm_scan_bwd`: a trace that unrolled it would hold S
copies of the step, forward and backward. Their FLOP formulas count the
loop's products at every step, as a walk of the reference's `scan` counts
its body S times, and their DTensor rules let the batch be sharded.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.ops import fit_groups, merge_heads

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
    hh = fit_groups(h, h.dim() - 1, n_heads).reshape(
        *shape[:-1], n_heads, shape[-1] // n_heads)
    var = torch.mean(torch.square(hh.float()), dim=-1, keepdim=True)
    hh = hh * torch.rsqrt(var + 1e-6)
    return (merge_heads(hh) * (1.0 + scale)).to(h.dtype)


def batch_only(t: torch.Tensor) -> torch.Tensor:
    """t (a DTensor's) replicated on every mesh dim but those that shard
    its batch (dim 0), pending partial sums summed; a plain tensor as it
    is. DTensor's einsum cannot take a bmm batch dim flattened from two
    sharded dims (batch and heads), and a decode step's token activations
    are cheaper to move than any weight."""
    if not hasattr(t, "device_mesh"):
        return t
    from torch.distributed.tensor import Replicate, Shard
    pl = [p if p == Shard(0) else Replicate() for p in t.placements]
    return t if pl == list(t.placements) else t.redistribute(t.device_mesh,
                                                             pl)


def mlstm_train(p: Params, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """x (B, S, D) → (B, S, D). Stabilized parallel form (xLSTM eq. 2x):
    the (B, H, S, S) decay matrix and scores in f32."""
    b, s, d = x.shape
    hd = d // n_heads

    def split(w):
        return batch_only(fit_groups(x @ w, 2, n_heads).reshape(
            b, s, n_heads, hd).transpose(1, 2))

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
    h = merge_heads(h.transpose(1, 2)).to(x.dtype)
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


def _mlstm_update(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  i_pre: torch.Tensor, f_pre: torch.Tensor,
                  state: Dict[str, torch.Tensor], hd: int) -> tuple:
    """The mLSTM's state update for one token and the two sums its output
    divides: (num (B, H, hd), n·qs (B, H), new state). k, q and the state's
    c, n may hold a slice of the key dim e (c's last), and then num and n·qs
    are that slice's partial sums; v and c's value dim stay whole."""
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
    nq = torch.einsum("bhe,bhe->bh", n, qs)
    return num, nq, {"c": c, "n": n, "m": m_new}


def _mlstm_out(num: torch.Tensor, nq: torch.Tensor,
               m: torch.Tensor) -> torch.Tensor:
    """The mLSTM's output h (B, H, hd) from the whole sums."""
    return num / torch.maximum(torch.abs(nq), torch.exp(-m))[..., None]


def _mlstm_step_sharded(q, k, v, i_pre, f_pre, state, hd: int) -> tuple:
    """`_mlstm_update` and `_mlstm_out` on DTensor states, each rank on its
    own shard of c (B, H, hd, e) as `launch.sharding.state_pspecs` places
    it, so that c never moves:

      * k and q are taken as c's slices of batch, heads and e; v and the
        gates as its batch and heads, v's value dim whole;
      * n and m are brought to c's layout (n's e with c's e), each O(B·H·hd),
        a token's worth;
      * the update runs on local tensors, which keeps DTensor's einsum out
        of it, and with it the limit `batch_only` works around (a bmm
        batch dim flattened from sharded batch and heads);
      * the partial num and n·qs are summed over the mesh dims that shard
        e, and only then come abs, maximum and the division.

    Returns (h (B, H, hd) replicated over the mesh dims that shard e, the
    new state placed as the old)."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    c = state["c"]
    mesh, pc = c.device_mesh, list(c.placements)
    if any(pl.is_shard(2) or pl.is_partial() for pl in pc):
        raise ValueError(f"an mLSTM state c placed {pc} (its value dim "
                         f"sharded, or partial) is not supported")
    e_dims = [i for i, pl in enumerate(pc) if pl.is_shard(3)]
    p_n = [Shard(2) if i in e_dims else pl for i, pl in enumerate(pc)]
    p_bh = [Replicate() if i in e_dims else pl for i, pl in enumerate(pc)]

    def local(t, placed):
        return t.redistribute(mesh, placed).to_local()

    m = local(state["m"], p_bh)
    num, nq, new = _mlstm_update(
        local(q, p_n), local(k, p_n), local(v, p_bh), local(i_pre, p_bh),
        local(f_pre, p_bh),
        {"c": c.to_local(), "n": local(state["n"], p_n), "m": m}, hd)
    for i in e_dims:
        num = funcol.all_reduce(num, "sum", (mesh, i))
        nq = funcol.all_reduce(nq, "sum", (mesh, i))

    def placed(t, like, places):
        out = DTensor.from_local(t, mesh, places, run_check=False,
                                 shape=like.shape, stride=like.stride())
        return out.redistribute(mesh, list(like.placements))

    h = _mlstm_out(num, nq, new["m"])
    h = DTensor.from_local(h, mesh, p_bh, run_check=False,
                           shape=(*c.shape[:3],),
                           stride=(c.shape[1] * c.shape[2], c.shape[2], 1))
    return h, {"c": placed(new["c"], c, pc),
               "n": placed(new["n"], state["n"], p_n),
               "m": placed(new["m"], state["m"], p_bh)}


def mlstm_step(p: Params, x: torch.Tensor, state: Dict[str, torch.Tensor],
               n_heads: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, 1, D) one token; returns (y (B, 1, D), new state). With
    DTensor states each rank updates its own shard of them
    (`_mlstm_step_sharded`)."""
    b, _, d = x.shape
    hd = d // n_heads
    xt = x[:, 0]
    sharded = hasattr(state["c"], "device_mesh")
    keep = (lambda t: t) if sharded else batch_only

    def split(w):
        return keep(fit_groups(xt @ w, 1, n_heads).reshape(b, n_heads, hd))

    q, k, v = split(p["wq"]), split(p["wk"]), split(p["wv"])
    i_pre = keep((xt @ p["wi"]).reshape(b, n_heads).float())
    f_pre = keep((xt @ p["wf"]).reshape(b, n_heads).float())
    if sharded:
        h, new = _mlstm_step_sharded(q, k, v, i_pre, f_pre, state, hd)
        h = batch_only(h)
    else:
        num, nq, new = _mlstm_update(q, k, v, i_pre, f_pre, state, hd)
        h = _mlstm_out(num, nq, new["m"])
    h = h.reshape(b, 1, d).to(x.dtype)
    y = rms_head_norm(h, p["gn"], n_heads) @ p["wo"]
    return y, new


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


def _slstm_cell(p: Params, state: Dict[str, torch.Tensor],
                xt: "torch.Tensor | None", xw: Tuple[torch.Tensor, ...] = ()
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One sLSTM step; xt (B, D), and `xw` its four input projections
    xt @ (wz, wi_g, wf_g, wo_g) where already computed (xt None: h in
    their dtype)."""
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
    h = h.to(xw[0].dtype if xt is None else xt.dtype)
    return {"c": c, "n": n, "h": h, "m": m_new}, h


def slstm_train(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) → (B, S, D); a loop over time (under a trace, the
    `slstm_scan` operator)."""
    xw = [x @ p[name] for name in _SLSTM_IN]           # every position
    rec = [p[name] for name in _SLSTM_REC]
    loop = (torch.ops.repro_torch.slstm_scan if torch.compiler.is_compiling()
            else _slstm_loop)
    return loop(*xw, *rec) @ p["wo"]


def _slstm_loop(z, i, f, o, rz, ri, rf, ro) -> torch.Tensor:
    """The loop over time of `slstm_train` on its input projections (B, S,
    D) each: the emitted h (B, S, D)."""
    b, s, d = z.shape
    p = dict(zip(_SLSTM_REC, (rz, ri, rf, ro)))
    state = slstm_init_state(b, d, torch.float32, device=z.device)
    # The carried h is in the emitted h's dtype (the activation dtype).
    state["h"] = state["h"].to(z.dtype)
    hs = []
    for t in range(s):
        state, h = _slstm_cell(p, state, None,
                               tuple(w[:, t] for w in (z, i, f, o)))
        hs.append(h)
    return torch.stack(hs, dim=1)


def _slstm_loop_bwd(z, i, f, o, rz, ri, rf, ro, dh):
    """The gradients of `_slstm_loop` for the cotangent dh, by autograd
    through the loop."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True)
               for t in (z, i, f, o, rz, ri, rf, ro)]
        return tuple(torch.autograd.grad(_slstm_loop(*ins), ins, dh))


# The loop as operators: `slstm_scan` (z, i, f, o, rz, ri, rf, ro) → h and
# `slstm_scan_bwd` (the same, dh) → their eight gradients. Each runs the
# loop (by autograd for the backward) on any device; a trace keeps each
# call as one node, with a fake implementation, a FLOP formula and a
# DTensor rule.
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("slstm_scan(Tensor z, Tensor i, Tensor f, Tensor o, Tensor rz, "
            "Tensor ri, Tensor rf, Tensor ro) -> Tensor")
_LIB.define("slstm_scan_bwd(Tensor z, Tensor i, Tensor f, Tensor o, "
            "Tensor rz, Tensor ri, Tensor rf, Tensor ro, Tensor dh) -> "
            "(Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, "
            "Tensor)")
_LIB.impl("slstm_scan", _slstm_loop, "CompositeExplicitAutograd")
_LIB.impl("slstm_scan_bwd", _slstm_loop_bwd, "CompositeExplicitAutograd")


@torch.library.register_fake("repro_torch::slstm_scan")
def _slstm_scan_fake(z, i, f, o, rz, ri, rf, ro):
    return torch.empty_like(z)


@torch.library.register_fake("repro_torch::slstm_scan_bwd")
def _slstm_scan_bwd_fake(z, i, f, o, rz, ri, rf, ro, dh):
    return tuple(torch.empty_like(t) for t in (z, i, f, o, rz, ri, rf, ro))


def _slstm_setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _slstm_backward(ctx, dh):
    return torch.ops.repro_torch.slstm_scan_bwd(*ctx.saved_tensors,
                                                dh.contiguous())


torch.library.register_autograd("repro_torch::slstm_scan", _slstm_backward,
                                setup_context=_slstm_setup_context)


@register_flop_formula(torch.ops.repro_torch.slstm_scan)
def _slstm_scan_flops(z_shape, *args, out_shape=None, **kwargs) -> int:
    """4 · 2·B·S·D·D: h_prev @ (rz, ri, rf, ro) at each of the S steps."""
    b, s, d = z_shape
    return 8 * b * s * d * d


@register_flop_formula(torch.ops.repro_torch.slstm_scan_bwd)
def _slstm_scan_bwd_flops(z_shape, *args, out_shape=None, **kwargs) -> int:
    """Twice the forward's: each step's dh_prev = dg @ Rᵀ and dR += h_prevᵀ
    @ dg for the four gates, as `jax.grad` of the reference's scan counts
    them; the recompute of the forward is not counted."""
    b, s, d = z_shape
    return 16 * b * s * d * d


_DTENSOR_RULES = []


def register_sharding() -> None:
    """DTensor rules for the loop and `F.logsigmoid`, registered once
    (`transformer.register_dtensor_rules` calls it). The loop: everything
    replicated, or the batch sharded with the recurrent weights
    replicated (their gradients then partial sums). `log_sigmoid_forward`
    and its backward are pointwise; the forward's buffer is an empty
    (0,) tensor on CUDA (replicated), x's shape elsewhere."""
    if _DTENSOR_RULES:
        return
    _DTENSOR_RULES.append(True)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten
    r, b = Replicate(), Shard(0)

    @register_sharding(torch.ops.repro_torch.slstm_scan.default)
    def _fwd(*args):
        return [([r], [r] * 8), ([b], [b] * 4 + [r] * 4)]

    @register_sharding(torch.ops.repro_torch.slstm_scan_bwd.default)
    def _bwd(*args):
        return [([r] * 8, [r] * 9),
                ([b] * 4 + [Partial()] * 4, [b] * 4 + [r] * 4 + [b])]

    def pointwise(x):
        return [r] + [Shard(d) for d in range(len(x.shape))]

    def empty_on_cuda(x, pl):
        return r if x.mesh.device_type == "cuda" else pl

    @register_sharding(aten.log_sigmoid_forward.default)
    def _logsig(x):
        return [([pl, empty_on_cuda(x, pl)], [pl]) for pl in pointwise(x)]

    @register_sharding(aten.log_sigmoid_backward.default)
    def _logsig_bwd(dy, x, buffer):
        return [([pl], [pl, pl, empty_on_cuda(x, pl)])
                for pl in pointwise(x)]

    # cumsum's backward flips (the mLSTM's decay); torch 2.11's DTensor
    # has no rule for flip, later versions have their own.
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    if not any(aten.flip.default in getattr(prop, name, {}) for name in (
            "op_strategy_funcs", "op_single_dim_strategy_funcs")):
        @register_sharding(aten.flip.default)
        def _flip(x, dims):
            flipped = {d % len(x.shape) for d in dims}
            return [([pl], [pl, None]) for pl in pointwise(x)
                    if not (pl.is_shard() and pl.dim in flipped)]


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
    pad = torch.cat([x.new_zeros((x.shape[0], width - 1, x.shape[2])), x],
                    dim=1)
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
