"""Parity of the port's recurrent blocks (`repro_torch.models.recurrent`)
with the JAX package's (`repro.models.recurrent`) on the CPU.

Each of the module's thirteen functions runs against its reference
counterpart on the same inputs, made from a seed with numpy, at SMOKE
widths (d_model 64, 4 heads: the mLSTM's head dim 16, lru_width 64). The
weights are the reference's own `_init_*` draws carried over as numpy,
the RG-LRU's lambda redrawn per width entry so that the gate varies.
Outputs and every state leaf are compared, and the state dtypes must be
equal: in bf16 the sLSTM's first decode step multiplies the f32 initial h
in f32 and every later step in bf16, as JAX promotes.

Tolerances: float32 atol 1e-5 with rtol 1e-5 (the same f32 arithmetic in
another order; the RG-LRU's log-depth scan sums in another order than
`lax.associative_scan`); bfloat16 rtol 2^-6 and atol 2^-6, two bf16 ulps
of O(1) values, since each side rounds its products once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import recurrent as r_rec
from repro.models import transformer as r_tf
from repro_torch.models import recurrent as p_rec

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2.0 ** -6, atol=2.0 ** -6)
TOL = {"float32": F32, "bfloat16": BF16}
B, S = 2, 11


def _cfg(arch):
    return r_configs.get_config(arch, smoke=True)


def _pt(x) -> torch.Tensor:
    """A JAX or numpy array as a tensor of the same dtype and values."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(x, copy=True))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _close(out, ref, dtype="float32"):
    """A port tensor against a reference array: dtype equal, values within
    the dtype's tolerance."""
    ref = jnp.asarray(ref)
    assert str(out.dtype).split(".")[-1] == str(ref.dtype), (out.dtype,
                                                             ref.dtype)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(_np(out), np.asarray(ref, np.float32),
                               **TOL[dtype])


def _close_tree(out, ref, dtype="float32"):
    assert set(out) == set(ref)
    for name in ref:
        _close(out[name], ref[name], dtype)


def _params(kind, dtype="float32", seed=0):
    """(reference params, port params) of one recurrent block from the
    reference's initializer at its SMOKE config."""
    dt = jnp.dtype(dtype)
    key = jax.random.PRNGKey(seed)
    if kind == "mlstm":
        p = r_tf._init_mlstm(key, _cfg("xlstm_125m"), dt)
        p["gn"] = jnp.asarray(np.random.default_rng(seed).standard_normal(
            p["gn"].shape) * 0.1, dt)
    elif kind == "slstm":
        p = r_tf._init_slstm(key, _cfg("xlstm_125m"), dt)
    else:
        p = r_tf._init_rglru_block(key, _cfg("recurrentgemma_2b"), dt)
        rng = np.random.default_rng(seed)
        p["lambda"] = jnp.asarray(rng.uniform(-1.0, 2.0, p["lambda"].shape),
                                  dt)
        p["conv_b"] = jnp.asarray(rng.standard_normal(p["conv_b"].shape)
                                  * 0.1, dt)
    return p, {k: _pt(v) for k, v in p.items()}


def _x(shape, seed, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jnp.dtype(dtype)), _pt(jnp.asarray(x,
                                                             jnp.dtype(dtype)))


def test_rms_head_norm_matches_reference():
    rx, px = _x((B, S, 64), 1)
    rs, ps = _x((64,), 2)
    _close(p_rec.rms_head_norm(px, ps, 4), r_rec.rms_head_norm(rx, rs, 4))


def test_mlstm_train_matches_reference():
    rp, pp = _params("mlstm")
    rx, px = _x((B, S, 64), 3)
    _close(p_rec.mlstm_train(pp, px, 4), r_rec.mlstm_train(rp, rx, 4))


def test_mlstm_init_state_matches_reference():
    _close_tree(p_rec.mlstm_init_state(B, 4, 16),
                r_rec.mlstm_init_state(B, 4, 16))


def test_mlstm_step_matches_reference_and_its_parallel_form():
    """S steps from the initial state: each y and the final c, n, m
    against the reference's steps, and the ys against the parallel form."""
    rp, pp = _params("mlstm")
    rx, px = _x((B, S, 64), 4)
    r_st, p_st = r_rec.mlstm_init_state(B, 4, 16), p_rec.mlstm_init_state(
        B, 4, 16)
    ys = []
    for t in range(S):
        r_y, r_st = r_rec.mlstm_step(rp, rx[:, t:t + 1], r_st, 4)
        p_y, p_st = p_rec.mlstm_step(pp, px[:, t:t + 1], p_st, 4)
        _close(p_y, r_y)
        ys.append(p_y)
    _close_tree(p_st, r_st)
    np.testing.assert_allclose(_np(torch.cat(ys, 1)),
                               _np(p_rec.mlstm_train(pp, px, 4)), atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_init_state_matches_reference(dtype):
    r_dt = jnp.dtype(str(dtype).split(".")[-1])
    _close_tree(p_rec.slstm_init_state(B, 64, dtype),
                r_rec.slstm_init_state(B, 64, r_dt))


def test_slstm_cell_matches_reference_and_takes_precomputed_projections():
    rp, pp = _params("slstm")
    rx, px = _x((B, 64), 5)
    rng = np.random.default_rng(6)
    r_st = {k: jnp.asarray(rng.standard_normal((B, 64)).astype(np.float32))
            for k in ("c", "h", "m")}
    r_st["n"] = jnp.asarray(rng.uniform(0.5, 2.0, (B, 64)).astype(np.float32))
    p_st = {k: _pt(v) for k, v in r_st.items()}
    r_new, r_h = r_rec._slstm_cell(rp, r_st, rx)
    p_new, p_h = p_rec._slstm_cell(pp, p_st, px)
    _close(p_h, r_h)
    _close_tree(p_new, r_new)
    xw = tuple(px @ pp[n] for n in ("wz", "wi_g", "wf_g", "wo_g"))
    again, h = p_rec._slstm_cell(pp, p_st, px, xw)
    assert torch.equal(h, p_h)
    assert all(torch.equal(again[k], p_new[k]) for k in p_new)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_train_matches_reference(dtype):
    rp, pp = _params("slstm", dtype)
    rx, px = _x((B, S, 64), 7, dtype)
    _close(p_rec.slstm_train(pp, px), r_rec.slstm_train(rp, rx), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_step_matches_reference(dtype):
    """Three decode steps from the f32 initial state. In bf16 the state's
    h is f32 before step 0 (h_prev @ R in f32, as JAX promotes the mixed
    product) and bf16 after every step; c, n, m stay f32."""
    rp, pp = _params("slstm", dtype)
    rx, px = _x((B, 3, 64), 8, dtype)
    r_st, p_st = r_rec.slstm_init_state(B, 64), p_rec.slstm_init_state(B, 64)
    for t in range(3):
        assert p_st["h"].dtype == (torch.float32 if t == 0 or
                                   dtype == "float32" else torch.bfloat16)
        r_y, r_st = r_rec.slstm_step(rp, rx[:, t:t + 1], r_st)
        p_y, p_st = p_rec.slstm_step(pp, px[:, t:t + 1], p_st)
        _close(p_y, r_y, dtype)
        _close_tree(p_st, r_st, dtype)
        assert p_st["c"].dtype == p_st["n"].dtype == p_st["m"].dtype \
            == torch.float32


@pytest.mark.parametrize("s", [1, 2, 3, 8, 11, 37])
def test_rglru_train_matches_reference_at_any_length(s):
    """The log-depth scan at lengths 1, 2, 3, a power of two and two that
    are none."""
    rp, pp = _params("rglru")
    rx, px = _x((B, s, 64), 9 + s)
    _close(p_rec.rglru_train(pp, px), r_rec.rglru_train(rp, rx))


def test_linear_scan_is_the_recurrence():
    rng = np.random.default_rng(10)
    a = torch.from_numpy(rng.uniform(0.0, 1.0, (3, 37, 5)))
    b = torch.from_numpy(rng.standard_normal((3, 37, 5)))
    h, want = torch.zeros((3, 5), dtype=torch.float64), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(p_rec.linear_scan(a, b).numpy(),
                               torch.stack(want, 1).numpy(), atol=1e-12)


def test_rglru_init_state_matches_reference():
    for dtype in (jnp.float32, jnp.bfloat16):
        _close(p_rec.rglru_init_state(B, 64, getattr(torch, dtype.__name__)),
               r_rec.rglru_init_state(B, 64, dtype))


def test_rglru_step_matches_reference_and_its_parallel_form():
    rp, pp = _params("rglru")
    rx, px = _x((B, S, 64), 11)
    r_h, p_h = r_rec.rglru_init_state(B, 64), p_rec.rglru_init_state(B, 64)
    ys = []
    for t in range(S):
        r_y, r_h = r_rec.rglru_step(rp, rx[:, t:t + 1], r_h)
        p_y, p_h = p_rec.rglru_step(pp, px[:, t:t + 1], p_h)
        _close(p_y, r_y)
        _close(p_h, r_h)
        ys.append(p_y)
    np.testing.assert_allclose(_np(torch.cat(ys, 1)),
                               _np(p_rec.rglru_train(pp, px)), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_train_in_bf16_orders_softplus_as_the_reference(dtype):
    """bf16 lambda: softplus in bf16, then the f32 gate."""
    rp, pp = _params("rglru", dtype)
    rx, px = _x((B, S, 64), 12, dtype)
    _close(p_rec.rglru_train(pp, px), r_rec.rglru_train(rp, rx), dtype)


def test_temporal_conv_train_matches_reference():
    rp, pp = _params("rglru")
    rx, px = _x((B, S, 64), 13)
    _close(p_rec.temporal_conv_train(pp, px, 4),
           r_rec.temporal_conv_train(rp, rx, 4))


def test_temporal_conv_step_matches_reference_and_its_parallel_form():
    rp, pp = _params("rglru")
    rx, px = _x((B, S, 64), 14)
    r_st, p_st = jnp.zeros((B, 3, 64)), torch.zeros((B, 3, 64))
    ys = []
    for t in range(S):
        r_y, r_st = r_rec.temporal_conv_step(rp, rx[:, t:t + 1], r_st, 4)
        p_y, p_st = p_rec.temporal_conv_step(pp, px[:, t:t + 1], p_st, 4)
        _close(p_y, r_y)
        _close(p_st, r_st)
        ys.append(p_y)
    np.testing.assert_allclose(_np(torch.cat(ys, 1)),
                               _np(p_rec.temporal_conv_train(pp, px, 4)),
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_scan_operator_is_the_loop_and_its_gradient(dtype):
    """`torch.ops.repro_torch.slstm_scan`, the loop a trace keeps as one
    node: applied to the input projections and wo, the reference's
    `slstm_train` within tolerance, and `slstm_train`'s eager loop bit
    for bit; its backward operator, the gradients of the eager loop (the
    same autograd, so bit for bit) and, in f32, of `jax.grad` of the
    reference within F32. Its FLOP formulas count 4 · 2·B·S·D² forward and
    twice that backward."""
    from torch.utils.flop_counter import FlopCounterMode
    rp, pp = _params("slstm", dtype)
    rx, px = _x((B, S, 64), 7, dtype)
    xw = [px @ pp[n] for n in p_rec._SLSTM_IN]
    rec = [pp[n] for n in p_rec._SLSTM_REC]
    hs = torch.ops.repro_torch.slstm_scan(*xw, *rec)
    assert torch.equal(hs @ pp["wo"], p_rec.slstm_train(pp, px))
    _close(hs @ pp["wo"], r_rec.slstm_train(rp, rx), dtype)

    dh = _pt(jnp.asarray(np.random.default_rng(3).standard_normal(
        (B, S, 64)), jnp.dtype(dtype)))
    grads = torch.ops.repro_torch.slstm_scan_bwd(*xw, *rec, dh)
    live = [t.detach().requires_grad_(True) for t in (*xw, *rec)]
    want = torch.autograd.grad(p_rec._slstm_loop(*live), live, dh)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))
    if dtype == "float32":
        dx = grads[:4]
        got_dx = sum(g @ pp[n].T for g, n in zip(dx, p_rec._SLSTM_IN))
        r_dx = jax.grad(lambda x: jnp.sum(
            r_rec.slstm_train(dict(rp, wo=jnp.eye(64)), x)
            * jnp.asarray(dh.numpy())))(rx)
        _close(got_dx, r_dx)

    meta = [t.to("meta") for t in (*xw, *rec, dh)]
    with FlopCounterMode(display=False) as counter:
        torch.ops.repro_torch.slstm_scan(*meta[:-1])
        torch.ops.repro_torch.slstm_scan_bwd(*meta)
    assert counter.get_total_flops() == 3 * 8 * B * S * 64 * 64
