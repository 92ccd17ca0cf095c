"""The port's training path on the CPU against the JAX package's, on the
cases of tests/test_spgemm_grad.py: gradients through the streamed
`AiresSpGEMM` and its fused `gcn_layer`, the backward `StreamStats`, one
optimizer step, and an 8-epoch out-of-core training run.

Both packages see the same inputs: matrices from the shared `make_sparse`
factory, features, weights and labels drawn with numpy (or the reference's
`gcn_init`, carried across with `params_from_numpy`). On CPU tensors the
port runs its kernels' plain versions; the reference runs its Pallas
kernels in interpret mode. Tolerances are the reference tests' own.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as r_models
import repro.train as r_train
from repro.core import AiresConfig as RConfig, AiresSpGEMM as RSpGEMM

import repro_torch.models as p_models
import repro_torch.train as p_train
from repro_torch.core import AiresConfig as PConfig, AiresSpGEMM as PSpGEMM
from repro_torch.sparse import CSR

SHAPES = [(16, 16, 8), (40, 24, 16), (33, 57, 24), (41, 23, 12)]
STATS = ("segments", "uploaded_bytes", "cache_hits", "cache_hit_bytes",
         "reissues")


def _engines(r_csr, h_nbytes, frac=0.8):
    """(port engine on the CPU, reference engine, port CSR) at
    tests/test_spgemm_grad.py's budget rule."""
    budget = int((r_csr.nbytes() + 3 * h_nbytes) * frac) + 4096
    p_csr = CSR(r_csr.indptr.copy(), r_csr.indices.copy(),
                r_csr.data.copy(), r_csr.shape)
    return (PSpGEMM(PConfig(device_budget_bytes=budget, bm=8, bk=8,
                            device="cpu")),
            RSpGEMM(RConfig(device_budget_bytes=budget, bm=8, bk=8)),
            p_csr)


def _case(make_sparse, n, m, f, density=0.25, seed=0):
    a, dense = make_sparse(n, m, density=density, seed=seed)
    h = np.random.default_rng(seed + 1).standard_normal((m, f)).astype(
        np.float32)
    return a, dense, h


def _stats(log):
    return [tuple(getattr(s, c) for c in STATS) for s in log]


@pytest.mark.parametrize("n,m,f", SHAPES)
def test_grad_matches_reference_f32(n, m, f, make_sparse):
    r_a, dense, h = _case(make_sparse, n, m, f, seed=n * m + f)
    pe, re, p_a = _engines(r_a, h.nbytes)
    ht = torch.from_numpy(h).requires_grad_(True)
    torch.sum(torch.sin(pe(p_a, ht))).backward()
    g_ref = jax.grad(lambda h_: jnp.sum(jnp.sin(re(r_a, h_))))(
        jnp.asarray(h))
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(g_ref), atol=1e-4)
    np.testing.assert_allclose(
        ht.grad.numpy(), dense.T @ np.cos(dense @ h), atol=1e-4)
    assert pe.last_backward_stream_stats.segments >= 1
    assert (_stats(pe.backward_stats_log) == _stats(re.backward_stats_log))
    assert (_stats(pe.forward_stats_log) == _stats(re.forward_stats_log))


def _rounded(x: np.ndarray, dtype: str):
    """x rounded once to `dtype` through torch: (the torch tensor, the same
    values as a jnp array of that dtype). numpy has no bfloat16, so the
    values cross as float32, where every bfloat16 and float16 is exact."""
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return t, jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))


@pytest.mark.parametrize("dtype", [np.float32, np.float16, "bfloat16"])
def test_grad_dtypes(dtype, make_sparse):
    """The gradient comes back in the primal dtype, for every type the
    port's SpMM kernel takes."""
    dtype = np.dtype(dtype).name if dtype != "bfloat16" else dtype
    r_a, dense, h_np = _case(make_sparse, 40, 40, 16, seed=7)
    pe, re, p_a = _engines(r_a, h_np.nbytes)
    ht, hj = _rounded(h_np, dtype)
    ht.requires_grad_(True)
    torch.sum(pe(p_a, ht)).backward()
    g_ref = jax.grad(lambda h_: jnp.sum(re(r_a, h_)))(hj)
    assert ht.grad.dtype == getattr(torch, dtype)
    assert g_ref.dtype == getattr(jnp, dtype)
    atol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(ht.grad.float().numpy(),
                               np.asarray(g_ref, np.float32), atol=atol)
    np.testing.assert_allclose(ht.grad.float().numpy(),
                               dense.sum(axis=0)[:, None]
                               * np.ones((1, 16), np.float32), atol=atol)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_gcn_forward_out_of_core_16bit_matches_reference(dtype, make_sparse):
    """Out-of-core gcn_forward with 16-bit H and params: the streamed SpMM
    gives f32 X, which meets 16-bit W; both packages promote to f32 and
    return f32 logits, within the reference test's 5e-2."""
    r_a, dense, h_np = _case(make_sparse, 40, 40, 16, seed=8)
    rng = np.random.default_rng(3)
    dims = [(16, 16), (16, 4)]
    raw = {}
    for i, (din, dout) in enumerate(dims):
        raw[f"w{i}"] = (rng.standard_normal((din, dout))
                        * din ** -0.5).astype(np.float32)
        raw[f"b{i}"] = (0.1 * rng.standard_normal(dout)).astype(np.float32)
    pairs = {k: _rounded(v, dtype) for k, v in raw.items()}
    h_t, h_j = _rounded(h_np, dtype)
    kw = dict(feature_dim=16, hidden_dims=(16,), n_classes=4,
              out_of_core=True, dtype=dtype)
    pe, re, p_a = _engines(r_a, h_np.nbytes)
    port = p_models.gcn_forward(p_models.GCNConfig(**kw),
                                {k: t for k, (t, _) in pairs.items()}, p_a,
                                h_t, engine=pe)
    ref = r_models.gcn_forward(r_models.GCNConfig(**kw),
                               {k: j for k, (_, j) in pairs.items()}, r_a,
                               h_j, engine=re)
    assert port.dtype == torch.float32 and ref.dtype == jnp.float32
    assert port.shape == ref.shape == (40, 4)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=5e-2)
    assert _stats(pe.forward_stats_log) == _stats(re.forward_stats_log)


def test_grad_streams_multiple_transposed_segments(make_sparse):
    """A tight budget forces both directions to stream ≥2 segments, with
    equal per-segment statistics in the two packages."""
    r_a, dense, h = _case(make_sparse, 64, 64, 16, density=0.3, seed=3)
    pe, re, p_a = _engines(r_a, h.nbytes, frac=0.35)
    ht = torch.from_numpy(h).requires_grad_(True)
    torch.sum(pe(p_a, ht) ** 2).backward()
    g_ref = jax.grad(lambda h_: jnp.sum(re(r_a, h_) ** 2))(jnp.asarray(h))
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(g_ref), atol=1e-3)
    np.testing.assert_allclose(ht.grad.numpy(), 2 * dense.T @ (dense @ h),
                               atol=1e-3)
    assert pe.last_stream_stats.segments >= 2
    assert pe.last_backward_stream_stats.segments >= 2
    assert _stats(pe.backward_stats_log) == _stats(re.backward_stats_log)
    assert (pe.last_backward_stream_stats.uploaded_bytes
            == re.last_backward_stream_stats.uploaded_bytes > 0)


def test_no_backward_stream_without_grad(make_sparse):
    """H that needs no gradient records no backward stream, as in the
    reference, where jax.grad never differentiates a constant."""
    r_a, _, h = _case(make_sparse, 24, 24, 8, seed=5)
    pe, _, p_a = _engines(r_a, h.nbytes)
    w = torch.ones((8, 2), requires_grad=True)
    torch.sum(pe(p_a, torch.from_numpy(h)) @ w).backward()
    assert len(pe.forward_stats_log) == 1 and pe.backward_stats_log == []
    pe.reset_stats_logs()
    assert pe.forward_stats_log == [] and pe.backward_stats_log == []


def test_fused_layer_param_grads(make_sparse):
    """y, dH, dW, db through the fused relu((A H) W + b) streamed layer,
    against the reference's custom VJP and the dense chain."""
    r_a, dense, h = _case(make_sparse, 41, 41, 12, seed=11)
    rng = np.random.default_rng(5)
    w = rng.standard_normal((12, 6)).astype(np.float32)
    b = rng.standard_normal((6,)).astype(np.float32)
    pe, re, p_a = _engines(r_a, h.nbytes)

    args = [torch.from_numpy(x).requires_grad_(True) for x in (h, w, b)]
    y = pe.gcn_layer(p_a, *args)
    torch.sum(torch.tanh(y)).backward()

    def loss_ref(h_, w_, b_):
        return jnp.sum(jnp.tanh(re.gcn_layer(r_a, h_, w_, b_)))

    refs = jax.grad(loss_ref, argnums=(0, 1, 2))(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(
        y.detach().numpy(), np.maximum(dense @ h @ w + b, 0), atol=1e-4)
    for t, r in zip(args, refs):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=2e-3)
    # The fused forward, then the recompute and the transposed stream.
    assert _stats(pe.forward_stats_log) == _stats(re.forward_stats_log)
    assert _stats(pe.backward_stats_log) == _stats(re.backward_stats_log)
    assert len(pe.backward_stats_log) == 2


def test_fused_layer_always_streams_dh(make_sparse):
    """Like the reference's VJP, the layer's backward streams Aᵀ even when
    only W needs a gradient."""
    r_a, _, h = _case(make_sparse, 24, 24, 8, seed=2)
    pe, _, p_a = _engines(r_a, h.nbytes)
    w = torch.ones((8, 4), requires_grad=True)
    pe.gcn_layer(p_a, torch.from_numpy(h), w, torch.zeros(4)).sum().backward()
    assert w.grad is not None and len(pe.backward_stats_log) == 2


def test_gcn_model_grads_out_of_core(make_sparse):
    """Full GCN parameter grads through gcn_loss(engine=) against the
    reference's, from the same weights, with equal backward logs."""
    r_a, dense, h = _case(make_sparse, 40, 40, 16, seed=2)
    r_cfg = r_models.GCNConfig(feature_dim=16, hidden_dims=(16,),
                               n_classes=4, out_of_core=True)
    p_cfg = p_models.GCNConfig(feature_dim=16, hidden_dims=(16,),
                               n_classes=4, out_of_core=True)
    r_params = r_models.gcn_init(r_cfg, jax.random.PRNGKey(0))
    labels = np.random.default_rng(1).integers(0, 4, size=(r_a.n_rows,))
    pe, re, p_a = _engines(r_a, h.nbytes)

    params = p_models.params_from_numpy(
        {k: np.asarray(v) for k, v in r_params.items()}, "cpu")
    for p in params.values():
        p.requires_grad_(True)
    loss = p_models.gcn_loss(p_cfg, params, p_a, torch.from_numpy(h),
                             torch.from_numpy(labels), engine=pe)
    grads = torch.autograd.grad(loss, list(params.values()))
    r_loss, r_grads = jax.value_and_grad(
        lambda p: r_models.gcn_loss(r_cfg, p, r_a, jnp.asarray(h),
                                    jnp.asarray(labels), engine=re))(r_params)
    np.testing.assert_allclose(float(loss.detach()), float(r_loss),
                               atol=1e-5)
    for k, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r_grads[k]),
                                   atol=1e-4, err_msg=k)
    assert len(pe.backward_stats_log) == len(re.backward_stats_log) >= 1
    assert _stats(pe.backward_stats_log) == _stats(re.backward_stats_log)
    # ... and the dense in-core path agrees.
    ic = dataclasses.replace(p_cfg, out_of_core=False)
    loss_ic = p_models.gcn_loss(ic, params, torch.from_numpy(dense),
                                torch.from_numpy(h), torch.from_numpy(labels))
    for g, g_ic in zip(grads, torch.autograd.grad(loss_ic,
                                                  list(params.values()))):
        np.testing.assert_allclose(g.numpy(), g_ic.numpy(), atol=1e-4)


def _optimizer_case():
    rng = np.random.default_rng(9)
    params = {"w0": rng.standard_normal((6, 5)).astype(np.float32),
              "b0": rng.standard_normal((5,)).astype(np.float32),
              "w1": rng.standard_normal((5, 1)).astype(np.float32)}
    grads = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
    return params, grads


def _tree_close(port, ref, atol):
    if isinstance(port, dict):
        assert set(port) == set(ref)
        for k in port:
            _tree_close(port[k], ref[k], atol)
    elif isinstance(port, torch.Tensor):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol)
    else:
        assert port == int(ref)


@pytest.mark.parametrize("name,hyper", [
    ("adamw", {"lr": 1e-2}),
    ("adamw", {"lr": 3e-3, "weight_decay": 0.1}),
    ("adafactor", {}),
    ("adafactor", {"lr": 5e-2, "weight_decay": 0.01}),
])
def test_optimizer_steps_match_reference(name, hyper):
    """Two steps of each optimizer: parameters and state within 1e-6."""
    params, grads = _optimizer_case()
    p_init, p_update = p_train.make_optimizer(name, **hyper)
    r_init, r_update = r_train.make_optimizer(name, **hyper)
    pp = {k: torch.from_numpy(v) for k, v in params.items()}
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    ps, rs = p_init(pp), r_init(rp)
    for scale in (1.0, -0.5):
        pp, ps = p_update(pp, {k: torch.from_numpy(scale * g)
                               for k, g in grads.items()}, ps)
        rp, rs = r_update(rp, {k: jnp.asarray(scale * g)
                               for k, g in grads.items()}, rs)
        _tree_close(pp, rp, 1e-6)
        _tree_close(ps, rs, 1e-6)
    assert all(not p.requires_grad for p in pp.values())


def test_optimizer_keeps_param_dtype():
    p = {"w": torch.ones((3, 2), dtype=torch.float16)}
    g = {"w": torch.full((3, 2), 0.5, dtype=torch.float16)}
    for name in p_train.OPTIMIZERS:
        init, update = p_train.make_optimizer(name)
        new, state = update(p, g, init(p))
        assert new["w"].dtype == torch.float16 and state["step"] == 1


def test_gcn_train_loop_matches_reference(make_sparse):
    """8 out-of-core AdamW epochs: the loss history within 1e-4 of the
    reference's, from the same weights, and every epoch streams both
    directions with the reference's per-segment statistics."""
    r_a, _, h = _case(make_sparse, 40, 40, 16, seed=4)
    r_cfg = r_models.GCNConfig(feature_dim=16, hidden_dims=(16,),
                               n_classes=4, out_of_core=True)
    p_cfg = p_models.GCNConfig(feature_dim=16, hidden_dims=(16,),
                               n_classes=4, out_of_core=True)
    r_params = r_models.gcn_init(r_cfg, jax.random.PRNGKey(0))
    labels = np.random.default_rng(1).integers(0, 4, size=(r_a.n_rows,))
    pe, re, p_a = _engines(r_a, h.nbytes)

    params, info = p_train.gcn_train_loop(
        p_cfg, pe, p_a, torch.from_numpy(h), torch.from_numpy(labels),
        p_models.params_from_numpy(
            {k: np.asarray(v) for k, v in r_params.items()}, "cpu"),
        n_epochs=8, lr=5e-2)
    r_params, r_info = r_train.gcn_train_loop(
        r_cfg, re, r_a, jnp.asarray(h), jnp.asarray(labels), r_params,
        n_epochs=8, lr=5e-2)
    losses = [loss for _, loss in info["history"]]
    assert [e for e, _ in info["history"]] == list(range(8))
    np.testing.assert_allclose(losses, [loss for _, loss in r_info["history"]],
                               atol=1e-4)
    assert losses[-1] < 0.8 * losses[0]
    for k, v in params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(r_params[k]),
                                   atol=1e-4, err_msg=k)
    assert len(info["epochs"]) == 8 and info["seconds"] > 0
    for ep, r_ep in zip(info["epochs"], r_info["epochs"]):
        assert len(ep["forward_stream"]) == 2       # two layers
        assert _stats(ep["forward_stream"]) == _stats(r_ep["forward_stream"])
        assert (_stats(ep["backward_stream"])
                == _stats(r_ep["backward_stream"]))
        assert all(s.segments >= 1 for s in ep["backward_stream"])
