"""The port's MoE feed-forward (`repro_torch.models.layers.moe_ffn`)
against the reference's `repro.models.layers.moe_ffn` on the CPU.

The reference's `init_params` draws an MoE layer's weights (router,
w_gate, w_up, w_down); the same values and the same activations, made with
numpy from a seed, go through both in float32:
  * Mixtral's SMOKE config (4 experts, top-2) on 2 x 24 tokens, where no
    assignment drops (capacity 64);
  * the same with `capacity_factor` lowered to 0.25 on 2 x 128 tokens:
    capacity 64 for 128 assignments an expert on average, so about half
    the assignments drop, and those tokens lose that expert's share;
  * a top-8 config (16 experts) on 2 x 40 tokens, whose eight rows a token
    the combine sums in slot order.

Tolerances: out atol 1e-5 (f32 products and sums in another order), aux
1e-6; the gradients of Σ out·cot + aux with respect to x and every weight
within 1e-5 of each tensor's largest |g|. The dropped assignments are
counted from the router on numpy and must be what the case says.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import layers as r_layers
from repro.models import transformer as r_tf
from repro_torch.models import layers as p_layers
from repro_torch.models import transformer as p_tf

OUT_TOL = 1e-5
AUX_TOL = 1e-6
GRAD_TOL = 1e-5


CASES = {  # name: (config overrides, (batch, seq), dropped assignments?)
    "smoke": ({}, (2, 24), False),
    "drops": ({"capacity_factor": 0.25}, (2, 128), True),
    "top8": ({"n_experts": 16, "top_k": 8}, (2, 40), False),
}


def _case(name):
    overrides, shape, drops = CASES[name]
    r_cfg = dataclasses.replace(
        r_configs.get_config("mixtral_8x22b", smoke=True), **overrides)
    r_params = r_tf.init_params(r_cfg, jax.random.PRNGKey(7))
    moe = {k: np.array(v) for k, v in r_params["layers"][0]["moe"].items()}
    x = np.random.default_rng(sum(shape)).standard_normal(
        (*shape, r_cfg.d_model)).astype(np.float32)
    p_cfg = p_tf.ArchConfig(**dataclasses.asdict(r_cfg))
    return r_cfg, p_cfg, moe, x, drops


def _dropped(cfg, moe, x):
    """Assignments ranked at or past the capacity, from the router on
    numpy: top-k of the f32 softmax, capacity as the reference rounds it."""
    t = x.shape[0] * x.shape[1]
    logits = x.reshape(t, -1) @ moe["w_router"]
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :cfg.top_k]
    counts = np.bincount(top.reshape(-1), minlength=cfg.n_experts)
    cap = max(1, int(cfg.capacity_factor * t * cfg.top_k / cfg.n_experts))
    cap = (cap + 63) // 64 * 64
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_ffn_matches_reference(name):
    """out and aux of the port's `moe_ffn` against the reference's."""
    r_cfg, p_cfg, moe, x, drops = _case(name)
    ref, r_aux = r_layers.moe_ffn(
        r_cfg, {k: jnp.asarray(v) for k, v in moe.items()}, jnp.asarray(x))
    out, aux = p_layers.moe_ffn(
        p_cfg, {k: torch.from_numpy(v) for k, v in moe.items()},
        torch.from_numpy(x))
    assert out.shape == x.shape and out.dtype == torch.float32
    assert aux.shape == () and aux.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OUT_TOL)
    assert abs(float(aux) - float(r_aux)) <= AUX_TOL
    assert (_dropped(p_cfg, moe, x) > 0) == drops


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_ffn_gradients_match_reference(name):
    """The gradients of Σ out·cot + aux with respect to x and the four
    weights against `jax.grad` of the reference's (drops included: a
    dropped assignment passes no gradient to its expert)."""
    r_cfg, p_cfg, moe, x, _ = _case(name)
    cot = np.random.default_rng(1).standard_normal(x.shape).astype(
        np.float32)

    def f(p, x_):
        out, aux = r_layers.moe_ffn(r_cfg, p, x_)
        return jnp.sum(out * cot) + aux

    r_gp, r_gx = jax.grad(f, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in moe.items()}, jnp.asarray(x))
    live = {k: torch.from_numpy(v).requires_grad_(True)
            for k, v in moe.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = p_layers.moe_ffn(p_cfg, live, xt)
    (torch.sum(out * torch.from_numpy(cot)) + aux).backward()
    pairs = [(xt.grad, r_gx)] + [(live[k].grad, r_gp[k]) for k in moe]
    for g, r in pairs:
        r = np.asarray(r)
        assert g.shape == r.shape
        assert np.abs(g.numpy() - r).max() <= GRAD_TOL * np.abs(r).max()


def test_moe_ffn_is_deterministic_and_keeps_the_dtype():
    """bf16 activations and weights give bf16 out (f32 aux), the same bits
    on a second call: the combine has no atomics."""
    _, p_cfg, moe, x, _ = _case("top8")
    p = {k: torch.from_numpy(v).bfloat16() for k, v in moe.items()}
    xt = torch.from_numpy(x).bfloat16()
    out, aux = p_layers.moe_ffn(p_cfg, p, xt)
    again, aux2 = p_layers.moe_ffn(p_cfg, p, xt)
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert torch.equal(out, again) and torch.equal(aux, aux2)


def test_moe_ffn_breaks_router_ties_as_the_reference():
    """Experts whose router columns are equal get equal probabilities for
    every token; `lax.top_k` takes the lower expert first, and so must the
    port (bf16 router logits tie often enough to matter in serving). A
    zero router ties all 16 experts exactly for every token: each token
    takes experts 0-7 at weight 1/8, and past the capacity of 64 the
    later tokens drop."""
    r_cfg, p_cfg, moe, x, _ = _case("top8")
    moe = dict(moe, w_router=np.zeros_like(moe["w_router"]))
    ref, r_aux = r_layers.moe_ffn(
        r_cfg, {k: jnp.asarray(v) for k, v in moe.items()}, jnp.asarray(x))
    out, aux = p_layers.moe_ffn(
        p_cfg, {k: torch.from_numpy(v) for k, v in moe.items()},
        torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OUT_TOL)
    assert abs(float(aux) - float(r_aux)) <= AUX_TOL
