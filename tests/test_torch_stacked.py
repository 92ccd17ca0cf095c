"""The port's scan-over-layers path (`repro_torch.models.stacked`) against
the JAX package's on the CPU, for every arch of the registry, as
tests/test_stacked_scan.py holds the reference's.

The reference's `init_params_stacked` draws the weights and
`params_from_numpy_stacked` carries its stacked tree to the port; the
same token ids (and, where the arch takes them, vision embeddings or
audio frames), made with numpy from a seed, go through both. Each stacked
path is held within the reference test's atol 2e-4 and rtol 1e-4 of the
reference's stacked path and of the port's unrolled path on the same
weights: `forward_scan` against `forward`, two `decode_step_scan` steps
against `decode_step` (the stacked state's leaves too), and
`lm_loss_scan`'s gradients against `lm_loss`'s.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import arch_ids, get_config
from repro.models import stacked as r_st
from repro.models import transformer as r_tf
from repro_torch import configs as p_configs
from repro_torch.models import stacked as p_st
from repro_torch.models import transformer as p_tf

KEY = jax.random.PRNGKey(0)
B, S = 2, 8
ATOL, RTOL = 2e-4, 1e-4


@functools.lru_cache(maxsize=None)
def _built(arch):
    r_cfg = get_config(arch, smoke=True)
    r_params = r_st.init_params_stacked(r_cfg, KEY)
    p_cfg = p_tf.ArchConfig(**dataclasses.asdict(r_cfg))
    p_params = p_st.params_from_numpy_stacked(
        p_cfg, jax.tree_util.tree_map(np.asarray, r_params), "cpu")
    return r_cfg, r_params, p_cfg, p_params


def _inputs(cfg):
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, size=(B, S), dtype=np.int32)
    kw = {}
    if cfg.n_vision_tokens:
        kw["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_enc_dec:
        kw["audio_embeds"] = rng.standard_normal(
            (B, cfg.audio_frames, cfg.d_model)).astype(np.float32)
    return tokens, kw


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("arch", arch_ids())
def test_scan_equals_unrolled(arch):
    r_cfg, r_params, p_cfg, p_params = _built(arch)
    tokens, kw = _inputs(r_cfg)
    r_kw = {k: jnp.asarray(v) for k, v in kw.items()}
    p_kw = {k: torch.from_numpy(v) for k, v in kw.items()}
    ref, _ = r_st.forward_scan(r_cfg, r_params, jnp.asarray(tokens), **r_kw)
    with torch.no_grad():
        out, aux = p_st.forward_scan(p_cfg, p_params,
                                     torch.from_numpy(tokens), **p_kw)
        flat, flat_aux = p_tf.forward(
            p_cfg, p_st.unstack_params(p_cfg, p_params),
            torch.from_numpy(tokens), **p_kw)
        last, _ = p_st.forward_scan(p_cfg, p_params,
                                    torch.from_numpy(tokens), last_only=True,
                                    **p_kw)
    _close(out.numpy(), ref)
    _close(out.numpy(), flat.numpy())
    _close(float(aux), float(flat_aux))
    np.testing.assert_array_equal(last.numpy(), out[:, -1:].numpy())
    # The reference's unrolled forward on the unstacked weights, beside it.
    r_flat, _ = r_tf.forward(r_cfg, r_tf.init_params(r_cfg, KEY),
                             jnp.asarray(tokens), **r_kw)
    _close(out.numpy(), r_flat)


@pytest.mark.parametrize("arch", arch_ids())
def test_scan_decode_matches_unrolled_and_reference(arch):
    """Two greedy steps of `decode_step_scan` (zero frames for the
    encoder-decoder, as the reference's test feeds it) against the
    reference's and against `decode_step` on the unstacked weights; the
    stacked state's leaves against the unrolled state's."""
    r_cfg, r_params, p_cfg, p_params = _built(arch)
    r_enc = (jnp.zeros((B, r_cfg.audio_frames, r_cfg.d_model))
             if r_cfg.is_enc_dec else None)
    p_enc = (torch.zeros((B, p_cfg.audio_frames, p_cfg.d_model))
             if p_cfg.is_enc_dec else None)
    r_state = r_st.init_decode_state_stacked(r_cfg, B, 16)
    state = p_st.init_decode_state_stacked(p_cfg, B, 16, device="cpu")
    flat_params = p_st.unstack_params(p_cfg, p_params)
    flat_state = p_tf.init_decode_state(p_cfg, B, 16, device="cpu")
    step = jax.jit(lambda p, t, st: r_st.decode_step_scan(
        r_cfg, p, t, st, enc_out=r_enc))
    tok = np.zeros((B, 1), np.int32)
    for _ in range(2):
        ref, r_state = step(r_params, jnp.asarray(tok), r_state)
        with torch.no_grad():
            out, state = p_st.decode_step_scan(
                p_cfg, p_params, torch.from_numpy(tok).long(), state,
                enc_out=p_enc)
            flat, flat_state = p_tf.decode_step(
                p_cfg, flat_params, torch.from_numpy(tok).long(),
                flat_state, enc_out=p_enc)
        assert np.isfinite(out.numpy()).all()
        _close(out.numpy(), ref)
        _close(out.numpy(), flat.numpy())
        tok = np.asarray(jnp.argmax(ref, -1)).astype(np.int32)
    assert state["pos"] == flat_state["pos"] == 2
    views = p_st._layers(p_cfg, state["scan"], state["rest"])
    assert len(views) == len(flat_state["layers"])
    for got, want in zip(views, flat_state["layers"]):
        assert set(got) == set(want)
        for name in want:
            _close(got[name].float().numpy(), want[name].float().numpy())


@pytest.mark.parametrize("arch", arch_ids())
def test_scan_loss_grads_match_unrolled(arch):
    """`lm_loss_scan` and its gradients against `lm_loss` on the unstacked
    weights (gradients restacked), the loss against the reference's
    `lm_loss_scan`; every gradient finite."""
    r_cfg, r_params, p_cfg, p_params = _built(arch)
    tokens, kw = _inputs(r_cfg)
    p_kw = {k: torch.from_numpy(v) for k, v in kw.items()}
    r_loss = r_st.lm_loss_scan(r_cfg, r_params, jnp.asarray(tokens),
                               jnp.asarray(tokens),
                               **{k: jnp.asarray(v) for k, v in kw.items()})
    live = jax.tree_util.tree_map(
        lambda t: t.detach().clone().requires_grad_(True), p_params)
    loss = p_st.lm_loss_scan(p_cfg, live, torch.from_numpy(tokens),
                             torch.from_numpy(tokens), **p_kw)
    loss.backward()
    flat = jax.tree_util.tree_map(
        lambda t: t.detach().clone().requires_grad_(True),
        p_st.unstack_params(p_cfg, p_params))
    flat_loss = p_tf.lm_loss(p_cfg, flat, torch.from_numpy(tokens),
                             torch.from_numpy(tokens), **p_kw)
    flat_loss.backward()
    _close(float(loss.detach()), float(r_loss))
    _close(float(loss.detach()), float(flat_loss.detach()))
    want = p_st.stack_params(p_cfg, jax.tree_util.tree_map(
        lambda t: t.grad, flat))
    got = jax.tree_util.tree_map(lambda t: t.grad, live)
    pairs = list(zip(jax.tree_util.tree_leaves(got),
                     jax.tree_util.tree_leaves(want)))
    assert len(pairs) == len(jax.tree_util.tree_leaves(r_params))
    for g, w in pairs:
        assert np.isfinite(g.numpy()).all()
        _close(g.numpy(), w.numpy())


def test_group_split_covers_all_layers():
    for arch in arch_ids():
        r_cfg, p_cfg = get_config(arch), p_configs.get_config(arch)
        r, rem = p_st.group_split(p_cfg)
        assert (r, rem) == r_st.group_split(r_cfg)
        assert [k.value for k in p_st.unit_kinds(p_cfg)] == [
            k.value for k in r_st.unit_kinds(r_cfg)]
        assert r * len(p_st.unit_kinds(p_cfg)) + rem == p_cfg.n_layers


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "seamless_m4t_medium"])
def test_init_params_stacked_draws_init_params(arch):
    """The stacked weights are `init_params`' from the same generator, and
    `unstack_params` gives them back leaf for leaf (RecurrentGemma at 4
    layers: one repeat of its unit of 3 and a remainder of 1)."""
    cfg = p_configs.get_config(arch, smoke=True)
    if arch == "recurrentgemma_2b":
        cfg = dataclasses.replace(cfg, n_layers=4,
                                  block_pattern=("rglru", "rglru", "local"))
    assert p_st.group_split(cfg) == ((1, 1) if cfg.block_pattern else (2, 0))
    stacked = p_st.init_params_stacked(cfg, torch.Generator().manual_seed(3),
                                       "cpu")
    flat = p_tf.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    got = jax.tree_util.tree_leaves(p_st.unstack_params(cfg, stacked))
    want = jax.tree_util.tree_leaves(flat)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
