"""Qwen2-VL's M-RoPE, vision input and bidirectional vision prefix in the
port against the JAX package on the CPU.

`apply_mrope` and `_build_positions` against the reference's, at the SMOKE
sections (2, 3, 3) over hd 16 and the published (16, 24, 24) over hd 128;
`attention`'s prefix against the reference's mask by temporal id, and its
refusals; then Qwen2-VL-72B's SMOKE config (2 layers, 8 vision tokens),
its weights drawn by the reference and carried over by `params_from_numpy`,
the token ids and vision embeddings made with numpy from a seed: `forward`
with `vision_embeds` in float32 and with bf16 weights (the projection's
promotion), `lm_loss` gradients (`vision_proj` among them), teacher-forced
`decode_step`, `serve` and the serving CLI.

As in the reference, decode rotates by plain RoPE at the index and masks
causally (ROADMAP.md queue 3, R6), so its logits are held to the
reference's decode and to a forward without M-RoPE and the vision prefix,
not to the M-RoPE forward.

Tolerances are those of tests/test_torch_lm.py and test_torch_lm_train.py
(float32 summed in another order): logits 1e-4, the loss 1e-5, gradients
1e-5 of each tensor's largest |g|, decode against a forward 2e-3 and rtol
1e-3 (the reference's own prefill-decode tolerance); bf16 below.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.launch.serve import main as r_serve_main
from repro.launch.serve import serve as r_serve
from repro.models import layers as r_layers
from repro.models import transformer as r_tf
from repro_torch import configs as p_configs
from repro_torch.launch import serve as p_serve_mod
from repro_torch.models import layers as p_layers
from repro_torch.models import transformer as p_tf

LOGIT_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
ARCH = "qwen2_vl_72b"


@functools.lru_cache(maxsize=None)
def _built(dtype="float32"):
    r_cfg = dataclasses.replace(r_configs.get_config(ARCH, smoke=True),
                                dtype=dtype)
    r_params = r_tf.init_params(r_cfg, jax.random.PRNGKey(7))
    tree = jax.tree_util.tree_map(np.asarray, r_params)
    p_cfg = p_tf.ArchConfig(**dataclasses.asdict(r_cfg))
    return r_cfg, r_params, p_cfg, p_tf.params_from_numpy(p_cfg, tree, "cpu")


def _inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(b, s), dtype=np.int32)
    vision = rng.standard_normal(
        (b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return tokens, vision


@pytest.mark.parametrize("hd,sections", [(16, (2, 3, 3)),
                                         (128, (16, 24, 24))])
def test_apply_mrope_matches_reference(hd, sections):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 3, 11, hd)).astype(np.float32)
    pos = rng.integers(0, 1000, size=(3, 2, 11)).astype(np.int32)
    out = p_layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                               10_000.0, sections)
    ref = r_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 10_000.0,
                               sections)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    # Equal ids in the three streams are plain RoPE.
    same = np.ascontiguousarray(np.broadcast_to(pos[:1], pos.shape))
    np.testing.assert_allclose(
        p_layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(same),
                             10_000.0, sections).numpy(),
        p_layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]),
                            10_000.0).numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="sections"):
        p_layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                             10_000.0, (1, 2, 3))


@pytest.mark.parametrize("smoke,s", [(True, 24), (True, 8), (False, 300),
                                     (False, 4096)])
def test_build_positions_matches_reference(smoke, s):
    r_cfg = r_configs.get_config(ARCH, smoke=smoke)
    p_cfg = p_configs.get_config(ARCH, smoke=smoke)
    out = p_tf._build_positions(p_cfg, 2, s, "cpu")
    ref = np.asarray(r_tf._build_positions(r_cfg, 2, s))
    assert out.shape == (3, 2, s) and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    yi = p_configs.get_config("yi_6b", smoke=True)
    np.testing.assert_array_equal(
        p_tf._build_positions(yi, 2, s, "cpu").numpy(),
        np.asarray(r_tf._build_positions(r_configs.get_config(
            "yi_6b", smoke=True), 2, s)))


@pytest.mark.parametrize("s", [8, 9, 24])
def test_attention_prefix_is_the_reference_mask(s):
    """`attention` under M-RoPE (the kernels' bidirectional prefix of 8
    vision positions, by index) against the reference's (by temporal id)
    on the same weights and inputs, at S = 8 (all vision), 9 and 24."""
    r_cfg, r_params, p_cfg, p_params = _built()
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, r_cfg.d_model)).astype(np.float32)
    r_pos = r_tf._build_positions(r_cfg, 2, s)
    ref, _ = jax.jit(functools.partial(r_layers.attention, r_cfg))(
        r_params["layers"][0]["attn"], jnp.asarray(x), r_pos)
    out, _ = p_layers.attention(p_cfg, p_params["layers"][0]["attn"],
                                torch.from_numpy(x),
                                p_tf._build_positions(p_cfg, 2, s, "cpu"))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_TOL)


def test_attention_refuses_positions_the_prefix_cannot_mask():
    """Fewer positions than vision tokens (the reference's
    `_build_positions` cannot build them either), temporal ids of another
    layout, and (B, S) positions under M-RoPE raise ValueError."""
    _, _, p_cfg, p_params = _built()
    p = p_params["layers"][0]["attn"]
    x = torch.zeros((1, 7, p_cfg.d_model))
    with pytest.raises(ValueError, match="fewer than"):
        p_tf._build_positions(p_cfg, 1, 7, "cpu")
    with pytest.raises(ValueError, match="fewer than"):
        p_layers.attention(p_cfg, p, x, torch.zeros((3, 1, 7),
                                                    dtype=torch.int32))
    x = torch.zeros((1, 12, p_cfg.d_model))
    pos = p_tf._build_positions(p_cfg, 1, 12, "cpu").clone()
    pos[0, 0, 9] = 7                 # a text position's temporal id moved
    with pytest.raises(ValueError, match="temporal"):
        p_layers.attention(p_cfg, p, x, pos)
    with pytest.raises(ValueError, match=r"\(3, B, S\)"):
        p_layers.attention(p_cfg, p, x, torch.arange(12)[None])
    with pytest.raises(ValueError, match="vision_embeds"):
        p_tf.forward(p_cfg, p_params, torch.zeros((1, 12), dtype=torch.long),
                     vision_embeds=torch.zeros((1, 7, p_cfg.d_model)))


def test_forward_with_vision_matches_reference():
    r_cfg, r_params, p_cfg, p_params = _built()
    tokens, vision = _inputs(r_cfg, 2, 24, seed=1)
    ref, _ = r_tf.forward(r_cfg, r_params, jnp.asarray(tokens),
                          vision_embeds=jnp.asarray(vision))
    out, aux = p_tf.forward(p_cfg, p_params, torch.from_numpy(tokens),
                            vision_embeds=torch.from_numpy(vision))
    assert out.shape == (2, 24, r_cfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_TOL)
    # Without vision input both attend over the token embeddings alone.
    ref, _ = r_tf.forward(r_cfg, r_params, jnp.asarray(tokens))
    out, _ = p_tf.forward(p_cfg, p_params, torch.from_numpy(tokens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_TOL)


def test_bf16_forward_promotes_the_vision_projection():
    """bf16 weights and activations, f32 vision embeddings: JAX computes
    f32 @ bf16 in f32 and rounds once to bf16, and so does the port, so
    the projected rows agree to one bf16 rounding of the same f32 sums;
    the logits after two bf16 layers within 2^-5 of the largest |logit|
    (a few bf16 roundings, 2^-8 each, of values of that size)."""
    r_cfg, r_params, p_cfg, p_params = _built("bfloat16")
    tokens, vision = _inputs(r_cfg, 2, 16, seed=2)
    vis = np.asarray((jnp.asarray(vision) @ r_params["vision_proj"]).astype(
        jnp.bfloat16)).astype(np.float32)
    port_vis = (torch.from_numpy(vision) @ p_params["vision_proj"].float()
                ).bfloat16().float().numpy()
    np.testing.assert_allclose(port_vis, vis, rtol=2.0 ** -7, atol=1e-6)
    ref, _ = jax.jit(functools.partial(r_tf.forward, r_cfg))(
        r_params, jnp.asarray(tokens), vision_embeds=jnp.asarray(vision))
    out, _ = p_tf.forward(p_cfg, p_params, torch.from_numpy(tokens),
                          vision_embeds=torch.from_numpy(vision))
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.abs(out.float().numpy() - ref).max() <= 2.0 ** -5 * \
        np.abs(ref).max()
    with pytest.raises(RuntimeError):        # what the port promotes by hand
        torch.matmul(torch.from_numpy(vision), p_params["vision_proj"])


def test_lm_loss_gradients_with_vision_match_reference():
    r_cfg, r_params, p_cfg, p_params = _built()
    tokens, vision = _inputs(r_cfg, 2, 16, seed=3)
    labels = np.roll(tokens, -1, axis=-1)
    r_loss, r_grads = jax.jit(jax.value_and_grad(
        lambda p: r_tf.lm_loss(r_cfg, p, jnp.asarray(tokens),
                               jnp.asarray(labels),
                               vision_embeds=jnp.asarray(vision))))(r_params)
    live = jax.tree_util.tree_map(
        lambda t: t.detach().requires_grad_(True), p_params)
    loss = p_tf.lm_loss(p_cfg, live, torch.from_numpy(tokens),
                        torch.from_numpy(labels),
                        vision_embeds=torch.from_numpy(vision))
    loss.backward()
    assert abs(float(loss.detach()) - float(r_loss)) <= LOSS_TOL
    port = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: t.grad.numpy(), live))
    ref = dict(jax.tree_util.tree_leaves_with_path(r_grads))
    assert len(port) == len(ref)
    for path, g in port:
        r = np.asarray(ref[path])
        assert np.abs(g - r).max() <= GRAD_TOL * np.abs(r).max(), path
    assert np.abs(live["vision_proj"].grad.numpy()).max() > 0


def test_decode_mirrors_the_reference_decode():
    """Teacher-forced `decode_step` against the reference's (R6: plain
    RoPE at the index, a causal cache mask), and against a forward
    without M-RoPE and vision prefix at the reference's prefill-decode
    tolerance; the M-RoPE forward differs from both."""
    r_cfg, r_params, p_cfg, p_params = _built()
    b, s = 2, 12
    tokens, _ = _inputs(r_cfg, b, s, seed=4)
    r_state = r_tf.init_decode_state(r_cfg, b, max_len=s + 2)
    p_state = p_tf.init_decode_state(p_cfg, b, max_len=s + 2, device="cpu")
    ref, out = [], []
    r_step = jax.jit(functools.partial(r_tf.decode_step, r_cfg))
    for t in range(s):
        r_logits, r_state = r_step(r_params, jnp.asarray(tokens[:, t:t + 1]),
                                   r_state)
        logits, p_state = p_tf.decode_step(
            p_cfg, p_params, torch.from_numpy(tokens[:, t:t + 1]), p_state)
        ref.append(np.asarray(r_logits[:, 0]))
        out.append(logits[:, 0].numpy())
    out, ref = np.stack(out, 1), np.stack(ref, 1)
    np.testing.assert_allclose(out, ref, atol=LOGIT_TOL)
    for p_layer, r_layer in zip(p_state["layers"], r_state["layers"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(p_layer[name][:, :, :s].numpy(),
                                       np.asarray(r_layer[name])[:, :, :s],
                                       atol=LOGIT_TOL)
    plain_cfg = dataclasses.replace(p_cfg, mrope_sections=None,
                                    n_vision_tokens=0)
    plain, _ = p_tf.forward(plain_cfg, p_params, torch.from_numpy(tokens))
    np.testing.assert_allclose(out, plain.numpy(), atol=2e-3, rtol=1e-3)
    mrope, _ = p_tf.forward(p_cfg, p_params, torch.from_numpy(tokens))
    assert not np.allclose(out, mrope.numpy(), atol=2e-3, rtol=1e-3)


def test_serve_and_cli_match_reference(capsys):
    """`serve` tokens equal the reference's on the same weights; both
    serving CLIs serve the SMOKE config with `--arch qwen2_vl_72b`."""
    r_cfg, r_params, p_cfg, p_params = _built()
    prompts, _ = _inputs(r_cfg, 3, 10, seed=5)
    np.testing.assert_array_equal(
        p_serve_mod.serve(p_cfg, p_params, prompts, steps=5),
        np.asarray(r_serve(r_cfg, r_params, prompts, steps=5)))
    args = ["--mode", "lm", "--arch", ARCH, "--batch", "2", "--prompt-len",
            "20", "--steps", "4"]
    p_serve_mod.main([*args, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out and "on cpu" in out
    r_serve_main(args)                      # the reference's CLI, beside it
    assert "generated (2, 4)" in capsys.readouterr().out
