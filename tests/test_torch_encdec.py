"""The encoder-decoder (SeamlessM4T-medium) in the port against the JAX
package on the CPU.

`attention(cross_kv=)` at S = 1 (the decode kernel's plain version) and
S > 1 (the flash kernel's, non-causal, a key length of its own) and
`attention(cache=)` with and without a window, against
`repro.models.layers.attention` on a GQA config; their refusals; then
SeamlessM4T-medium's SMOKE config (2 encoder and 2 decoder layers, 16
audio frames), its weights drawn by the reference and carried over by
`params_from_numpy`, the token ids and frames made with numpy from a seed:
`encode`, `forward`, `lm_loss` and its gradients (`xattn`, `enc_layers`
and `audio_proj` among them), teacher-forced `decode_step(enc_out=)`,
`serve` and both launchers; a bf16 variant with the f32 frames the
reference's `serve` feeds (a f32 encoder under bf16 weights) and with
bf16 frames.

Tolerances are those of tests/test_torch_lm.py and test_torch_qwen.py
(float32 summed in another order): logits 1e-4, the loss 1e-5, gradients
1e-5 of each tensor's largest |g|, decode against the forward 2e-3 and
rtol 1e-3 (the reference's own prefill-decode tolerance), attention
outputs and caches 1e-5; bf16 logits within 2^-5 of the largest |logit|
(a few bf16 roundings, 2^-8 each, of values of that size), a f32 encoder
output under bf16 weights within 1e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.launch import train as r_train_mod
from repro.launch.serve import serve as r_serve
from repro.models import layers as r_layers
from repro.models import transformer as r_tf
from repro_torch import configs as p_configs
from repro_torch.kernels import ops as p_ops
from repro_torch.launch import serve as p_serve_mod
from repro_torch.launch import train as p_train_mod
from repro_torch.models import layers as p_layers
from repro_torch.models import transformer as p_tf

LOGIT_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
ATTN_TOL = 1e-5
BF16_REL = 2.0 ** -5
ARCH = "seamless_m4t_medium"


@functools.lru_cache(maxsize=None)
def _built(dtype="float32"):
    r_cfg = dataclasses.replace(r_configs.get_config(ARCH, smoke=True),
                                dtype=dtype)
    r_params = r_tf.init_params(r_cfg, jax.random.PRNGKey(11))
    tree = jax.tree_util.tree_map(np.asarray, r_params)
    p_cfg = p_tf.ArchConfig(**dataclasses.asdict(r_cfg))
    return r_cfg, r_params, p_cfg, p_tf.params_from_numpy(p_cfg, tree, "cpu")


def _inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(b, s), dtype=np.int32)
    audio = rng.standard_normal(
        (b, cfg.audio_frames, cfg.d_model)).astype(np.float32)
    return tokens, audio


def _gqa_layer(seed, softcap=None):
    """A GQA attention layer (8 query heads over 2 KV heads) for both
    packages: the reference's config and weights, and the port's."""
    r_cfg = r_configs.get_config("yi_6b").scaled_down(
        dtype="float32", n_heads=8, n_kv_heads=2, attn_softcap=softcap)
    rng = np.random.default_rng(seed)
    d, hd = r_cfg.d_model, r_cfg.hd
    p = {"wq": rng.standard_normal((d, 8 * hd)) * d ** -0.5,
         "wk": rng.standard_normal((d, 2 * hd)) * d ** -0.5,
         "wv": rng.standard_normal((d, 2 * hd)) * d ** -0.5,
         "wo": rng.standard_normal((8 * hd, d)) * (8 * hd) ** -0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return (r_cfg, {k: jnp.asarray(v) for k, v in p.items()},
            p_tf.ArchConfig(**dataclasses.asdict(r_cfg)),
            {k: torch.from_numpy(v) for k, v in p.items()}, rng)


@pytest.mark.parametrize("s,s_enc", [(1, 16), (1, 5), (7, 16), (20, 9)])
@pytest.mark.parametrize("softcap", [None, 1.0])
def test_cross_attention_matches_reference(s, s_enc, softcap):
    """`attention(cross_kv=)`: no RoPE, no mask, KV heads repeated; the
    decode kernel's plain version at S = 1, the flash kernel's otherwise."""
    r_cfg, r_p, p_cfg, p_p, rng = _gqa_layer(s * 100 + s_enc, softcap)
    x = rng.standard_normal((2, s, r_cfg.d_model)).astype(np.float32)
    ek, ev = (rng.standard_normal((2, 2, s_enc, r_cfg.hd)).astype(np.float32)
              for _ in range(2))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32) + 3, (2, s))
    ref, ref_cache = r_layers.attention(
        r_cfg, r_p, jnp.asarray(x), jnp.asarray(pos),
        cross_kv=(jnp.asarray(ek), jnp.asarray(ev)))
    out, cache = p_layers.attention(
        p_cfg, p_p, torch.from_numpy(x), torch.from_numpy(pos.copy()),
        cross_kv=(torch.from_numpy(ek), torch.from_numpy(ev)))
    assert ref_cache is None and cache is None
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATTN_TOL)


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("length", [0, 5, 7])
@pytest.mark.parametrize("s", [1, 4])
def test_attention_with_a_cache_matches_reference(s, length, window):
    """`attention(cache=)` at positions len + arange(S): the output and the
    new cache (k, v and len) against the reference's; "len" taken as an
    int and as a 0-d tensor."""
    r_cfg, r_p, p_cfg, p_p, rng = _gqa_layer(10 * s + length)
    x = rng.standard_normal((2, s, r_cfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((2, 2, 12, r_cfg.hd)).astype(np.float32)
              for _ in range(2))
    pos = np.broadcast_to(np.arange(length, length + s, dtype=np.int32),
                          (2, s)).copy()
    ref, ref_cache = r_layers.attention(
        r_cfg, r_p, jnp.asarray(x), jnp.asarray(pos), sliding_window=window,
        cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv),
               "len": jnp.int32(length)})
    for n in (length, torch.tensor(length)):
        cache = {"k": torch.from_numpy(ck.copy()),
                 "v": torch.from_numpy(cv.copy()), "len": n}
        out, new = p_layers.attention(p_cfg, p_p, torch.from_numpy(x),
                                      torch.from_numpy(pos),
                                      sliding_window=window, cache=cache)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=ATTN_TOL)
        for name in ("k", "v"):
            assert new[name] is cache[name]          # written in place
            np.testing.assert_allclose(new[name].numpy(),
                                       np.asarray(ref_cache[name]),
                                       atol=ATTN_TOL)
        assert int(new["len"]) == int(ref_cache["len"]) == length + s
        assert isinstance(new["len"], type(n))


def test_attention_refusals():
    """`cross_mask` raises NotImplementedError (no reference caller passes
    one); positions other than len + arange(S), and len + S past the
    cache, raise ValueError before anything is written; the flash kernels
    refuse causal attention with Sk < Sq and a prefix with Sq != Sk."""
    r_cfg, _, p_cfg, p_p, rng = _gqa_layer(0)
    x = torch.zeros((1, 4, p_cfg.d_model))
    kv = torch.zeros((1, 2, 6, p_cfg.hd))
    pos = torch.arange(4)[None]
    with pytest.raises(NotImplementedError, match="cross_mask"):
        p_layers.attention(p_cfg, p_p, x, pos, cross_kv=(kv, kv),
                           cross_mask=torch.ones((1, 6), dtype=torch.bool))
    cache = {"k": torch.ones((1, 2, 8, p_cfg.hd)),
             "v": torch.ones((1, 2, 8, p_cfg.hd)), "len": 2}
    for bad in (pos, pos + 3, torch.tensor([[2, 3, 5, 4]])):
        with pytest.raises(ValueError, match="len"):
            p_layers.attention(p_cfg, p_p, x, bad, cache=cache)
    with pytest.raises(ValueError, match="cannot take"):
        p_layers.attention(p_cfg, p_p, x, pos + 5, cache=dict(cache, len=5))
    assert bool((cache["k"] == 1).all())         # nothing was written
    q, k = torch.zeros((1, 2, 8, 16)), torch.zeros((1, 2, 5, 16))
    with pytest.raises(ValueError, match="Sk >= Sq"):
        p_ops.flash_attention(q, k, k, causal=True)
    with pytest.raises(ValueError, match="prefix"):
        p_ops.flash_attention(q, k, k, causal=False, prefix=2)
    with pytest.raises(ValueError, match="prefix"):
        p_ops.flash_attention(k, q, q, causal=True, prefix=2)


def test_params_from_numpy_carries_every_leaf():
    r_cfg, r_params, p_cfg, p_params = _built()
    leaves = jax.tree_util.tree_leaves_with_path(r_params)
    assert p_tf.param_count(p_params) == r_tf.param_count(r_params)
    for path, leaf in leaves:
        node = p_params
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert {"enc_layers", "enc_norm", "audio_proj"} <= set(p_params)
    assert all({"ln_x", "xattn"} <= set(p) for p in p_params["layers"])
    assert not any("xattn" in p for p in p_params["enc_layers"])
    # The port draws every leaf itself, in the same structure.
    drawn = p_tf.init_params(p_cfg, torch.Generator().manual_seed(0), "cpu")
    assert p_tf.param_count(drawn) == p_tf.param_count(p_params)


def test_encode_and_forward_match_reference():
    r_cfg, r_params, p_cfg, p_params = _built()
    tokens, audio = _inputs(r_cfg, 2, 12, seed=1)
    ref_enc = r_tf.encode(r_cfg, r_params, jnp.asarray(audio))
    enc = p_tf.encode(p_cfg, p_params, torch.from_numpy(audio))
    assert enc.shape == (2, r_cfg.audio_frames, r_cfg.d_model)
    np.testing.assert_allclose(enc.numpy(), np.asarray(ref_enc),
                               atol=LOGIT_TOL)
    ref, _ = r_tf.forward(r_cfg, r_params, jnp.asarray(tokens),
                          audio_embeds=jnp.asarray(audio))
    out, aux = p_tf.forward(p_cfg, p_params, torch.from_numpy(tokens),
                            audio_embeds=torch.from_numpy(audio))
    assert out.shape == (2, 12, r_cfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_TOL)
    # The encoder output reaches the logits.
    other, _ = p_tf.forward(p_cfg, p_params, torch.from_numpy(tokens),
                            audio_embeds=torch.from_numpy(audio[::-1].copy()))
    assert float((other - out).abs().max()) > 1e-3


def test_encoder_decoder_needs_audio_and_others_ignore_it():
    """An enc-dec forward without frames raises (the reference asserts); a
    config without an encoder ignores `audio_embeds`, as the reference's
    does (the port raised on them before the encoder-decoder came)."""
    r_cfg, r_params, p_cfg, p_params = _built()
    tokens, audio = _inputs(r_cfg, 2, 6, seed=2)
    with pytest.raises(AssertionError):
        r_tf.forward(r_cfg, r_params, jnp.asarray(tokens))
    with pytest.raises(ValueError, match="audio_embeds"):
        p_tf.forward(p_cfg, p_params, torch.from_numpy(tokens))
    yi = r_configs.get_config("yi_6b", smoke=True)
    yi_params = r_tf.init_params(yi, jax.random.PRNGKey(1))
    p_yi = p_tf.ArchConfig(**dataclasses.asdict(yi))
    p_yi_params = p_tf.params_from_numpy(
        p_yi, jax.tree_util.tree_map(np.asarray, yi_params), "cpu")
    frames = np.zeros((2, 16, yi.d_model), np.float32)
    ref, _ = r_tf.forward(yi, yi_params, jnp.asarray(tokens),
                          audio_embeds=jnp.asarray(frames))
    out, _ = p_tf.forward(p_yi, p_yi_params, torch.from_numpy(tokens),
                          audio_embeds=torch.from_numpy(frames))
    plain, _ = p_tf.forward(p_yi, p_yi_params, torch.from_numpy(tokens))
    np.testing.assert_array_equal(out.numpy(), plain.numpy())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_TOL)


def test_lm_loss_gradients_match_reference():
    r_cfg, r_params, p_cfg, p_params = _built()
    tokens, audio = _inputs(r_cfg, 2, 10, seed=3)
    labels = np.roll(tokens, -1, axis=-1)
    r_loss, r_grads = jax.jit(jax.value_and_grad(
        lambda p: r_tf.lm_loss(r_cfg, p, jnp.asarray(tokens),
                               jnp.asarray(labels),
                               audio_embeds=jnp.asarray(audio))))(r_params)
    live = jax.tree_util.tree_map(
        lambda t: t.detach().requires_grad_(True), p_params)
    loss = p_tf.lm_loss(p_cfg, live, torch.from_numpy(tokens),
                        torch.from_numpy(labels),
                        audio_embeds=torch.from_numpy(audio))
    loss.backward()
    assert abs(float(loss.detach()) - float(r_loss)) <= LOSS_TOL
    port = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: t.grad.numpy(), live))
    ref = dict(jax.tree_util.tree_leaves_with_path(r_grads))
    assert len(port) == len(ref)
    for path, g in port:
        r = np.asarray(ref[path])
        assert np.abs(g - r).max() <= GRAD_TOL * np.abs(r).max(), path
    for leaf in (live["audio_proj"], live["layers"][1]["xattn"]["wk"],
                 live["enc_layers"][0]["attn"]["wq"]):
        assert np.abs(leaf.grad.numpy()).max() > 0


def test_lm_loss_under_remat_equals_without():
    """`cfg.remat` checkpoints the encoder's and the decoder's layers; the
    gradients are those without it, bit for bit on the CPU."""
    _, _, p_cfg, p_params = _built()
    tokens, audio = _inputs(p_cfg, 2, 8, seed=4)
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(p_cfg, remat=remat)
        live = jax.tree_util.tree_map(
            lambda t: t.detach().requires_grad_(True), p_params)
        p_tf.lm_loss(cfg, live, torch.from_numpy(tokens),
                     torch.from_numpy(np.roll(tokens, -1, -1)),
                     audio_embeds=torch.from_numpy(audio)).backward()
        grads.append(jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda t: t.grad, live)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_teacher_forced_decode_matches_reference():
    """`decode_step(enc_out=)` over every position against the reference's
    (the caches too), and against the forward at the reference's
    prefill-decode tolerance."""
    r_cfg, r_params, p_cfg, p_params = _built()
    b, s = 2, 10
    tokens, audio = _inputs(r_cfg, b, s, seed=5)
    r_enc = r_tf.encode(r_cfg, r_params, jnp.asarray(audio))
    enc = p_tf.encode(p_cfg, p_params, torch.from_numpy(audio))
    r_state = r_tf.init_decode_state(r_cfg, b, max_len=s + 2)
    p_state = p_tf.init_decode_state(p_cfg, b, max_len=s + 2, device="cpu")
    r_step = jax.jit(functools.partial(r_tf.decode_step, r_cfg))
    ref, out = [], []
    for t in range(s):
        r_logits, r_state = r_step(r_params, jnp.asarray(tokens[:, t:t + 1]),
                                   r_state, r_enc)
        with torch.no_grad():
            logits, p_state = p_tf.decode_step(
                p_cfg, p_params, torch.from_numpy(tokens[:, t:t + 1]),
                p_state, enc_out=enc)
        ref.append(np.asarray(r_logits[:, 0]))
        out.append(logits[:, 0].numpy())
    out, ref = np.stack(out, 1), np.stack(ref, 1)
    np.testing.assert_allclose(out, ref, atol=LOGIT_TOL)
    for p_layer, r_layer in zip(p_state["layers"], r_state["layers"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(p_layer[name][:, :, :s].numpy(),
                                       np.asarray(r_layer[name])[:, :, :s],
                                       atol=LOGIT_TOL)
    fwd, _ = p_tf.forward(p_cfg, p_params, torch.from_numpy(tokens),
                          audio_embeds=torch.from_numpy(audio))
    np.testing.assert_allclose(out, fwd.detach().numpy(), atol=2e-3,
                               rtol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_matches_reference(dtype):
    """`serve` encodes f32 zero frames once, as the reference's does, and
    generates the reference's tokens, in f32 and with bf16 weights."""
    r_cfg, r_params, p_cfg, p_params = _built(dtype)
    prompts, _ = _inputs(r_cfg, 3, 6, seed=6)
    np.testing.assert_array_equal(
        p_serve_mod.serve(p_cfg, p_params, prompts, steps=5),
        np.asarray(r_serve(r_cfg, r_params, prompts, steps=5)))


@pytest.mark.parametrize("frames", ["float32", "bfloat16"])
def test_bf16_model_matches_reference(frames):
    """bf16 weights: with f32 frames (the reference's `serve`) the encoder
    runs in f32, its output a f32 tensor within 1e-5 of the reference's,
    and the decoder's cross K and V are f32 against bf16 queries; with
    bf16 frames everything is bf16. The logits within 2^-5 of the
    largest |logit| either way."""
    r_cfg, r_params, p_cfg, p_params = _built("bfloat16")
    tokens, audio = _inputs(r_cfg, 2, 12, seed=7)
    r_audio = jnp.asarray(audio).astype(getattr(jnp, frames))
    p_audio = torch.from_numpy(audio).to(getattr(torch, frames))
    r_enc = r_tf.encode(r_cfg, r_params, r_audio)
    enc = p_tf.encode(p_cfg, p_params, p_audio)
    assert enc.dtype == getattr(torch, frames)
    assert str(r_enc.dtype) == frames
    r_enc = np.asarray(r_enc.astype(jnp.float32))
    if frames == "float32":
        np.testing.assert_allclose(enc.numpy(), r_enc, atol=ATTN_TOL)
    else:
        assert np.abs(enc.float().numpy() - r_enc).max() <= \
            BF16_REL * np.abs(r_enc).max()
    ref, _ = r_tf.forward(r_cfg, r_params, jnp.asarray(tokens),
                          audio_embeds=r_audio)
    out, _ = p_tf.forward(p_cfg, p_params, torch.from_numpy(tokens),
                          audio_embeds=p_audio)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.abs(out.float().numpy() - ref).max() <= \
        BF16_REL * np.abs(ref).max()
    with pytest.raises(RuntimeError):        # what the port promotes by hand
        torch.matmul(torch.from_numpy(audio), p_params["audio_proj"])


def test_serve_cli_runs_the_encoder_decoder(capsys):
    args = ["--mode", "lm", "--arch", ARCH, "--batch", "2", "--prompt-len",
            "3", "--steps", "4"]
    p_serve_mod.main([*args, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out and "on cpu" in out


def test_train_launchers_refuse_the_encoder_decoder():
    """Neither launcher feeds audio frames (the reference's batches carry
    none), so `--arch seamless_m4t_medium` fails in both: the reference
    asserts in `forward`, the port raises ValueError there."""
    args = ["--arch", ARCH, "--steps", "1", "--batch", "1", "--seq", "4"]
    with pytest.raises(AssertionError, match="encoder frames"):
        r_train_mod.main(args)
    with pytest.raises(ValueError, match="audio_embeds"):
        p_train_mod.main([*args, "--device", "cpu"])


def test_config_and_registry():
    r_cfg = r_configs.get_config(ARCH)
    p_cfg = p_configs.get_config(ARCH)
    assert dataclasses.asdict(p_cfg) == dataclasses.asdict(r_cfg)
    assert p_cfg.is_enc_dec and not p_cfg.subquadratic
    params = p_tf._param_spec(p_cfg)
    count = sum(int(np.prod(shape)) for shape in _shapes(params))
    assert count == 978_806_784                   # 1.96 GB in bf16


def _shapes(spec):
    if isinstance(spec, dict):
        return [s for v in spec.values() for s in _shapes(v)]
    if isinstance(spec, list):
        return [s for v in spec for s in _shapes(v)]
    return [spec[0]]
