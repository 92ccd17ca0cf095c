"""Parity of the port's LM path with the JAX package on the CPU.

The reference's `init_params` draws the weights; `params_from_numpy`
carries the same values to the port, and the same token ids, made with
numpy from a seed, go through both. The models run in float32 at smoke
size, where the port's attention takes the kernels' plain versions.

Configs: each dense arch's SMOKE config (n_heads == n_kv_heads == 4:
group 1) and a GQA variant of Yi-6B's (8 query heads over 2 KV heads:
group 4), so that both the repeat of KV heads in `forward` and the grouped
decode are exercised; and Gemma-2 27B's (local and global layers, window
16, attention softcap 50, logit softcap 30): its SMOKE config, a GQA
variant (8 over 2) and one whose caps bite (attention 1.0, logits 0.5).
The Gemma-2 configs are also held past the window (`forward` on 48
tokens) and past the ring caches' wrap (teacher-forced decode over 40
tokens, the rings' k, v and slot_pos against the reference's, slot_pos
exactly; serve with prompts longer than the window). The MoE archs'
SMOKE configs (Mixtral 8x22B, Kimi K2: every layer MOE, 4 experts top-2)
run the same tests, and Mixtral's past its window of 16, which the
reference applies to no MOE layer. The recurrent archs' SMOKE configs
(xLSTM-125M: an sLSTM and an mLSTM layer; RecurrentGemma-2B: an RG-LRU
and a local attention layer, window 16) run them too, with every decode
state leaf against the reference's, and past the window.

Tolerances (float32, the same arithmetic summed in another order): logits
atol 1e-4, the loss 1e-5, the caches 1e-4; teacher-forced decode against
the full forward, atol 2e-3 and rtol 1e-3 as tests/test_models.py's
test_prefill_decode_consistency holds the reference; generated tokens
exactly equal; the MoE aux loss within 1e-6.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.launch.serve import serve as r_serve
from repro.models import layers as r_layers
from repro.models import transformer as r_tf
from repro_torch import configs as p_configs
from repro_torch.kernels import decode_attn as p_dec
from repro_torch.kernels import flash_attn as p_flash
from repro_torch.launch import serve as p_serve_mod
from repro_torch.models import layers as p_layers
from repro_torch.models import transformer as p_tf
from repro_torch.train.optim import tree_map

LOGIT_TOL = 1e-4
LOSS_TOL = 1e-5
DENSE = ("yi_6b", "yi_9b", "deepseek_7b")
MOE = ("mixtral_8x22b", "kimi_k2_1t_a32b")
RECURRENT = ("xlstm_125m", "recurrentgemma_2b")
# Qwen2-VL's model tests (M-RoPE, the vision input) are in
# tests/test_torch_qwen.py, SeamlessM4T's (the encoder-decoder) in
# tests/test_torch_encdec.py.
PORTED = DENSE + ("gemma2_27b",) + MOE + RECURRENT + ("qwen2_vl_72b",
                                                      "seamless_m4t_medium")
AUX_TOL = 1e-6


def _gqa():
    return r_configs.get_config("yi_6b").scaled_down(
        dtype="float32", n_heads=8, n_kv_heads=2)


def _gemma(**overrides):
    return lambda: r_configs.get_config("gemma2_27b").scaled_down(
        dtype="float32", **overrides)


CONFIGS = {"yi_6b": lambda: r_configs.get_config("yi_6b", smoke=True),
           "deepseek_7b": lambda: r_configs.get_config("deepseek_7b",
                                                       smoke=True),
           "yi_6b_gqa": _gqa,
           "gemma2_27b": lambda: r_configs.get_config("gemma2_27b",
                                                      smoke=True),
           "gemma2_27b_gqa": _gemma(n_heads=8, n_kv_heads=2),
           "gemma2_27b_caps": _gemma(attn_softcap=1.0, logit_softcap=0.5),
           "mixtral_8x22b": lambda: r_configs.get_config("mixtral_8x22b",
                                                         smoke=True),
           "kimi_k2_1t_a32b": lambda: r_configs.get_config(
               "kimi_k2_1t_a32b", smoke=True),
           **{arch: functools.partial(r_configs.get_config, arch,
                                      smoke=True) for arch in RECURRENT}}
WINDOWED = sorted(name for name in CONFIGS if name.startswith("gemma2"))


def _port_cfg(r_cfg):
    """The same field values in the port's own dataclass."""
    return p_tf.ArchConfig(**dataclasses.asdict(r_cfg))


@functools.lru_cache(maxsize=None)
def _built(name):
    r_cfg = CONFIGS[name]()
    r_params = r_tf.init_params(r_cfg, jax.random.PRNGKey(3))
    tree = jax.tree_util.tree_map(np.asarray, r_params)
    p_cfg = _port_cfg(r_cfg)
    return r_cfg, r_params, p_cfg, p_tf.params_from_numpy(p_cfg, tree, "cpu")


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    return _built(request.param)


@pytest.fixture(scope="module", params=WINDOWED)
def windowed(request):
    """The Gemma-2 configs: window 16, both softcaps."""
    return _built(request.param)


def _count_tensors(tree):
    if isinstance(tree, dict):
        return sum(_count_tensors(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_count_tensors(v) for v in tree)
    assert isinstance(tree, torch.Tensor)
    return 1


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(b, s), dtype=np.int32)


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("smoke", [False, True])
def test_dense_configs_equal_reference(arch, smoke):
    r_cfg = r_configs.get_config(arch, smoke=smoke)
    p_cfg = p_configs.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(p_cfg) == dataclasses.asdict(r_cfg)
    assert p_cfg.blocks() == [p_tf.BlockKind(k.value) for k in r_cfg.blocks()]
    assert p_cfg.hd == r_cfg.hd and p_cfg.subquadratic == r_cfg.subquadratic
    for shape in r_configs.SHAPES:
        assert (p_configs.shape_applicable(arch, shape)
                == r_configs.shape_applicable(arch, shape))


def test_registry_matches_reference_and_refuses_unported_archs():
    """Every arch of the reference's registry is ported now, so `get_config`
    returns a config for each id (the name stays from when one was
    refused); an unknown id still raises."""
    assert p_configs.arch_ids() == r_configs.arch_ids()
    assert p_configs.SHAPES == r_configs.SHAPES
    assert set(r_configs.arch_ids()) == set(PORTED)
    for arch in p_configs.arch_ids():
        assert p_configs.get_config(arch).name == r_configs.get_config(
            arch).name
    with pytest.raises(KeyError):
        p_configs.get_config("no_such_arch")
    assert p_configs.get_config("yi-6b").name == "yi-6b"     # alias


def test_model_refuses_unported_configs():
    """Every config field of the reference's zoo builds now: a sliding
    window, an attention softcap, MoE layers, recurrent blocks, M-RoPE, a
    vision frontend (with its `vision_proj`), and since the
    encoder-decoder came, an encoder (`enc_layers`, `enc_norm`, and
    `ln_x` and `xattn` in every decoder layer) and an audio frontend
    (`audio_proj`). The name stays from when the last two raised."""
    base = p_configs.get_config("yi_6b", smoke=True)
    for ported in (dict(sliding_window=8), dict(attn_softcap=50.0),
                   dict(sliding_window=8, local_global_pattern=2),
                   dict(n_experts=4, top_k=2, expert_d_ff=32),
                   dict(block_pattern=("rglru", "attn")),
                   dict(mrope_sections=(2, 3, 3)),
                   dict(mrope_sections=(2, 3, 3), n_vision_tokens=4),
                   dict(encoder_layers=2), dict(audio_frames=16),
                   dict(encoder_layers=2, audio_frames=16)):
        cfg = dataclasses.replace(base, **ported)
        params = p_tf.init_params(cfg, torch.Generator(), device="cpu")
        assert len(params["layers"]) == cfg.n_layers
        assert ("vision_proj" in params) == bool(cfg.n_vision_tokens)
        assert ("audio_proj" in params) == bool(cfg.audio_frames)
        assert len(params.get("enc_layers", [])) == cfg.encoder_layers
        assert all(("xattn" in p) == cfg.is_enc_dec
                   for p in params["layers"])


def test_params_from_numpy_carries_every_leaf(model):
    r_cfg, r_params, p_cfg, p_params = model
    r_leaves = jax.tree_util.tree_leaves_with_path(r_params)
    assert len(r_leaves) == _count_tensors(p_params)
    for path, leaf in r_leaves:
        node = p_params
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert p_tf.param_count(p_params) == r_tf.param_count(r_params)


def test_params_from_numpy_bf16_and_structure_checks():
    r_cfg = r_configs.get_config("yi_6b").scaled_down(dtype="bfloat16")
    tree = jax.tree_util.tree_map(
        np.asarray, r_tf.init_params(r_cfg, jax.random.PRNGKey(0)))
    p_params = p_tf.params_from_numpy(_port_cfg(r_cfg), tree, "cpu")
    wq = p_params["layers"][1]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wq.float().numpy(),
        tree["layers"][1]["attn"]["wq"].astype(np.float32))
    bad = dict(tree, embed=tree["embed"][:-1])
    with pytest.raises(ValueError, match="embed"):
        p_tf.params_from_numpy(_port_cfg(r_cfg), bad, "cpu")
    missing = dict(tree)
    del missing["lm_head"]
    with pytest.raises(ValueError, match="keys"):
        p_tf.params_from_numpy(_port_cfg(r_cfg), missing, "cpu")


@pytest.mark.parametrize("arch,count", [
    ("yi_6b", 6_061_035_520), ("yi_9b", 8_829_407_232),
    ("deepseek_7b", 6_910_365_696), ("gemma2_27b", 28_406_352_384),
    ("mixtral_8x22b", 140_630_071_296),
    ("kimi_k2_1t_a32b", 1_041_166_988_288),
    ("xlstm_125m", 114_498_048), ("recurrentgemma_2b", 3_549_841_920),
    ("qwen2_vl_72b", 72_772_493_312)])
def test_param_count_at_full_size(arch, count):
    """From the shapes alone (nothing allocated), against the reference's
    abstract init."""
    cfg = p_configs.get_config(arch)
    spec = p_tf._param_spec(cfg)
    shapes = []
    p_tf._map_spec(spec, None, lambda path, leaf, _: shapes.append(leaf[0]))
    assert sum(int(np.prod(s)) for s in shapes) == count
    r_shapes = jax.eval_shape(
        functools.partial(r_tf.init_params, r_configs.get_config(arch)),
        jax.random.PRNGKey(0))
    assert r_tf.param_count(r_shapes) == count


def test_init_params_draws_on_the_generators_device():
    cfg = p_configs.get_config("yi_6b", smoke=True)
    a = p_tf.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    b = p_tf.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    assert torch.equal(a["layers"][1]["mlp"]["w_up"],
                       b["layers"][1]["mlp"]["w_up"])
    assert not a["final_norm"].any() and a["embed"].dtype == torch.float32
    w = a["layers"][0]["attn"]["wq"]
    assert abs(float(w.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    with pytest.raises(ValueError, match="generator"):
        p_tf.init_params(cfg, torch.Generator(), device="meta")


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    scale = rng.standard_normal((16,)).astype(np.float32)
    pos = rng.integers(0, 1000, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        p_layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
        np.asarray(r_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        atol=1e-6)
    np.testing.assert_allclose(
        p_layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            10_000.0),
        np.asarray(r_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                       10_000.0)), atol=1e-4)


def test_forward_matches_reference(model):
    r_cfg, r_params, p_cfg, p_params = model
    tokens = _tokens(r_cfg, 2, 24, seed=1)
    ref, r_aux = r_tf.forward(r_cfg, r_params, jnp.asarray(tokens))
    before = p_flash.FLASH_LAUNCHES
    out, aux = p_tf.forward(p_cfg, p_params, torch.from_numpy(tokens))
    assert p_flash.FLASH_LAUNCHES == before        # CPU: plain version
    assert out.shape == (2, 24, r_cfg.vocab) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_TOL)
    assert abs(float(aux) - float(r_aux)) <= AUX_TOL
    if not r_cfg.is_moe:
        assert float(aux) == float(r_aux) == 0.0


def test_lm_loss_matches_reference(model):
    r_cfg, r_params, p_cfg, p_params = model
    tokens = _tokens(r_cfg, 2, 16, seed=2)
    labels = _tokens(r_cfg, 2, 16, seed=3)
    ref = r_tf.lm_loss(r_cfg, r_params, jnp.asarray(tokens),
                       jnp.asarray(labels))
    out = p_tf.lm_loss(p_cfg, p_params, torch.from_numpy(tokens),
                       torch.from_numpy(labels))
    assert out.shape == ()
    np.testing.assert_allclose(float(out), float(ref), atol=LOSS_TOL)


def _state_close(p_layer, r_layer):
    """A layer's decode state against the reference's: the same leaves,
    shapes and dtypes, values within LOGIT_TOL (slot_pos exactly)."""
    assert set(p_layer) == set(r_layer)
    for name, r_arr in r_layer.items():
        r_arr = np.asarray(r_arr)
        assert tuple(p_layer[name].shape) == r_arr.shape
        assert str(p_layer[name].dtype).split(".")[-1] == r_arr.dtype.name
        if name == "slot_pos":
            np.testing.assert_array_equal(p_layer[name].numpy(), r_arr)
        else:
            np.testing.assert_allclose(p_layer[name].float().numpy(), r_arr,
                                       atol=LOGIT_TOL)


def test_teacher_forced_decode_matches_reference(model):
    """Logits step by step against the reference's decode, every state
    leaf of every layer after the last step (the caches' first s
    positions), and against the port's own forward."""
    r_cfg, r_params, p_cfg, p_params = model
    b, s = 3, 10
    tokens = _tokens(r_cfg, b, s, seed=4)
    r_state = r_tf.init_decode_state(r_cfg, b, max_len=s + 2)
    p_state = p_tf.init_decode_state(p_cfg, b, max_len=s + 2, device="cpu")
    caches = [st.get("k") for st in p_state["layers"]]
    ref, out = [], []
    for t in range(s):
        r_logits, r_state = r_tf.decode_step(r_cfg, r_params,
                                              jnp.asarray(tokens[:, t:t + 1]),
                                              r_state)
        logits, p_state = p_tf.decode_step(p_cfg, p_params,
                                           torch.from_numpy(
                                               tokens[:, t:t + 1]), p_state)
        ref.append(np.asarray(r_logits[:, 0]))
        out.append(logits[:, 0].numpy())
    assert p_state["pos"] == s and isinstance(p_state["pos"], int)
    # The caches were written in place.
    assert all(st.get("k") is c for st, c in zip(p_state["layers"], caches))
    for p_layer, r_layer in zip(p_state["layers"], r_state["layers"]):
        if "k" in r_layer and "slot_pos" not in r_layer:   # full caches
            r_layer = {n: r_layer[n][:, :, :s] for n in ("k", "v")}
            p_layer = {n: p_layer[n][:, :, :s] for n in ("k", "v")}
        _state_close(p_layer, r_layer)
    np.testing.assert_allclose(np.stack(out, 1), np.stack(ref, 1),
                               atol=LOGIT_TOL)
    full, _ = p_tf.forward(p_cfg, p_params, torch.from_numpy(tokens))
    np.testing.assert_allclose(np.stack(out, 1), full.numpy(), atol=2e-3,
                               rtol=1e-3)


def test_decode_step_refuses_a_full_cache():
    cfg = p_configs.get_config("yi_6b", smoke=True)
    params = p_tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = p_tf.init_decode_state(cfg, 1, max_len=2, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.long)
    for _ in range(2):
        _, state = p_tf.decode_step(cfg, params, tok, state)
    with pytest.raises(ValueError, match="outside the cache"):
        p_tf.decode_step(cfg, params, tok, state)


def test_serve_matches_reference(model):
    r_cfg, r_params, p_cfg, p_params = model
    prompts = _tokens(r_cfg, 4, 7, seed=5)
    ref = r_serve(r_cfg, r_params, prompts, steps=6)
    before = p_dec.DECODE_LAUNCHES
    out = p_serve_mod.serve(p_cfg, p_params, prompts, steps=6)
    assert p_dec.DECODE_LAUNCHES == before         # CPU: plain version
    assert out.dtype == np.int32 and out.shape == (4, 6)
    np.testing.assert_array_equal(out, np.asarray(ref))


def _moe_hints_as_the_reference(x):
    """The MoE feed-forward's sharding hints: on plain tensors, outside a
    mesh, the port raises RuntimeError where the reference's
    `with_sharding_constraint` does; on a one-rank (1, 1) mesh with DTensor
    params and input they are taken, and the output and aux loss are the
    unhinted call's, bit for bit."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch.dryrun import fake_world
    r_cfg = r_configs.get_config("mixtral_8x22b", smoke=True)
    r_p = r_tf.init_params(r_cfg, jax.random.PRNGKey(0))["layers"][0]["moe"]
    with pytest.raises(RuntimeError, match="mesh"):
        r_layers.moe_ffn(r_cfg, r_p, jnp.zeros((1, 4, r_cfg.d_model)),
                         mesh_axes=r_tf.MESH_AXES_SINGLE)
    cfg = p_configs.get_config("mixtral_8x22b", smoke=True)
    p = p_tf.init_params(cfg, torch.Generator().manual_seed(0),
                         "cpu")["layers"][0]["moe"]
    x = torch.randn((2, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    with pytest.raises(RuntimeError, match="mesh"):
        p_layers.moe_ffn(cfg, p, x, mesh_axes=p_tf.MESH_AXES_SINGLE)
    want = p_layers.moe_ffn(cfg, p, x)
    with fake_world(1):
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))

        def dist(t):
            return DTensor.from_local(t, mesh, [Replicate(), Replicate()],
                                      run_check=False)

        with implicit_replication():
            got = p_layers.moe_ffn(cfg, {k: dist(v) for k, v in p.items()},
                                   dist(x), mesh_axes=p_tf.MESH_AXES_SINGLE)
    for g, w in zip(got, want):
        assert isinstance(g, DTensor)
        assert torch.equal(g.to_local(), w)


def test_attention_refuses_unported_arguments():
    """A key mask for cross-attention (`cross_mask`) raises; a KV cache and
    cross-attention are taken since the encoder-decoder came
    (tests/test_torch_encdec.py holds them to the reference), as are a
    sliding window and the softcap (the window must be at least 1), and
    since the dry run the MoE feed-forward's sharding hints
    (`_moe_hints_as_the_reference`). The name is kept from when more of
    these were refused, for the name-by-name comparison of test runs."""
    cfg = p_configs.get_config("yi_6b", smoke=True)
    params = p_tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p = params["layers"][0]["attn"]
    x = torch.zeros((1, 4, cfg.d_model))
    pos = torch.arange(4)[None]
    kv = torch.zeros((1, cfg.n_kv_heads, 6, cfg.hd))
    with pytest.raises(NotImplementedError, match="cross_mask"):
        p_layers.attention(cfg, p, x, pos, cross_kv=(kv, kv),
                           cross_mask=torch.ones((1, 6), dtype=torch.bool))
    out, _ = p_layers.attention(cfg, p, x, pos, cross_kv=(kv, kv))
    assert out.shape == x.shape
    cache = {"k": torch.zeros((1, cfg.n_kv_heads, 8, cfg.hd)),
             "v": torch.zeros((1, cfg.n_kv_heads, 8, cfg.hd)), "len": 0}
    out, new = p_layers.attention(cfg, p, x, pos, cache=cache)
    assert out.shape == x.shape and new["len"] == 4
    _moe_hints_as_the_reference(x)
    with pytest.raises(ValueError, match="sliding_window"):
        p_layers.attention(cfg, p, x, pos, sliding_window=0)
    out, _ = p_layers.attention(dataclasses.replace(cfg, attn_softcap=30.0),
                                p, x, pos, sliding_window=2)
    assert out.shape == x.shape


def test_serve_cli_runs_lm_mode_on_cpu(capsys):
    p_serve_mod.main(["--mode", "lm", "--arch", "yi_6b", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "3", "--steps", "4"])
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out and "on cpu" in out


def test_serve_cli_runs_gemma2_on_cpu(capsys):
    """Gemma-2's SMOKE config (window 16) with prompts longer than the
    window: the rings wrap during the prefill."""
    p_serve_mod.main(["--mode", "lm", "--arch", "gemma2_27b", "--device",
                      "cpu", "--batch", "2", "--prompt-len", "20",
                      "--steps", "4"])
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out and "on cpu" in out


def test_serve_cli_defaults_to_lm_mode(capsys):
    """`--mode` defaults to lm, as in the reference: without it the CLI
    serves the arch, and without `--arch` too it stops with lm mode's
    error."""
    p_serve_mod.main(["--arch", "yi_6b", "--device", "cpu", "--batch", "1",
                      "--prompt-len", "2", "--steps", "2"])
    assert "generated (1, 2)" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        p_serve_mod.main(["--device", "cpu"])
    assert "--arch is required in lm mode" in capsys.readouterr().err


@pytest.mark.parametrize("dtype", [None, "float32", "bfloat16"])
def test_init_decode_state_takes_dtype_fourth(dtype):
    """The fourth parameter is the caches' dtype, overriding cfg.dtype as in
    the reference; the device is keyword-only."""
    r_cfg = r_configs.get_config("yi_6b", smoke=True)
    p_cfg = p_configs.get_config("yi_6b", smoke=True)
    r_state = r_tf.init_decode_state(
        r_cfg, 2, 5, None if dtype is None else getattr(jnp, dtype))
    p_state = p_tf.init_decode_state(
        p_cfg, 2, 5, None if dtype is None else getattr(torch, dtype),
        device="cpu")
    assert len(p_state["layers"]) == len(r_state["layers"])
    for p_layer, r_layer in zip(p_state["layers"], r_state["layers"]):
        for name in ("k", "v"):
            assert tuple(p_layer[name].shape) == r_layer[name].shape
            assert str(p_layer[name].dtype).split(".")[-1] == str(
                r_layer[name].dtype)
            assert not p_layer[name].any()
    with pytest.raises(TypeError):
        p_tf.init_decode_state(p_cfg, 2, 5, None, "cpu")


def test_forward_past_the_window_matches_reference(windowed):
    """48 tokens, three times the window: the local layers' window bites."""
    r_cfg, r_params, p_cfg, p_params = windowed
    tokens = _tokens(r_cfg, 2, 48, seed=6)
    ref, _ = r_tf.forward(r_cfg, r_params, jnp.asarray(tokens))
    out, _ = p_tf.forward(p_cfg, p_params, torch.from_numpy(tokens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_TOL)


def test_ring_decode_past_the_wrap_matches_reference(windowed):
    """Teacher-forced decode over 40 tokens into caches of 42 positions:
    the local layers' rings (16 slots) wrap twice. Logits against the
    reference's decode and the port's forward; the rings' k, v against the
    reference's and slot_pos exactly equal; the global caches too."""
    r_cfg, r_params, p_cfg, p_params = windowed
    b, s = 2, 40
    tokens = _tokens(r_cfg, b, s, seed=7)
    r_state = r_tf.init_decode_state(r_cfg, b, max_len=s + 2)
    p_state = p_tf.init_decode_state(p_cfg, b, max_len=s + 2, device="cpu")
    ref, out = [], []
    for t in range(s):
        r_logits, r_state = r_tf.decode_step(r_cfg, r_params,
                                              jnp.asarray(tokens[:, t:t + 1]),
                                              r_state)
        logits, p_state = p_tf.decode_step(p_cfg, p_params,
                                           torch.from_numpy(
                                               tokens[:, t:t + 1]), p_state)
        ref.append(np.asarray(r_logits[:, 0]))
        out.append(logits[:, 0].numpy())
    np.testing.assert_allclose(np.stack(out, 1), np.stack(ref, 1),
                               atol=LOGIT_TOL)
    kinds = p_cfg.blocks()
    assert p_tf.BlockKind.LOCAL_ATTN in kinds and p_tf.BlockKind.ATTN in kinds
    for kind, p_layer, r_layer in zip(kinds, p_state["layers"],
                                      r_state["layers"]):
        assert set(p_layer) == set(r_layer)
        for name in ("k", "v"):
            assert tuple(p_layer[name].shape) == r_layer[name].shape
            np.testing.assert_allclose(p_layer[name].numpy(),
                                       np.asarray(r_layer[name]),
                                       atol=LOGIT_TOL)
        if kind == p_tf.BlockKind.LOCAL_ATTN:
            assert p_layer["slot_pos"].dtype == torch.int32
            np.testing.assert_array_equal(p_layer["slot_pos"].numpy(),
                                          np.asarray(r_layer["slot_pos"]))
            assert p_layer["k"].shape[2] == r_cfg.sliding_window
    full, _ = p_tf.forward(p_cfg, p_params, torch.from_numpy(tokens))
    np.testing.assert_allclose(np.stack(out, 1), full.numpy(), atol=2e-3,
                               rtol=1e-3)


def test_serve_past_the_window_matches_reference(windowed):
    """Prompts of 20 tokens and 8 steps: the rings wrap in the prefill."""
    r_cfg, r_params, p_cfg, p_params = windowed
    prompts = _tokens(r_cfg, 3, 20, seed=8)
    ref = r_serve(r_cfg, r_params, prompts, steps=8)
    out = p_serve_mod.serve(p_cfg, p_params, prompts, steps=8)
    np.testing.assert_array_equal(out, np.asarray(ref))


@pytest.mark.parametrize("max_len", [5, 16, 40])
def test_init_decode_state_gives_local_layers_rings(max_len):
    """A ring of min(window, max_len) slots and slot_pos of -1 on the local
    layers, a full cache on the global ones, as the reference allocates."""
    r_cfg = r_configs.get_config("gemma2_27b", smoke=True)
    p_cfg = p_configs.get_config("gemma2_27b", smoke=True)
    r_state = r_tf.init_decode_state(r_cfg, 2, max_len)
    p_state = p_tf.init_decode_state(p_cfg, 2, max_len, device="cpu")
    for p_layer, r_layer in zip(p_state["layers"], r_state["layers"]):
        assert set(p_layer) == set(r_layer)
        for name, r_arr in r_layer.items():
            assert tuple(p_layer[name].shape) == r_arr.shape
            np.testing.assert_array_equal(p_layer[name].numpy(),
                                          np.asarray(r_arr))


def test_decode_step_bounds_only_by_global_caches():
    """Gemma-2's rings never refuse a position; its global caches bound
    pos. A stack of local layers alone has no bound: past max_len its
    rings go on wrapping, as the reference's do."""
    r_cfg = r_configs.get_config("gemma2_27b", smoke=True)
    cfg = _port_cfg(r_cfg)
    params = p_tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = p_tf.init_decode_state(cfg, 1, max_len=3, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.long)
    for _ in range(3):
        _, state = p_tf.decode_step(cfg, params, tok, state)
    with pytest.raises(ValueError, match="outside the cache"):
        p_tf.decode_step(cfg, params, tok, state)
    r_local = dataclasses.replace(r_cfg, local_global_pattern=None,
                                  sliding_window=4)
    local = _port_cfg(r_local)
    assert set(local.blocks()) == {p_tf.BlockKind.LOCAL_ATTN}
    r_params = r_tf.init_params(r_local, jax.random.PRNGKey(1))
    p_params = p_tf.params_from_numpy(
        local, jax.tree_util.tree_map(np.asarray, r_params), "cpu")
    tokens = _tokens(local, 1, 9, seed=9)
    r_state = r_tf.init_decode_state(r_local, 1, max_len=3)
    p_state = p_tf.init_decode_state(local, 1, max_len=3, device="cpu")
    for t in range(9):                   # three times max_len
        r_logits, r_state = r_tf.decode_step(
            r_local, r_params, jnp.asarray(tokens[:, t:t + 1]), r_state)
        logits, p_state = p_tf.decode_step(
            local, p_params, torch.from_numpy(tokens[:, t:t + 1]), p_state)
        np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                                   atol=LOGIT_TOL)
    np.testing.assert_array_equal(p_state["layers"][0]["slot_pos"].numpy(),
                                  np.asarray(r_state["layers"][0]["slot_pos"]))


def test_softcapped_lm_loss_under_autograd_raises():
    """`lm_loss` of Gemma-2's SMOKE config (both softcaps, window 16)
    under autograd, on 24 tokens past the window: the loss and every
    gradient against `jax.grad` of the reference's `lm_loss`, within 1e-5
    of each tensor's largest |g| (the name is kept from when the softcap
    had no backward and this raised)."""
    r_cfg, r_params, p_cfg, p_params = _built("gemma2_27b")
    tokens = _tokens(r_cfg, 2, 24, seed=10)
    labels = np.roll(tokens, -1, axis=1)
    r_loss, r_grads = jax.value_and_grad(
        lambda p: r_tf.lm_loss(r_cfg, p, jnp.asarray(tokens),
                               jnp.asarray(labels)))(r_params)
    live = tree_map(lambda t: t.detach().requires_grad_(True), p_params)
    before = p_flash.FLASH_BWD_LAUNCHES
    loss = p_tf.lm_loss(p_cfg, live, torch.from_numpy(tokens),
                        torch.from_numpy(labels))
    loss.backward()
    assert p_flash.FLASH_BWD_LAUNCHES == before    # CPU: plain version
    assert abs(float(loss.detach()) - float(r_loss)) <= LOSS_TOL
    r_leaves = jax.tree_util.tree_leaves(r_grads)
    p_leaves = jax.tree_util.tree_leaves(tree_map(lambda t: t.grad, live))
    assert len(r_leaves) == len(p_leaves)
    for g, r in zip(p_leaves, r_leaves):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 1e-5 * np.abs(r).max()


def test_moe_layers_attend_without_a_window():
    """Mixtral's SMOKE config has sliding_window 16, but every layer is an
    MOE block, to which the reference applies no window: `forward` on 40
    tokens and a teacher-forced decode over them (full caches, no
    slot_pos) match the reference, and differ from the same stack with
    the window applied."""
    r_cfg, r_params, p_cfg, p_params = _built("mixtral_8x22b")
    assert r_cfg.sliding_window == 16
    assert set(p_cfg.blocks()) == {p_tf.BlockKind.MOE}
    tokens = _tokens(r_cfg, 2, 40, seed=11)
    ref, r_aux = r_tf.forward(r_cfg, r_params, jnp.asarray(tokens))
    out, aux = p_tf.forward(p_cfg, p_params, torch.from_numpy(tokens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_TOL)
    assert abs(float(aux) - float(r_aux)) <= AUX_TOL
    state = p_tf.init_decode_state(p_cfg, 2, 40, device="cpu")
    assert all("slot_pos" not in st and st["k"].shape[2] == 40
               for st in state["layers"])
    dec = []
    for t in range(40):
        logits, state = p_tf.decode_step(
            p_cfg, p_params, torch.from_numpy(tokens[:, t:t + 1]), state)
        dec.append(logits[:, 0].numpy())
    np.testing.assert_allclose(np.stack(dec, 1), np.asarray(ref), atol=2e-3,
                               rtol=1e-3)
    # With the window the positions past it would attend elsewhere.
    h = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (1, 40, p_cfg.d_model)).astype(np.float32))
    attn = p_params["layers"][0]["attn"]
    pos = torch.arange(40)[None]
    full, _ = p_layers.attention(p_cfg, attn, h, pos)
    windowed, _ = p_layers.attention(p_cfg, attn, h, pos,
                                     sliding_window=16)
    assert torch.equal(full[:, :16], windowed[:, :16])
    assert float((full[:, 16:] - windowed[:, 16:]).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", MOE)
def test_serve_cli_runs_moe_on_cpu(arch, capsys):
    """`--mode lm --arch` of both MoE archs serves their SMOKE configs."""
    p_serve_mod.main(["--mode", "lm", "--arch", arch, "--device", "cpu",
                      "--batch", "2", "--prompt-len", "20", "--steps", "4"])
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out and "on cpu" in out


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_decode_past_the_window_matches_reference(arch):
    """The recurrent SMOKE configs over 40 tokens, past RecurrentGemma's
    window of 16 (its local layer's ring wraps twice): `forward` against
    the reference's, teacher-forced decode logits and every state leaf
    after the last step against the reference's decode, and the decode
    against the forward at the reference's own prefill-decode tolerance."""
    r_cfg, r_params, p_cfg, p_params = _built(arch)
    b, s = 2, 40
    tokens = _tokens(r_cfg, b, s, seed=13)
    r_full, _ = r_tf.forward(r_cfg, r_params, jnp.asarray(tokens))
    full, _ = p_tf.forward(p_cfg, p_params, torch.from_numpy(tokens))
    np.testing.assert_allclose(full.numpy(), np.asarray(r_full),
                               atol=LOGIT_TOL)
    r_state = r_tf.init_decode_state(r_cfg, b, max_len=s + 2)
    p_state = p_tf.init_decode_state(p_cfg, b, max_len=s + 2, device="cpu")
    ref, out = [], []
    for t in range(s):
        r_logits, r_state = r_tf.decode_step(r_cfg, r_params,
                                              jnp.asarray(tokens[:, t:t + 1]),
                                              r_state)
        logits, p_state = p_tf.decode_step(p_cfg, p_params,
                                           torch.from_numpy(
                                               tokens[:, t:t + 1]), p_state)
        ref.append(np.asarray(r_logits[:, 0]))
        out.append(logits[:, 0].numpy())
    np.testing.assert_allclose(np.stack(out, 1), np.stack(ref, 1),
                               atol=LOGIT_TOL)
    for p_layer, r_layer in zip(p_state["layers"], r_state["layers"]):
        _state_close(p_layer, r_layer)
    np.testing.assert_allclose(np.stack(out, 1), full.numpy(), atol=2e-3,
                               rtol=1e-3)


@pytest.mark.parametrize("arch", RECURRENT)
def test_serve_cli_runs_recurrent_archs_as_the_reference(arch, capsys):
    """`--mode lm --arch` of both recurrent archs serves their SMOKE
    configs, prompts past RecurrentGemma's window, to the tokens
    `repro.launch.serve.serve` gives for the same weights."""
    p_serve_mod.main(["--mode", "lm", "--arch", arch, "--device", "cpu",
                      "--batch", "2", "--prompt-len", "20", "--steps", "4"])
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out and "on cpu" in out
    r_cfg, r_params, p_cfg, p_params = _built(arch)
    prompts = _tokens(r_cfg, 2, 20, seed=14)
    np.testing.assert_array_equal(
        p_serve_mod.serve(p_cfg, p_params, prompts, steps=4),
        np.asarray(r_serve(r_cfg, r_params, prompts, steps=4)))
