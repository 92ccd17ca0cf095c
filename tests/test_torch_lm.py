"""Parity of the port's dense LM path with the JAX package on the CPU.

The reference's `init_params` draws the weights; `params_from_numpy`
carries the same values to the port, and the same token ids, made with
numpy from a seed, go through both. The models run in float32 at smoke
size, where the port's attention takes the kernels' plain versions.

Configs: each dense arch's SMOKE config (n_heads == n_kv_heads == 4:
group 1) and a GQA variant of Yi-6B's (8 query heads over 2 KV heads:
group 4), so that both the repeat of KV heads in `forward` and the grouped
decode are exercised.

Tolerances (float32, the same arithmetic summed in another order): logits
atol 1e-4, the loss 1e-5; teacher-forced decode against the full forward,
atol 2e-3 and rtol 1e-3 as tests/test_models.py's
test_prefill_decode_consistency holds the reference; generated tokens
exactly equal.
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

LOGIT_TOL = 1e-4
LOSS_TOL = 1e-5
DENSE = ("yi_6b", "yi_9b", "deepseek_7b")


def _gqa():
    return r_configs.get_config("yi_6b").scaled_down(
        dtype="float32", n_heads=8, n_kv_heads=2)


CONFIGS = {"yi_6b": lambda: r_configs.get_config("yi_6b", smoke=True),
           "deepseek_7b": lambda: r_configs.get_config("deepseek_7b",
                                                       smoke=True),
           "yi_6b_gqa": _gqa}


def _port_cfg(r_cfg):
    """The same field values in the port's own dataclass."""
    return p_tf.ArchConfig(**dataclasses.asdict(r_cfg))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    r_cfg = CONFIGS[request.param]()
    r_params = r_tf.init_params(r_cfg, jax.random.PRNGKey(3))
    tree = jax.tree_util.tree_map(np.asarray, r_params)
    p_cfg = _port_cfg(r_cfg)
    return r_cfg, r_params, p_cfg, p_tf.params_from_numpy(p_cfg, tree, "cpu")


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


@pytest.mark.parametrize("arch", DENSE)
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
    assert p_configs.arch_ids() == r_configs.arch_ids()
    assert p_configs.SHAPES == r_configs.SHAPES
    unported = set(r_configs.arch_ids()) - set(DENSE)
    assert len(unported) == 7
    for arch in sorted(unported):
        with pytest.raises(NotImplementedError, match="queue 1 item 8"):
            p_configs.get_config(arch)
    with pytest.raises(KeyError):
        p_configs.get_config("no_such_arch")
    assert p_configs.get_config("yi-6b").name == "yi-6b"     # alias


def test_model_refuses_unported_configs():
    base = p_configs.get_config("yi_6b", smoke=True)
    for bad in (dict(sliding_window=8), dict(n_experts=4, top_k=2),
                dict(attn_softcap=50.0), dict(encoder_layers=2),
                dict(mrope_sections=(2, 3, 3)),
                dict(block_pattern=("rglru", "attn"))):
        cfg = dataclasses.replace(base, **bad)
        with pytest.raises(NotImplementedError, match="queue 1 item 8"):
            p_tf.init_params(cfg, torch.Generator(), device="cpu")


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
    ("deepseek_7b", 6_910_365_696)])
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


def test_teacher_forced_decode_matches_reference(model):
    r_cfg, r_params, p_cfg, p_params = model
    b, s = 3, 10
    tokens = _tokens(r_cfg, b, s, seed=4)
    r_state = r_tf.init_decode_state(r_cfg, b, max_len=s + 2)
    p_state = p_tf.init_decode_state(p_cfg, b, max_len=s + 2, device="cpu")
    caches = [st["k"] for st in p_state["layers"]]
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
    assert all(st["k"] is c for st, c in zip(p_state["layers"], caches))
    np.testing.assert_allclose(
        p_state["layers"][-1]["v"][:, :, :s].numpy(),
        np.asarray(r_state["layers"][-1]["v"][:, :, :s]), atol=LOGIT_TOL)
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


def test_attention_refuses_unported_arguments():
    cfg = p_configs.get_config("yi_6b", smoke=True)
    params = p_tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p = params["layers"][0]["attn"]
    x = torch.zeros((1, 4, cfg.d_model))
    pos = torch.arange(4)[None]
    with pytest.raises(NotImplementedError, match="cache"):
        p_layers.attention(cfg, p, x, pos, cache={"k": x, "v": x, "len": 0})
    with pytest.raises(NotImplementedError, match="sliding-window"):
        p_layers.attention(cfg, p, x, pos, sliding_window=2)
    with pytest.raises(NotImplementedError, match="cross"):
        p_layers.attention(cfg, p, x, pos, cross_kv=(x, x))
    with pytest.raises(NotImplementedError, match="softcap"):
        p_layers.attention(dataclasses.replace(cfg, attn_softcap=30.0), p, x,
                           pos)
    with pytest.raises(NotImplementedError):
        p_layers.moe_ffn(cfg, p, x)


def test_serve_cli_runs_lm_mode_on_cpu(capsys):
    p_serve_mod.main(["--mode", "lm", "--arch", "yi_6b", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "3", "--steps", "4"])
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
