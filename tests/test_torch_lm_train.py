"""LM training in the port against the JAX package on the CPU.

The reference's `init_params` draws the weights; `params_from_numpy`
carries the same values to the port, and the same token ids, made with
numpy from a seed, go through both. The models run in float32 at smoke
size (Yi-6B's SMOKE config, n_heads == n_kv_heads: group 1, and a GQA
variant, 8 query heads over 2 KV heads: group 4; Gemma-2's, with both
softcaps and a window of 16; Mixtral's and Kimi K2's, every layer MoE;
RecurrentGemma-2B's and xLSTM-125M's, the recurrent blocks differentiated
as plain PyTorch; Qwen2-VL's, M-RoPE with the vision block's
bidirectional prefix),
where the port's attention takes the kernels' plain versions under
the `flash_attn` operator and its autograd formula, the softcapped
backward among them; the reference trains through XLA's autodiff of its jnp
`_attn_core`, which has no Pallas backward.

Tolerances, each for float32 arithmetic summed in another order:
  * attention gradients, GRAD_TOL absolute on values of order 1;
  * `lm_loss` gradients, LM_GRAD_TOL relative to each tensor's largest
    |g| (sums over the batch, the vocabulary and two layers);
  * one train step, the loss within LOSS_TOL;
    parameters and optimizer state within STATE_TOL relative to each
    tensor's largest value. Two discontinuities let a few elements go
    further, and `_close_but_for_flips` bounds those by what one flip can
    do: AdamW's first update is m̂ / (√v̂ + 1e-8), about sign(g), so a
    gradient within rounding of 0 may move its parameter by up to 2·lr the
    other way; and int8 compression rounds each g / scale to an integer,
    so an element within rounding of a half step may round to the
    neighbouring integer, which moves its residual and its decompressed
    gradient by one step (the leaf's scale) and, through the first
    update, its parameter by up to 2·lr.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro import train as r_train
from repro.models import layers as r_layers
from repro.models import transformer as r_tf
from repro_torch import train as p_train
from repro_torch.kernels import flash_attn as p_flash
from repro_torch.models import transformer as p_tf
from repro_torch.train.optim import tree_map

GRAD_TOL = 2e-5
LM_GRAD_TOL = 1e-5
# xLSTM-125M's SMOKE config: its exponential gates and the mLSTM's
# normalizer amplify f32 rounding, so that the reference's own f32
# gradients lie up to 4.7e-5 (relative to each tensor's largest |g|) from
# float64 autograd of the same weights, and the port's up to 6.7e-5; the
# two are held to 1e-4 of each other, above both.
LM_GRAD_TOL_BY_CONFIG = {"xlstm-125m": 1e-4}
LOSS_TOL = 1e-5
STATE_TOL = 1e-5
# Elements of a tensor allowed past STATE_TOL (each within one flip's
# bound): at most this share of the tensor, and at least one.
FLIP_SHARE = 1e-3


def _gqa():
    return r_configs.get_config("yi_6b").scaled_down(
        dtype="float32", n_heads=8, n_kv_heads=2)


CONFIGS = {"yi_6b": lambda: r_configs.get_config("yi_6b", smoke=True),
           "yi_6b_gqa": _gqa,
           "gemma2_27b": lambda: r_configs.get_config("gemma2_27b",
                                                      smoke=True),
           "mixtral_8x22b": lambda: r_configs.get_config("mixtral_8x22b",
                                                         smoke=True),
           "kimi_k2_1t_a32b": lambda: r_configs.get_config(
               "kimi_k2_1t_a32b", smoke=True),
           **{arch: (lambda arch=arch: r_configs.get_config(arch,
                                                            smoke=True))
              for arch in ("recurrentgemma_2b", "xlstm_125m",
                           "qwen2_vl_72b")}}


@pytest.fixture(scope="module")
def models():
    return {name: _model(name) for name in CONFIGS}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request, models):
    return models[request.param]


def _model(name):
    r_cfg = CONFIGS[name]()
    r_params = r_tf.init_params(r_cfg, jax.random.PRNGKey(5))
    tree = jax.tree_util.tree_map(np.asarray, r_params)
    p_cfg = p_tf.ArchConfig(**dataclasses.asdict(r_cfg))
    return r_cfg, r_params, p_cfg, p_tf.params_from_numpy(p_cfg, tree, "cpu")


def _batch(cfg, shape, seed):
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab, size=shape, dtype=np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=-1)}


def _flat(tree, prefix=""):
    """{path: numpy array} of a tree of tensors or arrays."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{prefix}{i}/").items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().numpy()
    return {prefix: np.asarray(tree)}


def _close_but_for_flips(port, ref, flip_bound, magnitude=None):
    """Every tensor within STATE_TOL of the reference relative to its
    largest |value| (or to `magnitude(path)`), but for at most FLIP_SHARE
    of its elements (at least one), each within `flip_bound(path)`."""
    port, ref = _flat(port), _flat(ref)
    assert set(port) == set(ref)
    for path in sorted(ref):
        r = ref[path].astype(np.float64)
        p = port[path].astype(np.float64)
        assert p.shape == r.shape, path
        if r.size == 0:
            continue
        delta = np.abs(p - r)
        mag = float(np.abs(r).max()) if magnitude is None \
            else magnitude(path)
        far = delta > STATE_TOL * max(mag, 1e-30)
        assert far.sum() <= max(1, FLIP_SHARE * r.size), (
            path, int(far.sum()), float(delta.max()))
        if far.any():
            assert delta[far].max() <= flip_bound(path), (
                path, float(delta[far].max()), flip_bound(path))


def _grads_port(p_cfg, params, batch):
    live = jax.tree_util.tree_map(
        lambda t: t.detach().requires_grad_(True), params)
    loss = p_tf.lm_loss(p_cfg, live, torch.from_numpy(batch["tokens"]),
                        torch.from_numpy(batch["labels"]))
    loss.backward()
    # A leaf the loss does not reach (Qwen2-VL's vision_proj without vision
    # input) has no grad; jax.grad gives it zeros.
    return float(loss.detach()), jax.tree_util.tree_map(
        lambda t: torch.zeros_like(t) if t.grad is None else t.grad, live)


# ---- attention backward -----------------------------------------------------


def _reference_mask(s_len, causal, window, prefix=0):
    """The reference's mask. With a prefix P, as `attention` builds it
    under M-RoPE: from the temporal ids of `_build_positions` (P zeros,
    then 1, 2, ...), key j valid for query i iff t_j <= t_i."""
    pos = np.arange(s_len)
    t = np.maximum(pos - prefix + 1, 0) if prefix else pos
    mask = np.ones((s_len, s_len), bool)
    if causal:
        mask &= t[None, :] <= t[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    return mask


# (causal, window, head dim, prefix): the first four cases keep their ids;
# then d = 256 (RecurrentGemma's, which the card's backward takes since its
# NC = 16 instances), and the bidirectional prefix at P = 0, 1, 8 and S.
BWD_CASES = [(True, 0, 16, 0), (True, 7, 16, 0), (False, 0, 16, 0),
             (False, 9, 16, 0), (True, 0, 256, 0), (True, 7, 256, 0),
             (False, 0, 256, 0), (True, 0, 256, 8), (True, 0, 16, 1),
             (True, 0, 16, 8), (True, 0, 16, 37), (True, 7, 16, 8)]


@pytest.mark.parametrize(
    "causal,window,d,prefix", BWD_CASES,
    ids=[f"{c}-{w}" if (d, p) == (16, 0) else f"{c}-{w}-d{d}-prefix{p}"
         for c, w, d, p in BWD_CASES])
def test_attention_backward_matches_reference(causal, window, d, prefix):
    """The `flash_attn` operator's backward on CPU tensors (the plain
    backward) and
    `flash_attention_bwd_plain` against `jax.grad` of the reference's
    `_attn_core` on the same q, k, v and cotangent, under the reference's
    mask (with a prefix, the one `attention` builds from M-RoPE's temporal
    ids); the plain forward and its lse against `_attn_core` and a
    logsumexp over that mask."""
    rng = np.random.default_rng(window + 2 * causal + d + 3 * prefix)
    q, k, v, cot = (rng.standard_normal((2, 3, 37, d)).astype(np.float32)
                    for _ in range(4))
    mask = jnp.asarray(np.broadcast_to(
        _reference_mask(37, causal, window, prefix), (2, 37, 37)))

    def f(q_, k_, v_):
        return jnp.sum(r_layers._attn_core(q_, k_, v_, mask, None) * cot)

    ref = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    live = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    before = p_flash.FLASH_BWD_LAUNCHES
    out = p_flash.flash_attention_blocks(*live, causal=causal, window=window,
                                         prefix=prefix)
    out.backward(torch.from_numpy(cot))
    assert p_flash.FLASH_BWD_LAUNCHES == before    # CPU: the plain version
    np.testing.assert_allclose(
        out.detach().numpy(), np.asarray(r_layers._attn_core(
            *map(jnp.asarray, (q, k, v)), mask, None)), atol=GRAD_TOL)
    for t, r in zip(live, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   atol=GRAD_TOL)
    fwd, lse = p_flash.flash_attention_plain_lse(
        *(t.detach() for t in live), causal=causal, window=window,
        prefix=prefix)
    plain = p_flash.flash_attention_bwd_plain(
        *(t.detach() for t in live), fwd, torch.from_numpy(cot), lse,
        causal, window, prefix=prefix)
    for t, g in zip(live, plain):
        assert torch.equal(t.grad, g)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(jax.nn.logsumexp(
            jnp.where(mask[:, None], jnp.einsum(
                "bhsd,bhtd->bhst", q, k) / d ** 0.5, -jnp.inf), axis=-1)),
        atol=GRAD_TOL)


@pytest.mark.parametrize("softcap", [50.0, 1.0])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 7),
                                           (False, 9)])
def test_attention_backward_softcap_matches_reference(causal, window,
                                                      softcap):
    """The softcapped backward: the `flash_attn` operator on CPU tensors and
    `flash_attention_bwd_plain` with the softcap against `jax.grad` of the
    reference's `_attn_core` with it (cap 1 bites on every score, cap 50
    as Gemma-2's), causal and windowed; lse over the softcapped scores."""
    rng = np.random.default_rng(window + 2 * causal + int(softcap))
    q, k, v, cot = (2.0 * rng.standard_normal((2, 3, 37, 16)).astype(
        np.float32) for _ in range(4))
    mask = jnp.asarray(np.broadcast_to(_reference_mask(37, causal, window),
                                       (2, 37, 37)))

    def f(q_, k_, v_):
        return jnp.sum(r_layers._attn_core(q_, k_, v_, mask, softcap) * cot)

    ref = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    live = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = p_flash.flash_attention_blocks(*live, causal=causal, window=window,
                                         softcap=softcap)
    out.backward(torch.from_numpy(cot))
    for t, r in zip(live, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   atol=GRAD_TOL)
    fwd, lse = p_flash.flash_attention_plain_lse(
        *(t.detach() for t in live), causal=causal, window=window,
        softcap=softcap)
    plain = p_flash.flash_attention_bwd_plain(
        *(t.detach() for t in live), fwd, torch.from_numpy(cot), lse,
        causal, window, softcap)
    for t, g in zip(live, plain):
        assert torch.equal(t.grad, g)
    uncapped = p_flash.flash_attention_bwd_plain(
        *(t.detach() for t in live), fwd, torch.from_numpy(cot), lse,
        causal, window)
    assert any(not torch.equal(g, u) for g, u in zip(plain, uncapped))
    capped = softcap * jnp.tanh(jnp.einsum("bhsd,bhtd->bhst", q, k) / 4.0
                                / softcap)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(jax.nn.logsumexp(
            jnp.where(mask[:, None], capped, -jnp.inf), axis=-1)),
        atol=GRAD_TOL)


def test_attention_backward_bf16_sums_in_f32():
    """bf16 inputs: the gradients come back in bf16, from sums in f32 (the
    float32 backward of the same values, rounded once)."""
    rng = np.random.default_rng(3)
    q, k, v, cot = (torch.from_numpy(rng.standard_normal(
        (1, 2, 20, 16)).astype(np.float32)).bfloat16() for _ in range(4))
    out, lse = p_flash.flash_attention_plain_lse(q, k, v, causal=True)
    grads = p_flash.flash_attention_bwd_plain(q, k, v, out, cot, lse)
    f32 = p_flash.flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), out.float(), cot.float(), lse)
    for g, g32 in zip(grads, f32):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, g32.bfloat16())


# ---- model gradients and remat ------------------------------------------


def test_lm_loss_gradients_match_reference(model):
    r_cfg, r_params, p_cfg, p_params = model
    batch = _batch(r_cfg, (2, 16), seed=1)
    r_loss, r_grads = jax.jit(jax.value_and_grad(
        lambda p: r_tf.lm_loss(r_cfg, p, jnp.asarray(batch["tokens"]),
                               jnp.asarray(batch["labels"]))))(r_params)
    loss, grads = _grads_port(p_cfg, p_params, batch)
    assert abs(loss - float(r_loss)) <= LOSS_TOL
    port, ref = _flat(grads), _flat(r_grads)
    assert set(port) == set(ref)
    tol = LM_GRAD_TOL_BY_CONFIG.get(r_cfg.name, LM_GRAD_TOL)
    for path in ref:
        scale = float(np.abs(ref[path]).max())
        assert np.abs(port[path] - ref[path]).max() <= tol * scale, path


def test_remat_gives_the_same_gradients(model):
    """`cfg.remat` checkpoints each layer (its backward recomputes the
    forward) and changes no bit of the loss or the gradients; under
    `torch.inference_mode()` it records nothing."""
    _, _, p_cfg, p_params = model
    batch = _batch(p_cfg, (2, 16), seed=2)
    plain = _grads_port(dataclasses.replace(p_cfg, remat=False), p_params,
                        batch)
    remat = _grads_port(dataclasses.replace(p_cfg, remat=True), p_params,
                        batch)
    assert plain[0] == remat[0]
    for a, b in zip(_flat(plain[1]).values(), _flat(remat[1]).values()):
        np.testing.assert_array_equal(a, b)
    with torch.inference_mode():
        logits, _ = p_tf.forward(dataclasses.replace(p_cfg, remat=True),
                                 p_params, torch.from_numpy(batch["tokens"]))
    assert logits.shape == (2, 16, p_cfg.vocab)


# ---- make_train_step and train_loop ---------------------------------------


STEP_CASES = [  # (config, optimizer, grad_accum, compress): each config
    ("yi_6b", "adamw", 1, False),       # meets each optimizer and each
    ("yi_6b", "adamw", 2, True),        # (grad_accum, compress) pair
    ("yi_6b", "adafactor", 2, False),
    ("yi_6b", "adafactor", 1, True),
    ("yi_6b_gqa", "adamw", 2, False),
    ("yi_6b_gqa", "adamw", 1, True),
    ("yi_6b_gqa", "adafactor", 1, False),
    ("yi_6b_gqa", "adafactor", 2, True),
]


def _step_bound(ef_port, ef_ref):
    """One quantization step of each leaf, its scale: at most twice the
    leaf's largest residual, since a residual is at most half a step and
    an element that flips holds one of about half a step."""
    port, ref = _flat(ef_port), _flat(ef_ref)
    return {path: 2.01 * max(float(np.abs(port[path]).max()),
                             float(np.abs(ref[path]).max()))
            for path in ref}


@pytest.mark.parametrize("name,optimizer,accum,compress", STEP_CASES)
def test_train_step_matches_reference(models, name, optimizer, accum,
                                      compress):
    """One step of `make_train_step`: the loss, every updated parameter,
    the optimizer state and the error feedback."""
    r_cfg, r_params, p_cfg, p_params = models[name]
    shape = (accum, 2, 16) if accum > 1 else (2, 16)
    batch = _batch(r_cfg, shape, seed=11)
    r_lc = r_train.TrainLoopConfig(optimizer=optimizer, grad_accum=accum,
                                   compress=compress)
    p_lc = p_train.TrainLoopConfig(optimizer=optimizer, grad_accum=accum,
                                   compress=compress)
    assert dataclasses.asdict(p_lc) == dataclasses.asdict(r_lc)
    r_state = r_train.make_optimizer(optimizer, lr=r_lc.lr)[0](r_params)
    p_state = p_train.make_optimizer(optimizer, lr=p_lc.lr)[0](p_params)
    r_ef = r_train.ef_init(r_params) if compress else None
    p_ef = p_train.ef_init(p_params) if compress else None
    r_out = jax.jit(r_train.make_train_step(r_cfg, r_lc))(
        r_params, r_state, jax.tree_util.tree_map(jnp.asarray, batch), r_ef)
    p_out = p_train.make_train_step(p_cfg, p_lc)(p_params, p_state, batch,
                                                 p_ef)
    assert abs(float(p_out[0]) - float(r_out[0])) <= LOSS_TOL
    assert p_out[2]["step"] == int(r_out[2]["step"]) == 1
    # A flipped parameter moves by up to 2·lr·(1 + decay·|p|) ≤ 2.1·lr.
    _close_but_for_flips(p_out[1], r_out[1], lambda path: 2.1 * p_lc.lr)
    steps = _step_bound(p_out[3], r_out[3]) if compress else {}

    def state_bound(path):
        """A flip moves AdamW's m by 0.1 of a step, v and Adafactor's
        factored statistics by any amount (they square it); without
        compression nothing flips in the state."""
        if not compress:
            return 0.0
        kind, leaf = path.split("/", 1)
        return 0.1 * steps[leaf] if kind == "m" else np.inf

    _close_but_for_flips(
        {k: v for k, v in p_out[2].items() if k != "step"},
        {k: v for k, v in r_out[2].items() if k != "step"}, state_bound)
    if compress:
        # A residual is the difference of two values up to 127 steps in
        # size, so its rounding is relative to those, not to itself.
        _close_but_for_flips(p_out[3], r_out[3], steps.__getitem__,
                             lambda path: 127 * steps[path])
    else:
        assert p_out[3] is None and r_out[3] is None
    assert not any(t.requires_grad
                   for t in p_train.optim.tree_leaves(p_out[1]))


def test_train_step_refuses_meshes():
    """The sharding hints in the train step (the name is kept from when
    `make_train_step` refused `mesh_axes`, for the name-by-name comparison
    of test runs). Outside a mesh, on plain tensors, the port's step raises
    RuntimeError where the reference's does (its `with_sharding_constraint`
    needs a mesh in context). On a one-rank (1, 1) mesh with DTensor params,
    optimizer state, batch and error feedback, the hinted step with int8
    compression gives the plain step's loss, params, state and residual,
    bit for bit."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    from repro.train import optim as r_optim
    from repro_torch.launch.dryrun import fake_world
    r_cfg, r_params, p_cfg, p_params = _model("yi_6b")
    batch = _batch(r_cfg, (2, 8), seed=4)
    r_init, _ = r_optim.make_optimizer("adamw", lr=3e-4)
    r_step = r_train.make_train_step(r_cfg, r_train.TrainLoopConfig(
        mesh_axes=r_tf.MESH_AXES_SINGLE))
    with pytest.raises(RuntimeError, match="mesh"):
        r_step(r_params, r_init(r_params),
               {k: jnp.asarray(v) for k, v in batch.items()})
    loop = p_train.TrainLoopConfig(compress=True,
                                   mesh_axes=p_tf.MESH_AXES_SINGLE)
    p_init, _ = p_train.make_optimizer("adamw", lr=3e-4)
    step = p_train.make_train_step(p_cfg, loop)
    with pytest.raises(RuntimeError, match="mesh"):
        step(p_params, p_init(p_params), batch)

    plain = p_train.make_train_step(p_cfg, dataclasses.replace(
        loop, mesh_axes=None))
    want = plain(p_params, p_init(p_params), batch,
                 p_train.ef_init(p_params))
    with fake_world(1):
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))

        def dist(t):
            return DTensor.from_local(t, mesh, [Replicate(), Replicate()],
                                      run_check=False) \
                if isinstance(t, torch.Tensor) else t

        d_params = tree_map(dist, p_params)
        got = step(d_params, p_init(d_params),
                   {k: dist(torch.from_numpy(v)) for k, v in batch.items()},
                   p_train.ef_init(d_params))
    assert isinstance(got[0], DTensor)
    got = [tree_map(lambda t: t.to_local() if isinstance(t, DTensor)
                    else t, part) for part in got]
    for g, w in zip(_flat(got), _flat(list(want))):
        assert g == w
        np.testing.assert_array_equal(_flat(got)[g], _flat(list(want))[w])
