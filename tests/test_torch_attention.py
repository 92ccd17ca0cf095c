"""Parity of the port's attention kernels with the JAX package on the CPU.

The same inputs, made from a seed with numpy, go through the reference's
Pallas kernels (in interpret mode, as tests/test_kernels.py runs them) or
its jnp oracles, and through the port's `ops.flash_attention` /
`ops.decode_attention`, which on CPU tensors take the kernels' plain
versions. The CUDA kernels themselves are held to those plain versions on
the card (tests/test_torch_gpu.py, chip_smoke.py's `attn` phase).

The attention softcap (Gemma-2's), which the Pallas kernels lack, is held
to the reference's XLA attention: the plain flash version to
`repro.models.layers._attn_core`, the plain decode version through the
port's `_decode_attn` to `repro.models.transformer._decode_attn`, on a
full cache and on a ring past its wrap.

Tolerances: float32 atol 1e-5 (the same f32 arithmetic, summed in another
order), softcapped cases too; bfloat16 outputs per element 2^-7·|ref| +
1e-5, one bf16 ulp, since both sides round once an f32 result whose last
bits differ.
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as r_decode
from repro.kernels import flash_attention as r_flash
from repro.kernels import ref as r_ref
from repro.models import layers as r_layers
from repro.models import transformer as r_tf
from repro.models.config import ArchConfig as RArchConfig
from repro_torch.kernels import decode_attn as p_dec
from repro_torch.kernels import flash_attn as p_flash
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import ref as p_ref
from repro_torch.models import transformer as p_tf

F32_TOL = 1e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _bf16_pair(x):
    """The same bf16 values for both packages."""
    t = torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy(), jnp.bfloat16), t


@pytest.mark.parametrize("causal,window", [
    (True, 0), (True, 24), (False, 0), (False, 24)])
@pytest.mark.parametrize("b,h,s,d", [(2, 3, 64, 16), (1, 2, 48, 32),
                                     (1, 2, 32, 256)])   # RecurrentGemma's d
def test_flash_matches_pallas_kernel(b, h, s, d, causal, window):
    rng = np.random.default_rng(b * s + d)
    q, k, v = (_normal(rng, (b, h, s, d)) for _ in range(3))
    ref = np.asarray(r_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window, block_q=16,
                             block_k=16))
    out = p_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                window=window)
    assert out.dtype == torch.float32 and out.shape == (b, h, s, d)
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 8),
                                           (False, 0)])
def test_flash_bf16_matches_pallas_kernel(causal, window):
    rng = np.random.default_rng(5)
    pairs = [_bf16_pair(_normal(rng, (1, 2, 32, 16))) for _ in range(3)]
    ref = r_flash(*(j for j, _ in pairs), causal=causal, window=window,
                  block_q=16, block_k=16)
    out = p_ops.flash_attention(*(t for _, t in pairs), causal=causal,
                                window=window)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=BF16_RTOL,
                               atol=BF16_ATOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 7),
                                           (False, 0), (False, 5)])
@pytest.mark.parametrize("s", [1, 37, 50])
def test_flash_ragged_length_matches_oracle(s, causal, window):
    """S a multiple of no block: the Pallas kernel asserts divisibility, so
    the reference here is its jnp oracle."""
    rng = np.random.default_rng(s)
    q, k, v = (_normal(rng, (2, 2, s, 24)) for _ in range(3))
    ref = np.asarray(r_ref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window))
    out = p_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                window=window)
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 3)])
def test_port_flash_oracle_matches_reference_oracle(causal, window):
    rng = np.random.default_rng(11)
    q, k, v = (_normal(rng, (1, 3, 20, 8)) for _ in range(3))
    ref = np.asarray(r_ref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window))
    out = p_ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal,
                                    window=window)
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_window_of_one_attends_to_itself(causal):
    """window 1 keeps keys j > i - 1: causal, each row's own key alone, so
    the output is v; not causal, the row's key and every key ahead."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(_normal(rng, (1, 2, 6, 8))) for _ in range(3))
    out = p_ops.flash_attention(q, k, v, causal=causal, window=1)
    ref = p_ref.flash_attention_ref(q, k, v, causal=causal, window=1)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=F32_TOL)
    if causal:
        np.testing.assert_allclose(out.numpy(), v.numpy(), atol=F32_TOL)


@pytest.mark.parametrize("b,nq,nkv,s,d", [
    (2, 8, 2, 64, 16),     # group 4
    (1, 4, 4, 32, 8),      # group 1 (MHA)
    (3, 16, 2, 48, 32),    # group 8, as Yi-6B
    (2, 4, 1, 96, 16),     # one KV head
    (2, 10, 1, 64, 256),   # RecurrentGemma: MQA, group 10, d = 256
])
def test_decode_matches_pallas_kernel(b, nq, nkv, s, d):
    rng = np.random.default_rng(b * s + nq)
    q = _normal(rng, (b, nq, d))
    k, v = (_normal(rng, (b, nkv, s, d)) for _ in range(2))
    lens = rng.integers(1, s + 1, size=(b,)).astype(np.int32)
    lens[0], lens[-1] = 1, s
    ref = np.asarray(r_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(lens), block_s=16))
    out = p_ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(lens))
    assert out.dtype == torch.float32 and out.shape == (b, nq, d)
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_TOL)


@pytest.mark.parametrize("s", [1, 37, 161])
def test_decode_ragged_cache_matches_reference(s):
    """A cache length that is a multiple of no block (161 is serve's at a
    128-token prompt and 32 steps): the reference wrapper pads it, the
    port masks by lens."""
    rng = np.random.default_rng(s)
    b, nq, nkv, d = 3, 8, 2, 16
    q = _normal(rng, (b, nq, d))
    k, v = (_normal(rng, (b, nkv, s, d)) for _ in range(2))
    lens = np.array([1, s, max(1, s // 2)], np.int32)
    ref = np.asarray(r_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(lens), block_s=16))
    out = p_ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(lens))
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_TOL)


def test_decode_bf16_matches_pallas_kernel():
    rng = np.random.default_rng(9)
    b, nq, nkv, s, d = 2, 8, 2, 48, 16
    jq, tq = _bf16_pair(_normal(rng, (b, nq, d)))
    jk, tk = _bf16_pair(_normal(rng, (b, nkv, s, d)))
    jv, tv = _bf16_pair(_normal(rng, (b, nkv, s, d)))
    lens = np.array([5, 48], np.int32)
    ref = r_decode(jq, jk, jv, jnp.asarray(lens), block_s=16)
    out = p_ops.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=BF16_RTOL,
                               atol=BF16_ATOL)


def test_decode_zero_length_gives_zero_like_pallas_kernel():
    rng = np.random.default_rng(4)
    b, nq, nkv, s, d = 2, 4, 2, 32, 8
    q = _normal(rng, (b, nq, d))
    k, v = (_normal(rng, (b, nkv, s, d)) for _ in range(2))
    lens = np.array([0, 7], np.int32)
    ref = np.asarray(r_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(lens), block_s=16))
    out = p_ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(lens))
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_TOL)
    assert not out[0].any()


def test_decode_ignores_positions_past_lens():
    rng = np.random.default_rng(0)
    b, nq, nkv, s, d = 2, 4, 2, 32, 16
    q = torch.from_numpy(_normal(rng, (b, nq, d)))
    k, v = (torch.from_numpy(_normal(rng, (b, nkv, s, d))) for _ in range(2))
    lens = torch.tensor([10, 20], dtype=torch.int32)
    out1 = p_ops.decode_attention(q, k, v, lens)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 25:], v2[:, :, 25:] = 999.0, -999.0
    out2 = p_ops.decode_attention(q, k2, v2, lens)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=F32_TOL)


def test_port_decode_oracle_matches_reference_oracle():
    rng = np.random.default_rng(12)
    q = _normal(rng, (2, 2, 4, 8))
    k, v = (_normal(rng, (2, 2, 24, 8)) for _ in range(2))
    lens = np.array([3, 24], np.int32)
    ref = np.asarray(r_ref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens)))
    out = p_ref.decode_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v),
                                     torch.from_numpy(lens))
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_TOL)


@pytest.mark.parametrize("softcap", [50.0, 1.0])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16),
                                           (False, 0), (False, 9)])
def test_flash_softcap_matches_attn_core(causal, window, softcap):
    """The plain flash version with a softcap against the reference's
    `_attn_core` (softcap, then the mask at -1e30, then softmax) on GQA
    inputs whose KV heads are repeated, as both attention layers do; cap 1
    bites on every score, cap 50 as Gemma-2's."""
    rng = np.random.default_rng(int(softcap) + window)
    b, hq, hkv, s, d = 2, 4, 2, 40, 16
    q = _normal(rng, (b, hq, s, d)) * 2.0
    k, v = (_normal(rng, (b, hkv, s, d)) * 2.0 for _ in range(2))
    pos = np.arange(s)
    mask = np.ones((s, s), bool)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    ref = np.asarray(r_layers._attn_core(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), 2, axis=1),
        jnp.repeat(jnp.asarray(v), 2, axis=1),
        jnp.asarray(np.broadcast_to(mask, (b, s, s))), softcap))
    kt, vt = (torch.from_numpy(x).repeat_interleave(2, dim=1)
              for x in (k, v))
    out = p_ops.flash_attention(torch.from_numpy(q), kt, vt, causal=causal,
                                window=window, softcap=softcap)
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_TOL)
    if softcap == 1.0:                   # a cap that bites moves the output
        plain = p_ops.flash_attention(torch.from_numpy(q), kt, vt,
                                      causal=causal, window=window)
        assert float((out - plain).abs().max()) > 0.1


@pytest.mark.parametrize("softcap", [None, 1.0])
@pytest.mark.parametrize("sq,sk,causal,window", [
    (5, 17, False, 0), (1, 31, False, 0), (40, 16, False, 0),
    (33, 64, False, 0), (24, 40, True, 0), (24, 40, True, 7),
    (1, 40, True, 0), (1, 40, True, 5)])
def test_flash_key_length_of_its_own_matches_attn_core(sq, sk, causal,
                                                       window, softcap):
    """Both plain flash directions with Sq != Sk against the reference's
    `_attn_core` and `jax.vjp` of it: non-causal (cross-attention, every
    key valid), and causal with query i at key position i + Sk - Sq (the
    reference's cache mask kv_pos <= q_pos for q_pos = len + i), within a
    window where given. float32, atol 1e-5 on the output and on dq, dk,
    dv."""
    rng = np.random.default_rng(sq * 1000 + sk + window)
    b, h, d = 2, 3, 16
    q = _normal(rng, (b, h, sq, d))
    k, v = (_normal(rng, (b, h, sk, d)) for _ in range(2))
    dout = _normal(rng, (b, h, sq, d))
    q_pos, kv_pos = np.arange(sq) + sk - sq, np.arange(sk)
    mask = np.ones((sq, sk), bool)
    if causal:
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= kv_pos[None, :] > q_pos[:, None] - window
    mask = jnp.asarray(np.broadcast_to(mask, (b, sq, sk)))
    ref, vjp = jax.vjp(
        lambda q_, k_, v_: r_layers._attn_core(q_, k_, v_, mask, softcap),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_grads = vjp(jnp.asarray(dout))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    out = p_ops.flash_attention(qt, kt, vt, causal=causal, window=window,
                                softcap=softcap)
    out.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=F32_TOL)
    for got, want in zip((qt.grad, kt.grad, vt.grad), ref_grads):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=F32_TOL)


def test_flash_refuses_lengths_the_kernels_cannot_mask():
    """Causal with Sk < Sq (the first rows would have no key) and a prefix
    with Sq != Sk raise ValueError in both plain versions, as the CUDA
    wrappers do before any launch; Sk = 0 is no key length at all."""
    q, k = torch.zeros((1, 2, 8, 16)), torch.zeros((1, 2, 5, 16))
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="Sk >= Sq"):
        p_flash.flash_attention_plain(q, k, k, causal=True)
    with pytest.raises(ValueError, match="Sk >= Sq"):
        p_flash.flash_attention_bwd_plain(q, k, k, q, q, lse, causal=True)
    with pytest.raises(ValueError, match="prefix"):
        p_flash.flash_attention_plain(k, q, q, causal=True, prefix=3)
    with pytest.raises(ValueError, match="Sk >= Sq"):
        p_flash.flash_attention_cuda(q, k, k, causal=True)
    with pytest.raises(ValueError, match="Sk >= 1"):
        p_flash.flash_attention_plain(q, k[:, :, :0], k[:, :, :0],
                                      causal=False)
    out = p_flash.flash_attention_plain(q, k, k, causal=False)
    assert out.shape == q.shape


def _decode_case(ring: bool, softcap: float, seed: int):
    """A one-token decode layer for both packages: the reference's cfg,
    weights, input and state (a full cache of 24 positions at pos 17, or a
    ring of 8 slots past its wrap at pos 21, each slot holding the position
    that pos % 8 would have written), and the port's copies."""
    rng = np.random.default_rng(seed)
    b, hq, hkv, hd = 2, 4, 2, 16
    cfg = RArchConfig(name="softcap", family="dense", n_layers=1,
                      d_model=hq * hd, n_heads=hq, n_kv_heads=hkv, d_ff=0,
                      vocab=8, head_dim=hd, attn_softcap=softcap)
    d = cfg.d_model
    p = {"wq": _normal(rng, (d, hq * hd)) * d ** -0.5 * 3.0,
         "wk": _normal(rng, (d, hkv * hd)) * d ** -0.5 * 3.0,
         "wv": _normal(rng, (d, hkv * hd)) * d ** -0.5,
         "wo": _normal(rng, (hq * hd, d)) * d ** -0.5}
    h = _normal(rng, (b, 1, d))
    n, pos = (8, 21) if ring else (24, 17)
    state = {"k": _normal(rng, (b, hkv, n, hd)) * 2.0,
             "v": _normal(rng, (b, hkv, n, hd))}
    if ring:
        slot_pos = np.empty(n, np.int32)
        for t in range(pos - n, pos):        # the n positions before pos
            slot_pos[t % n] = t
        state["slot_pos"] = slot_pos
    p_cfg = p_tf.ArchConfig(**dataclasses.asdict(cfg))
    p_state = {k_: torch.from_numpy(x.copy()) for k_, x in state.items()}
    return cfg, p_cfg, p, h, state, p_state, pos


@pytest.mark.parametrize("softcap", [50.0, 1.0])
@pytest.mark.parametrize("ring", [False, True])
def test_decode_softcap_matches_decode_attn(ring, softcap):
    """The plain decode version with a softcap, through the port's
    `_decode_attn`, against the reference's `_decode_attn`: on a full
    cache (lens pos + 1) and on a ring past its wrap (lens = its size),
    the output and the updated cache (slot_pos exact)."""
    cfg, p_cfg, p, h, state, p_state, pos = _decode_case(
        ring, softcap, seed=int(softcap) + ring)
    ref, r_state = r_tf._decode_attn(
        cfg, {k_: jnp.asarray(x) for k_, x in p.items()}, jnp.asarray(h),
        {k_: jnp.asarray(x) for k_, x in state.items()}, pos,
        window=8 if ring else None, ring=ring)
    b, n = h.shape[0], state["k"].shape[2]
    lens = torch.full((b,), min(pos + 1, n), dtype=torch.int32)
    posb = torch.full((b, 1), pos, dtype=torch.int32)
    out = p_tf._decode_attn(p_cfg, {k_: torch.from_numpy(x)
                                     for k_, x in p.items()},
                            torch.from_numpy(h), p_state, pos, posb, lens)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(p_state[name].numpy(),
                                   np.asarray(r_state[name]), atol=F32_TOL)
    if ring:
        np.testing.assert_array_equal(p_state["slot_pos"].numpy(),
                                      np.asarray(r_state["slot_pos"]))


def test_softcap_must_be_positive_and_finite():
    q = torch.zeros((1, 2, 8, 16))
    for bad in (0.0, -1.0, float("inf"), float("nan")):
        with pytest.raises(ValueError, match="softcap"):
            p_ops.flash_attention(q, q, q, softcap=bad)
        with pytest.raises(ValueError, match="softcap"):
            p_ops.decode_attention(torch.zeros((1, 4, 16)), q, q,
                                   torch.ones(1, dtype=torch.int32),
                                   softcap=bad)


def test_softcapped_flash_under_autograd_raises():
    """The softcap under autograd (the name is kept from when every entry
    raised here, before the softcap had a backward): each entry records a
    graph whose gradients are `jax.grad` of the reference's `_attn_core`
    with the softcap, through the plain softcapped backward on CPU
    tensors; the CUDA backward refuses CPU tensors and counts nothing."""
    rng = np.random.default_rng(3)
    q, k, v, cot = (_normal(rng, (1, 2, 8, 16)) * 2.0 for _ in range(4))
    mask = jnp.asarray(np.broadcast_to(np.tril(np.ones((8, 8), bool)),
                                       (1, 8, 8)))

    def f(q_, k_, v_):
        return jnp.sum(r_layers._attn_core(q_, k_, v_, mask, 1.0) * cot)

    ref = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for call in (
            lambda *t: p_ops.flash_attention(*t, softcap=1.0),
            lambda *t: p_flash.flash_attention_blocks(*t, softcap=1.0),
            lambda *t: torch.ops.repro_torch.flash_attn(*t, True, 0, 1.0,
                                                         0)[0]):
        live = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        out = call(*live)
        assert out.requires_grad
        out.backward(torch.from_numpy(cot))
        for t, r in zip(live, ref):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                       atol=F32_TOL)
    before = p_flash.FLASH_BWD_LAUNCHES, p_flash.FLASH_BWD_SOFTCAP_LAUNCHES
    qt = torch.from_numpy(q)
    with pytest.raises(ValueError, match="CUDA"):
        p_flash.flash_attention_bwd_cuda(qt, qt, qt, qt, qt, qt[..., 0],
                                         True, 0, softcap=50.0)
    assert (p_flash.FLASH_BWD_LAUNCHES,
            p_flash.FLASH_BWD_SOFTCAP_LAUNCHES) == before


# The card's per-element limit on the 16-bit kernels against their plain
# versions (chip_smoke.py ATTN_TOL, tests/test_torch_gpu.py): rtol, atol.
ATTN_TOL = {torch.bfloat16: (2.0 ** -7, 4e-6),
            torch.float16: (2.0 ** -10, 4e-6)}


def _tensor_core_arithmetic(q, k, v, valid, parts, softcap=None):
    """The 16-bit kernels' arithmetic, emulated on the CPU: scores as f32
    sums of exact products of 16-bit q and k (what mma.sync accumulates),
    softcapped where asked, the softmax in f32, and P·V as `parts` 16-bit
    pieces of P (p_hi = T(p), p_lo = T(p - p_hi), ...), each multiplied
    with V in f32 and summed. `valid` masks the scores (True = attend)."""
    dt = q.dtype
    sc = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / q.shape[-1] ** 0.5)
    if softcap:
        sc = softcap * torch.tanh(sc / softcap)
    sc = sc.masked_fill(~valid, float("-inf"))
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - torch.where(torch.isfinite(m), m, 0.0))
    acc = sum(piece @ v.float() for piece in _pieces(p, dt, parts))
    return (acc / p.sum(-1, keepdim=True).clamp_min(1e-30)).to(dt)


def _pieces(x, dt, parts):
    """x as `parts` 16-bit pieces in f32: T(x), T(x - T(x)), ..."""
    rest, out = x, []
    for _ in range(parts):
        piece = rest.to(dt).float()
        out.append(piece)
        rest = rest - piece
    return out


def _over_limit(out, plain):
    """The largest |out - plain| / (rtol·|plain| + atol)."""
    rtol, atol = ATTN_TOL[plain.dtype]
    delta = (out.float() - plain.float()).abs()
    return float((delta / (rtol * plain.float().abs() + atol)).max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,h,s,d,window,softcap", [
    (1, 4, 1024, 128, 0, None), (2, 3, 130, 64, 0, None),
    (1, 2, 200, 128, 33, None), (1, 2, 300, 128, 100, 50.0)],
    ids=["1-4-1024-128-0", "2-3-130-64-0", "1-2-200-128-33",
         "1-2-300-128-100-softcap50"])
def test_split_p_meets_the_flash_kernels_limit(b, h, s, d, window, softcap,
                                               dtype):
    """Why the tensor-core kernels split P: P·V on P rounded once to 16
    bits misses the per-element limit against the f32 plain version; on
    p_hi + p_lo it meets it (causal masks; a window where given; Gemma-2's
    softcap where given)."""
    rng = np.random.default_rng(b * s + d)
    q, k, v = (torch.from_numpy(_normal(rng, (b, h, s, d))).to(dtype)
               for _ in range(3))
    plain = p_flash.flash_attention_plain(q, k, v, causal=True,
                                          window=window, softcap=softcap)
    pos = torch.arange(s)
    valid = pos[None, :] <= pos[:, None]
    if window:
        valid &= pos[None, :] > pos[:, None] - window
    assert _over_limit(_tensor_core_arithmetic(q, k, v, valid, 2, softcap),
                       plain) <= 1.0
    assert _over_limit(_tensor_core_arithmetic(q, k, v, valid, 1, softcap),
                       plain) > 1.0


# The card's per-element limit on the backward kernels against their plain
# version (tests/test_torch_gpu.py and chip_smoke.py BWD_TOL): rtol, and
# atol relative to M, the largest |plain| over dQ, dK and dV.
BWD_TOL = {torch.bfloat16: (2.0 ** -7, 2e-5),
           torch.float16: (2.0 ** -10, 2e-5)}


def _tensor_core_backward(q, k, v, out, dout, lse, valid, parts,
                          softcap=None):
    """The 16-bit backward kernels' arithmetic, emulated on the CPU: S =
    Q·Kᵀ and dP = dO·Vᵀ as f32 sums of exact products of 16-bit values
    (what mma.sync accumulates), P = exp(S/√d - lse) and dS = P (dP - D)
    in f32 with D = Σ dO·O from the forward's `out` (with a softcap c,
    P = exp(c t - lse) and dS = P (dP - D)(1 - t²), t = tanh(S/√d/c)), and
    dV = Pᵀ·dO, dK = dSᵀ·Q/√d, dQ = dS·K/√d each summed over `parts`
    16-bit pieces of P or dS. `valid` masks the pairs (True = attend).
    Returns (dq, dk, dv) in q's dtype."""
    dt, scale = q.dtype, 1.0 / q.shape[-1] ** 0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    ok = valid & torch.isfinite(lse)[..., None]
    x = (qf @ kf.transpose(-1, -2)) * scale
    if softcap:
        t = torch.tanh(x / softcap)
        x = softcap * t
    p = torch.where(ok, torch.exp(x - lse[..., None]), 0.0)
    delta = (dof * out.float()).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    if softcap:
        ds = ds * (1.0 - t * t)
    dv = sum(x.transpose(-1, -2) @ dof for x in _pieces(p, dt, parts))
    dk = sum(x.transpose(-1, -2) @ qf for x in _pieces(ds, dt, parts))
    dq = sum(x @ kf for x in _pieces(ds, dt, parts))
    return (dq * scale).to(dt), (dk * scale).to(dt), dv.to(dt)


def _bwd_over_limit(got, want):
    """The largest |got - want| / (rtol·|want| + atol·M) over dQ, dK, dV."""
    rtol, atol = BWD_TOL[want[0].dtype]
    m = max(float(w.float().abs().max()) for w in want)
    return max(float(((g.float() - w.float()).abs()
                      / (rtol * w.float().abs() + atol * m)).max())
               for g, w in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,h,s,d,window", [
    (1, 4, 512, 128, 0),         # causal, 8 tiles of 64
    (2, 3, 130, 64, 0),          # ragged S
    (1, 2, 200, 128, 33)])       # a window whose edge crosses tiles
def test_split_ds_meets_the_backward_kernels_limit(b, h, s, d, window,
                                                   dtype):
    """Why the tensor-core backward splits P and dS: dV, dK and dQ on P
    and dS rounded once to 16 bits miss BWD_TOL against
    `flash_attention_bwd_plain`; on hi + lo they meet it (causal masks).
    The split also meets the limit against `jax.grad` of the reference's
    `_attn_core` on the same values in f32, rounded to the dtype, when its
    D is taken from the f32 forward's output, as the reference's is: from
    the 16-bit output the kernel reads, D is off by more than the limit
    allows, for the plain version as much."""
    rng = np.random.default_rng(b * s + d + window)
    q, k, v, dout = (torch.from_numpy(_normal(rng, (b, h, s, d))).to(dtype)
                     for _ in range(4))
    out, lse = p_flash.flash_attention_plain_lse(q, k, v, causal=True,
                                                 window=window)
    plain = p_flash.flash_attention_bwd_plain(q, k, v, out, dout, lse, True,
                                              window)
    pos = torch.arange(s)
    valid = pos[None, :] <= pos[:, None]
    if window:
        valid &= pos[None, :] > pos[:, None] - window
    assert _bwd_over_limit(_tensor_core_backward(q, k, v, out, dout, lse,
                                                 valid, 2), plain) <= 1.0
    assert _bwd_over_limit(_tensor_core_backward(q, k, v, out, dout, lse,
                                                 valid, 1), plain) > 1.0

    mask = jnp.asarray(np.broadcast_to(valid.numpy(), (b, s, s)))
    cot = jnp.asarray(dout.float().numpy())

    def f(q_, k_, v_):
        return jnp.sum(r_layers._attn_core(q_, k_, v_, mask, None) * cot)

    ref = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)))
    ref = [torch.from_numpy(np.array(r)).to(dtype) for r in ref]
    out32, lse32 = p_flash.flash_attention_plain_lse(
        q.float(), k.float(), v.float(), causal=True, window=window)
    assert _bwd_over_limit(_tensor_core_backward(q, k, v, out32, dout, lse32,
                                                 valid, 2), ref) <= 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("softcap", [50.0, 1.0])
@pytest.mark.parametrize("b,h,s,d,window", [
    (1, 4, 512, 128, 0),         # causal, 8 tiles of 64
    (1, 2, 200, 128, 33)])       # a window whose edge crosses tiles
def test_split_ds_meets_the_backward_kernels_limit_with_softcap(
        b, h, s, d, window, softcap, dtype):
    """The softcapped backward kernels keep the split: with Gemma-2's cap
    and with one that bites on every score, dV, dK and dQ on hi + lo
    pieces of P and dS (dS carrying 1 - t²) meet BWD_TOL against the
    softcapped `flash_attention_bwd_plain`."""
    rng = np.random.default_rng(b * s + d + window + int(softcap))
    q, k, v, dout = (torch.from_numpy(_normal(rng, (b, h, s, d))).to(dtype)
                     for _ in range(4))
    out, lse = p_flash.flash_attention_plain_lse(q, k, v, causal=True,
                                                 window=window,
                                                 softcap=softcap)
    plain = p_flash.flash_attention_bwd_plain(q, k, v, out, dout, lse, True,
                                              window, softcap)
    pos = torch.arange(s)
    valid = pos[None, :] <= pos[:, None]
    if window:
        valid &= pos[None, :] > pos[:, None] - window
    assert _bwd_over_limit(_tensor_core_backward(
        q, k, v, out, dout, lse, valid, 2, softcap), plain) <= 1.0


@pytest.mark.parametrize("b,n_kv,group,s,d,softcap", [
    (4, 4, 8, 161, 128, None),     # lm_serve's cache at Yi-6B width
    (2, 2, 16, 1000, 64, None),
    (4, 16, 2, 161, 128, 50.0)],   # gemma_serve's cache, Gemma-2's softcap
    ids=["4-4-8-161-128", "2-2-16-1000-64", "4-16-2-161-128-softcap50"])
def test_split_p_meets_the_decode_kernels_limit(b, n_kv, group, s, d,
                                                softcap):
    rng = np.random.default_rng(s + group)
    q = torch.from_numpy(_normal(rng, (b, n_kv, group, d))).bfloat16()
    k, v = (torch.from_numpy(_normal(rng, (b, n_kv, s, d))).bfloat16()
            for _ in range(2))
    lens = torch.from_numpy(rng.integers(1, s + 1, size=(b,)).astype(
        np.int32))
    lens[0] = s
    plain = p_dec.decode_attention_plain(q, k, v, lens, softcap)
    valid = (torch.arange(s)[None, :] < lens[:, None])[:, None, None, :]
    assert _over_limit(_tensor_core_arithmetic(q, k, v, valid, 2, softcap),
                       plain) <= 1.0
    assert _over_limit(_tensor_core_arithmetic(q, k, v, valid, 1, softcap),
                       plain) > 1.0


@pytest.mark.parametrize("b,n_kv,s", [
    (4, 4, 161),            # serve: batch 4, Yi-6B's 4 KV heads
    (128, 4, 32768),        # decode_32k
    (1, 4, 1), (1, 1, 64), (2, 32, 4097), (1, 4, 524288),
])
def test_decode_split_plan_covers_the_cache(b, n_kv, s):
    n_sm = 132                                    # an H100 SXM
    target = p_dec.BLOCKS_PER_SM * n_sm
    chunk, n_splits = p_dec.split_plan(b, n_kv, s, n_sm)
    assert chunk % p_dec.TILE == 0 and chunk > 0
    assert n_splits * chunk >= s > (n_splits - 1) * chunk   # none empty
    assert chunk <= max(p_dec.TILE, p_dec._MAX_CHUNK)
    if b * n_kv < target:
        # Split as far as one tile per split allows.
        assert b * n_kv * n_splits >= target or chunk == p_dec.TILE


@pytest.mark.parametrize("b,n_kv,s", [
    (4, 1, 161),            # rgemma_serve: batch 4, one KV head
    (4, 1, 2048),           # its ring of 2048, full
    (128, 1, 2048), (1, 1, 1), (2, 2, 4097)])
def test_decode_split_plan_at_head_dim_256(b, n_kv, s):
    """At d = 256 one 16-bit split block fits on an SM (200 KiB), so the
    plan asks for BLOCKS_PER_SM_WIDE blocks an SM, the same four waves."""
    n_sm = 132
    target = p_dec.BLOCKS_PER_SM_WIDE * n_sm
    chunk, n_splits = p_dec.split_plan(b, n_kv, s, n_sm, 256)
    assert chunk % p_dec.TILE == 0 and chunk > 0
    assert n_splits * chunk >= s > (n_splits - 1) * chunk
    if b * n_kv < target:
        assert b * n_kv * n_splits >= target or chunk == p_dec.TILE
    assert p_dec.split_plan(b, n_kv, s, n_sm, 200) == (chunk, n_splits)
    assert p_dec.split_plan(b, n_kv, s, n_sm) == p_dec.split_plan(
        b, n_kv, s, n_sm, 128)


def test_flash_backward_refuses_head_dim_256_naming_k5():
    """Since the backward's d = 256 instances (ROADMAP.md K5, done) the
    backward kernels take head dims up to 256, as the forward does: the
    limits are those of csrc/attention.cuh, 256 and 256; d = 256 gets past
    the head-dim check to the CUDA check (here on CPU tensors), d = 264
    is still refused before any other check or launch, and the plain
    backward, the CPU's, takes d = 256 under autograd. (The name is the
    one the test had while the backward refused d = 256.)"""
    cuh = (pathlib.Path(p_flash.__file__).parent / "csrc"
           / "attention.cuh").read_text()
    for name, value in (("MAX_HEAD_DIM", p_flash.MAX_HEAD_DIM),
                        ("MAX_BWD_HEAD_DIM", p_flash.BWD_MAX_HEAD_DIM)):
        assert f"constexpr int {name} = {value};" in cuh
    assert (p_flash.MAX_HEAD_DIM, p_flash.BWD_MAX_HEAD_DIM) == (256, 256)
    q = torch.zeros((1, 2, 8, 264))
    lse = torch.zeros((1, 2, 8))
    before = p_flash.FLASH_BWD_LAUNCHES
    with pytest.raises(NotImplementedError, match="up to 256"):
        p_flash.flash_attention_bwd_cuda(q, q, q, q, q, lse)
    assert p_flash.FLASH_BWD_LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):     # d = 256 gets past it
        p_flash.flash_attention_bwd_cuda(*(t[..., :256] for t in (q,) * 5),
                                         lse)
    # The plain backward, the CPU's, takes d = 256.
    live = [torch.randn((1, 2, 8, 256), requires_grad=True)
            for _ in range(3)]
    p_ops.flash_attention(*live).sum().backward()
    assert all(t.grad is not None for t in live)


def test_cuda_wrappers_reject_cpu_tensors_and_count_nothing():
    q = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        p_flash.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        p_dec.decode_attention_cuda(torch.zeros((1, 2, 4, 16)), q, q,
                                    torch.ones(1, dtype=torch.int32))
    before = (p_flash.FLASH_LAUNCHES, p_dec.DECODE_LAUNCHES)
    p_ops.flash_attention(q, q, q)
    p_ops.decode_attention(torch.zeros((1, 8, 16)), q, q,
                           torch.ones(1, dtype=torch.int32))
    assert (p_flash.FLASH_LAUNCHES, p_dec.DECODE_LAUNCHES) == before


@pytest.mark.parametrize("bad", ["shape", "dtype", "lens", "group"])
def test_operand_checks(bad):
    q = torch.zeros((2, 4, 16))
    k = torch.zeros((2, 2, 8, 16))
    lens = torch.ones(2, dtype=torch.int32)
    if bad == "shape":
        with pytest.raises(ValueError):
            p_ops.flash_attention(torch.zeros((1, 2, 8, 16)), k, k)
    elif bad == "dtype":
        with pytest.raises(TypeError):
            p_ops.decode_attention(q, k.double(), k.double(), lens)
    elif bad == "lens":
        with pytest.raises(ValueError):
            p_dec.decode_attention_plain(q.reshape(2, 2, 2, 16), k, k,
                                         lens.long())
    else:
        with pytest.raises(ValueError):
            p_ops.decode_attention(torch.zeros((2, 5, 16)), k, k, lens)
