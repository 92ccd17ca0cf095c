"""The decode over a slice of the head dim (`ops.decode_scores`,
`ops.decode_softmax_v`, `csrc/decode_attn_hd.cu`) against the JAX
package's decode kernel on the CPU.

A decode step whose caches are sharded along the head dim runs, on each
rank, the scores of its slice, an all-reduce of them over the ranks, and
softmax · V on its slice of V (`models.transformer._decode_attn_split_hd`).
Here the ranks are the slices of one tensor: the same inputs, made from a
seed with numpy, go through the reference's Pallas decode kernel (in
interpret mode, as tests/test_torch_attention.py runs it) and through the
two plain versions, the scores summed over the slices and the outputs put
side by side. The CUDA kernels are held to the plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py's `attn` phase).

Tolerances are tests/test_torch_attention.py's: float32 atol 1e-5 (the
same f32 arithmetic summed in another order); bfloat16 per element
2^-7·|ref| + 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as r_decode
from repro_torch.kernels import decode_attn as p_dec
from repro_torch.kernels import ops as p_ops

F32_TOL = 1e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _split_decode(q, k, v, lens, slices, softcap=None):
    """q (B, nq, d), k, v (B, nkv, S, d): the decode as `slices` ranks of
    the head dim run it, through `ops.decode_scores` and
    `ops.decode_softmax_v`; (B, nq, d)."""
    b, nq, d = q.shape
    nkv = k.shape[1]
    qg = q.reshape(b, nkv, nq // nkv, d)
    cuts = np.linspace(0, d, slices + 1).astype(int)
    parts = [slice(lo, hi) for lo, hi in zip(cuts[:-1], cuts[1:])]
    s = sum(p_ops.decode_scores(qg[..., c], k[..., c], lens) for c in parts)
    out = torch.cat([p_ops.decode_softmax_v(s, v[..., c], lens,
                                            1.0 / d ** 0.5, softcap)
                     for c in parts], dim=-1)
    return out.reshape(b, nq, d)


@pytest.mark.parametrize("slices", [1, 2, 4])
@pytest.mark.parametrize("b,nq,nkv,s,d", [
    (2, 8, 2, 64, 16),     # group 4
    (3, 16, 2, 48, 32),    # group 8, as Yi-6B
    (2, 4, 1, 96, 16),     # one KV head
    (2, 10, 1, 64, 256),   # RecurrentGemma: MQA, group 10, d = 256
])
def test_split_decode_matches_pallas_kernel(b, nq, nkv, s, d, slices):
    rng = np.random.default_rng(b * s + nq + slices)
    q = _normal(rng, (b, nq, d))
    k, v = (_normal(rng, (b, nkv, s, d)) for _ in range(2))
    lens = rng.integers(1, s + 1, size=(b,)).astype(np.int32)
    lens[0], lens[-1] = 1, s
    ref = np.asarray(r_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(lens), block_s=16))
    out = _split_decode(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), torch.from_numpy(lens), slices)
    assert out.dtype == torch.float32 and out.shape == (b, nq, d)
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_TOL)


def test_split_decode_bf16_matches_pallas_kernel():
    rng = np.random.default_rng(9)
    b, nq, nkv, s, d = 2, 8, 2, 48, 16
    pairs = [torch.from_numpy(_normal(rng, shape)).to(torch.bfloat16)
             for shape in ((b, nq, d), (b, nkv, s, d), (b, nkv, s, d))]
    lens = np.array([5, 48], np.int32)
    ref = r_decode(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                     for t in pairs), jnp.asarray(lens), block_s=16)
    out = _split_decode(*pairs, torch.from_numpy(lens), 2)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=BF16_RTOL,
                               atol=BF16_ATOL)


def test_split_decode_zero_length_gives_zero_like_pallas_kernel():
    rng = np.random.default_rng(4)
    b, nq, nkv, s, d = 2, 4, 2, 32, 8
    q = _normal(rng, (b, nq, d))
    k, v = (_normal(rng, (b, nkv, s, d)) for _ in range(2))
    lens = np.array([0, 7], np.int32)
    ref = np.asarray(r_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(lens), block_s=16))
    out = _split_decode(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), torch.from_numpy(lens), 2)
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_TOL)
    assert not out[0].any()


@pytest.mark.parametrize("softcap", [5.0, 50.0])
def test_split_decode_with_softcap_is_the_decode_kernels_function(softcap):
    """Gemma-2's softcap, which the Pallas kernel lacks: the split decode
    against the whole decode's plain version, which
    tests/test_torch_attention.py holds to the reference's `_decode_attn`
    with a softcap."""
    rng = np.random.default_rng(int(softcap))
    b, nq, nkv, s, d = 2, 8, 4, 40, 32
    q = torch.from_numpy(_normal(rng, (b, nq, d))) * 3
    k, v = (torch.from_numpy(_normal(rng, (b, nkv, s, d))) for _ in range(2))
    lens = torch.tensor([40, 9], dtype=torch.int32)
    want = p_ops.decode_attention(q, k, v, lens, softcap=softcap)
    got = _split_decode(q, k, v, lens, 4, softcap)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_TOL)


def test_scores_are_zero_and_unread_past_lens():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(_normal(rng, (2, 2, 4, 8)))
    k = torch.from_numpy(_normal(rng, (2, 2, 16, 8)))
    v = torch.from_numpy(_normal(rng, (2, 2, 16, 8)))
    lens = torch.tensor([5, 16], dtype=torch.int32)
    s = p_ops.decode_scores(q, k, lens)
    assert s.dtype == torch.float32 and s.shape == (2, 2, 4, 16)
    assert not s[0, :, :, 5:].any() and s[0, :, :, :5].all()
    k2, v2 = k.clone(), v.clone()
    k2[0, :, 5:], v2[0, :, 5:] = float("nan"), 1e6
    torch.testing.assert_close(p_ops.decode_scores(q, k2, lens), s,
                               rtol=0, atol=0)
    torch.testing.assert_close(
        p_ops.decode_softmax_v(s, v2, lens, 0.3),
        p_ops.decode_softmax_v(s, v, lens, 0.3), rtol=0, atol=0)


def test_operators_trace_to_shapes_and_count_the_decodes_flops():
    """Fake tensors get shapes; over the slices of the head dim the two
    FLOP formulas add up to `decode_attn`'s."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    b, nkv, group, s, d, slices = 2, 4, 8, 64, 32, 4
    with FakeTensorMode():
        q = torch.empty((b, nkv, group, d // slices))
        k = torch.empty((b, nkv, s, d // slices))
        lens = torch.empty((b,), dtype=torch.int32)
        with FlopCounterMode(display=False) as fc:
            sc = torch.ops.repro_torch.decode_scores(q, k, lens)
            out = torch.ops.repro_torch.decode_softmax_v(sc, k, lens, 0.1,
                                                         0.0)
        assert sc.shape == (b, nkv, group, s) and sc.dtype == torch.float32
        assert out.shape == q.shape and out.dtype == q.dtype
        with FlopCounterMode(display=False) as whole:
            qq, kk = torch.empty((b, nkv, group, d)), torch.empty(
                (b, nkv, s, d))
            torch.ops.repro_torch.decode_attn(qq, kk, kk, lens, 0.0)
    assert fc.get_total_flops() * slices == whole.get_total_flops()


def test_operators_refuse_a_graph_and_bad_shapes():
    q = torch.zeros((1, 1, 2, 8), requires_grad=True)
    k = torch.zeros((1, 1, 4, 8))
    lens = torch.ones((1,), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        p_dec.decode_scores(q, k, lens)
    with pytest.raises(ValueError, match="query heads per KV head"):
        p_dec.decode_scores(torch.zeros((1, 1, 17, 8)), k, lens)
    with pytest.raises(ValueError, match="float32"):
        p_dec.decode_softmax_v(torch.zeros((1, 1, 2, 4), dtype=torch.half),
                               k, lens, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        p_dec._launch_scores(q.detach(), k, lens)
