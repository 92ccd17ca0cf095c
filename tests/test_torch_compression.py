"""int8 error-feedback gradient compression in the port against the JAX
package's, on the same arrays made with numpy from a seed: `ef_init`,
`compress_grads` (the int8 tree, the f32 scales and the new residual) and
`decompress_grads` equal the reference's exactly, bit for bit, over several
rounds of error feedback, on nested trees of the LM's shape, with ties at
half a step (both round half to even), all-zero leaves and 16-bit
gradients among them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compression as r_comp
from repro_torch.train import compression as p_comp


def _tree(seed, dtype=np.float32, scale=1.0):
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return (scale * rng.standard_normal(shape)).astype(dtype)

    return {"embed": arr(16, 8), "final_norm": arr(8),
            "layers": [{"attn": {"wq": arr(8, 8), "wo": arr(8, 8)},
                        "ln1": arr(8)} for _ in range(2)]}


def _port(tree, dtype=None):
    """numpy leaves → tensors (bf16 by value from f32 when asked)."""
    if isinstance(tree, dict):
        return {k: _port(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_port(v, dtype) for v in tree]
    t = torch.from_numpy(np.array(tree))
    return t.to(dtype) if dtype is not None else t


def _ref(tree, dtype=None):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype=dtype), tree)


def _assert_equal(port, ref):
    """Same structure, dtypes and bits."""
    if isinstance(port, dict):
        assert set(port) == set(ref)
        for k in port:
            _assert_equal(port[k], ref[k])
    elif isinstance(port, list):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            _assert_equal(p, r)
    else:
        r = np.asarray(ref)
        p = port.numpy()
        assert p.dtype == r.dtype and p.shape == r.shape
        np.testing.assert_array_equal(p.reshape(-1).view(np.uint8),
                                      r.reshape(-1).view(np.uint8))


def test_ef_init_equals_reference():
    tree = _tree(0)
    _assert_equal(p_comp.ef_init(_port(tree)), r_comp.ef_init(_ref(tree)))


@pytest.mark.parametrize("seed,scale", [(1, 1.0), (2, 1e-3), (3, 1e4)])
def test_compress_rounds_equal_reference(seed, scale):
    """Four rounds of error feedback on fresh gradients each round: q,
    scales and residuals equal bit for bit every round."""
    p_ef = p_comp.ef_init(_port(_tree(seed)))
    r_ef = r_comp.ef_init(_ref(_tree(seed)))
    for rnd in range(4):
        grads = _tree(100 * seed + rnd, scale=scale)
        p_q, p_s, p_ef = p_comp.compress_grads(_port(grads), p_ef)
        r_q, r_s, r_ef = r_comp.compress_grads(_ref(grads), r_ef)
        _assert_equal(p_q, r_q)
        _assert_equal(p_s, r_s)
        _assert_equal(p_ef, r_ef)
        _assert_equal(p_comp.decompress_grads(p_q, p_s),
                      r_comp.decompress_grads(r_q, r_s))
        assert all(q.dtype == torch.int8 for q in
                   (p_q["embed"], p_q["layers"][1]["attn"]["wo"]))


def test_half_steps_round_to_even_and_zero_leaves():
    """max |x| = 127 makes the scale 1 (1 + 1e-12 rounds to 1 in f32), so
    x / scale = x: the halves round to even in both packages; a zero leaf
    quantizes to 0 with the scale 1e-12."""
    x = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -127.0],
                 np.float32)
    tree = {"x": x, "z": np.zeros((3,), np.float32)}
    ef = {"x": np.zeros_like(x), "z": np.zeros((3,), np.float32)}
    p_q, p_s, p_ef = p_comp.compress_grads(_port(tree), _port(ef))
    r_q, r_s, r_ef = r_comp.compress_grads(_ref(tree), _ref(ef))
    _assert_equal(p_q, r_q)
    _assert_equal(p_s, r_s)
    _assert_equal(p_ef, r_ef)
    assert p_q["x"].tolist() == [127, 2, -4, 0, 0, 2, 126, -127]
    assert p_q["z"].tolist() == [0, 0, 0]


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_16bit_gradients_equal_reference(dtype):
    """16-bit gradients (the bf16 model's) are widened to f32 before the
    residual is added, in both packages."""
    grads = _tree(7)
    ef = _tree(8, scale=1e-2)
    p_q, p_s, p_ef = p_comp.compress_grads(_port(grads, getattr(torch, dtype)),
                                           _port(ef))
    r_q, r_s, r_ef = r_comp.compress_grads(_ref(grads, getattr(jnp, dtype)),
                                           _ref(ef))
    _assert_equal(p_q, r_q)
    _assert_equal(p_s, r_s)
    _assert_equal(p_ef, r_ef)
