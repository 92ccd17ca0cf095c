"""The port's Block-ELL kernel module on the CPU against the JAX package's
Pallas kernels in interpret mode, on the cases of tests/test_kernels.py.

On CPU tensors `ops.bcsr_spmm` and `ops.fused_gcn_layer` run the kernels'
plain PyTorch versions; the CUDA kernels themselves are held against those
versions on the card (tests/test_torch_gpu.py and chip_smoke.py).
Tolerances: 1e-4 for float32 (sums in another order), 1e-2 for float16;
against the dense product, the reference tests' own.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as r_kernels
import repro.sparse as r_sparse
from repro_torch.kernels.ops import bcsr_spmm, fused_gcn_layer
from repro_torch.kernels.ref import bcsr_spmm_ref, fused_gcn_layer_ref
from repro_torch.sparse import (
    csr_from_dense, spmm_dense_ref, tile_csr_to_block_ell,
)

# The module, not the function `repro_torch.kernels.bcsr_spmm` names.
kmod = importlib.import_module("repro_torch.kernels.bcsr_spmm")


def _rand_sparse(n, m, density, dtype, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random((n, m)) < density)
            * rng.standard_normal((n, m))).astype(dtype)


def _both(dense, h, dtype=np.float32, bm=8, bk=8):
    """(port output, reference Pallas output) for the same inputs."""
    ell = tile_csr_to_block_ell(csr_from_dense(dense), bm=bm, bk=bk,
                                dtype=dtype)
    port = bcsr_spmm(ell, torch.from_numpy(h)).numpy()
    r_ell = r_sparse.tile_csr_to_block_ell(r_sparse.csr_from_dense(dense),
                                           bm=bm, bk=bk, dtype=dtype)
    ref = np.asarray(r_kernels.bcsr_spmm(r_ell, jnp.asarray(h), bn=8))
    return port, ref


@pytest.mark.parametrize("n,m,f", [(16, 16, 8), (40, 24, 16), (64, 64, 32),
                                   (33, 57, 24)])
@pytest.mark.parametrize("density", [0.05, 0.3])
def test_bcsr_spmm_matches_pallas_shapes(n, m, f, density):
    dense = _rand_sparse(n, m, density, np.float32, seed=n * m + f)
    h = np.random.default_rng(1).standard_normal((m, f)).astype(np.float32)
    port, ref = _both(dense, h)
    assert port.shape == ref.shape == (n, f)
    np.testing.assert_allclose(port, ref, atol=1e-4)
    np.testing.assert_allclose(port, dense @ h, atol=1e-4)


def _both_bf16(dense, h, bm=8, bk=8):
    """`_both` for bfloat16 bricks and H: the inputs round once to bf16
    through torch and cross to the reference as float32 values (numpy has no
    bfloat16), where the Pallas kernel takes them as jnp.bfloat16."""
    dense = torch.from_numpy(dense).bfloat16().float().numpy()
    h_t = torch.from_numpy(h).bfloat16()
    ell = tile_csr_to_block_ell(csr_from_dense(dense), bm=bm, bk=bk)
    port = kmod.bcsr_spmm_blocks(
        torch.from_numpy(ell.blocks).bfloat16(), torch.from_numpy(
            ell.col_tile), torch.from_numpy(ell.n_tiles), h_t, bm=bm,
        bk=bk)[:dense.shape[0]].numpy()
    r_ell = r_sparse.tile_csr_to_block_ell(r_sparse.csr_from_dense(dense),
                                           bm=bm, bk=bk, dtype=jnp.bfloat16)
    ref = np.asarray(r_kernels.bcsr_spmm(
        r_ell, jnp.asarray(h_t.float().numpy()).astype(jnp.bfloat16), bn=8))
    return port, ref, dense, h_t.float().numpy()


@pytest.mark.parametrize("dtype", [np.float32, np.float16, "bfloat16"])
def test_bcsr_spmm_matches_pallas_dtypes(dtype):
    dense = _rand_sparse(32, 32, 0.2, np.float32, seed=7)
    h = np.random.default_rng(2).standard_normal((32, 16)).astype(np.float32)
    if dtype == "bfloat16":
        port, ref, dense, h = _both_bf16(dense, h)
    else:
        dense, h = dense.astype(dtype), h.astype(dtype)
        port, ref = _both(dense, h, dtype=dtype)
    tol = 1e-4 if dtype == np.float32 else 1e-2
    assert port.dtype == np.float32
    np.testing.assert_allclose(port, ref, atol=tol)
    np.testing.assert_allclose(
        port, dense.astype(np.float32) @ h.astype(np.float32), atol=tol)


def test_bcsr_spmm_matches_pallas_empty_rows():
    dense = np.zeros((24, 24), np.float32)
    dense[3, 5] = 2.0  # single nonzero: two of three row blocks are empty
    port, ref = _both(dense, np.ones((24, 8), np.float32))
    np.testing.assert_allclose(port, ref, atol=1e-5)
    np.testing.assert_allclose(port, dense @ np.ones((24, 8)), atol=1e-5)


@pytest.mark.parametrize("n,m,f,bm,bk", [(50, 70, 40, 12, 8),
                                         (96, 96, 20, 16, 16),
                                         (33, 57, 24, 8, 8)])
def test_plain_version_matches_densify_oracle(n, m, f, bm, bk):
    dense = _rand_sparse(n, m, 0.2, np.float32, seed=n + f)
    ell = tile_csr_to_block_ell(csr_from_dense(dense), bm=bm, bk=bk)
    h = np.random.default_rng(3).standard_normal((m, f)).astype(np.float32)
    args = [torch.from_numpy(x) for x in (ell.blocks, ell.col_tile,
                                          ell.n_tiles)]
    plain = kmod.bcsr_spmm_plain(*args, torch.from_numpy(h), bm=bm, bk=bk)
    h_pad = np.zeros((-(-m // bk) * bk, f), np.float32)
    h_pad[:m] = h
    oracle = bcsr_spmm_ref(*args, torch.from_numpy(h_pad), bm=bm, bk=bk)
    np.testing.assert_allclose(plain.numpy(), oracle.numpy(), atol=1e-4)
    dense_ref = spmm_dense_ref(torch.from_numpy(dense), torch.from_numpy(h))
    np.testing.assert_allclose(plain[:n].numpy(), dense_ref.numpy(),
                               atol=1e-4)


def test_plain_version_skips_padding_slots_and_short_h():
    """Slots past n_tiles and negative ids contribute nothing; tiles past
    H's last row read zeros (the reference pads H with zeros)."""
    blocks = torch.ones((2, 3, 8, 8))
    col_tile = torch.tensor([[0, 1, 5], [-1, 0, 0]], dtype=torch.int32)
    n_tiles = torch.tensor([3, 2], dtype=torch.int32)
    h = torch.ones((12, 4))   # tile 1 is half past the end, tile 5 beyond it
    out = kmod.bcsr_spmm_plain(blocks, col_tile, n_tiles, h, bm=8, bk=8)
    np.testing.assert_allclose(out[:8].numpy(), 12.0)
    np.testing.assert_allclose(out[8:].numpy(), 8.0)


def test_wrapper_rejects_bad_operands():
    blocks = torch.zeros((2, 1, 8, 8))
    col_tile = torch.zeros((2, 1), dtype=torch.int32)
    n_tiles = torch.ones((2,), dtype=torch.int32)
    h = torch.zeros((8, 4))
    with pytest.raises(TypeError):
        kmod.bcsr_spmm_blocks(blocks.double(), col_tile, n_tiles, h,
                              bm=8, bk=8)
    with pytest.raises(TypeError):
        kmod.bcsr_spmm_blocks(blocks, col_tile.long(), n_tiles, h, bm=8, bk=8)
    with pytest.raises(ValueError):
        kmod.bcsr_spmm_blocks(blocks, col_tile, n_tiles, h, bm=8, bk=4)
    with pytest.raises(ValueError):
        kmod.bcsr_spmm_blocks(blocks, col_tile[:1], n_tiles, h, bm=8, bk=8)
    with pytest.raises(ValueError):   # the CUDA path never takes CPU tensors
        kmod.bcsr_spmm_cuda(blocks, col_tile, n_tiles, h, bm=8, bk=8)


@pytest.mark.parametrize("f,bm,expected", [(1024, 8, 128), (16, 8, 32),
                                           (100, 8, 128), (64, 128, 64),
                                           (1024, 256, 32)])
def test_feature_tile_fits_a_thread_block(f, bm, expected):
    bn = kmod._feature_tile(f, bm)
    assert bn == expected
    assert bn * -(-bm // 8) <= 1024


@pytest.mark.parametrize("n,f,fo", [(24, 16, 8), (40, 24, 16)])
def test_fused_gcn_layer_matches_pallas(n, f, fo):
    """ops.fused_gcn_layer (the plain version on CPU tensors) against the
    reference's fused Pallas kernel in interpret mode, on
    tests/test_kernels.py's cases."""
    dense = _rand_sparse(n, n, 0.2, np.float32, seed=n)
    rng = np.random.default_rng(5)
    h = rng.standard_normal((n, f)).astype(np.float32)
    w = rng.standard_normal((f, fo)).astype(np.float32)
    b = rng.standard_normal((fo,)).astype(np.float32)
    ell = tile_csr_to_block_ell(csr_from_dense(dense), bm=8, bk=8)
    port = fused_gcn_layer(ell, *(torch.from_numpy(x) for x in (h, w, b)))
    r_ell = r_sparse.tile_csr_to_block_ell(r_sparse.csr_from_dense(dense),
                                           bm=8, bk=8)
    ref = np.asarray(r_kernels.fused_gcn_layer(
        r_ell, jnp.asarray(h), jnp.asarray(w), jnp.asarray(b)))
    assert port.shape == ref.shape == (n, fo)
    np.testing.assert_allclose(port.numpy(), ref, atol=1e-4)
    np.testing.assert_allclose(port.numpy(), np.maximum(dense @ h @ w + b, 0),
                               atol=1e-3)


@pytest.mark.parametrize("n,m,f,fo,bm,bk", [(50, 70, 40, 24, 12, 8),
                                            (96, 96, 20, 64, 16, 16),
                                            (33, 57, 24, 5, 8, 8)])
def test_fused_plain_version_matches_densify_oracle(n, m, f, fo, bm, bk):
    dense = _rand_sparse(n, m, 0.2, np.float32, seed=n + f)
    ell = tile_csr_to_block_ell(csr_from_dense(dense), bm=bm, bk=bk)
    rng = np.random.default_rng(3)
    h, w, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((m, f), (f, fo), (fo,)))
    args = [torch.from_numpy(x) for x in (ell.blocks, ell.col_tile,
                                          ell.n_tiles)]
    plain = kmod.fused_gcn_layer_plain(*args, h, w, b, bm=bm, bk=bk)
    h_pad = torch.zeros((-(-m // bk) * bk, f))
    h_pad[:m] = h
    oracle = fused_gcn_layer_ref(*args, h_pad, w, b, bm=bm, bk=bk)
    assert plain.shape == (ell.n_row_blocks * bm, fo)
    np.testing.assert_allclose(plain.numpy(), oracle.numpy(), atol=1e-4)


def test_fused_plain_version_empty_row_blocks_give_relu_b():
    """A row block with no valid slot yields relu(b), as on the TPU."""
    dense = np.zeros((24, 24), np.float32)
    dense[3, 5] = 2.0
    ell = tile_csr_to_block_ell(csr_from_dense(dense), bm=8, bk=8)
    args = [torch.from_numpy(x) for x in (ell.blocks, ell.col_tile,
                                          ell.n_tiles)]
    b = torch.tensor([1.0, -1.0, 0.5])
    out = kmod.fused_gcn_layer_plain(*args, torch.ones((24, 4)),
                                     torch.ones((4, 3)), b, bm=8, bk=8)
    np.testing.assert_allclose(out[8:].numpy(),
                               np.tile([1.0, 0.0, 0.5], (16, 1)))


def test_fused_wrapper_rejects_bad_operands():
    blocks = torch.zeros((2, 1, 8, 8))
    col_tile = torch.zeros((2, 1), dtype=torch.int32)
    n_tiles = torch.ones((2,), dtype=torch.int32)
    h, w, b = torch.zeros((8, 4)), torch.zeros((4, 3)), torch.zeros(3)
    fn = kmod.fused_gcn_layer_blocks
    with pytest.raises(TypeError):     # float32 only, f16 included
        fn(blocks.half(), col_tile, n_tiles, h, w, b, bm=8, bk=8)
    with pytest.raises(TypeError):
        fn(blocks, col_tile, n_tiles, h, w.double(), b, bm=8, bk=8)
    with pytest.raises(ValueError):
        fn(blocks, col_tile, n_tiles, h, w.T, b, bm=8, bk=8)
    with pytest.raises(ValueError):
        fn(blocks, col_tile, n_tiles, h, w, b[:2], bm=8, bk=8)
    with pytest.raises(ValueError):   # the CUDA path never takes CPU tensors
        kmod.fused_gcn_layer_cuda(blocks, col_tile, n_tiles, h, w, b,
                                  bm=8, bk=8)


@pytest.mark.parametrize("f,fo,bm,expected", [(256, 256, 8, 256),
                                              (256, 64, 8, 256),
                                              (12, 6, 8, 32),
                                              (200, 40, 128, 64),
                                              (1024, 1024, 256, 32)])
def test_fused_tile_fits_a_thread_block(f, fo, bm, expected):
    bn = kmod._fused_tile(f, fo, bm)
    assert bn == expected
    assert bn * -(-bm // 8) <= 1024


def _dense_from_bricks(blocks, col_tile, n_tiles, k_rows):
    """The matrix the bricks hold, in float64, over H's k_rows columns."""
    n_rb, ell_w, bm, bk = blocks.shape
    n_ct = -(-k_rows // bk)
    a = np.zeros((n_rb * bm, (n_ct + 1) * bk))
    for rb in range(n_rb):
        for s in range(min(int(n_tiles[rb]), ell_w)):
            t = int(col_tile[rb, s])
            if 0 <= t < n_ct:
                a[rb * bm:(rb + 1) * bm, t * bk:(t + 1) * bk] += (
                    blocks[rb, s].double().numpy())
    return a[:, :k_rows]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("case", ["dense", "zero_columns", "zero_brick",
                                  "hub", "short_h"])
def test_plain_version_on_zero_skip_edge_cases(case, dtype):
    """The plain version, which the card tests hold the zero-skipping
    kernel to, on the bricks of those tests (every column nonzero, one
    nonzero column, a brick of zeros, a row block of 300 slots, H ending 3
    rows into the last tile), in each brick and H type, against the float64
    product of the same values. Both sum f32 products of exactly converted
    values: limit 1e-5 of the output's scale."""
    rng = np.random.default_rng(7)
    n, m = 64, 64
    if case == "dense":
        dense = rng.standard_normal((n, m))
    elif case == "hub":          # row block 0 spans 300 column tiles
        m = 8 * 300
        dense = (rng.random((n, m)) < 0.002) * rng.standard_normal((n, m))
        dense[:8, ::8] = rng.standard_normal((8, 300))
    else:
        dense = np.zeros((n, m))
        dense[:, ::8] = rng.standard_normal((n, m // 8))
    if case == "short_h":
        dense[:, m - 5:] = rng.standard_normal((n, 5))
    ell = tile_csr_to_block_ell(csr_from_dense(dense.astype(np.float32)),
                                bm=8, bk=8)
    blocks = torch.from_numpy(ell.blocks).to(dtype)
    if case == "zero_brick":
        blocks[:, 0] = 0.0
    col_tile, n_tiles = (torch.from_numpy(x) for x in (ell.col_tile,
                                                       ell.n_tiles))
    h = torch.from_numpy(rng.standard_normal((m, 24)).astype(
        np.float32)).to(dtype)
    if case == "short_h":
        h = h[:m - 3]
    plain = kmod.bcsr_spmm_plain(blocks, col_tile, n_tiles, h, bm=8, bk=8)
    oracle = _dense_from_bricks(blocks, col_tile, n_tiles, h.shape[0]) @ (
        h.double().numpy())
    assert plain.dtype == torch.float32
    np.testing.assert_allclose(plain.numpy(), oracle,
                               atol=1e-5 * np.abs(oracle).max())
