"""Card tests of the port: the CUDA Block-ELL SpMM kernel against its plain
PyTorch version, and the serving engine on the card against itself on the
CPU.

Marked `gpu`: each test decides inside itself whether a card is present
and skips without one. This file imports no `jax`, so it also runs where
only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(`--noconftest` because tests/conftest.py imports the JAX package.)
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import bcsr_spmm as kmod
from repro_torch.sparse import csr_from_dense, tile_csr_to_block_ell

pytestmark = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ell(n, m, density, bm, bk, dtype, seed):
    rng = np.random.default_rng(seed)
    dense = ((rng.random((n, m)) < density)
             * rng.standard_normal((n, m))).astype(np.float32).astype(dtype)
    return tile_csr_to_block_ell(csr_from_dense(dense), bm=bm, bk=bk,
                                 dtype=dtype)


@pytest.mark.parametrize("n,m,f,density,bm,bk,a_dt,h_dt", [
    (16, 16, 8, 0.3, 8, 8, np.float32, np.float32),
    (40, 24, 16, 0.05, 8, 8, np.float32, np.float32),
    (64, 64, 32, 0.3, 8, 8, np.float32, np.float32),
    (33, 57, 24, 0.3, 8, 8, np.float32, np.float32),
    (300, 280, 200, 0.02, 8, 8, np.float32, np.float32),
    (96, 96, 130, 0.1, 16, 16, np.float32, np.float32),
    (50, 70, 40, 0.2, 12, 8, np.float32, np.float32),
    (32, 32, 16, 0.2, 8, 8, np.float16, np.float16),
    (32, 32, 16, 0.2, 8, 8, np.float16, np.float32),
    (32, 32, 16, 0.2, 8, 8, np.float32, np.float16),
    (128, 128, 64, 0.05, 128, 128, np.float32, np.float32),
])
def test_kernel_matches_plain_version(n, m, f, density, bm, bk, a_dt, h_dt):
    dev = _card()
    ell = _ell(n, m, density, bm, bk, a_dt, seed=n * m + f)
    h = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (m, f)).astype(h_dt))
    args = [torch.from_numpy(x) for x in (ell.blocks, ell.col_tile,
                                          ell.n_tiles)]
    plain = kmod.bcsr_spmm_plain(*args, h, bm=bm, bk=bk)
    before = kmod.LAUNCHES
    out = kmod.bcsr_spmm_cuda(*[x.to(dev) for x in args], h.to(dev),
                              bm=bm, bk=bk)
    torch.cuda.synchronize()
    assert kmod.LAUNCHES == before + 1
    tol = 1e-2 if np.float16 in (a_dt, h_dt) else 1e-4
    np.testing.assert_allclose(out.cpu().numpy(), plain.numpy(), atol=tol)


def test_kernel_empty_row_blocks_and_padding_slots():
    dev = _card()
    dense = np.zeros((24, 24), np.float32)
    dense[3, 5] = 2.0
    ell = tile_csr_to_block_ell(csr_from_dense(dense), bm=8, bk=8)
    blocks = torch.from_numpy(ell.blocks).to(dev)
    col_tile = torch.from_numpy(ell.col_tile).to(dev)
    # A poisoned padding slot past n_tiles must not contribute.
    blocks_wide = torch.cat([blocks, torch.full_like(blocks, 7.0)], dim=1)
    col_wide = torch.cat([col_tile, torch.zeros_like(col_tile)], dim=1)
    h = torch.ones((24, 8), device=dev)
    out = kmod.bcsr_spmm_cuda(blocks_wide.contiguous(), col_wide.contiguous(),
                              torch.from_numpy(ell.n_tiles).to(dev), h,
                              bm=8, bk=8)
    np.testing.assert_allclose(out.cpu().numpy(), dense @ np.ones((24, 8)),
                               atol=1e-6)


def test_kernel_rejects_what_it_does_not_take():
    dev = _card()
    ell = _ell(16, 16, 0.3, 8, 8, np.float32, seed=0)
    blocks, col_tile, n_tiles = (torch.from_numpy(x).to(dev) for x in
                                 (ell.blocks, ell.col_tile, ell.n_tiles))
    h = torch.ones((16, 8), device=dev)
    with pytest.raises(ValueError):
        kmod.bcsr_spmm_cuda(blocks, col_tile, n_tiles, h.t(), bm=8, bk=8)
    with pytest.raises(TypeError):
        kmod.bcsr_spmm_cuda(blocks, col_tile, n_tiles, h.double(),
                            bm=8, bk=8)
    with pytest.raises(ValueError):
        kmod.bcsr_spmm_cuda(blocks, col_tile, n_tiles, h.cpu(), bm=8, bk=8)


def test_engine_on_card_matches_cpu_and_launches_per_segment():
    _card()
    from repro_torch.core import plan_memory_dense_features
    from repro_torch.data import (
        SUITESPARSE_SPECS, generate_graph, normalized_adjacency, scaled_spec,
    )
    from repro_torch.runtime import (
        EngineConfig, InferenceRequest, ServingEngine,
    )

    a = normalized_adjacency(generate_graph(
        scaled_spec(SUITESPARSE_SPECS["socLJ1"], 1e-4), seed=0))
    est = plan_memory_dense_features(a, a.n_rows, 64, float("inf"))
    budget = int(est.m_b + est.m_c + 0.6 * a.nbytes())
    rng = np.random.default_rng(0)
    h = rng.standard_normal((a.n_rows, 32)).astype(np.float32)
    ws = [rng.standard_normal((32, 32)).astype(np.float32) for _ in range(2)]
    reports = {}
    for device in ("cpu", "cuda"):
        eng = ServingEngine(EngineConfig(device_budget_bytes=budget,
                                         device=device))
        eng.register_graph("g", a)
        before = kmod.LAUNCHES
        reports[device] = []
        for _ in range(2):
            eng.submit(InferenceRequest("g", h, ws))
            reports[device].append(eng.run_batch())
        if device == "cuda":
            assert kmod.LAUNCHES - before == sum(
                r.segments_streamed for r in reports[device])
    for cpu, gpu in zip(reports["cpu"], reports["cuda"]):
        assert (gpu.uploaded_bytes, gpu.cache_hit_bytes,
                gpu.segments_streamed) == (cpu.uploaded_bytes,
                                           cpu.cache_hit_bytes,
                                           cpu.segments_streamed)
        np.testing.assert_allclose(gpu.results[0].output,
                                   cpu.results[0].output,
                                   atol=1e-4, rtol=1e-5)
