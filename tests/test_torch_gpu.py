"""Card tests of the port: the CUDA Block-ELL SpMM and fused GCN-layer
kernels against their plain PyTorch versions, and the serving engine, the
differentiable engine and its fused layer on the card against themselves
on the CPU.

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


@pytest.mark.parametrize("n,m,f,fo,density,bm,bk", [
    (16, 16, 8, 4, 0.3, 8, 8),
    (33, 57, 24, 5, 0.3, 8, 8),
    (300, 280, 200, 64, 0.02, 8, 8),
    (300, 280, 256, 256, 0.05, 8, 8),
    (96, 96, 130, 40, 0.1, 16, 16),
    (50, 70, 40, 24, 0.2, 12, 8),
    (128, 128, 64, 33, 0.05, 128, 128),
    (41, 41, 1030, 7, 0.2, 8, 8),
])
def test_fused_kernel_matches_plain_version(n, m, f, fo, density, bm, bk):
    dev = _card()
    ell = _ell(n, m, density, bm, bk, np.float32, seed=n * m + f)
    rng = np.random.default_rng(2)
    h, w, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((m, f), (f, fo), (fo,)))
    w = w * f ** -0.5   # outputs of order 1, as gcn_init's weights give
    args = [torch.from_numpy(x) for x in (ell.blocks, ell.col_tile,
                                          ell.n_tiles)]
    plain = kmod.fused_gcn_layer_plain(*args, h, w, b, bm=bm, bk=bk)
    before = kmod.FUSED_LAUNCHES
    out = kmod.fused_gcn_layer_cuda(*[x.to(dev) for x in args + [h, w, b]],
                                    bm=bm, bk=bk)
    torch.cuda.synchronize()
    assert kmod.FUSED_LAUNCHES == before + 1
    np.testing.assert_allclose(out.cpu().numpy(), plain.numpy(), atol=1e-4)


def test_fused_kernel_empty_row_blocks_and_padding_slots():
    dev = _card()
    dense = np.zeros((24, 24), np.float32)
    dense[3, 5] = 2.0
    ell = tile_csr_to_block_ell(csr_from_dense(dense), bm=8, bk=8)
    blocks = torch.from_numpy(ell.blocks).to(dev)
    col_tile = torch.from_numpy(ell.col_tile).to(dev)
    blocks_wide = torch.cat([blocks, torch.full_like(blocks, 7.0)], dim=1)
    col_wide = torch.cat([col_tile, torch.zeros_like(col_tile)], dim=1)
    w = torch.ones((8, 3), device=dev)
    b = torch.tensor([1.0, -1.0, 0.5], device=dev)
    out = kmod.fused_gcn_layer_cuda(
        blocks_wide.contiguous(), col_wide.contiguous(),
        torch.from_numpy(ell.n_tiles).to(dev), torch.ones((24, 8), device=dev),
        w, b, bm=8, bk=8)
    ref = np.maximum(dense @ np.ones((24, 8)) @ np.ones((8, 3))
                     + [1.0, -1.0, 0.5], 0)
    np.testing.assert_allclose(out.cpu().numpy(), ref, atol=1e-6)


def test_fused_kernel_rejects_what_it_does_not_take():
    dev = _card()
    ell = _ell(16, 16, 0.3, 8, 8, np.float32, seed=0)
    blocks, col_tile, n_tiles = (torch.from_numpy(x).to(dev) for x in
                                 (ell.blocks, ell.col_tile, ell.n_tiles))
    h = torch.ones((16, 8), device=dev)
    w = torch.ones((8, 4), device=dev)
    b = torch.zeros(4, device=dev)
    fn = kmod.fused_gcn_layer_cuda
    with pytest.raises(TypeError):
        fn(blocks.half(), col_tile, n_tiles, h, w, b, bm=8, bk=8)
    with pytest.raises(TypeError):
        fn(blocks, col_tile, n_tiles, h.half(), w, b, bm=8, bk=8)
    with pytest.raises(ValueError):
        fn(blocks, col_tile, n_tiles, h, torch.ones((4, 8), device=dev).t(),
           b, bm=8, bk=8)
    with pytest.raises(ValueError):
        fn(blocks, col_tile, n_tiles, h, w, b.cpu(), bm=8, bk=8)
    with pytest.raises(ValueError):   # X and the brick exceed shared memory
        fn(blocks, col_tile, n_tiles, torch.ones((16, 8000), device=dev),
           torch.ones((8000, 4), device=dev), b, bm=8, bk=8)


def _train_case():
    from repro_torch.core import (
        AiresConfig, AiresSpGEMM, plan_memory_dense_features,
    )
    from repro_torch.data import (
        SUITESPARSE_SPECS, generate_graph, normalized_adjacency, scaled_spec,
    )
    a = normalized_adjacency(generate_graph(
        scaled_spec(SUITESPARSE_SPECS["socLJ1"], 1e-4), seed=0))
    rng = np.random.default_rng(0)
    h = rng.standard_normal((a.n_rows, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 16)) / 6).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    # Streams 4 segments each way at width 32.
    est = plan_memory_dense_features(a, a.n_rows, 32, float("inf"))
    budget = int(est.m_b + est.m_c + 0.3 * a.nbytes())
    engines = {device: AiresSpGEMM(AiresConfig(
        device_budget_bytes=budget, bm=8, bk=8, device=device))
        for device in ("cpu", "cuda")}
    return a, h, w, b, engines


def _stats(log):
    return [(s.segments, s.uploaded_bytes) for s in log]


def test_spgemm_backward_on_card_matches_cpu():
    """dH through the transposed stream: the card's launches equal the
    segments streamed in both directions, and its H on the CPU gets its
    gradient back on the CPU."""
    _card()
    a, h, _, _, engines = _train_case()
    grads = {}
    for device, eng in engines.items():
        ht = torch.from_numpy(h).requires_grad_(True)
        before = kmod.LAUNCHES
        torch.sum(torch.sin(eng(a, ht))).backward()
        if device == "cuda":
            torch.cuda.synchronize()
            assert kmod.LAUNCHES - before == sum(
                s.segments for s in eng.forward_stats_log
                + eng.backward_stats_log)
        assert ht.grad.device.type == "cpu"
        assert eng.last_backward_stream_stats.segments >= 2
        grads[device] = ht.grad.numpy()
    assert (_stats(engines["cuda"].backward_stats_log)
            == _stats(engines["cpu"].backward_stats_log))
    np.testing.assert_allclose(grads["cuda"], grads["cpu"], atol=1e-4)


def test_gcn_layer_on_card_matches_cpu():
    """y, dH, dW and db of the fused layer on the card against the same
    engine on the CPU; the fused kernel runs once per forward segment, the
    SpMM once per recompute and transposed segment."""
    _card()
    a, h, w, b, engines = _train_case()
    results = {}
    for device, eng in engines.items():
        args = [torch.from_numpy(x).to(device).requires_grad_(True)
                for x in (h, w, b)]
        fused, spmm = kmod.FUSED_LAUNCHES, kmod.LAUNCHES
        y = eng.gcn_layer(a, *args)
        torch.sum(torch.tanh(y)).backward()
        if device == "cuda":
            torch.cuda.synchronize()
            assert kmod.FUSED_LAUNCHES - fused == sum(
                s.segments for s in eng.forward_stats_log)
            assert kmod.LAUNCHES - spmm == sum(
                s.segments for s in eng.backward_stats_log)
        assert len(eng.backward_stats_log) == 2
        results[device] = [y.detach().cpu().numpy()] + [
            t.grad.cpu().numpy() for t in args]
    assert (_stats(engines["cuda"].forward_stats_log)
            == _stats(engines["cpu"].forward_stats_log))
    assert (_stats(engines["cuda"].backward_stats_log)
            == _stats(engines["cpu"].backward_stats_log))
    for gpu, cpu in zip(results["cuda"], results["cpu"]):
        np.testing.assert_allclose(gpu, cpu, atol=1e-4, rtol=1e-5)
