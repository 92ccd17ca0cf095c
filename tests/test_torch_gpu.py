"""Card tests of the port: the CUDA Block-ELL SpMM, fused GCN-layer,
flash-attention and GQA flash-decode kernels (and the decode over a slice
of the head dim) against their plain PyTorch
versions (the SpMM also at the autotuner's bucket widths; both attention
kernels also with Gemma-2's attention softcap and at RecurrentGemma's head
dim 256, in both directions, and the flash kernels with Qwen2-VL's
bidirectional vision prefix and with a key length of their own, the
encoder-decoder's), and the
serving engine (sharded, with replicated workers and a warm start among
them, autotuned, through edge-delta updates, and under the continuous
serving loop), the differentiable
engine and its fused layer, the schedulers' execute mode, a coalesced
stream, and the dense LM's forward, decode and serve on the card against
themselves on the CPU or against float64 (Gemma-2's past its window and
its rings' wrap among them, the recurrent archs' and SeamlessM4T's); and
that importing the
kernels package builds nothing until the first launch.

Marked `gpu`: each test decides inside itself whether a card is present
and skips without one. This file imports no `jax`, so it also runs where
only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(`--noconftest` because tests/conftest.py imports the JAX package.)
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro_torch.sparse import csr_from_dense, tile_csr_to_block_ell

# The module, not the function `repro_torch.kernels.bcsr_spmm` names.
kmod = importlib.import_module("repro_torch.kernels.bcsr_spmm")

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


def _to_torch(x: np.ndarray, dtype) -> torch.Tensor:
    """numpy values as a tensor of `dtype`: a numpy type, or "bfloat16",
    which numpy lacks and which is rounded to from float32."""
    if dtype == "bfloat16":
        return torch.from_numpy(x.astype(np.float32)).bfloat16()
    return torch.from_numpy(x.astype(dtype))


def _spmm_on_card(args, h, bm, bk, route):
    """The kernel on the card, its launch counted once in all and once on
    `route`; returns the output on the CPU."""
    dev = _card()
    before = kmod.LAUNCHES, kmod.SPMM_ROUTE_LAUNCHES[route]
    out = kmod.bcsr_spmm_cuda(*[x.to(dev) for x in args], h.to(dev),
                              bm=bm, bk=bk)
    torch.cuda.synchronize()
    assert (kmod.LAUNCHES, kmod.SPMM_ROUTE_LAUNCHES[route]) == (
        before[0] + 1, before[1] + 1)
    return out.cpu()


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
    (300, 280, 256, 0.02, 8, 8, "bfloat16", "bfloat16"),
    (300, 280, 256, 0.02, 8, 8, np.float32, "bfloat16"),
    (300, 280, 256, 0.02, 8, 8, "bfloat16", np.float32),
    (64, 72, 520, 0.1, 8, 8, "bfloat16", np.float16),
    # F not a multiple of the 4 or 8 values in 16 bytes, and F = 1.
    (300, 280, 1, 0.05, 8, 8, np.float32, np.float32),
    (300, 280, 3, 0.05, 8, 8, np.float32, np.float32),
    (300, 280, 257, 0.05, 8, 8, np.float32, np.float32),
    (300, 280, 257, 0.05, 8, 8, np.float32, "bfloat16"),
    (300, 280, 260, 0.05, 8, 8, np.float32, np.float16),
    # Shorter bricks on the zero-skipping route, and narrower ones off it.
    (100, 96, 64, 0.1, 4, 8, np.float32, np.float32),
    (100, 96, 64, 0.1, 4, 8, np.float16, "bfloat16"),
    (100, 96, 64, 0.1, 8, 4, np.float32, np.float32),
])
def test_kernel_matches_plain_version(n, m, f, density, bm, bk, a_dt, h_dt):
    ell = _ell(n, m, density, bm, bk, np.float32, seed=n * m + f)
    h = _to_torch(np.random.default_rng(1).standard_normal((m, f)), h_dt)
    args = [_to_torch(ell.blocks, a_dt)] + [
        torch.from_numpy(x) for x in (ell.col_tile, ell.n_tiles)]
    plain = kmod.bcsr_spmm_plain(*args, h, bm=bm, bk=bk)
    route = "zero_skip" if bm <= 8 and bk == 8 else "brick_loop"
    out = _spmm_on_card(args, h, bm, bk, route)
    # bf16 values convert to f32 exactly: both sides then sum f32 products
    # in other orders. The f16 cases keep the first version's 1e-2.
    tol = 1e-2 if np.float16 in (a_dt, h_dt) else 1e-4
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=tol)


@pytest.mark.parametrize("case", ["dense", "zero_columns", "zero_brick",
                                  "hub", "unaligned_h", "short_h"])
def test_kernel_zero_skip_edge_cases(case):
    """The zero-skipping route on bricks whose 8 columns are all nonzero,
    whose columns are zero but for one, that are zero throughout; on one row
    block with far more slots than the rest (its tail goes to the second
    kernel); on H whose pointer is not 16-byte aligned; and on H shorter than
    the last column tile."""
    _card()
    rng = np.random.default_rng(7)
    n, m, f = 64, 64, 96
    if case == "dense":
        dense = rng.standard_normal((n, m))
    elif case in ("zero_columns", "zero_brick", "unaligned_h", "short_h"):
        dense = np.zeros((n, m))
        dense[:, ::8] = rng.standard_normal((n, m // 8))   # one column each
    else:                        # row block 0 spans 300 column tiles
        m = 8 * 300
        dense = (rng.random((n, m)) < 0.002) * rng.standard_normal((n, m))
        dense[:8, ::8] = rng.standard_normal((8, 300))
    dense = dense.astype(np.float32)
    if case == "short_h":        # H ends 3 rows into the last column tile
        dense[:, m - 5:] = rng.standard_normal((n, 5))
    ell = tile_csr_to_block_ell(csr_from_dense(dense), bm=8, bk=8)
    args = [torch.from_numpy(x) for x in (ell.blocks, ell.col_tile,
                                          ell.n_tiles)]
    if case == "zero_brick":
        args[0][:, 0] = 0.0
    h = torch.randn((m, f), generator=torch.Generator().manual_seed(3))
    if case == "unaligned_h":    # contiguous, 4 bytes past 16-byte alignment
        h = torch.cat([torch.zeros(1), h.flatten()])[1:].view(m, f)
    if case == "short_h":
        h = h[:m - 3]
    out = _spmm_on_card(args, h, 8, 8, "zero_skip")
    plain = kmod.bcsr_spmm_plain(*args, h, bm=8, bk=8)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=1e-4)
    if case == "hub":
        assert int(ell.n_tiles[0]) == ell.blocks.shape[1] == 300
    if case in ("dense", "zero_columns"):
        np.testing.assert_allclose(out[:n].numpy(), dense @ h.numpy(),
                                   atol=1e-4)


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


@pytest.mark.parametrize("bm,bk,dtype,k_rows,expected", [
    (8, 8, torch.float32, 100, "zero_skip"),     # the plans' bricks
    (8, 8, torch.float16, 100, "zero_skip"),
    (8, 8, torch.bfloat16, 100, "zero_skip"),
    (4, 8, torch.float32, 100, "zero_skip"),     # shorter bricks
    (1, 8, torch.float16, 100, "zero_skip"),
    (8, 4, torch.bfloat16, 100, "brick_loop"),   # narrower bricks
    (12, 8, torch.float32, 100, "brick_loop"),
    (16, 16, torch.float32, 100, "brick_loop"),
    (128, 128, torch.float32, 100, "brick_loop"),
    (8, 8, torch.float32, 2 ** 31, "brick_loop"),  # rows past int32
])
def test_spmm_route(bm, bk, dtype, k_rows, expected):
    """The route the C entry point chooses, read from the counters, and its
    output against the plain version."""
    dev = _card()
    rows = min(k_rows, 100)
    ell = _ell(4 * bm, rows, 0.1, bm, bk, np.float32, seed=bm * bk)
    args = [torch.from_numpy(ell.blocks).to(dtype)] + [
        torch.from_numpy(x) for x in (ell.col_tile, ell.n_tiles)]
    f = 1 if k_rows > rows else 16
    h_small = torch.randn((rows, f), generator=torch.Generator()
                          .manual_seed(5)).to(dtype)
    plain = kmod.bcsr_spmm_plain(*args, h_small, bm=bm, bk=bk)
    h = h_small
    if k_rows > rows:   # 4 GiB of f16 rows, zeros past the first 100
        h = torch.zeros((k_rows, f), dtype=torch.float16, device=dev)
        h[:rows] = h_small.to(dev, torch.float16)
        plain = kmod.bcsr_spmm_plain(*args, h_small.half(), bm=bm, bk=bk)
    out = _spmm_on_card(args, h, bm, bk, expected)
    del h
    tol = 1e-2 if torch.float16 in (dtype, h_small.dtype) else 1e-4
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=tol)


@pytest.mark.parametrize("ell_w", [1, 64, 65, 80, 81, 512])
def test_zero_skip_tail_splits_cover_every_slot(ell_w):
    """The first zero-skip kernel takes 64 slots of a row block and the
    second every further 16 (it is not launched when ell_w <= 64): three
    row blocks of ell_w valid slots each, every slot holding a nonzero."""
    rng = np.random.default_rng(ell_w)
    m = 8 * ell_w
    dense = (rng.random((24, m)) < 0.05) * rng.standard_normal((24, m))
    dense[:, rng.integers(0, 8) + 8 * np.arange(ell_w)] = (
        rng.standard_normal((24, ell_w)))
    ell = tile_csr_to_block_ell(csr_from_dense(dense.astype(np.float32)),
                                bm=8, bk=8)
    assert ell.blocks.shape[1] == ell_w and (ell.n_tiles == ell_w).all()
    args = [torch.from_numpy(x) for x in (ell.blocks, ell.col_tile,
                                          ell.n_tiles)]
    h = torch.randn((m, 40), generator=torch.Generator().manual_seed(6))
    out = _spmm_on_card(args, h, 8, 8, "zero_skip")
    np.testing.assert_allclose(out.numpy(), dense @ h.double().numpy(),
                               atol=1e-4)


@pytest.mark.parametrize("bm,bk,f,expected", [
    (8, 8, 256, "grouped"),       # the training path's layer
    (8, 8, 1, "grouped"),
    (8, 8, 736, "grouped"),       # the widest X of a group that fits the
    (8, 8, 737, "row_block"),     # H100's 227 KiB of shared memory
    (8, 8, 1030, "row_block"),
    (4, 8, 64, "grouped"),
    (12, 8, 40, "row_block"),
    (16, 16, 130, "row_block"),
    (128, 128, 64, "row_block"),
    (8, 4, 64, "row_block"),
])
def test_fused_route(bm, bk, f, expected):
    """The route the fused C entry point chooses, read from the counters,
    and its output against the plain version."""
    dev = _card()
    ell = _ell(4 * bm, 4 * bk, 0.1, bm, bk, np.float32, seed=f)
    gen = torch.Generator().manual_seed(8)
    h = torch.randn((4 * bk, f), generator=gen)
    w = torch.randn((f, 24), generator=gen) * f ** -0.5
    b = 0.1 * torch.randn((24,), generator=gen)
    args = [torch.from_numpy(x) for x in (ell.blocks, ell.col_tile,
                                          ell.n_tiles)]
    plain = kmod.fused_gcn_layer_plain(*args, h, w, b, bm=bm, bk=bk)
    before = kmod.FUSED_ROUTE_LAUNCHES[expected]
    out = kmod.fused_gcn_layer_cuda(*[x.to(dev) for x in args + [h, w, b]],
                                    bm=bm, bk=bk)
    torch.cuda.synchronize()
    assert kmod.FUSED_ROUTE_LAUNCHES[expected] == before + 1
    np.testing.assert_allclose(out.cpu().numpy(), plain.numpy(), atol=1e-4)


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
    # Groups of 8 row blocks: exactly two groups, one group and one row
    # block more, the last group cut to 5; F_out past one 256-column pass.
    (128, 128, 256, 64, 0.05, 8, 8),
    (72, 72, 64, 64, 0.1, 8, 8),
    (104, 90, 256, 300, 0.05, 8, 8),
    (200, 200, 257, 99, 0.03, 8, 8),
    (100, 96, 64, 48, 0.1, 4, 8),
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
    route = "grouped" if bm <= 8 and bk == 8 and f < 1000 else "row_block"
    before = kmod.FUSED_LAUNCHES, kmod.FUSED_ROUTE_LAUNCHES[route]
    out = kmod.fused_gcn_layer_cuda(*[x.to(dev) for x in args + [h, w, b]],
                                    bm=bm, bk=bk)
    torch.cuda.synchronize()
    assert (kmod.FUSED_LAUNCHES, kmod.FUSED_ROUTE_LAUNCHES[route]) == (
        before[0] + 1, before[1] + 1)
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


def _scheduler_case():
    from repro_torch.core import FeatureSpec, required_bytes
    from repro_torch.data import (
        SUITESPARSE_SPECS, generate_graph, normalized_adjacency, scaled_spec,
    )
    a = normalized_adjacency(generate_graph(
        scaled_spec(SUITESPARSE_SPECS["socLJ1"], 1e-4), seed=0))
    h = np.random.default_rng(0).standard_normal(
        (a.n_rows, 32)).astype(np.float32)
    rows = np.repeat(np.arange(a.n_rows), np.diff(a.indptr))
    dense = np.zeros(a.shape, np.float64)
    np.add.at(dense, (rows, a.indices), a.data.astype(np.float64))
    # Above every baseline's Table III floor (the reference's choice).
    budget = int(1.1 * required_bytes(a, FeatureSpec.of(h)))
    return a, h, dense @ h.astype(np.float64), budget


def _close_to_f64(x, ref64, tol=1e-4):
    """max |x - ref| over the reference's largest magnitude: f32 sums in
    another order than float64's."""
    x = x.detach().cpu().double().numpy()
    assert x.shape == ref64.shape and np.isfinite(x).all()
    assert np.abs(x - ref64).max() <= tol * np.abs(ref64).max()


def test_aires_scheduler_executes_on_card_through_the_spmm():
    """AIRES's execute plan on the card: one zero-skipping SpMM launch per
    segment, the output on the card against float64, the metrics equal to
    a cost interpretation of the same plan."""
    dev = _card()
    from repro_torch.core import CostInterpreter, SCHEDULERS
    from repro_torch.io import PAPER_GPU_SYSTEM

    from repro_torch.core import plan_memory_dense_features

    a, h, ref64, _ = _scheduler_case()
    # Streams 4 segments at width 32 (1.1 x the requirement streams one).
    est = plan_memory_dense_features(a, a.n_rows, 32, float("inf"))
    budget = int(est.m_b + est.m_c + 0.3 * a.nbytes())
    sched = SCHEDULERS["aires"](PAPER_GPU_SYSTEM, device_budget=budget,
                                bm=8, bk=8, wire_format="bricks")
    before = kmod.LAUNCHES, kmod.SPMM_ROUTE_LAUNCHES["zero_skip"]
    res = sched.run(a, h, mode="execute")
    torch.cuda.synchronize()
    segs = res.metrics.segments
    assert segs >= 2 and res.x.device.type == dev.type
    assert (kmod.LAUNCHES - before[0],
            kmod.SPMM_ROUTE_LAUNCHES["zero_skip"] - before[1]) == (segs, segs)
    _close_to_f64(res.x, ref64)
    m, _ = CostInterpreter(PAPER_GPU_SYSTEM).run(
        sched.build_plan(a, h, mode="simulate"))
    for field in ("makespan_s", "bytes_by_path", "segments", "oom"):
        assert getattr(m, field) == getattr(res.metrics, field), field


@pytest.mark.parametrize("name", ["maxmemory", "ucg", "etc"])
def test_baseline_schedulers_execute_on_card(name):
    dev = _card()
    from repro_torch.core import SCHEDULERS
    from repro_torch.io import PAPER_GPU_SYSTEM

    a, h, ref64, budget = _scheduler_case()
    res = SCHEDULERS[name](PAPER_GPU_SYSTEM, device_budget=budget).run(
        a, h, mode="execute")
    assert not res.metrics.oom and res.x.device.type == dev.type
    _close_to_f64(res.x, ref64)


def test_coalesced_stream_on_card_matches_plain_stream():
    """A coalesced stream uploads every brick in one issue and computes
    what the plain stream computes, within the SpMM's limit (its long row
    blocks add slots with f32 atomics, so the order of sums may differ)."""
    _card()
    from repro_torch.core import (
        AiresConfig, AiresSpGEMM, PassPipeline, TransferCoalescingPass,
        plan_memory_dense_features,
    )

    a, h, ref64, _ = _scheduler_case()
    est = plan_memory_dense_features(a, a.n_rows, 32, float("inf"))
    budget = int(est.m_b + est.m_c + 0.3 * a.nbytes())
    cfg = AiresConfig(device_budget_bytes=budget, bm=8, bk=8)
    plain = AiresSpGEMM(cfg)
    co = AiresSpGEMM(cfg, plan_passes=PassPipeline(
        [TransferCoalescingPass(min_bytes=1 << 40)]))
    x0 = plain(a, torch.from_numpy(h))
    before = kmod.LAUNCHES
    x1 = co(a, torch.from_numpy(h))
    torch.cuda.synchronize()
    s0, s1 = plain.last_stream_stats, co.last_stream_stats
    assert s0.segments >= 2 and s1.segments == 1
    assert kmod.LAUNCHES - before == s0.segments
    assert s1.uploaded_bytes == s0.uploaded_bytes
    assert (x1 - x0).abs().max().item() <= 1e-4 * x0.abs().max().item()
    _close_to_f64(x1, ref64)


def test_serve_gcn_with_passes_on_card_matches_cpu():
    """The launcher with the three rewrite passes runs on the card: the
    same bytes per epoch as on the CPU, one SpMM launch per segment
    streamed, outputs within the launcher test's limit."""
    _card()
    from repro_torch.launch.serve import serve_gcn

    before = kmod.LAUNCHES
    gpu = serve_gcn(scale=1e-4, passes=True)
    torch.cuda.synchronize()
    assert kmod.LAUNCHES - before == sum(r.segments_streamed for r in gpu)
    cpu = serve_gcn(scale=1e-4, passes=True, device="cpu")
    for g, c in zip(gpu, cpu):
        assert ((g.uploaded_bytes, g.cache_hit_bytes, g.segments_streamed)
                == (c.uploaded_bytes, c.cache_hit_bytes, c.segments_streamed))
        for gr, cr in zip(g.results, c.results):
            np.testing.assert_allclose(gr.output, cr.output, atol=1e-4,
                                       rtol=1e-5)


def test_sharded_workers_on_card_match_cpu():
    """`serve_gcn` with two workers over four-shard caches, a shared
    directory, the passes and calibration on the card: the CPU's bytes per
    epoch and worker (peer serves, ICI and skipped demotions among them),
    one SpMM launch per segment streamed, outputs as on the CPU, and a
    fitted calibrator."""
    _card()
    from repro_torch.launch.serve import serve_gcn

    kw = dict(scale=1e-4, workers=2, cache_shards=4, calibrate=True,
              passes=True)
    before = kmod.LAUNCHES
    summary = {}
    gpu = serve_gcn(summary_out=summary, **kw)
    torch.cuda.synchronize()
    assert kmod.LAUNCHES - before == sum(r.segments_streamed
                                         for epoch in gpu for r in epoch)
    cpu = serve_gcn(device="cpu", **kw)
    fields = ("uploaded_bytes", "cache_hit_bytes", "promoted_bytes",
              "segments_streamed", "ici_bytes", "directory_hit_bytes",
              "duplicate_avoided_bytes")
    for g_epoch, c_epoch in zip(gpu, cpu):
        for g, c in zip(g_epoch, c_epoch):
            assert ([getattr(g, f) for f in fields]
                    == [getattr(c, f) for f in fields])
            for gr, cr in zip(g.results, c.results):
                np.testing.assert_allclose(gr.output, cr.output, atol=1e-4,
                                           rtol=1e-5)
    assert sum(r.directory_hit_bytes for r in gpu[0]) > 0
    assert len(summary["epoch_errors"]) == 2


def test_warm_start_and_evict_on_card(tmp_path):
    """Bricks checkpointed by a CPU engine warm-start a card engine: its
    first epoch uploads nothing and serves the CPU's outputs; evicting the
    graph then leaves no key behind and frees the device tier's bytes."""
    import gc

    dev = _card()
    from repro_torch.core import AiresSpGEMM, plan_memory_dense_features
    from repro_torch.data import (
        SUITESPARSE_SPECS, generate_graph, normalized_adjacency, scaled_spec,
    )
    from repro_torch.io import prefix_matches
    from repro_torch.runtime import (
        EngineConfig, InferenceRequest, ServingEngine,
    )

    a = normalized_adjacency(generate_graph(
        scaled_spec(SUITESPARSE_SPECS["socLJ1"], 1e-4), seed=0))
    est = plan_memory_dense_features(a, a.n_rows, 64, float("inf"))
    budget = int(est.m_b + est.m_c + 0.6 * a.nbytes())
    rng = np.random.default_rng(3)
    h = rng.standard_normal((a.n_rows, 32)).astype(np.float32)
    ws = [rng.standard_normal((32, 16)).astype(np.float32)]
    engines = {}
    for device in ("cpu", "cuda"):
        engines[device] = ServingEngine(EngineConfig(
            device_budget_bytes=budget, cache_shards=4, device=device))
        engines[device].register_graph("g", a)
    donor, card = engines["cpu"], engines["cuda"]
    donor.submit(InferenceRequest("g", h, ws))
    cold = donor.run_batch()
    donor.checkpoint_cache(str(tmp_path))
    report = card.warm_start(str(tmp_path))
    assert report.wire_bytes == cold.uploaded_bytes > 0
    card.submit(InferenceRequest("g", h, ws))
    first = card.run_batch()
    assert first.uploaded_bytes == 0
    assert first.cache_hit_bytes == cold.uploaded_bytes
    np.testing.assert_allclose(first.results[0].output,
                               cold.results[0].output, atol=1e-4, rtol=1e-5)
    device_bytes = card.cache.device_used_bytes
    gc.collect()
    torch.cuda.synchronize(dev)
    allocated = torch.cuda.memory_allocated(dev)
    card.submit(InferenceRequest("g", h, ws))
    assert len(card.evict_graph("g")) == 1
    gc.collect()
    torch.cuda.synchronize(dev)
    prefix = AiresSpGEMM.graph_cache_prefix(a)
    assert not any(prefix_matches(str(k.graph_id), prefix)
                   for k, _, _ in card.cache.export_entries())
    assert allocated - torch.cuda.memory_allocated(dev) >= device_bytes


@pytest.mark.parametrize("ell_w", [42, 49, 341, 467])
def test_kernel_at_explicit_bucket_widths(ell_w):
    """The autotuner's bucket widths (rUSA's 42 and 49, socLJ1's 341 and
    467 at the smoke run's serving shape): not powers of two, and past 64
    the second kernel's ell_w - 64 slots are not a multiple of 16. Row
    blocks hold ell_w, fewer and no valid slots, padding slots -1 past
    n_tiles; against the plain version and float64."""
    rng = np.random.default_rng(ell_w)
    m = 8 * ell_w
    fill = [ell_w, ell_w - 1, ell_w // 2, 0, 1, ell_w - 17, ell_w, 3]
    dense = np.zeros((8 * len(fill), m))
    for rb, k in enumerate(fill):
        tiles = rng.choice(ell_w, size=max(k, 0), replace=False)
        for t in tiles:
            dense[8 * rb + rng.integers(0, 8), 8 * t + rng.integers(0, 8)] = (
                rng.standard_normal())
    ell = tile_csr_to_block_ell(csr_from_dense(dense.astype(np.float32)),
                                bm=8, bk=8, ell_width=ell_w)
    assert ell.blocks.shape[1] == ell_w
    assert ell.n_tiles.tolist() == [max(k, 0) for k in fill]
    args = [torch.from_numpy(x) for x in (ell.blocks, ell.col_tile,
                                          ell.n_tiles)]
    h = torch.randn((m, 1024), generator=torch.Generator().manual_seed(7))
    plain = kmod.bcsr_spmm_plain(*args, h, bm=8, bk=8)
    out = _spmm_on_card(args, h, 8, 8, "zero_skip")
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=1e-4)
    np.testing.assert_allclose(out.numpy(), dense @ h.double().numpy(),
                               atol=1e-4)


def _slice_graphs():
    from repro_torch.core import plan_memory_dense_features
    from repro_torch.data import (
        SUITESPARSE_SPECS, generate_graph, normalized_adjacency, scaled_spec,
    )
    a = normalized_adjacency(generate_graph(
        scaled_spec(SUITESPARSE_SPECS["socLJ1"], 1e-4), seed=0))
    est = plan_memory_dense_features(a, a.n_rows, 64, float("inf"))
    return a, int(est.m_b + est.m_c + 0.3 * a.nbytes())


def test_autotuned_serving_on_card_matches_cpu():
    """`serve_gcn(autotune=True)`: the same installed schedules and bytes
    per epoch as on the CPU, one launch per segment, the CPU's outputs."""
    _card()
    from repro_torch.launch.serve import serve_gcn

    before = kmod.LAUNCHES
    summaries = {"cuda": {}, "cpu": {}}
    gpu = serve_gcn(autotune=True, summary_out=summaries["cuda"])
    torch.cuda.synchronize()
    assert kmod.LAUNCHES - before == sum(r.segments_streamed for r in gpu)
    cpu = serve_gcn(autotune=True, summary_out=summaries["cpu"],
                    device="cpu")
    assert summaries["cuda"] == summaries["cpu"]
    assert summaries["cpu"]["installed_schedules"]
    for g, c in zip(gpu, cpu):
        assert (g.uploaded_bytes, g.cache_hit_bytes) == (
            c.uploaded_bytes, c.cache_hit_bytes)
        for gr, cr in zip(g.results, c.results):
            np.testing.assert_allclose(gr.output, cr.output, atol=1e-4,
                                       rtol=1e-5)


@pytest.mark.parametrize("shards,clusters", [(1, 0), (4, 8)])
def test_update_graph_on_card_matches_cpu(shards, clusters):
    """An edge delta on a card engine, unpartitioned and on a partitioned
    four-shard cache: the CPU engine's report and bytes per epoch, and
    its outputs on the updated graph."""
    _card()
    from repro_torch.runtime import (
        EngineConfig, InferenceRequest, ServingEngine,
    )

    a, budget = _slice_graphs()
    rng = np.random.default_rng(4)
    h = rng.standard_normal((a.n_rows, 32)).astype(np.float32)
    ws = [rng.standard_normal((32, 16)).astype(np.float32)]
    engines = {}
    for device in ("cuda", "cpu"):
        engines[device] = ServingEngine(EngineConfig(
            device_budget_bytes=budget, cache_shards=shards,
            partition_shards=clusters, device=device))
        engines[device].register_graph("g", a)
    reports = {}
    for device, eng in engines.items():
        reps = []
        eng.submit(InferenceRequest("g", h, ws))
        reps.append(eng.run_batch())
        update = eng.update_graph("g", inserts=[(5, 100, 0.5), (7, 3, 1.0)],
                                  deletes=[(0, 0)])
        for _ in range(2):
            eng.submit(InferenceRequest("g", h, ws))
            reps.append(eng.run_batch())
        reports[device] = (update, reps)
    (g_up, g_reps), (c_up, c_reps) = reports["cuda"], reports["cpu"]
    fields = ("plans_updated", "segments_retiled", "segments_reused",
              "retiled_bytes", "stale_keys", "cache_entries_dropped")
    assert ([getattr(g_up, f) for f in fields]
            == [getattr(c_up, f) for f in fields])
    assert g_reps[1].uploaded_bytes == g_up.retiled_bytes
    for g, c in zip(g_reps, c_reps):
        assert (g.uploaded_bytes, g.cache_hit_bytes, g.ici_bytes) == (
            c.uploaded_bytes, c.cache_hit_bytes, c.ici_bytes)
        np.testing.assert_allclose(g.results[0].output, c.results[0].output,
                                   atol=1e-4, rtol=1e-5)


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


# ---------------------------------------------------------------------------
# Attention kernels and the dense LM
# ---------------------------------------------------------------------------

# (rtol, atol) per element. Both sides compute in f32, summed in another
# order (a gap near 1e-6), then round once to the output type: to the same
# value or to neighbours one ulp apart, at most 2^-10·|x| in f16 and
# 2^-7·|x| in bf16. atol takes the f32 gap.
ATTN_TOL = {torch.float32: (0.0, 4e-6), torch.float16: (2.0 ** -10, 4e-6),
            torch.bfloat16: (2.0 ** -7, 4e-6)}


def _attn_inputs(shape, dtype, dev, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(device=dev, dtype=dtype)
            for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("b,h,s,d,causal,window", [
    (1, 2, 64, 16, True, 0),
    (2, 3, 130, 64, True, 0),       # ragged S
    (1, 2, 200, 128, True, 33),     # sliding window
    (1, 1, 77, 100, False, 0),      # d a multiple of no tile
    (2, 2, 65, 8, False, 9),
    (1, 4, 1, 128, True, 0),
    # The edges of the 64-row query and key tiles of the 16-bit kernel.
    (1, 4, 63, 128, True, 0),
    (1, 4, 64, 128, True, 0),
    (1, 4, 65, 128, True, 0),
    (1, 4, 129, 128, True, 0),
    (1, 2, 300, 128, True, 100),    # a window whose edge crosses tiles
    (2, 2, 129, 64, False, 70),
])
def test_flash_kernel_matches_plain_version(b, h, s, d, causal, window,
                                            dtype):
    dev = _card()
    from repro_torch.kernels import flash_attn as fmod
    q, k, v = _attn_inputs((b, h, s, d), dtype, dev, seed=s * d)
    plain = fmod.flash_attention_plain(q, k, v, causal=causal, window=window)
    route = fmod.ROUTES[dtype]
    before = fmod.FLASH_LAUNCHES, fmod.FLASH_ROUTE_LAUNCHES[route]
    out = fmod.flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (fmod.FLASH_LAUNCHES, fmod.FLASH_ROUTE_LAUNCHES[route]) == (
        before[0] + 1, before[1] + 1)
    assert out.dtype == dtype and out.shape == q.shape
    rtol, atol = ATTN_TOL[dtype]
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               plain.float().cpu().numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("b,n_kv,group,s,d,lens", [
    (4, 4, 8, 161, 128, None),     # serve's cache at Yi-6B width
    (3, 2, 4, 1000, 64, None),
    (2, 3, 1, 37, 16, None),       # MHA
    (2, 1, 16, 5000, 72, None),    # the largest group; several splits
    (1, 2, 8, 1, 128, None),
    # lens one below, at and one above the edges of 64-position tiles (the
    # 16-bit kernel's ring stages), groups of 1, 5 and 16.
    (3, 4, 1, 257, 128, (127, 128, 129)),
    (2, 2, 5, 300, 128, (64, 65)),
    (2, 1, 16, 200, 128, (63, 129)),
    # 64 (b, kv head) pairs on an H100 give splits of three tiles: lens at
    # the splits' edges and the cache's end.
    (8, 8, 8, 4096, 128, (191, 192, 193, 4095, 4096, 63, 64, 65)),
], ids=lambda x: "lens" + "_".join(map(str, x)) if isinstance(x, tuple)
    else None)
def test_decode_kernel_matches_plain_version(b, n_kv, group, s, d, lens,
                                             dtype):
    dev = _card()
    from repro_torch.kernels import decode_attn as dmod
    gen = torch.Generator().manual_seed(s + d)
    q = torch.randn((b, n_kv, group, d), generator=gen).to(dev, dtype)
    k, v = (torch.randn((b, n_kv, s, d), generator=gen).to(dev, dtype)
            for _ in range(2))
    if lens is None:                 # drawn; the first s, the second 1
        lens = torch.randint(1, s + 1, (b,), generator=gen,
                             dtype=torch.int32)
        lens[0] = s
        if b > 1:
            lens[1] = 1
        if b > 2:
            lens[2] = 0              # an empty sequence gives 0
    else:
        lens = torch.tensor(lens, dtype=torch.int32)
    lens = lens.to(dev)
    plain = dmod.decode_attention_plain(q, k, v, lens)
    route = dmod.ROUTES[dtype]
    before = dmod.DECODE_LAUNCHES, dmod.DECODE_ROUTE_LAUNCHES[route]
    out = dmod.decode_attention_cuda(q, k, v, lens)
    torch.cuda.synchronize()
    assert (dmod.DECODE_LAUNCHES, dmod.DECODE_ROUTE_LAUNCHES[route]) == (
        before[0] + 1, before[1] + 1)
    assert out.dtype == dtype and out.shape == q.shape
    rtol, atol = ATTN_TOL[dtype]
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               plain.float().cpu().numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("b,n_kv,group,s,d,lens", [
    (2, 4, 8, 64, 128, (8, 64)),          # hints_check's, whole head dims
    (8, 4, 8, 4096, 8, None),             # a production slice, d' = 8
    (2, 1, 16, 129, 256, (0, 65)),        # group 16, d' = 256, lens 0
    (3, 2, 5, 300, 32, (63, 64, 65)),     # lens at a P tile's edges
])
def test_decode_hd_kernels_match_plain_versions(b, n_kv, group, s, d, lens,
                                                dtype):
    """The decode over a slice of the head dim (`decode_scores`, then
    `decode_softmax_v` with and without a softcap) against the plain
    versions, one launch each counted."""
    _card()
    from repro_torch.kernels import decode_attn as p_dec
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(s + d + 1)
    q = torch.randn((b, n_kv, group, d), generator=gen).to("cuda", dt)
    k, v = (torch.randn((b, n_kv, s, d), generator=gen).to("cuda", dt)
            for _ in range(2))
    lens = (torch.randint(1, s + 1, (b,), generator=gen, dtype=torch.int32)
            if lens is None else torch.tensor(lens, dtype=torch.int32))
    lens = lens.cuda()
    before = dict(p_dec.DECODE_HD_LAUNCHES)
    s_plain = p_dec.decode_scores_plain(q, k, lens)
    s_got = p_dec.decode_scores(q, k, lens)
    torch.testing.assert_close(s_got, s_plain, rtol=1e-5, atol=1e-4)
    for cap in (None, 30.0):
        got = p_dec.decode_softmax_v(s_plain, v, lens, 0.05, cap)
        want = p_dec.decode_softmax_v_plain(s_plain, v, lens, 0.05, cap)
        rtol = {"float32": 0.0, "float16": 2.0 ** -10,
                "bfloat16": 2.0 ** -7}[dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=4e-6)
    assert p_dec.DECODE_HD_LAUNCHES == {
        "decode_scores": before["decode_scores"] + 1,
        "decode_softmax_v": before["decode_softmax_v"] + 2}


def test_attention_kernels_refuse_grad_and_cpu_tensors():
    """The decode kernel, which only serves, still refuses a graph; the
    flash kernel now takes one: its gradient flows through the backward
    kernel and matches the plain backward (the name is kept from when both
    refused). Both refuse CPU and non-contiguous tensors."""
    dev = _card()
    from repro_torch.kernels import decode_attn as dmod
    from repro_torch.kernels import flash_attn as fmod
    q, k, v = _attn_inputs((1, 2, 16, 32), torch.float32, dev, seed=0)
    lens = torch.full((1,), 16, dtype=torch.int32, device=dev)
    qg = q[:, :, :1].contiguous()
    live = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = fmod.FLASH_LAUNCHES, fmod.FLASH_BWD_LAUNCHES
    out = fmod.flash_attention_cuda(*live)
    dout = torch.randn(out.shape, dtype=out.dtype, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0))
    out.backward(dout)
    torch.cuda.synchronize()
    assert (fmod.FLASH_LAUNCHES, fmod.FLASH_BWD_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    out_p, lse_p = fmod.flash_attention_plain_lse(q, k, v)
    _bwd_close([t.grad for t in live],
               fmod.flash_attention_bwd_plain(q, k, v, out_p, dout, lse_p))
    with pytest.raises(RuntimeError, match="no backward"):
        dmod.decode_attention_cuda(qg.requires_grad_(True), k, v, lens)
    with torch.no_grad():               # no graph recorded: allowed
        fmod.flash_attention_cuda(q, k, v)
    cpu = [t.detach().cpu() for t in (q, k, v)]
    with pytest.raises(ValueError, match="CUDA"):
        fmod.flash_attention_cuda(*cpu)
    with pytest.raises(ValueError, match="CUDA"):
        dmod.decode_attention_cuda(qg.detach().cpu(), cpu[1], cpu[2],
                                   lens.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        fmod.flash_attention_cuda(q.detach().transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("b,h,s,d,causal,window,softcap", [
    (1, 2, 200, 128, True, 33, 50.0),   # Gemma-2's cap, a window
    (2, 3, 130, 64, True, 0, 1.0),      # a cap that bites, ragged S
    (1, 4, 129, 128, True, 0, 50.0),    # the 16-bit kernel's tile edge
    (1, 2, 300, 128, True, 100, 1.0),   # a window whose edge crosses tiles
    (2, 2, 77, 100, False, 0, 50.0),    # d a multiple of no tile
])
def test_flash_kernel_softcap_matches_plain_version(b, h, s, d, causal,
                                                    window, softcap, dtype):
    """The softcapped flash kernel (both routes) against its plain version,
    per element within ATTN_TOL, and its lse against the plain forward's;
    each launch counted once on its route and once with a softcap."""
    dev = _card()
    from repro_torch.kernels import flash_attn as fmod
    q, k, v = _attn_inputs((b, h, s, d), dtype, dev, seed=s * d + 3)
    kw = dict(causal=causal, window=window, softcap=softcap)
    plain, lse_p = fmod.flash_attention_plain_lse(q, k, v, **kw)
    route = fmod.ROUTES[dtype]
    before = (fmod.FLASH_LAUNCHES, fmod.FLASH_ROUTE_LAUNCHES[route],
              fmod.FLASH_SOFTCAP_LAUNCHES)
    out = fmod.flash_attention_cuda(q, k, v, **kw)
    with torch.no_grad():
        out2, lse = fmod.flash_attention_lse_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (fmod.FLASH_LAUNCHES, fmod.FLASH_ROUTE_LAUNCHES[route],
            fmod.FLASH_SOFTCAP_LAUNCHES) == tuple(n + 2 for n in before)
    assert torch.equal(out, out2)
    rtol, atol = ATTN_TOL[dtype]
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               plain.float().cpu().numpy(), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_p.cpu().numpy(),
                               rtol=1e-6, atol=1e-6)
    if softcap == 1.0:                   # the cap bites: not the plain attn
        uncapped = fmod.flash_attention_plain(q, k, v, causal=causal,
                                              window=window)
        assert float((out.float() - uncapped.float()).abs().max()) > 0.05


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("b,n_kv,group,s,d,lens,softcap", [
    (4, 16, 2, 161, 128, None, 50.0),       # gemma_serve's cache
    # A ring of 4096 slots before its wrap (lens below the cache) and
    # after it (lens = the ring), Gemma-2's cap.
    (2, 4, 8, 4096, 128, (4096, 3000), 50.0),
    (3, 2, 4, 1000, 64, (1000, 17, 999), 1.0),
    (2, 1, 16, 300, 72, (64, 65), 1.0),
], ids=lambda x: "lens" + "_".join(map(str, x)) if isinstance(x, tuple)
    else None)
def test_decode_kernel_softcap_matches_plain_version(b, n_kv, group, s, d,
                                                     lens, softcap, dtype):
    """The softcapped decode kernels (both routes) against their plain
    version, per element within ATTN_TOL, with ring-style lens shorter than
    the cache; each launch counted once on its route and with a softcap."""
    dev = _card()
    from repro_torch.kernels import decode_attn as dmod
    gen = torch.Generator().manual_seed(s + d + 1)
    q = torch.randn((b, n_kv, group, d), generator=gen).to(dev, dtype)
    k, v = (torch.randn((b, n_kv, s, d), generator=gen).to(dev, dtype)
            for _ in range(2))
    if lens is None:                 # drawn; the first s
        lens = torch.randint(1, s + 1, (b,), generator=gen,
                             dtype=torch.int32)
        lens[0] = s
    else:
        lens = torch.tensor(lens, dtype=torch.int32)
    lens = lens.to(dev)
    plain = dmod.decode_attention_plain(q, k, v, lens, softcap)
    route = dmod.ROUTES[dtype]
    before = (dmod.DECODE_LAUNCHES, dmod.DECODE_ROUTE_LAUNCHES[route],
              dmod.DECODE_SOFTCAP_LAUNCHES)
    out = dmod.decode_attention_cuda(q, k, v, lens, softcap)
    torch.cuda.synchronize()
    assert (dmod.DECODE_LAUNCHES, dmod.DECODE_ROUTE_LAUNCHES[route],
            dmod.DECODE_SOFTCAP_LAUNCHES) == tuple(n + 1 for n in before)
    assert out.dtype == dtype and out.shape == q.shape
    rtol, atol = ATTN_TOL[dtype]
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               plain.float().cpu().numpy(), rtol=rtol,
                               atol=atol)
    if softcap == 1.0:                   # the cap bites: not the plain attn
        uncapped = dmod.decode_attention_plain(q, k, v, lens)
        assert float((out.float() - uncapped.float()).abs().max()) > 0.05


def test_softcapped_flash_under_autograd_raises_on_card():
    """The softcap under autograd on the card (the name is kept from when
    this raised, before the softcap had a backward): the forward kernel
    writes lse over the capped scores, the backward kernel takes the same
    cap, each counted once with it, and the gradients match the plain
    softcapped backward's from the kernel forward's out and lse. dO is
    drawn from a seeded generator on the card."""
    dev = _card()
    from repro_torch.kernels import flash_attn as fmod
    from repro_torch.kernels import ops
    q, k, v = _attn_inputs((1, 2, 64, 64), torch.bfloat16, dev, seed=5)
    live = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (fmod.FLASH_LAUNCHES, fmod.FLASH_SOFTCAP_LAUNCHES,
              fmod.FLASH_BWD_LAUNCHES, fmod.FLASH_BWD_SOFTCAP_LAUNCHES)
    out = ops.flash_attention(*live, softcap=1.0)
    dout = torch.randn(out.shape, dtype=out.dtype, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0))
    out.backward(dout)
    torch.cuda.synchronize()
    assert (fmod.FLASH_LAUNCHES, fmod.FLASH_SOFTCAP_LAUNCHES,
            fmod.FLASH_BWD_LAUNCHES, fmod.FLASH_BWD_SOFTCAP_LAUNCHES) == \
        tuple(n + 1 for n in before)
    # The backward kernel is held to the plain backward on its own inputs:
    # the kernel forward's out and lse, which the backward kernel read. The
    # plain forward's bf16 out lies an ulp from the kernel's in places, and
    # D = sum(dO * O) carries that into dQ past BWD_TOL's model of one
    # rounding (34 of 256 seeded draws, scripts/softcap_bwd_sweep.py).
    with torch.no_grad():
        out_k, lse_k = fmod.flash_attention_lse_cuda(q, k, v, softcap=1.0)
    assert torch.equal(out_k, out.detach())
    _bwd_close([t.grad for t in live], fmod.flash_attention_bwd_plain(
        q, k, v, out_k, dout, lse_k, softcap=1.0))
    out_u, lse_u = fmod.flash_attention_plain_lse(q, k, v)
    uncapped = fmod.flash_attention_bwd_plain(q, k, v, out_u, dout, lse_u)
    assert float((live[0].grad.float() - uncapped[0].float()).abs().max()) \
        > 1e-3                           # the cap changes the gradient
    for bad in (-1.0, float("inf")):
        with pytest.raises(ValueError, match="softcap"):
            fmod.flash_attention_bwd_cuda(q, k, v, out.detach(), dout,
                                          lse_k, True, 0, softcap=bad)


# The backward kernel against its plain version, per element:
# |kernel - plain| <= rtol·|plain| + atol·M, M the largest |plain| over dQ,
# dK and dV. Both sum f32 products in other orders; dK and dQ sum up to S
# terms of dS = P (dO·v - D), whose two parts cancel (to exactly 0 at S =
# 1), so the gap scales with the size of the terms, which M measures, not
# with each element (atol, the f32 gap relative to M); then each rounds
# once to the output type, one ulp apart at most (rtol).
BWD_TOL = {torch.float32: (0.0, 2e-5), torch.float16: (2.0 ** -10, 2e-5),
           torch.bfloat16: (2.0 ** -7, 2e-5)}


def _bwd_close(got, want):
    """Each of dQ, dK, dV within BWD_TOL of the plain version's."""
    scale = max(float(w.float().abs().max()) for w in want)
    for g, w in zip(got, want):
        rtol, atol = BWD_TOL[w.dtype]
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), rtol=rtol,
                                   atol=atol * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("b,h,s,d,causal,window", [
    (1, 2, 32, 16, True, 0),
    # The edges of the f32 backward's 32-row key and query tiles.
    (1, 3, 31, 128, True, 0),
    (1, 3, 33, 128, True, 0),
    (2, 2, 63, 64, True, 0),
    (1, 2, 65, 128, True, 0),
    # ... and of the 16-bit backward's 64-row tiles.
    (1, 2, 64, 128, True, 0),
    (1, 2, 127, 128, True, 0),
    (1, 2, 128, 64, True, 0),
    (1, 2, 129, 100, True, 0),      # d a multiple of no tile
    (1, 2, 200, 128, True, 33),     # a window whose edge crosses tiles
    (2, 2, 77, 8, False, 0),
    (1, 2, 129, 64, False, 70),
    (1, 4, 1, 128, True, 0),
])
def test_flash_backward_kernel_matches_plain_version(b, h, s, d, causal,
                                                     window, dtype):
    """dQ, dK, dV from the backward kernel against
    `flash_attention_bwd_plain` on the same q, k, v, out, dout and lse (the
    forward kernel's), and lse against the plain forward's (f32 sums in
    other orders, within 1e-6); two launches give the same bits (no
    atomics)."""
    dev = _card()
    from repro_torch.kernels import flash_attn as fmod
    q, k, v = _attn_inputs((b, h, s, d), dtype, dev, seed=s * d + 1)
    dout = _attn_inputs((b, h, s, d), dtype, dev, seed=s * d + 2)[0]
    with torch.no_grad():
        out, lse = fmod.flash_attention_lse_cuda(q, k, v, causal=causal,
                                                 window=window)
        # Writing lse changes no bit of the output.
        assert torch.equal(out, fmod.flash_attention_cuda(
            q, k, v, causal=causal, window=window))
        _, lse_p = fmod.flash_attention_plain_lse(q, k, v, causal=causal,
                                                  window=window)
        route = fmod.BWD_ROUTES[dtype]
        before = fmod.FLASH_BWD_LAUNCHES, fmod.FLASH_BWD_ROUTE_LAUNCHES[route]
        got = fmod.flash_attention_bwd_cuda(q, k, v, out, dout, lse, causal,
                                            window)
        again = fmod.flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                              causal, window)
        want = fmod.flash_attention_bwd_plain(q, k, v, out, dout, lse,
                                              causal, window)
    torch.cuda.synchronize()
    assert (fmod.FLASH_BWD_LAUNCHES,
            fmod.FLASH_BWD_ROUTE_LAUNCHES[route]) == (before[0] + 2,
                                                      before[1] + 2)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_p.cpu().numpy(),
                               rtol=1e-6, atol=1e-6)
    for g, g2 in zip(got, again):
        assert torch.equal(g, g2)
    _bwd_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("softcap", [50.0, 1.0])
@pytest.mark.parametrize("b,h,s,d,causal,window", [
    (1, 3, 33, 128, True, 0),       # the f32 kernels' 32-row tile edge
    (1, 2, 63, 128, True, 0),       # the 16-bit kernels' 64-row tiles
    (1, 2, 65, 64, True, 0),
    (1, 2, 129, 100, True, 0),      # d a multiple of no tile
    (1, 2, 200, 128, True, 33),     # a window whose edge crosses tiles
    (1, 2, 129, 64, False, 70),
])
def test_flash_backward_kernel_softcap_matches_plain_version(
        b, h, s, d, causal, window, softcap, dtype):
    """The backward kernels with the attention softcap (both routes, the
    CAP instances) against the softcapped `flash_attention_bwd_plain` on
    the same q, k, v, out, dout and the forward kernel's softcapped lse,
    within BWD_TOL; two launches give the same bits; each launch counted
    on its route and with the softcap."""
    dev = _card()
    from repro_torch.kernels import flash_attn as fmod
    q, k, v = _attn_inputs((b, h, s, d), dtype, dev, seed=s * d + 7)
    dout = _attn_inputs((b, h, s, d), dtype, dev, seed=s * d + 8)[0]
    kw = dict(causal=causal, window=window, softcap=softcap)
    with torch.no_grad():
        out, lse = fmod.flash_attention_lse_cuda(q, k, v, **kw)
        _, lse_p = fmod.flash_attention_plain_lse(q, k, v, **kw)
        route = fmod.BWD_ROUTES[dtype]
        before = (fmod.FLASH_BWD_LAUNCHES,
                  fmod.FLASH_BWD_ROUTE_LAUNCHES[route],
                  fmod.FLASH_BWD_SOFTCAP_LAUNCHES)
        got = fmod.flash_attention_bwd_cuda(q, k, v, out, dout, lse, causal,
                                            window, softcap)
        again = fmod.flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                              causal, window, softcap)
        want = fmod.flash_attention_bwd_plain(q, k, v, out, dout, lse,
                                              causal, window, softcap)
    torch.cuda.synchronize()
    assert (fmod.FLASH_BWD_LAUNCHES, fmod.FLASH_BWD_ROUTE_LAUNCHES[route],
            fmod.FLASH_BWD_SOFTCAP_LAUNCHES) == tuple(n + 2 for n in before)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_p.cpu().numpy(),
                               rtol=1e-6, atol=1e-6)
    for g, g2 in zip(got, again):
        assert torch.equal(g, g2)
    _bwd_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_attention_kernels_take_kimi_head_dim_112(dtype):
    """Kimi K2's head dim 112 through both dispatches (padded to the next
    tile width, 128): the flash forward and backward and the decode kernel
    against their plain versions, each launch counted on its route."""
    dev = _card()
    from repro_torch.kernels import decode_attn as dmod
    from repro_torch.kernels import flash_attn as fmod
    q, k, v = _attn_inputs((2, 4, 150, 112), dtype, dev, seed=112)
    dout = _attn_inputs((2, 4, 150, 112), dtype, dev, seed=113)[0]
    rtol, atol = ATTN_TOL[dtype]
    with torch.no_grad():
        before = fmod.FLASH_ROUTE_LAUNCHES[fmod.ROUTES[dtype]]
        out, lse = fmod.flash_attention_lse_cuda(q, k, v)
        plain, lse_p = fmod.flash_attention_plain_lse(q, k, v)
        grads = fmod.flash_attention_bwd_cuda(q, k, v, out, dout, lse)
        want = fmod.flash_attention_bwd_plain(q, k, v, out, dout, lse)
        lens = torch.tensor([150, 65], dtype=torch.int32, device=dev)
        qd = q[:, :, :8].contiguous()          # 4 KV heads of 8 queries
        dec = dmod.decode_attention_cuda(qd, k, v, lens)
        dec_p = dmod.decode_attention_plain(qd, k, v, lens)
    torch.cuda.synchronize()
    assert fmod.FLASH_ROUTE_LAUNCHES[fmod.ROUTES[dtype]] == before + 1
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               plain.float().cpu().numpy(), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_p.cpu().numpy(),
                               rtol=1e-6, atol=1e-6)
    _bwd_close(grads, want)
    np.testing.assert_allclose(dec.float().cpu().numpy(),
                               dec_p.float().cpu().numpy(), rtol=rtol,
                               atol=atol)


def test_gemma2_gradients_on_card_match_cpu():
    """`lm_loss` gradients of Gemma-2's f32 smoke config (window 16, both
    softcaps) with remat on 40 tokens: the card (the softcapped flash, its
    recompute and the softcapped backward kernel, f32 FMA routes) against
    the CPU (plain versions), within 1e-5 of each tensor's largest |g|."""
    dev = _card()
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn as fmod
    from repro_torch.models import init_params, lm_loss
    from repro_torch.train.optim import tree_leaves, tree_map
    cfg = dataclasses.replace(get_config("gemma2_27b", smoke=True),
                              remat=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    labels = torch.roll(tokens, -1, 1)

    def grads(tree, device):
        live = tree_map(lambda t: t.to(device).requires_grad_(True), tree)
        loss = lm_loss(cfg, live, tokens.to(device), labels.to(device))
        return float(loss.detach()), torch.autograd.grad(loss,
                                                        tree_leaves(live))

    before = (fmod.FLASH_SOFTCAP_LAUNCHES, fmod.FLASH_BWD_SOFTCAP_LAUNCHES,
              fmod.FLASH_BWD_ROUTE_LAUNCHES["f32_fma"])
    loss_card, g_card = grads(params, dev)
    torch.cuda.synchronize()
    n = cfg.n_layers
    assert (fmod.FLASH_SOFTCAP_LAUNCHES, fmod.FLASH_BWD_SOFTCAP_LAUNCHES,
            fmod.FLASH_BWD_ROUTE_LAUNCHES["f32_fma"]) == (
        before[0] + 2 * n, before[1] + n, before[2] + n)
    loss_cpu, g_cpu = grads(params, "cpu")
    assert abs(loss_card - loss_cpu) <= 1e-5
    for a, b in zip(g_card, g_cpu):
        scale = float(b.abs().max())
        assert float((a.cpu() - b).abs().max()) <= 1e-5 * max(scale, 1e-30)


def test_moe_on_card_matches_cpu():
    """Mixtral's and Kimi K2's f32 smoke configs (every layer MOE, no
    window): `forward`'s logits and aux and a teacher-forced decode on the
    card against the CPU, past the smoke window of 16."""
    dev = _card()
    from repro_torch.configs import get_config
    from repro_torch.models import (
        decode_step, forward, init_decode_state, init_params,
    )
    from repro_torch.train.optim import tree_map
    for arch in ("mixtral_8x22b", "kimi_k2_1t_a32b"):
        cfg = get_config(arch, smoke=True)
        params = init_params(cfg, torch.Generator().manual_seed(2),
                             device="cpu")
        on_card = tree_map(lambda t: t.to(dev), params)
        tokens = torch.randint(0, cfg.vocab, (2, 24),
                               generator=torch.Generator().manual_seed(3))
        with torch.inference_mode():
            logits, aux = forward(cfg, on_card, tokens.to(dev))
            logits_c, aux_c = forward(cfg, params, tokens)
            np.testing.assert_allclose(logits.cpu().numpy(),
                                       logits_c.numpy(), atol=1e-4)
            assert abs(float(aux) - float(aux_c)) <= 1e-5
            st = init_decode_state(cfg, 2, 24, device=dev)
            st_c = init_decode_state(cfg, 2, 24, device="cpu")
            for t in range(24):
                a, st = decode_step(cfg, on_card, tokens[:, t:t + 1].to(dev),
                                    st)
                b, st_c = decode_step(cfg, params, tokens[:, t:t + 1], st_c)
                np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                           atol=1e-4)


def test_streamed_expert_blocks_on_card():
    """`StreamedWeightProvider` on the card: pinned bf16 banks stream in
    aligned blocks on the copy stream, each block bit for bit the host's,
    the uploaded bytes the banks' bytes; an unpinned bank is staged."""
    dev = _card()
    from repro_torch.io import ExpertBank, StreamedWeightProvider
    gen = torch.Generator().manual_seed(4)
    banks = []
    for layer in range(3):
        arrays = {"w_gate": torch.randn((40, 16, 8), generator=gen),
                  "w_up": torch.randn((40, 16, 8), generator=gen),
                  "w_down": torch.randn((40, 8, 16), generator=gen)}
        arrays = {k: a.bfloat16() for k, a in arrays.items()}
        if layer < 2:
            arrays = {k: a.pin_memory() for k, a in arrays.items()}
        banks.append(ExpertBank(layer=layer, arrays=arrays))
    per = banks[0].expert_bytes()
    provider = StreamedWeightProvider(banks, hbm_budget_bytes=per * 13,
                                      align=4, depth=2, device=dev)
    assert provider.block_size == 12
    for bank in banks:
        blocks = []
        for (s, e), arrays in provider.stream_layer(bank):
            blocks.append((s, e))
            for name, a in arrays.items():
                assert a.device.type == "cuda"
                assert torch.equal(a.cpu(), bank.arrays[name][s:e])
        assert blocks == [(0, 12), (12, 24), (24, 36), (36, 40)]
    torch.cuda.synchronize()
    assert provider.stats.uploaded_bytes == 3 * 40 * per
    assert provider.stats.segments == 12


def test_lm_gradients_on_card_match_cpu():
    """`lm_loss` gradients of an f32 GQA smoke model with remat: the card
    (flash forward, its recompute and the backward kernel) against the CPU
    (plain versions), and a `make_train_step` step with compression."""
    dev = _card()
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn as fmod
    from repro_torch.models import init_params, lm_loss
    from repro_torch.train import (
        TrainLoopConfig, ef_init, make_optimizer, make_train_step,
    )
    from repro_torch.train.optim import tree_leaves, tree_map
    cfg = dataclasses.replace(get_config("yi_6b", smoke=True).scaled_down(
        dtype="float32", n_heads=8, n_kv_heads=2), remat=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    on_card = tree_map(lambda t: t.to(dev), params)
    tokens = torch.randint(0, cfg.vocab, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    labels = torch.roll(tokens, -1, 1)

    def grads(p, device):
        live = tree_map(lambda t: t.detach().requires_grad_(True), p)
        loss = lm_loss(cfg, live, tokens.to(device), labels.to(device))
        return loss, torch.autograd.grad(loss, tree_leaves(live))

    before = fmod.FLASH_LAUNCHES, fmod.FLASH_BWD_LAUNCHES
    loss, g_card = grads(on_card, dev)
    torch.cuda.synchronize()
    assert (fmod.FLASH_LAUNCHES - before[0],
            fmod.FLASH_BWD_LAUNCHES - before[1]) == (2 * cfg.n_layers,
                                                     cfg.n_layers)
    loss_cpu, g_cpu = grads(params, "cpu")
    assert abs(float(loss) - float(loss_cpu)) < 1e-5
    for a, b in zip(g_card, g_cpu):
        scale = float(b.abs().max())
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * scale
    lc = TrainLoopConfig(grad_accum=2, compress=True)
    init, _ = make_optimizer(lc.optimizer, lr=lc.lr)
    batch = {"tokens": tokens.view(2, 1, 40), "labels": labels.view(2, 1, 40)}
    out = make_train_step(cfg, lc)(on_card, init(on_card), batch,
                                   ef_init(on_card))
    assert torch.isfinite(out[0]) and out[2]["step"] == 1
    assert all(t.device.type == "cuda" and torch.isfinite(t).all()
               for t in tree_leaves(out[1]) + tree_leaves(out[3]))


def test_lm_on_card_matches_cpu():
    """Forward, teacher-forced decode and serve of an f32 GQA smoke model:
    the card (kernels) against the CPU (plain versions)."""
    dev = _card()
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attn as dmod
    from repro_torch.kernels import flash_attn as fmod
    from repro_torch.launch.serve import serve
    from repro_torch.models import (
        decode_step, forward, init_decode_state, init_params,
    )
    cfg = get_config("yi_6b", smoke=True).scaled_down(
        dtype="float32", n_heads=8, n_kv_heads=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    on_card = {k: v for k, v in params.items() if k != "layers"}
    on_card = {k: v.to(dev) for k, v in on_card.items()}
    on_card["layers"] = [{k: ({kk: vv.to(dev) for kk, vv in v.items()}
                              if isinstance(v, dict) else v.to(dev))
                          for k, v in layer.items()}
                         for layer in params["layers"]]
    tokens = torch.randint(0, cfg.vocab, (2, 12),
                           generator=torch.Generator().manual_seed(1))
    flash0, dec0 = fmod.FLASH_LAUNCHES, dmod.DECODE_LAUNCHES
    with torch.inference_mode():
        ref, _ = forward(cfg, params, tokens)
        out, _ = forward(cfg, on_card, tokens.to(dev))
        state = init_decode_state(cfg, 2, 12, device=dev)
        steps = []
        for t in range(12):
            logits, state = decode_step(cfg, on_card,
                                        tokens[:, t:t + 1].to(dev), state)
            steps.append(logits[:, 0])
    assert fmod.FLASH_LAUNCHES - flash0 == cfg.n_layers
    assert dmod.DECODE_LAUNCHES - dec0 == 12 * cfg.n_layers
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), atol=1e-4)
    np.testing.assert_allclose(torch.stack(steps, 1).cpu().numpy(),
                               ref.numpy(), atol=1e-4)
    prompts = tokens[:, :6].numpy().astype(np.int32)
    np.testing.assert_array_equal(serve(cfg, on_card, prompts, steps=5),
                                  serve(cfg, params, prompts, steps=5))


def _loop_graphs():
    """The serving-loop tests' fixtures: socLJ1 1e-4 seed 0, rUSA 2e-5
    seed 1, with the launchers' budget rule."""
    from repro_torch.data import (
        SUITESPARSE_SPECS, generate_graph, normalized_adjacency, scaled_spec,
    )
    from repro_torch.launch.serve import _paper_budget
    graphs = {key: normalized_adjacency(generate_graph(
        scaled_spec(SUITESPARSE_SPECS[name], scale), seed=seed))
        for key, name, scale, seed in (("g", "socLJ1", 1e-4, 0),
                                       ("road", "rUSA", 2e-5, 1))}
    return graphs, _paper_budget(graphs)


def _drained_burst(device):
    """Eight requests of mixed widths over both graphs at t = 0, drained
    one group per step by a `ContinuousServer` on `device`: the steps."""
    from repro_torch.core import EDFOrderingPass
    from repro_torch.runtime import (
        ContinuousServer, EngineConfig, InferenceRequest, ServingEngine,
        VirtualClock,
    )
    graphs, budget = _loop_graphs()
    clock = VirtualClock()
    eng = ServingEngine(EngineConfig(
        device_budget_bytes=budget, clock=clock, device=device,
        plan_passes=[EDFOrderingPass(clock=clock)]))
    for name, a in graphs.items():
        eng.register_graph(name, a)
    server = ContinuousServer(eng)
    rng = np.random.default_rng(3)
    for i in range(8):
        name, f = ("g", "road")[i % 2], (16, 40, 32, 8)[i % 4]
        a = graphs[name]
        h = rng.standard_normal((a.n_rows, f)).astype(np.float32)
        w = rng.standard_normal((f, 8)).astype(np.float32)
        server.submit(InferenceRequest(name, h, [w],
                                       deadline_s=None if i % 3 else 1.0),
                      at=0.0)
    return server.drain()


@pytest.mark.parametrize("trace", ["poisson", "bursty"])
def test_continuous_replay_on_card_matches_cpu(trace):
    """`serve_continuous` on the card: the same event timeline, verdicts,
    summary and byte counters as with device="cpu" (the virtual timeline
    depends on modeled costs alone), one SpMM launch per segment
    streamed; then a drained burst's steps serve the same groups with
    outputs within 1e-5 of the CPU's."""
    _card()
    from repro_torch.launch.serve import serve_continuous

    before = kmod.LAUNCHES
    g_rep, g_sum = serve_continuous(trace=trace, device="cuda")
    torch.cuda.synchronize()
    assert kmod.LAUNCHES - before == g_rep.stats.segments_streamed > 0
    c_rep, c_sum = serve_continuous(trace=trace, device="cpu")
    assert g_sum == c_sum
    assert [dataclasses.astuple(e) for e in g_rep.events] == [
        dataclasses.astuple(e) for e in c_rep.events]
    assert [(v.request_id, v.reason) for v in g_rep.expired + g_rep.rejected
            ] == [(v.request_id, v.reason)
                  for v in c_rep.expired + c_rep.rejected]
    assert dataclasses.astuple(g_rep.stats) == dataclasses.astuple(
        c_rep.stats)
    g_steps, c_steps = _drained_burst("cuda"), _drained_burst("cpu")
    assert len(g_steps) == len(c_steps) >= 2
    for gs, cs in zip(g_steps, c_steps):
        assert (gs.graph, gs.started_s, gs.finished_s) == (
            cs.graph, cs.started_s, cs.finished_s)
        assert dataclasses.astuple(gs.stats) == dataclasses.astuple(
            cs.stats)
        for gr, cr in zip(gs.results, cs.results):
            assert gr.request_id == cr.request_id
            np.testing.assert_allclose(gr.output, cr.output, atol=1e-5,
                                       rtol=1e-5)


def test_importing_kernels_builds_nothing_until_first_launch():
    """In a fresh interpreter, the first launch of the exported
    `bcsr_spmm` builds the library. That the import alone builds nothing
    is held on the CPU by
    `tests/test_torch_exports.py::test_importing_kernels_builds_nothing`."""
    _card()
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    code = (
        "import dataclasses, sys\n"
        "import numpy as np, torch\n"
        "import repro_torch.kernels as k\n"
        "from repro_torch.sparse import csr_from_dense, "
        "tile_csr_to_block_ell\n"
        "b = sys.modules['repro_torch.kernels.build']\n"
        "d = np.eye(16, dtype=np.float32)\n"
        "ell = tile_csr_to_block_ell(csr_from_dense(d), bm=8, bk=8)\n"
        "ell = dataclasses.replace(ell, **{f: torch.as_tensor(getattr(ell, "
        "f)).cuda() for f in ('blocks', 'col_tile', 'n_tiles')})\n"
        "h = torch.ones(16, 4, device='cuda')\n"
        "x = k.bcsr_spmm(ell, h)\n"
        "torch.cuda.synchronize()\n"
        "assert b._lib is not None, 'no library after a launch'\n"
        "assert torch.equal(x.cpu(), torch.ones(16, 4))\n")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_gemma2_on_card_matches_cpu():
    """Gemma-2's f32 GQA smoke variant (window 16, both softcaps): forward
    on 48 tokens, teacher-forced decode over 40 into caches of 42 (the
    rings wrap twice; their slot_pos exact) and serve with prompts longer
    than the window, the card (softcapped kernels) against the CPU (plain
    versions)."""
    dev = _card()
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attn as dmod
    from repro_torch.kernels import flash_attn as fmod
    from repro_torch.launch.serve import serve
    from repro_torch.models import (
        decode_step, forward, init_decode_state, init_params,
    )
    from repro_torch.train.optim import tree_map
    cfg = get_config("gemma2_27b").scaled_down(dtype="float32", n_heads=8,
                                               n_kv_heads=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    on_card = tree_map(lambda t: t.to(dev), params)
    tokens = torch.randint(0, cfg.vocab, (2, 48),
                           generator=torch.Generator().manual_seed(1))
    before = fmod.FLASH_SOFTCAP_LAUNCHES, dmod.DECODE_SOFTCAP_LAUNCHES
    states, steps = {}, {}
    with torch.inference_mode():
        ref, _ = forward(cfg, params, tokens)
        out, _ = forward(cfg, on_card, tokens.to(dev))
        for name, p, device in (("cpu", params, "cpu"), ("card", on_card,
                                                         dev)):
            state = init_decode_state(cfg, 2, 42, device=device)
            rows = []
            for t in range(40):
                logits, state = decode_step(cfg, p, tokens[:, t:t + 1].to(
                    device), state)
                rows.append(logits[:, 0].cpu())
            states[name], steps[name] = state, torch.stack(rows, 1)
    assert (fmod.FLASH_SOFTCAP_LAUNCHES - before[0],
            dmod.DECODE_SOFTCAP_LAUNCHES - before[1]) == (
        cfg.n_layers, 40 * cfg.n_layers)
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), atol=1e-4)
    np.testing.assert_allclose(steps["card"].numpy(), steps["cpu"].numpy(),
                               atol=1e-4)
    for card, cpu in zip(states["card"]["layers"], states["cpu"]["layers"]):
        assert set(card) == set(cpu)
        if "slot_pos" in cpu:
            assert torch.equal(card["slot_pos"].cpu(), cpu["slot_pos"])
        np.testing.assert_allclose(card["k"].cpu().numpy(),
                                   cpu["k"].numpy(), atol=1e-4)
    prompts = tokens[:, :20].numpy().astype(np.int32)
    np.testing.assert_array_equal(serve(cfg, on_card, prompts, steps=5),
                                  serve(cfg, params, prompts, steps=5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("b,h,s,d,causal,window", [
    # The edges of the d = 256 instance's 64-row query and 32-key tiles.
    (2, 3, 63, 256, True, 0),
    (2, 3, 64, 256, True, 0),
    (2, 3, 65, 256, True, 0),
    (1, 2, 129, 256, True, 0),
    (1, 2, 300, 256, True, 100),    # a window whose edge crosses tiles
    (1, 2, 150, 256, False, 0),
    (1, 2, 130, 200, True, 33),     # d = 200, padded to 256
    (1, 10, 2100, 256, True, 2048),  # RecurrentGemma's window, MQA heads
])
def test_flash_kernel_d256_matches_plain_version(b, h, s, d, causal, window,
                                                 dtype):
    """The d = 256 instances (RecurrentGemma's head dim) against the plain
    version, each launch counted on its route and as a d = 256 launch."""
    dev = _card()
    from repro_torch.kernels import flash_attn as fmod
    q, k, v = _attn_inputs((b, h, s, d), dtype, dev, seed=s * d + window)
    plain = fmod.flash_attention_plain(q, k, v, causal=causal, window=window)
    route = fmod.ROUTES[dtype]
    before = fmod.FLASH_ROUTE_LAUNCHES[route], fmod.FLASH_WIDE_LAUNCHES
    out = fmod.flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (fmod.FLASH_ROUTE_LAUNCHES[route], fmod.FLASH_WIDE_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    rtol, atol = ATTN_TOL[dtype]
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               plain.float().cpu().numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("b,n_kv,group,s,d,lens", [
    (4, 1, 10, 161, 256, None),     # rgemma_serve's cache
    (4, 1, 10, 2048, 256, None),    # its ring of 2048, full
    # lens one below, at and one above the edges of 64-position tiles and
    # of the splits (4 (b, kv head) pairs: one tile a split), groups 1, 10.
    (6, 1, 10, 2048, 256, (63, 64, 65, 127, 128, 129)),
    (6, 1, 1, 300, 256, (1, 63, 64, 65, 299, 300)),
    (3, 2, 16, 500, 200, (64, 65, 500)),   # d = 200, the largest group
], ids=lambda x: "lens" + "_".join(map(str, x)) if isinstance(x, tuple)
    else None)
def test_decode_kernel_d256_matches_plain_version(b, n_kv, group, s, d,
                                                  lens, dtype):
    dev = _card()
    from repro_torch.kernels import decode_attn as dmod
    gen = torch.Generator().manual_seed(s + d + group)
    q = torch.randn((b, n_kv, group, d), generator=gen).to(dev, dtype)
    k, v = (torch.randn((b, n_kv, s, d), generator=gen).to(dev, dtype)
            for _ in range(2))
    if lens is None:
        lens = torch.randint(1, s + 1, (b,), generator=gen,
                             dtype=torch.int32)
        lens[0] = s
    else:
        lens = torch.tensor(lens, dtype=torch.int32)
    lens = lens.to(dev)
    plain = dmod.decode_attention_plain(q, k, v, lens)
    route = dmod.ROUTES[dtype]
    before = dmod.DECODE_ROUTE_LAUNCHES[route], dmod.DECODE_WIDE_LAUNCHES
    out = dmod.decode_attention_cuda(q, k, v, lens)
    torch.cuda.synchronize()
    assert (dmod.DECODE_ROUTE_LAUNCHES[route], dmod.DECODE_WIDE_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    rtol, atol = ATTN_TOL[dtype]
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               plain.float().cpu().numpy(), rtol=rtol,
                               atol=atol)


def test_flash_gradient_at_d256_raises_naming_k5():
    """Since the backward's d = 256 instances (ROADMAP.md K5, done): the
    gradient of the d = 256 forward through the `flash_attn` operator on
    the card
    matches `flash_attention_bwd_plain` on the same out and lse within
    BWD_TOL, launched once and counted at d > 128. (The name is the one
    the test had while the backward refused d = 256.)"""
    dev = _card()
    from repro_torch.kernels import flash_attn as fmod
    q, k, v = _attn_inputs((1, 2, 80, 256), torch.bfloat16, dev, seed=256)
    dout = _attn_inputs((1, 2, 80, 256), torch.bfloat16, dev, seed=257)[0]
    live = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fmod.flash_attention_cuda(*live)
    before = fmod.FLASH_BWD_LAUNCHES, fmod.FLASH_BWD_WIDE_LAUNCHES
    out.backward(dout)
    torch.cuda.synchronize()
    assert (fmod.FLASH_BWD_LAUNCHES, fmod.FLASH_BWD_WIDE_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    with torch.no_grad():
        o, lse = fmod.flash_attention_lse_cuda(q, k, v)
        want = fmod.flash_attention_bwd_plain(q, k, v, o, dout, lse)
    _bwd_close([t.grad for t in live], want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("b,h,s,d,causal,window,prefix", [
    # The d = 256 instances: each 64-key tile's dK and dV in two dim
    # halves on the tensor cores; the FMA route's 32-row tiles.
    (1, 3, 31, 256, True, 0, 0),
    (1, 3, 65, 256, True, 0, 0),
    (1, 2, 129, 256, True, 0, 0),
    (1, 2, 300, 256, True, 100, 0),
    (1, 2, 150, 256, False, 0, 0),
    (1, 2, 130, 200, True, 33, 0),   # d = 200, padded to 256
    (1, 2, 300, 256, True, 0, 100),
    # The bidirectional prefix at and around the tiles' edges.
    (2, 3, 300, 128, True, 0, 1),
    (2, 3, 300, 64, True, 0, 63),
    (2, 3, 300, 64, True, 0, 64),
    (2, 3, 300, 64, True, 0, 65),
    (2, 3, 300, 128, True, 0, 256),
    (1, 2, 90, 128, True, 0, 90),    # P = S: all bidirectional
    (1, 2, 700, 128, True, 100, 200),
])
def test_flash_d256_and_prefix_match_plain_versions(b, h, s, d, causal,
                                                    window, prefix, dtype):
    """Both directions at d = 256 and with a prefix P > 0 against their
    plain versions, on both routes (f32: FMA, 16-bit: tensor cores): the
    forward within ATTN_TOL, dQ, dK, dV within BWD_TOL; launches counted
    at d > 128 and with P > 0."""
    dev = _card()
    from repro_torch.kernels import flash_attn as fmod
    q, k, v = _attn_inputs((b, h, s, d), dtype, dev, seed=s + d + prefix)
    dout = _attn_inputs((b, h, s, d), dtype, dev, seed=s + d + 1)[0]
    kw = {"causal": causal, "window": window, "prefix": prefix}
    counts = (fmod.FLASH_WIDE_LAUNCHES, fmod.FLASH_BWD_WIDE_LAUNCHES,
              fmod.FLASH_PREFIX_LAUNCHES, fmod.FLASH_BWD_PREFIX_LAUNCHES)
    with torch.no_grad():
        out = fmod.flash_attention_cuda(q, k, v, **kw)
        o, lse = fmod.flash_attention_lse_cuda(q, k, v, **kw)
        got = fmod.flash_attention_bwd_cuda(q, k, v, o, dout, lse, causal,
                                            window, prefix=prefix)
        plain = fmod.flash_attention_plain(q, k, v, **kw)
        want = fmod.flash_attention_bwd_plain(q, k, v, o, dout, lse, causal,
                                              window, prefix=prefix)
    torch.cuda.synchronize()
    wide, pre = int(d > 128), int(prefix > 0)
    assert (fmod.FLASH_WIDE_LAUNCHES, fmod.FLASH_BWD_WIDE_LAUNCHES,
            fmod.FLASH_PREFIX_LAUNCHES, fmod.FLASH_BWD_PREFIX_LAUNCHES) == (
        counts[0] + 2 * wide, counts[1] + wide, counts[2] + 2 * pre,
        counts[3] + pre)
    rtol, atol = ATTN_TOL[dtype]
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               plain.float().cpu().numpy(), rtol=rtol,
                               atol=atol)
    _bwd_close(got, want)


def test_qwen2_vl_on_card_matches_cpu():
    """Qwen2-VL's SMOKE config in f32 with vision embeddings: `forward`
    (M-RoPE, the flash kernel with a prefix of 8) and `lm_loss` gradients
    (`vision_proj` among them) through the backward with that prefix, the
    card against the CPU (the plain versions), the gradients within 1e-4
    of each tensor's largest |g|."""
    dev = _card()
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn as fmod
    from repro_torch.models import forward, init_params, lm_loss
    from repro_torch.train.optim import tree_leaves, tree_map
    cfg = get_config("qwen2_vl_72b", smoke=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 40), generator=gen)
    vision = torch.randn((2, cfg.n_vision_tokens, cfg.d_model),
                         generator=gen)
    n_attn = cfg.n_layers
    grads = {}
    before = fmod.FLASH_PREFIX_LAUNCHES, fmod.FLASH_BWD_PREFIX_LAUNCHES
    for name, device in (("cpu", "cpu"), ("card", dev)):
        live = tree_map(lambda t: t.to(device).requires_grad_(True), params)
        loss = lm_loss(cfg, live, tokens.to(device),
                       torch.roll(tokens, -1, 1).to(device),
                       vision_embeds=vision.to(device))
        grads[name] = [g.cpu() for g in torch.autograd.grad(
            loss, tree_leaves(live))]
    torch.cuda.synchronize()
    assert (fmod.FLASH_PREFIX_LAUNCHES - before[0],
            fmod.FLASH_BWD_PREFIX_LAUNCHES - before[1]) == (n_attn, n_attn)
    for g_card, g_cpu in zip(grads["card"], grads["cpu"]):
        scale = max(float(g_cpu.abs().max()), 1e-30)
        assert float((g_card - g_cpu).abs().max()) <= 1e-4 * scale
    on_card = tree_map(lambda t: t.to(dev), params)
    with torch.inference_mode():
        ref, _ = forward(cfg, params, tokens, vision_embeds=vision)
        out, _ = forward(cfg, on_card, tokens.to(dev),
                         vision_embeds=vision.to(dev))
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), atol=1e-4)


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "xlstm_125m"])
def test_recurrent_archs_on_card_match_cpu(arch):
    """The recurrent SMOKE configs in f32 (RecurrentGemma's at head dim 256,
    its local layer on the d = 256 instances): forward on 40 tokens,
    teacher-forced decode over them into caches of 42 (the ring of 16
    wraps) with every state leaf, and serve, the card against the CPU."""
    dev = _card()
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attn as dmod
    from repro_torch.kernels import flash_attn as fmod
    from repro_torch.launch.serve import serve
    from repro_torch.models import (
        decode_step, forward, init_decode_state, init_params,
    )
    from repro_torch.train.optim import tree_map
    cfg = get_config(arch, smoke=True)
    if arch == "recurrentgemma_2b":
        cfg = dataclasses.replace(cfg, head_dim=256)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    on_card = tree_map(lambda t: t.to(dev), params)
    tokens = torch.randint(0, cfg.vocab, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    before = fmod.FLASH_WIDE_LAUNCHES, dmod.DECODE_WIDE_LAUNCHES
    states, steps = {}, {}
    with torch.inference_mode():
        ref, _ = forward(cfg, params, tokens)
        out, _ = forward(cfg, on_card, tokens.to(dev))
        for name, p, device in (("cpu", params, "cpu"), ("card", on_card,
                                                         dev)):
            state = init_decode_state(cfg, 2, 42, device=device)
            rows = []
            for t in range(40):
                logits, state = decode_step(cfg, p, tokens[:, t:t + 1].to(
                    device), state)
                rows.append(logits[:, 0].cpu())
            states[name], steps[name] = state, torch.stack(rows, 1)
    n_attn = sum(k.value == "local" for k in cfg.blocks())
    assert (fmod.FLASH_WIDE_LAUNCHES - before[0],
            dmod.DECODE_WIDE_LAUNCHES - before[1]) == (n_attn, 40 * n_attn)
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), atol=1e-4)
    np.testing.assert_allclose(steps["card"].numpy(), steps["cpu"].numpy(),
                               atol=1e-4)
    for card, cpu in zip(states["card"]["layers"], states["cpu"]["layers"]):
        assert set(card) == set(cpu)
        for name in cpu:
            assert card[name].dtype == cpu[name].dtype
            np.testing.assert_allclose(card[name].float().cpu().numpy(),
                                       cpu[name].float().numpy(), atol=1e-4)
    prompts = tokens[:, :20].numpy().astype(np.int32)
    np.testing.assert_array_equal(serve(cfg, on_card, prompts, steps=5),
                                  serve(cfg, params, prompts, steps=5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("b,h,sq,sk,d,causal,window", [
    # Non-causal with a key length of its own (cross-attention) across
    # both routes' tiles.
    (2, 3, 1, 17, 64, False, 0),
    (2, 3, 31, 64, 64, False, 0),
    (2, 3, 65, 1000, 128, False, 0),
    (1, 2, 512, 1024, 64, False, 0),
    (1, 2, 130, 40, 128, False, 0),
    (1, 2, 65, 300, 256, False, 0),
    # The encoder: non-causal at Sq = Sk.
    (2, 2, 129, 129, 64, False, 0),
    # Causal with off = Sk - Sq > 0 (attention against a KV cache).
    (2, 3, 1, 100, 128, True, 0),
    (2, 3, 64, 200, 128, True, 0),
    (1, 2, 130, 1000, 64, True, 100),
    (1, 2, 65, 300, 256, True, 50),
])
def test_flash_key_length_of_its_own_matches_plain_versions(
        b, h, sq, sk, d, causal, window, dtype):
    """Both directions with q (B, H, Sq, d) and k, v (B, H, Sk, d) against
    their plain versions on both routes: the forward within ATTN_TOL, dQ,
    dK, dV within BWD_TOL; launches counted as cross where Sq != Sk and as
    non-causal without the mask."""
    dev = _card()
    from repro_torch.kernels import flash_attn as fmod
    q, dout = _attn_inputs((b, h, sq, d), dtype, dev, seed=sq + sk)[:2]
    k, v = _attn_inputs((b, h, sk, d), dtype, dev, seed=sq + sk + 1)[:2]
    kw = {"causal": causal, "window": window}
    counts = (fmod.FLASH_CROSS_LAUNCHES, fmod.FLASH_BWD_CROSS_LAUNCHES,
              fmod.FLASH_NONCAUSAL_LAUNCHES, fmod.FLASH_BWD_NONCAUSAL_LAUNCHES)
    with torch.no_grad():
        out = fmod.flash_attention_cuda(q, k, v, **kw)
        o, lse = fmod.flash_attention_lse_cuda(q, k, v, **kw)
        got = fmod.flash_attention_bwd_cuda(q, k, v, o, dout, lse, causal,
                                            window)
        plain = fmod.flash_attention_plain(q, k, v, **kw)
        want = fmod.flash_attention_bwd_plain(q, k, v, o, dout, lse, causal,
                                              window)
    torch.cuda.synchronize()
    cross, free = int(sq != sk), int(not causal)
    assert (fmod.FLASH_CROSS_LAUNCHES, fmod.FLASH_BWD_CROSS_LAUNCHES,
            fmod.FLASH_NONCAUSAL_LAUNCHES,
            fmod.FLASH_BWD_NONCAUSAL_LAUNCHES) == (
        counts[0] + 2 * cross, counts[1] + cross, counts[2] + 2 * free,
        counts[3] + free)
    rtol, atol = ATTN_TOL[dtype]
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               plain.float().cpu().numpy(), rtol=rtol,
                               atol=atol)
    _bwd_close(got, want)


def test_flash_refuses_lengths_before_any_launch():
    """Causal with Sk < Sq and a prefix with Sq != Sk raise on the card
    before a launch is made or counted."""
    dev = _card()
    from repro_torch.kernels import flash_attn as fmod
    q = torch.zeros((1, 2, 64, 64), device=dev, dtype=torch.bfloat16)
    k = q[:, :, :32].contiguous()
    before = fmod.FLASH_LAUNCHES, fmod.FLASH_BWD_LAUNCHES
    with pytest.raises(ValueError, match="Sk >= Sq"):
        fmod.flash_attention_cuda(q, k, k, causal=True)
    with pytest.raises(ValueError, match="Sk >= Sq"):
        fmod.flash_attention_bwd_cuda(
            q, k, k, q, q, torch.zeros((1, 2, 64), device=dev), True)
    with pytest.raises(ValueError, match="prefix"):
        fmod.flash_attention_cuda(q, k, k, causal=False, prefix=4)
    assert (fmod.FLASH_LAUNCHES, fmod.FLASH_BWD_LAUNCHES) == before


def test_seamless_on_card_matches_cpu():
    """SeamlessM4T's SMOKE config in f32: `encode`, `forward`, `lm_loss`
    gradients (the cross and encoder attentions through both flash
    directions, non-causal), teacher-forced `decode_step(enc_out=)` (the
    cross step through the decode kernel) and `serve`, the card against
    the CPU (the plain versions)."""
    dev = _card()
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attn as dmod
    from repro_torch.kernels import flash_attn as fmod
    from repro_torch.launch.serve import serve
    from repro_torch.models import (
        decode_step, encode, forward, init_decode_state, init_params,
        lm_loss,
    )
    from repro_torch.train.optim import tree_leaves, tree_map
    cfg = get_config("seamless_m4t_medium", smoke=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    on_card = tree_map(lambda t: t.to(dev), params)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 24), generator=gen)
    audio = torch.randn((2, cfg.audio_frames, cfg.d_model), generator=gen)
    before = (fmod.FLASH_CROSS_LAUNCHES, fmod.FLASH_BWD_NONCAUSAL_LAUNCHES,
              dmod.DECODE_LAUNCHES)
    grads = {}
    for name, device in (("cpu", "cpu"), ("card", dev)):
        live = tree_map(lambda t: t.to(device).requires_grad_(True), params)
        loss = lm_loss(cfg, live, tokens.to(device),
                       torch.roll(tokens, -1, 1).to(device),
                       audio_embeds=audio.to(device))
        grads[name] = [g.cpu() for g in torch.autograd.grad(
            loss, tree_leaves(live))]
    for g_card, g_cpu in zip(grads["card"], grads["cpu"]):
        scale = max(float(g_cpu.abs().max()), 1e-30)
        assert float((g_card - g_cpu).abs().max()) <= 1e-4 * scale
    steps = {}
    with torch.inference_mode():
        np.testing.assert_allclose(
            encode(cfg, on_card, audio.to(dev)).cpu().numpy(),
            encode(cfg, params, audio).numpy(), atol=1e-4)
        ref, _ = forward(cfg, params, tokens, audio_embeds=audio)
        out, _ = forward(cfg, on_card, tokens.to(dev),
                         audio_embeds=audio.to(dev))
        for name, p, device in (("cpu", params, "cpu"),
                                ("card", on_card, dev)):
            enc = encode(cfg, p, audio.to(device))
            state = init_decode_state(cfg, 2, 26, device=device)
            rows = []
            for t in range(24):
                logits, state = decode_step(cfg, p, tokens[:, t:t + 1].to(
                    device), state, enc_out=enc)
                rows.append(logits[:, 0].cpu())
            steps[name] = torch.stack(rows, 1)
    n = cfg.n_layers
    assert fmod.FLASH_CROSS_LAUNCHES - before[0] == 2 * n      # fwd, loss
    assert fmod.FLASH_BWD_NONCAUSAL_LAUNCHES - before[1] == \
        n + cfg.encoder_layers
    assert dmod.DECODE_LAUNCHES - before[2] == 2 * n * 24
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), atol=1e-4)
    np.testing.assert_allclose(steps["card"].numpy(), steps["cpu"].numpy(),
                               atol=1e-4)
    prompts = tokens[:, :10].numpy().astype(np.int32)
    np.testing.assert_array_equal(serve(cfg, on_card, prompts, steps=5),
                                  serve(cfg, params, prompts, steps=5))
