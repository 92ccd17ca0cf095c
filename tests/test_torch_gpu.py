"""Card tests of the port: the CUDA Block-ELL SpMM, fused GCN-layer,
flash-attention and GQA flash-decode kernels against their plain PyTorch
versions, and the serving engine, the differentiable engine and its fused
layer, and the dense LM's forward, decode and serve on the card against
themselves on the CPU.

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


def test_attention_kernels_refuse_grad_and_cpu_tensors():
    dev = _card()
    from repro_torch.kernels import decode_attn as dmod
    from repro_torch.kernels import flash_attn as fmod
    q, k, v = _attn_inputs((1, 2, 16, 32), torch.float32, dev, seed=0)
    lens = torch.full((1,), 16, dtype=torch.int32, device=dev)
    qg = q[:, :, :1].contiguous()
    with pytest.raises(RuntimeError, match="no backward"):
        fmod.flash_attention_cuda(q.requires_grad_(True), k, v)
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
