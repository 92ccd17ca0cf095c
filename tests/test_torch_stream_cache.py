"""The port's stream, segment cache, plan IR and `AiresSpGEMM` against the
JAX package's: the same segment sequence gives equal byte and hit
counters, equal cache statistics, equal modeled costs and equal bricks."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.pipeline as r_pipe
import repro.io.segment_cache as r_cache
import repro.io.streamer as r_stream
import repro.io.tiers as r_tiers
from repro.core import AiresConfig as RConfig, AiresSpGEMM as RSpGEMM
from repro.core.memory_model import plan_memory_dense_features
from repro.data import (
    SUITESPARSE_SPECS, generate_graph, normalized_adjacency, scaled_spec,
)
from repro.sparse import csr_from_dense as r_csr, tile_csr_to_block_ell as r_tile

import repro_torch.core.pipeline as p_pipe
import repro_torch.io.segment_cache as p_cache
import repro_torch.io.streamer as p_stream
import repro_torch.io.tiers as p_tiers
from repro_torch.core import AiresConfig as PConfig, AiresSpGEMM as PSpGEMM
from repro_torch.sparse import (
    CSR, csr_from_dense as p_csr, tile_csr_to_block_ell as p_tile,
)

COUNTERS = ("segments", "reissues", "uploaded_bytes", "cache_hits",
            "cache_hit_bytes", "promoted_bytes", "ici_bytes",
            "directory_hit_bytes")
CACHE_FIELDS = [f.name for f in dataclasses.fields(p_cache.CacheStats)]
METRICS = ("makespan_s", "io_modeled_s", "compute_modeled_s",
           "bytes_by_path", "seconds_by_path", "total_transfer_bytes",
           "cache_hit_bytes", "segments")


@pytest.fixture(scope="module")
def graph():
    """The quickstart graph (socLJ1 scaled for CPU), in both packages."""
    r = normalized_adjacency(generate_graph(
        scaled_spec(SUITESPARSE_SPECS["socLJ1"], 1e-4), seed=0))
    p = CSR(r.indptr.copy(), r.indices.copy(), r.data.copy(), r.shape)
    est = plan_memory_dense_features(r, r.n_rows, 64, float("inf"))
    return p, r, int(est.m_b + est.m_c + 0.6 * r.nbytes())


def _segment_ells(seed, count=7):
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(count):
        n, m = int(rng.integers(8, 48)), int(rng.integers(8, 64))
        dense = ((rng.random((n, m)) < 0.2)
                 * rng.standard_normal((n, m))).astype(np.float32)
        pairs.append((p_tile(p_csr(dense), bm=8, bk=8),
                      r_tile(r_csr(dense), bm=8, bk=8)))
    return pairs


def _run_epochs(mod_stream, mod_cache, mod_tiers, ells, upload, total_of,
                device_budget, host_budget, deadline, epochs=3, **device):
    """`device`: `device="cpu"` for the port's classes, which default to
    the card; nothing for the reference's."""
    tms = mod_tiers.TieredMemorySystem(mod_tiers.TPU_V5E_SYSTEM)
    cache = mod_cache.TieredSegmentCache(device_budget, host_budget, tms=tms,
                                         **device)
    keys = [mod_cache.SegmentKey("g", i, "bricks", tuple(e.blocks.shape),
                                 fingerprint=f"f{i}")
            for i, e in enumerate(ells)]
    record = []
    for _ in range(epochs):
        streamer = mod_stream.DoubleBufferedStreamer(
            upload, lambda dev, i: total_of(dev), depth=2,
            deadline_s=deadline,
            payload_nbytes=lambda p: p[1].nbytes(),
            cache_lookup=lambda p: cache.get(keys[p[0]],
                                             nbytes=p[1].nbytes()),
            cache_store=lambda p, dev: cache.put(keys[p[0]], dev,
                                                 p[1].nbytes()), **device)
        results = streamer.run_all(list(enumerate(ells)))
        record.append((
            [getattr(streamer.stats, c) for c in COUNTERS],
            [getattr(cache.stats, f) for f in CACHE_FIELDS],
            (cache.device_used_bytes, cache.host_used_bytes),
            [cache.tier_of(k) and cache.tier_of(k).value for k in keys],
            np.asarray(results, dtype=np.float64)))
    return record, tms


@pytest.mark.parametrize("device_frac,host_frac,deadline", [
    (0.4, None, None),     # demotion pressure, unbounded host tier
    (0.4, 0.3, None),      # host tier overflows: evictions
    (2.0, None, None),     # everything stays resident
    (0.4, None, -1.0),     # every upload re-issued once (straggler path)
])
def test_stream_and_cache_counters_match_reference(device_frac, host_frac,
                                                   deadline):
    pairs = _segment_ells(seed=5)
    total = sum(re.nbytes() for _, re in pairs)
    device_budget = int(device_frac * total)
    host_budget = None if host_frac is None else int(host_frac * total)

    def r_upload(payload):
        e = payload[1]
        return (jax.device_put(e.blocks), jax.device_put(e.col_tile),
                jax.device_put(e.n_tiles), e)

    def p_upload(payload):
        e = payload[1]
        return tuple(torch.from_numpy(x).clone() for x in
                     (e.blocks, e.col_tile, e.n_tiles)) + (e,)

    ref, r_tms = _run_epochs(r_stream, r_cache, r_tiers,
                             [re for _, re in pairs], r_upload,
                             lambda d: float(jnp.sum(d[0])), device_budget,
                             host_budget, deadline)
    port, p_tms = _run_epochs(p_stream, p_cache, p_tiers,
                              [pe for pe, _ in pairs], p_upload,
                              lambda d: float(torch.sum(d[0])), device_budget,
                              host_budget, deadline, device="cpu")
    for (pc, ps, pu, pt, pr), (rc, rs, ru, rt, rr) in zip(port, ref):
        assert pc == rc
        assert ps == rs
        assert pu == ru
        assert pt == rt
        np.testing.assert_allclose(pr, rr, atol=1e-4)  # f32 sum order
    assert ({p.value: b for p, b in p_tms.bytes_by_path().items()}
            == {p.value: b for p, b in r_tms.bytes_by_path().items()})
    assert ({p.value: s for p, s in p_tms.seconds_by_path().items()}
            == {p.value: s for p, s in r_tms.seconds_by_path().items()})
    assert port[-1][1][CACHE_FIELDS.index("misses")] > 0


def test_peek_cost_prices_without_mutating():
    tms = p_tiers.TieredMemorySystem(p_tiers.TPU_V5E_SYSTEM)
    cache = p_cache.TieredSegmentCache(100, tms=tms, device="cpu")
    keys = [p_cache.SegmentKey("g", i, "bricks", (1,)) for i in range(3)]
    for k in keys:
        cache.put(k, (torch.zeros(4),), 60)    # each put demotes the last
    before = (dataclasses.astuple(cache.stats), tms.total_bytes())
    assert cache.peek_cost(keys[2], 60) == (True, 0.0)
    hit, cost = cache.peek_cost(keys[0], 60, tms=p_tiers.TieredMemorySystem(
        p_tiers.TPU_V5E_SYSTEM))
    assert hit and cost > 0.0
    assert cache.peek_cost(p_cache.SegmentKey("h", 0, "bricks", (1,)),
                           60) == (False, 0.0)
    assert (dataclasses.astuple(cache.stats), tms.total_bytes()) == before
    assert cache.tier_of(keys[0]) is p_tiers.MemoryTier.HOST


def _engines(p, r, budget, cache_bytes=None):
    caches = (None, None)
    if cache_bytes is not None:
        caches = (p_cache.TieredSegmentCache(
                      cache_bytes, tms=p_tiers.TieredMemorySystem(
                          p_tiers.TPU_V5E_SYSTEM), device="cpu"),
                  r_cache.TieredSegmentCache(
                      cache_bytes, tms=r_tiers.TieredMemorySystem(
                          r_tiers.TPU_V5E_SYSTEM)))
    pe = PSpGEMM(PConfig(device_budget_bytes=budget, bm=8, bk=8,
                         plan_features=64, device="cpu"),
                 segment_cache=caches[0])
    re = RSpGEMM(RConfig(device_budget_bytes=budget, bm=8, bk=8,
                         plan_features=64), segment_cache=caches[1])
    return pe, re


def _metrics_equal(pm, rm):
    for name in METRICS:
        assert getattr(pm, name) == getattr(rm, name), name


@pytest.mark.parametrize("width", [16, 40, 64])
def test_stream_plan_estimate_matches_reference(graph, width):
    p, r, budget = graph
    pe, re = _engines(p, r, budget)
    shape = (r.n_rows, width)
    pplan = pe.stream_plan(p, shape, spec=p_tiers.TPU_V5E_SYSTEM)
    rplan = re.stream_plan(r, shape, spec=r_tiers.TPU_V5E_SYSTEM)
    assert pplan.segments == rplan.segments >= 2
    assert pplan.wire_bytes() == rplan.wire_bytes()
    assert len(pplan.stream_payloads()) == len(rplan.stream_payloads())
    _metrics_equal(pplan.estimate(p_tiers.TPU_V5E_SYSTEM),
                   rplan.estimate(r_tiers.TPU_V5E_SYSTEM))


def test_infeasible_width_raises_like_reference(graph):
    p, r, budget = graph
    pe, re = _engines(p, r, budget)
    with pytest.raises(MemoryError):
        re.stream_plan(r, (r.n_rows, 100))
    with pytest.raises(MemoryError, match="AIRES plan infeasible"):
        pe.stream_plan(p, (p.n_rows, 100))


@pytest.mark.parametrize("cache_frac", [0.5, 4.0])
def test_spgemm_streams_and_warm_estimates_match_reference(graph, cache_frac):
    """Two streamed passes through a segment cache (under demotion
    pressure when cache_frac < 1): equal outputs within f32 summation
    order, exactly equal StreamStats counters, and equal estimates against
    the warm cache (peeked, not mutated)."""
    p, r, budget = graph
    probe, _ = _engines(p, r, budget)
    wire = probe.stream_plan(p, (p.n_rows, 32)).wire_bytes()
    pe, re = _engines(p, r, budget, cache_bytes=int(cache_frac * wire))
    h = np.random.default_rng(4).standard_normal(
        (r.n_rows, 32)).astype(np.float32)
    for _ in range(2):
        x_p = pe(p, torch.from_numpy(h)).numpy()
        x_r = np.asarray(re(r, jnp.asarray(h)))
        np.testing.assert_allclose(x_p, x_r, atol=1e-4, rtol=1e-5)
        ps, rs = pe.last_stream_stats, re.last_stream_stats
        assert ([getattr(ps, c) for c in COUNTERS]
                == [getattr(rs, c) for c in COUNTERS])
        assert ([getattr(pe.segment_cache.stats, f) for f in CACHE_FIELDS]
                == [getattr(re.segment_cache.stats, f) for f in CACHE_FIELDS])
    _metrics_equal(
        pe.stream_plan(p, (p.n_rows, 32)).estimate(
            p_tiers.TPU_V5E_SYSTEM, segment_cache=pe.segment_cache),
        re.stream_plan(r, (r.n_rows, 32)).estimate(
            r_tiers.TPU_V5E_SYSTEM, segment_cache=re.segment_cache))


def test_transposed_preparation_matches_reference(graph):
    p, r, budget = graph
    pe, re = _engines(p, r, budget)
    pp = pe._prepare(p, (p.n_rows, 32), transpose=True)
    rp = re._prepare(r, (r.n_rows, 32), transpose=True)
    assert pp.cache_ns == rp.cache_ns and pp.fps == rp.fps
    assert ([dataclasses.astuple(s) for s in pp.segs]
            == [dataclasses.astuple(s) for s in rp.segs])
    for a, b in zip(pp.ells, rp.ells):
        np.testing.assert_array_equal(a.blocks, b.blocks)
        np.testing.assert_array_equal(a.col_tile, b.col_tile)
    assert pe.transpose_of(p) is pe.transpose_of(p)


def test_spgemm_backward_streams_transposed_plan(graph):
    """The gradient of X = A H streams the transposed plan prepared above:
    one segment per transposed RoBW segment, the reference's dH and its
    backward statistics."""
    p, r, budget = graph
    pe, re = _engines(p, r, budget)
    g = np.random.default_rng(6).standard_normal(
        (p.n_rows, 4)).astype(np.float32)
    h = torch.zeros((p.shape[1], 4), requires_grad=True)
    (pe(p, h) * torch.from_numpy(g)).sum().backward()
    dh_ref = jax.grad(lambda h_: jnp.sum(re(r, h_) * g))(
        jnp.zeros((r.shape[1], 4), jnp.float32))
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(dh_ref),
                               atol=1e-4, rtol=1e-5)
    ps, rs = pe.last_backward_stream_stats, re.last_backward_stream_stats
    assert ps.segments == len(pe._prepare(p, (p.n_rows, 4),
                                          transpose=True).segs) >= 2
    assert ([getattr(ps, c) for c in COUNTERS]
            == [getattr(rs, c) for c in COUNTERS])


@pytest.mark.parametrize("deps,phase,error", [
    ((5,), "stream", "dangling"),
    # The reference's wording (the id keeps this case's original name).
    pytest.param((1,), "stream", "depends on later op 1",
                 id="deps1-stream-depends on op 1"),
    ((), "other", "undeclared phase"),
])
def test_plan_validation_rejects_malformed_plans(deps, phase, error):
    plan = p_pipe.PipelinePlan(scheduler="t",
                               phases=[p_pipe.PhaseSpec("stream")])
    plan.add(p_pipe.ComputeOp(1.0), phase, p_pipe.LANE_COMPUTE, deps=deps)
    plan.add(p_pipe.ComputeOp(1.0), "stream", p_pipe.LANE_COMPUTE)
    with pytest.raises(p_pipe.PlanValidationError, match=error) as p_err:
        plan.estimate(p_tiers.TPU_V5E_SYSTEM)
    # The reference rejects the same plans, in the same words.
    r_plan = r_pipe.PipelinePlan(scheduler="t",
                                 phases=[r_pipe.PhaseSpec("stream")])
    r_plan.add(r_pipe.ComputeOp(1.0), phase, r_pipe.LANE_COMPUTE, deps=deps)
    r_plan.add(r_pipe.ComputeOp(1.0), "stream", r_pipe.LANE_COMPUTE)
    with pytest.raises(r_pipe.PlanValidationError) as r_err:
        r_plan.validate()
    assert str(p_err.value) == str(r_err.value)
