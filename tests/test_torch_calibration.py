"""The port's `CostCalibrator` and the engine's calibrated pricing against
the JAX package's: the same observations fit the same `TierSpec`s (within
one ulp) at the same `generation`, calibration off is bit-exact, and a
generation move drops the cost memo and reprices the queue."""
import math

import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import numpy as np
import pytest

import repro.core.calibration as r_cal
import repro.io.tiers as r_tiers
from repro.core.memory_model import plan_memory_dense_features
from repro.data import (
    SUITESPARSE_SPECS, generate_graph, normalized_adjacency, scaled_spec,
)
from repro.runtime import (
    EngineConfig as REngineConfig, InferenceRequest as RRequest,
    ServingEngine as RServingEngine,
)

import repro_torch.core.calibration as p_cal
import repro_torch.io.tiers as p_tiers
from repro_torch.runtime import (
    EngineConfig as PEngineConfig, InferenceRequest as PRequest,
    ServingEngine as PServingEngine,
)
from repro_torch.sparse import CSR

PATHS = ("dma", "gds", "sio", "um", "ici")


def _ulps(a: float, b: float) -> int:
    if a == b:
        return 0
    return round(abs(a - b) / math.ulp(max(abs(a), abs(b))))


def _specs_equal(p_spec, r_spec, max_ulps=1):
    for name in PATHS:
        pp, rp = p_tiers.Path(name), r_tiers.Path(name)
        assert _ulps(p_spec.bw[pp], r_spec.bw[rp]) <= max_ulps, name
        assert _ulps(p_spec.latency_s[pp], r_spec.latency_s[rp]) <= max_ulps
    for f in ("device_capacity", "host_capacity", "storage_capacity",
              "hbm_bw", "host_memcpy_bw", "host_op_latency_s", "peak_flops"):
        assert getattr(p_spec, f) == getattr(r_spec, f), f


class _Lat:
    """A `RequestLatency`-shaped sample."""

    def __init__(self, predicted_s, processing_s):
        self.predicted_s = predicted_s
        self.processing_s = processing_s


@pytest.mark.parametrize("seed", range(8))
def test_fits_match_reference(seed):
    """Random transfer records (multi-hop ICI among them), single
    transfers and request-error batches, fed to both calibrators in the
    same order: equal readings after every round."""
    rng = np.random.default_rng(seed)
    blend = float(rng.uniform(0.1, 1.0))
    alpha = float(rng.uniform(0.05, 1.0))
    pc, rc = (p_cal.CostCalibrator(blend=blend, error_alpha=alpha),
              r_cal.CostCalibrator(blend=blend, error_alpha=alpha))
    bases = [(p_tiers.TPU_V5E_SYSTEM, r_tiers.TPU_V5E_SYSTEM),
             (p_tiers.PAPER_GPU_SYSTEM, r_tiers.PAPER_GPU_SYSTEM)]
    for _ in range(6):
        kind = rng.random()
        if kind < 0.4:
            recs = []
            for _ in range(int(rng.integers(1, 8))):
                name = PATHS[int(rng.integers(0, len(PATHS)))]
                hops = int(rng.integers(1, 4)) if name == "ici" else 1
                nbytes = int(rng.integers(0, 1 << 24)) * hops
                secs = float(rng.uniform(0.0, 1e-2)) * (rng.random() > 0.05)
                recs.append((name, nbytes, secs, hops))
            got = pc.observe_records(
                [p_tiers.TransferRecord(p_tiers.Path(n), p_tiers.MemoryTier
                                        .HOST, p_tiers.MemoryTier.DEVICE,
                                        b, s, hops=h) for n, b, s, h in recs])
            want = rc.observe_records(
                [r_tiers.TransferRecord(r_tiers.Path(n), r_tiers.MemoryTier
                                        .HOST, r_tiers.MemoryTier.DEVICE,
                                        b, s, hops=h) for n, b, s, h in recs])
            assert got == want
        elif kind < 0.7:
            name = PATHS[int(rng.integers(0, len(PATHS)))]
            nbytes, secs = int(rng.integers(1, 1 << 22)), float(
                rng.uniform(1e-6, 1e-2))
            hops = int(rng.integers(1, 3))
            pc.observe_transfer(p_tiers.Path(name), nbytes, secs, hops=hops)
            rc.observe_transfer(r_tiers.Path(name), nbytes, secs, hops=hops)
        else:
            lats = [_Lat(float(rng.uniform(0, 1e-2)) * (rng.random() > 0.1),
                         float(rng.uniform(1e-4, 1e-1)))
                    for _ in range(int(rng.integers(1, 6)))]
            assert pc.observe_batch(lats) == rc.observe_batch(lats)
        assert pc.generation == rc.generation
        assert pc.error_scale == rc.error_scale
        for p_base, r_base in bases:
            _specs_equal(pc.calibrated(p_base), rc.calibrated(r_base))
            p_est, r_est = pc.estimates(p_base), rc.estimates(r_base)
            assert [e.path.value for e in p_est] == [e.path.value
                                                     for e in r_est]
            for pe, re in zip(p_est, r_est):
                assert (pe.n_obs, pe.rounds) == (re.n_obs, re.rounds)
                assert _ulps(pe.bw, re.bw) <= 1
                assert _ulps(pe.latency_s, re.latency_s) <= 1
                assert _ulps(pe.trust, re.trust) <= 1


def test_zero_observations_is_the_identity():
    cal = p_cal.CostCalibrator()
    assert cal.calibrated(p_tiers.TPU_V5E_SYSTEM) is p_tiers.TPU_V5E_SYSTEM
    assert cal.generation == 0 and cal.estimates(
        p_tiers.TPU_V5E_SYSTEM) == []


def test_fit_recovers_coefficients_and_degenerate_design():
    bw, lat = 20e9, 5e-6
    cal = p_cal.CostCalibrator(blend=1.0)
    for nbytes, hops in ((1 << 16, 1), (1 << 20, 1), (1 << 18, 2)):
        cal.observe_transfer(p_tiers.Path.DMA, nbytes, lat * hops
                             + nbytes / bw, hops=hops)
    got_bw, got_lat = cal.fitted(p_tiers.Path.DMA)
    assert got_bw == pytest.approx(bw, rel=1e-9)
    assert got_lat == pytest.approx(lat, rel=1e-6)
    degenerate = p_cal.CostCalibrator(blend=1.0)
    degenerate.observe_transfer(p_tiers.Path.DMA, 1 << 20, 1e-4)
    base = p_tiers.TPU_V5E_SYSTEM
    got_bw, got_lat = degenerate.fitted(p_tiers.Path.DMA, base)
    assert got_lat == base.latency_s[p_tiers.Path.DMA]
    assert got_lat + (1 << 20) / got_bw == pytest.approx(1e-4)
    for bad in ({"blend": 0.0}, {"error_alpha": 1.5}):
        with pytest.raises(ValueError):
            p_cal.CostCalibrator(**bad)


# ---- the engine ------------------------------------------------------------


@pytest.fixture(scope="module")
def graph():
    r = normalized_adjacency(generate_graph(
        scaled_spec(SUITESPARSE_SPECS["socLJ1"], 1e-4), seed=0))
    p = CSR(r.indptr.copy(), r.indices.copy(), r.data.copy(), r.shape)
    est = plan_memory_dense_features(r, r.n_rows, 64, float("inf"))
    return p, r, int(est.m_b + est.m_c + 0.6 * r.nbytes())


def _clock() -> float:
    return 100.0


def _engines(graph, calibrators=(None, None), **kw):
    p_a, r_a, budget = graph
    p = PServingEngine(PEngineConfig(device_budget_bytes=budget,
                                     clock=_clock, device="cpu",
                                     calibrator=calibrators[0], **kw))
    r = RServingEngine(REngineConfig(device_budget_bytes=budget,
                                     clock=_clock,
                                     calibrator=calibrators[1], **kw))
    p.register_graph("g", p_a)
    r.register_graph("g", r_a)
    return p, r


def _request(mod, n_rows, seed=1, width=16):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n_rows, width)).astype(np.float32)
    w = [rng.standard_normal((width, 16)).astype(np.float32)]
    return mod("g", h, w)


def _slow_dma(cal, tiers, sizes=(1 << 16, 1 << 18, 1 << 20)):
    slow_bw = tiers.TPU_V5E_SYSTEM.bw[tiers.Path.DMA] / 10.0
    for nbytes in sizes:
        cal.observe_transfer(tiers.Path.DMA, nbytes,
                             tiers.TPU_V5E_SYSTEM.latency_s[tiers.Path.DMA]
                             + nbytes / slow_bw)


def test_calibration_off_is_bit_exact(graph):
    """A calibrator with no observations changes nothing: the same
    predictions as no calibrator and as the reference, equal outputs and
    bytes."""
    n = graph[0].n_rows
    runs = []
    for cals in ((None, None), (p_cal.CostCalibrator(),
                                r_cal.CostCalibrator())):
        p, r = _engines(graph, cals, max_queue_cost_s=1e9)
        p.submit(_request(PRequest, n, seed=7))
        r.submit(_request(RRequest, n, seed=7))
        runs.append((p.run_batch(), r.run_batch()))
    (p_off, r_off), (p_on, r_on) = runs
    assert ([lt.predicted_s for lt in p_off.request_latency]
            == [lt.predicted_s for lt in p_on.request_latency])
    assert p_on.request_latency[0].predicted_s == pytest.approx(
        r_on.request_latency[0].predicted_s, rel=1e-12)
    for f in ("uploaded_bytes", "cache_hit_bytes", "promoted_bytes"):
        assert getattr(p_off, f) == getattr(p_on, f) == getattr(r_on, f)
    assert np.array_equal(p_off.results[0].output, p_on.results[0].output)


def test_generation_move_invalidates_memo_and_reprices_queue(graph):
    n = graph[0].n_rows
    pc, rc = p_cal.CostCalibrator(), r_cal.CostCalibrator()
    p, r = _engines(graph, (pc, rc), max_queue_cost_s=1e9)
    p_c0 = p.submit(_request(PRequest, n)).estimated_cost_s
    r_c0 = r.submit(_request(RRequest, n)).estimated_cost_s
    assert p_c0 == pytest.approx(r_c0, rel=1e-12) and p_c0 > 0.0
    assert p._pass_costs
    _slow_dma(pc, p_tiers)
    _slow_dma(rc, r_tiers)
    assert pc.generation == rc.generation == 3
    p_c1 = p.estimate_request_cost(_request(PRequest, n))
    r_c1 = r.estimate_request_cost(_request(RRequest, n))
    assert p_c1 == pytest.approx(r_c1, rel=1e-12) and p_c1 > p_c0
    assert p._queue[0].estimated_cost_s == pytest.approx(p_c1)
    assert p.queued_cost_s() == pytest.approx(r.queued_cost_s(), rel=1e-12)
    uncal = p.estimate_request_cost(_request(PRequest, n),
                                    spec=p.config.tier_spec)
    assert uncal == pytest.approx(p_c0, rel=1e-12)


def test_prepare_queue_reprices_detached_queue(graph):
    n = graph[0].n_rows
    pc, rc = p_cal.CostCalibrator(), r_cal.CostCalibrator()
    p, r = _engines(graph, (pc, rc), max_queue_cost_s=1e9)
    ready = []
    for eng, req, cal, tiers in ((p, PRequest, pc, p_tiers),
                                 (r, RRequest, rc, r_tiers)):
        eng.submit(_request(req, n))
        queue, eng._queue = eng._queue, []
        c0 = queue[0].estimated_cost_s
        _slow_dma(cal, tiers, sizes=(1 << 20,))
        got, expired = eng.prepare_queue(queue, eng.clock())
        assert not expired and got[0].estimated_cost_s > c0
        ready.append(got[0].estimated_cost_s)
    assert ready[0] == pytest.approx(ready[1], rel=1e-12)


@pytest.mark.parametrize("epochs", [1, 3])
def test_run_batch_feeds_calibrator(graph, epochs):
    """Each drain's latencies reach the calibrator: one error round per
    batch, as in the reference (the samples are wall times, so only the
    counts compare)."""
    n = graph[0].n_rows
    pc, rc = p_cal.CostCalibrator(), r_cal.CostCalibrator()
    p, r = _engines(graph, (pc, rc), max_queue_cost_s=1e9)
    for epoch in range(epochs):
        for j in range(2):
            p.submit(_request(PRequest, n, seed=10 * epoch + j))
            r.submit(_request(RRequest, n, seed=10 * epoch + j))
        p_rep, r_rep = p.run_batch(), r.run_batch()
        assert len(p_rep.request_latency) == len(r_rep.request_latency) == 2
        assert pc.generation == rc.generation == 2 * (epoch + 1)
        assert pc._error_rounds == rc._error_rounds == epoch + 1
    assert pc.error_scale != 1.0
    assert p.feed_latencies([]) == 0
