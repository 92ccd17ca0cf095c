"""The port's `gcn_epoch` and its serving engine with rewrite passes
against the JAX package's: a simulated epoch reads the same per-layer
metrics under every scheduler; an executed epoch streams the same
segments and bytes forward and backward beside the same modeled
per-layer metrics; and an engine with `plan_passes` and `analyze_plans`
serves deadline-carrying requests in the reference's order with the
reference's bytes.

The port runs on `device="cpu"` (the plain SpMM); the reference's Pallas
kernel runs in interpret mode; inputs come from one numpy seed.
"""
import numpy as np
import pytest

import repro.core.passes as r_passes
import repro.io.tiers as r_tiers
from repro.core import AiresConfig as RConfig, gcn_epoch as r_gcn_epoch
from repro.core.memory_model import (
    FeatureSpec as RFeat, plan_memory_dense_features,
)
from repro.data import (
    SUITESPARSE_SPECS, generate_graph, normalized_adjacency, scaled_spec,
)
from repro.runtime import (
    EngineConfig as REngineConfig, InferenceRequest as RRequest,
    ServingEngine as RServingEngine,
)

import repro_torch.core.analysis as p_analysis
import repro_torch.core.passes as p_passes
import repro_torch.io.tiers as p_tiers
from repro_torch.core import (
    AiresConfig as PConfig, FeatureSpec as PFeat, gcn_epoch as p_gcn_epoch,
)
from repro_torch.runtime import (
    EngineConfig as PEngineConfig, InferenceRequest as PRequest,
    ServingEngine as PServingEngine,
)
from repro_torch.sparse import CSR

METRIC_FIELDS = [
    "makespan_s", "io_modeled_s", "compute_modeled_s", "host_preprocess_s",
    "bytes_by_path", "seconds_by_path", "total_transfer_bytes",
    "cache_hit_bytes", "merge_events", "merge_io_s", "segments", "oom",
]
STREAM_FIELDS = ("segments", "uploaded_bytes", "cache_hits",
                 "cache_hit_bytes", "reissues")
SCHEDS = ["maxmemory", "ucg", "etc", "aires"]


@pytest.fixture(autouse=True)
def _analyze_port_plans():
    previous = p_analysis.set_default_analyze(True)
    yield
    p_analysis.set_default_analyze(previous)


def _graph(name, scale, seed):
    r = normalized_adjacency(generate_graph(
        scaled_spec(SUITESPARSE_SPECS[name], scale), seed=seed))
    return r, CSR(r.indptr.copy(), r.indices.copy(), r.data.copy(), r.shape)


@pytest.fixture(scope="module")
def small_graph():
    return _graph("socLJ1", 1e-4, 0)


def _budget(a, width):
    est = plan_memory_dense_features(a, a.n_rows, width, float("inf"))
    return int(est.m_b + est.m_c + 0.6 * a.nbytes())


def _metrics_list_equal(pms, rms):
    assert len(pms) == len(rms)
    for pm, rm in zip(pms, rms):
        for field in METRIC_FIELDS:
            assert getattr(pm, field) == getattr(rm, field), field


def _weights(seed, dims):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((fi, fo)) / np.sqrt(fi)).astype(np.float32)
            for fi, fo in zip(dims[:-1], dims[1:])]


# ---- simulate ---------------------------------------------------------------


@pytest.mark.parametrize("h0_kind", ["featurespec", "array"])
@pytest.mark.parametrize("sched", SCHEDS)
def test_simulated_epoch_matches_reference(small_graph, sched, h0_kind):
    r, p = small_graph
    dims = [64, 64, 64, 16]
    ws = _weights(0, dims)
    budget = 2 * _budget(r, 64)
    if h0_kind == "featurespec":
        rh, ph = (RFeat(r.n_rows, 64, 4, 99.0), PFeat(p.n_rows, 64, 4, 99.0))
    else:
        rh = ph = np.zeros((r.n_rows, 64), np.float32)
    rm = r_gcn_epoch(r, rh, ws, sched, r_tiers.PAPER_GPU_SYSTEM, budget,
                     dataset="lj")
    pm = p_gcn_epoch(p, ph, ws, sched, p_tiers.PAPER_GPU_SYSTEM, budget,
                     dataset="lj")
    _metrics_list_equal(pm.per_layer, rm.per_layer)
    assert pm.epoch_makespan_s == rm.epoch_makespan_s
    assert pm.total_transfer_bytes == rm.total_transfer_bytes
    assert pm.speedup_over(pm) == 1.0


def test_simulated_epoch_oom_matches_reference(small_graph):
    """Below the baselines' Table III floor the epoch stops at the first
    layer with an infinite makespan, as in the reference."""
    r, p = small_graph
    ws = _weights(1, [32, 32])
    budget = _budget(r, 32) // 8
    for sched in SCHEDS:
        rm = r_gcn_epoch(r, RFeat(r.n_rows, 32), ws, sched,
                         r_tiers.PAPER_GPU_SYSTEM, budget)
        pm = p_gcn_epoch(p, PFeat(p.n_rows, 32), ws, sched,
                         p_tiers.PAPER_GPU_SYSTEM, budget)
        _metrics_list_equal(pm.per_layer, rm.per_layer)
        assert ((pm.epoch_makespan_s, pm.total_transfer_bytes)
                == (rm.epoch_makespan_s, rm.total_transfer_bytes))
    assert pm.per_layer[0].oom and pm.epoch_makespan_s == float("inf")


# ---- execute ----------------------------------------------------------------


@pytest.mark.parametrize("sched", ["aires", "etc"])
def test_executed_epoch_matches_reference(small_graph, sched):
    """Forward and backward through the differentiable engine: the same
    modeled per-layer metrics over A and Aᵀ, and per layer, in layer
    order, the same streamed segments and wire bytes."""
    r, p = small_graph
    dims = [16, 16, 16, 8]
    ws = _weights(2, dims)
    h0 = np.random.default_rng(3).standard_normal(
        (r.n_rows, dims[0])).astype(np.float32)
    budget = _budget(r, 16)
    rm = r_gcn_epoch(r, h0, ws, sched, r_tiers.PAPER_GPU_SYSTEM, budget,
                     mode="execute", engine_config=RConfig(budget, bm=8, bk=8))
    pm = p_gcn_epoch(p, h0, ws, sched, p_tiers.PAPER_GPU_SYSTEM, budget,
                     mode="execute",
                     engine_config=PConfig(budget, bm=8, bk=8, device="cpu"))
    _metrics_list_equal(pm.per_layer, rm.per_layer)
    _metrics_list_equal(pm.per_layer_backward, rm.per_layer_backward)
    assert pm.epoch_makespan_s == rm.epoch_makespan_s
    assert pm.total_transfer_bytes == rm.total_transfer_bytes
    for direction in ("forward_stream", "backward_stream"):
        ps, rs = getattr(pm, direction), getattr(rm, direction)
        assert len(ps) == len(rs) == len(ws)
        for a_stats, b_stats in zip(ps, rs):
            for field in STREAM_FIELDS:
                assert getattr(a_stats, field) == getattr(b_stats, field), (
                    direction, field)
    assert min(s.segments for s in pm.forward_stream + pm.backward_stream) >= 2
    assert pm.wall_seconds > 0


# ---- the serving engine with passes and analysis ----------------------------


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("coalesce", [False, True])
def test_engine_with_passes_serves_in_reference_order(coalesce):
    """Two graphs, the later-registered one holding the earlier deadline,
    on one fixed clock: with the EDF pass both engines serve it first, and
    every BatchReport byte counter and output agrees."""
    g1 = _graph("socLJ1", 1e-4, 0)
    g2 = _graph("rUSA", 2e-5, 1)
    budget = max(_budget(g1[0], 64), _budget(g2[0], 64))
    rng = np.random.default_rng(4)
    feats = [rng.standard_normal((g[0].n_rows, 16)).astype(np.float32)
             for g in (g1, g1, g2)]
    w = [rng.standard_normal((16, 8)).astype(np.float32)]
    deadlines = [120.0, None, 30.0]
    graph_of = ["first", "first", "second"]
    out = {}
    for side in ("ref", "port"):
        passes = r_passes if side == "ref" else p_passes
        pset = [passes.ShardPlacementPass(), passes.EDFOrderingPass(
            clock=_Clock())]
        if coalesce:
            pset.insert(1, passes.TransferCoalescingPass(min_bytes=1 << 30))
        kw = dict(device_budget_bytes=budget, plan_passes=pset,
                  analyze_plans=True, clock=_Clock())
        eng = (RServingEngine(REngineConfig(**kw)) if side == "ref" else
               PServingEngine(PEngineConfig(**kw, device="cpu")))
        Req = RRequest if side == "ref" else PRequest
        eng.register_graph("first", g1[0] if side == "ref" else g1[1])
        eng.register_graph("second", g2[0] if side == "ref" else g2[1])
        reports = []
        for _ in range(2):
            for g, h, d in zip(graph_of, feats, deadlines):
                eng.submit(Req(g, h, w, deadline_s=d))
            reports.append(eng.run_batch())
        out[side] = reports
    for p_rep, r_rep in zip(out["port"], out["ref"]):
        for field in ("uploaded_bytes", "cache_hit_bytes", "promoted_bytes",
                      "segments_streamed", "aggregation_passes"):
            assert getattr(p_rep, field) == getattr(r_rep, field), field
        order = [sorted(rep.request_latency, key=lambda x: x.actual_s)
                 for rep in (p_rep, r_rep)]
        assert ([x.request_id % 3 for x in order[0]]
                == [x.request_id % 3 for x in order[1]] == [2, 0, 1])
        assert ([x.predicted_s for x in p_rep.request_latency]
                == pytest.approx([x.predicted_s
                                  for x in r_rep.request_latency]))
        for pr, rr in zip(p_rep.results, r_rep.results):
            np.testing.assert_allclose(pr.output, rr.output, atol=1e-4,
                                       rtol=1e-5)
