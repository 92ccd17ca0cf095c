"""The slice end to end: the port's `ServingEngine` (device="cpu") against
the JAX package's, on identical graphs, configs and requests.

Outputs agree within f32 summation order (atol 1e-4, rtol 1e-5); the byte
fields of every `BatchReport` are exactly equal; predicted latencies agree
to 1e-12 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.gcn_paper as r_cfgs
import repro.models.gcn as r_gcn
from repro.core import AiresConfig as RConfig, AiresSpGEMM as RSpGEMM
from repro.core.memory_model import plan_memory_dense_features
from repro.data import (
    SUITESPARSE_SPECS, generate_graph, normalized_adjacency, scaled_spec,
)
from repro.launch.serve import serve_gcn as r_serve_gcn
from repro.runtime import (
    AdmissionError as RAdmissionError, EngineConfig as REngineConfig,
    InferenceRequest as RRequest, ServingEngine as RServingEngine,
)

import repro_torch.configs.gcn_paper as p_cfgs
import repro_torch.models.gcn as p_gcn
from repro_torch.core import AiresConfig as PConfig, AiresSpGEMM as PSpGEMM
from repro_torch.launch.serve import serve_gcn as p_serve_gcn
from repro_torch.runtime import (
    AdmissionError as PAdmissionError, EngineConfig as PEngineConfig,
    InferenceRequest as PRequest, ServingEngine as PServingEngine,
)
from repro_torch.sparse import CSR, spgemm_csr_dense

BYTE_FIELDS = ("uploaded_bytes", "cache_hit_bytes", "promoted_bytes",
               "segments_streamed", "aggregation_passes")


def _port_csr(r):
    return CSR(r.indptr.copy(), r.indices.copy(), r.data.copy(), r.shape)


@pytest.fixture(scope="module")
def graphs():
    """Two small paper graphs (the reference engine tests' own), in the
    JAX package's CSR and the port's."""
    ref = {
        "lj": normalized_adjacency(generate_graph(
            scaled_spec(SUITESPARSE_SPECS["socLJ1"], 1e-4), seed=0)),
        "road": normalized_adjacency(generate_graph(
            scaled_spec(SUITESPARSE_SPECS["rUSA"], 2e-5), seed=1)),
    }
    budget = max(
        int(est.m_b + est.m_c + 0.6 * a.nbytes()) for a in ref.values()
        for est in [plan_memory_dense_features(a, a.n_rows, 64,
                                               float("inf"))])
    return ref, {k: _port_csr(a) for k, a in ref.items()}, budget


@pytest.fixture(scope="module")
def smoke_params():
    """gcn_paper.SMOKE weights from the JAX package's gcn_init, as numpy."""
    params = r_gcn.gcn_init(r_cfgs.SMOKE, jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in params.items()}


def _requests(graphs_ref, params, epoch, per_graph=3):
    """Identical request streams for both engines: SMOKE feature width,
    the SMOKE weight chain, one bare-aggregation request per graph."""
    rng = np.random.default_rng(100 + epoch)
    ws = [params["w0"], params["w1"]]
    out = []
    for name, a in graphs_ref.items():
        for j in range(per_graph):
            h = rng.standard_normal(
                (a.n_rows, r_cfgs.SMOKE.feature_dim)).astype(np.float32)
            out.append((name, h, ws if j < per_graph - 1 else []))
    return out


@pytest.mark.parametrize("cache", ["on", "off", "pressure"])
def test_serving_engine_matches_reference_over_two_epochs(graphs,
                                                          smoke_params,
                                                          cache):
    ref_graphs, port_graphs, budget = graphs
    kw = dict(device_budget_bytes=budget, max_batch_features=64,
              cache_enabled=cache != "off")
    if cache == "pressure":
        kw["cache_device_bytes"] = budget // 40
    r_eng = RServingEngine(REngineConfig(**kw))
    p_eng = PServingEngine(PEngineConfig(device="cpu", **kw))
    for name in ref_graphs:
        r_eng.register_graph(name, ref_graphs[name])
        p_eng.register_graph(name, port_graphs[name])
    port_w = p_gcn.params_from_numpy(smoke_params, "cpu")
    for k, v in smoke_params.items():
        np.testing.assert_array_equal(port_w[k].numpy(), v)

    reports = []
    for epoch in range(2):
        for name, h, ws in _requests(ref_graphs, smoke_params, epoch):
            r_eng.submit(RRequest(name, h, ws))
            p_eng.submit(PRequest(name, h, [w.numpy() for w in
                                            (port_w["w0"], port_w["w1"])]
                                  if ws else []))
        rr, pr = r_eng.run_batch(), p_eng.run_batch()
        reports.append(pr)
        for field in BYTE_FIELDS:
            assert getattr(pr, field) == getattr(rr, field), field
        assert [r.request_id for r in pr.results] == \
            [r.request_id for r in rr.results]
        for p_res, r_res in zip(pr.results, rr.results):
            assert p_res.output.shape == r_res.output.shape
            np.testing.assert_allclose(p_res.output, r_res.output,
                                       atol=1e-4, rtol=1e-5)
        for p_lat, r_lat in zip(pr.request_latency, rr.request_latency):
            assert p_lat.request_id == r_lat.request_id
            assert p_lat.predicted_s == pytest.approx(r_lat.predicted_s,
                                                      rel=1e-12)
    if cache == "off":
        assert p_eng.cache_stats() is None
        assert reports[1].uploaded_bytes == reports[0].uploaded_bytes
    else:
        assert reports[1].uploaded_bytes < reports[0].uploaded_bytes
        ps, rs = p_eng.cache_stats(), r_eng.cache_stats()
        for f in dataclasses.fields(ps):
            assert getattr(ps, f.name) == getattr(rs, f.name), f.name
        assert ({p.value: b for p, b in p_eng.tms.bytes_by_path().items()}
                == {p.value: b for p, b in r_eng.tms.bytes_by_path().items()})
        if cache == "pressure":
            assert ps.demoted_bytes > 0 and ps.host_hits > 0


def test_serve_gcn_matches_reference():
    p_summary, r_summary = {}, {}
    port = p_serve_gcn(scale=1e-4, summary_out=p_summary, device="cpu")
    ref = r_serve_gcn(scale=1e-4, summary_out=r_summary)
    assert p_summary == r_summary
    assert len(port) == len(ref) == 2
    for p_rep, r_rep in zip(port, ref):
        for field in BYTE_FIELDS:
            assert getattr(p_rep, field) == getattr(r_rep, field), field
        for p_res, r_res in zip(p_rep.results, r_rep.results):
            np.testing.assert_allclose(p_res.output, r_res.output,
                                       atol=1e-4, rtol=1e-5)
    assert port[1].cache_hit_bytes == port[0].uploaded_bytes > 0


@pytest.mark.parametrize("option", [{"autotune": True}])
def test_serve_gcn_refuses_unported_options(option):
    """The option the earlier slices refused is ported now: it runs, and
    the installed schedules and byte counters are the reference's. The
    name is the one it had while it checked the refusal, so that runs of
    the suite before and after compare test by test; it now checks that
    the option works."""
    p_summary, r_summary = {}, {}
    port = p_serve_gcn(device="cpu", summary_out=p_summary, **option)
    ref = r_serve_gcn(summary_out=r_summary, **option)
    assert p_summary == r_summary and p_summary["installed_schedules"]
    for p_rep, r_rep in zip(port, ref):
        for field in BYTE_FIELDS:
            assert getattr(p_rep, field) == getattr(r_rep, field), field


@pytest.mark.parametrize("option", [{"cache_shards": 2}, {"workers": 2},
                                    {"calibrate": True}])
def test_serve_gcn_option_matches_reference(option):
    """Each option the first slices refused now runs, with the reference's
    byte counters epoch by epoch (and worker by worker)."""
    p_summary, r_summary = {}, {}
    port = p_serve_gcn(scale=1e-4, summary_out=p_summary, device="cpu",
                       **option)
    ref = r_serve_gcn(scale=1e-4, summary_out=r_summary, **option)
    assert len(port) == len(ref) == 2
    fields = BYTE_FIELDS + ("ici_bytes", "directory_hit_bytes",
                            "duplicate_avoided_bytes")
    for p_epoch, r_epoch in zip(port, ref):
        p_reps = p_epoch if isinstance(p_epoch, list) else [p_epoch]
        r_reps = r_epoch if isinstance(r_epoch, list) else [r_epoch]
        assert len(p_reps) == len(r_reps)
        for p_rep, r_rep in zip(p_reps, r_reps):
            for field in fields:
                assert getattr(p_rep, field) == getattr(r_rep, field), field
            for p_res, r_res in zip(p_rep.results, r_rep.results):
                np.testing.assert_allclose(p_res.output, r_res.output,
                                           atol=1e-4, rtol=1e-5)
    assert len(p_summary["epoch_errors"]) == len(r_summary["epoch_errors"])


def test_admission_control_matches_reference(graphs):
    ref_graphs, port_graphs, budget = graphs
    a_r, a_p = ref_graphs["lj"], port_graphs["lj"]
    r_eng = RServingEngine(REngineConfig(device_budget_bytes=budget,
                                         max_queue_cost_s=1.0))
    p_eng = PServingEngine(PEngineConfig(device_budget_bytes=budget,
                                         max_queue_cost_s=1.0, device="cpu"))
    r_eng.register_graph("lj", a_r)
    p_eng.register_graph("lj", a_p)
    h = np.ones((a_r.n_rows, 16), np.float32)
    w = [np.ones((16, 8), np.float32), np.ones((8, 4), np.float32)]
    r_rid = r_eng.submit(RRequest("lj", h, w))
    p_rid = p_eng.submit(PRequest("lj", h, w))
    assert int(p_rid) == int(r_rid) == 0
    assert p_rid.estimated_cost_s == pytest.approx(r_rid.estimated_cost_s,
                                                   rel=1e-12)
    assert p_rid.estimated_cost_s > 0.0
    tight = p_rid.estimated_cost_s / 2
    with pytest.raises(RAdmissionError):
        r_eng.submit(RRequest("lj", h, w, deadline_s=tight))
    with pytest.raises(PAdmissionError) as err:
        p_eng.submit(PRequest("lj", h, w, deadline_s=tight))
    assert err.value.decision.reason == "deadline-infeasible"
    assert p_eng.queued_cost_s() == pytest.approx(r_eng.queued_cost_s(),
                                                  rel=1e-12)
    report = p_eng.run_batch()
    assert [d.reason for d in report.rejected] == ["deadline-infeasible"]
    with pytest.raises(KeyError):
        p_eng.submit(PRequest("nope", h, w))
    with pytest.raises(ValueError):
        p_eng.submit(PRequest("lj", h[:3], w))
    with pytest.raises(ValueError):
        p_eng.register_graph("lj", a_p)


def test_infer_keeps_other_callers_queue(graphs):
    ref_graphs, port_graphs, budget = graphs
    a_r, a_p = ref_graphs["road"], port_graphs["road"]
    r_eng = RServingEngine(REngineConfig(device_budget_bytes=budget))
    p_eng = PServingEngine(PEngineConfig(device_budget_bytes=budget,
                                         device="cpu"))
    r_eng.register_graph("g", a_r)
    p_eng.register_graph("g", a_p)
    rng = np.random.default_rng(7)
    h_queued = rng.standard_normal((a_r.n_rows, 8)).astype(np.float32)
    h_now = rng.standard_normal((a_r.n_rows, 8)).astype(np.float32)
    rid = p_eng.submit(PRequest("g", h_queued))
    out = p_eng.infer("g", h_now)
    np.testing.assert_allclose(out, r_eng.infer("g", h_now),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(out, spgemm_csr_dense(a_p, h_now), atol=1e-4)
    report = p_eng.run_batch()
    assert [r.request_id for r in report.results] == [rid]


@pytest.mark.parametrize("out_of_core", [False, True])
def test_gcn_forward_and_loss_match_reference(graphs, smoke_params,
                                              out_of_core):
    ref_graphs, port_graphs, budget = graphs
    a_r, a_p = ref_graphs["lj"], port_graphs["lj"]
    cfg_r = dataclasses.replace(r_cfgs.SMOKE, out_of_core=out_of_core)
    cfg_p = dataclasses.replace(p_cfgs.SMOKE, out_of_core=out_of_core)
    rng = np.random.default_rng(3)
    h = rng.standard_normal((a_r.n_rows, 32)).astype(np.float32)
    labels = rng.integers(0, cfg_r.n_classes, size=a_r.n_rows)
    params = p_gcn.params_from_numpy(smoke_params, "cpu")
    if out_of_core:
        r_arg, p_arg = a_r, a_p
        r_eng = RSpGEMM(RConfig(device_budget_bytes=budget, bm=8, bk=8))
        p_eng = PSpGEMM(PConfig(device_budget_bytes=budget, bm=8, bk=8,
                                device="cpu"))
    else:
        from repro.sparse import csr_to_dense
        dense = csr_to_dense(a_r)
        r_arg, p_arg = jnp.asarray(dense), torch.from_numpy(dense)
        r_eng = p_eng = None
    ref = np.asarray(r_gcn.gcn_forward(cfg_r, smoke_params, r_arg,
                                       jnp.asarray(h), r_eng))
    out = p_gcn.gcn_forward(cfg_p, params, p_arg, torch.from_numpy(h), p_eng)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-5)
    r_loss = float(r_gcn.gcn_loss(cfg_r, smoke_params, r_arg, jnp.asarray(h),
                                  jnp.asarray(labels), r_eng))
    p_loss = float(p_gcn.gcn_loss(cfg_p, params, p_arg, torch.from_numpy(h),
                                  torch.from_numpy(labels), p_eng))
    assert p_loss == pytest.approx(r_loss, rel=1e-5)


def test_gcn_init_paper_widths_are_seeded():
    cfg = p_cfgs.CONFIG
    p1 = p_gcn.gcn_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    p2 = p_gcn.gcn_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(p1[f"w{i}"].shape) for i in range(3)] == \
        [(256, 256), (256, 256), (256, 64)]
    for k in p1:
        torch.testing.assert_close(p1[k], p2[k], rtol=0, atol=0)
    assert all(float(p1[f"b{i}"].abs().sum()) == 0.0 for i in range(3))
    std = float(p1["w0"].std())
    assert 0.8 * 256 ** -0.5 < std < 1.2 * 256 ** -0.5


def test_cuda_request_without_a_card_raises(graphs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path cannot run")
    _, _, budget = graphs
    with pytest.raises(RuntimeError, match="cuda"):
        PServingEngine(PEngineConfig(device_budget_bytes=budget))
    with pytest.raises(RuntimeError, match="cuda"):
        PSpGEMM(PConfig(device_budget_bytes=budget))
