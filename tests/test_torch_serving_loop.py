"""The continuous-batching loop of the port against the JAX package's, on
the reference tests' fixtures (socLJ1 1e-4 seed 0, rUSA 2e-5 seed 1).

Each test builds both packages' engines from the same CSR, each on its own
`VirtualClock`; the reference streams on the CPU as its own tests run it
(Pallas in interpret mode), the port with `device="cpu"`. Held equal: the
seeded traces, the served / on-time / expired / rejected ids, the event
order, every byte counter, `groups_served` and `estimate_group_cost`.
Virtual stamps and latencies within 1e-12 relative (ROADMAP queue 3 R1:
plain float sums may differ by one ulp). Outputs within the reference
test's own atol of 1e-4. Then the reference tests' behavioural checks, on
the port alone, and `serve_continuous` at its defaults."""
import dataclasses
import math

import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import numpy as np
import pytest

from repro.core import EDFOrderingPass as REDF
from repro.core import plan_memory_dense_features
from repro.data import (
    SUITESPARSE_SPECS, generate_graph, normalized_adjacency, scaled_spec,
)
from repro.launch.serve import serve_continuous as r_serve_continuous
import repro.runtime as R

import repro_torch.core.analysis as p_analysis
import repro_torch.runtime as P
from repro_torch.core import CostCalibrator
from repro_torch.core import EDFOrderingPass as PEDF
from repro_torch.launch.serve import serve_continuous as p_serve_continuous
from repro_torch.sparse import CSR, spgemm_csr_dense

STAT_FIELDS = ("uploaded_bytes", "cache_hit_bytes", "promoted_bytes",
               "ici_bytes", "directory_hit_bytes", "segments_streamed",
               "aggregation_passes")
STAMP_REL = 1e-12
OUT_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _analyze_port_plans():
    """The port's static analyzer is on for every plan these tests stream,
    as tests/conftest.py turns on the reference's; restored after."""
    previous = p_analysis.set_default_analyze(True)
    yield
    p_analysis.set_default_analyze(previous)


def _pair(name, scale, seed):
    r = normalized_adjacency(generate_graph(
        scaled_spec(SUITESPARSE_SPECS[name], scale), seed=seed))
    return r, CSR(r.indptr.copy(), r.indices.copy(), r.data.copy(), r.shape)


@pytest.fixture(scope="module")
def graphs():
    """name -> (reference CSR, port CSR): the reference tests' two graphs."""
    return {"g": _pair("socLJ1", 1e-4, 0), "road": _pair("rUSA", 2e-5, 1)}


def _budget(graphs):
    return max(
        int(est.m_b + est.m_c + 0.6 * r.nbytes())
        for r, _ in graphs.values()
        for est in [plan_memory_dense_features(r, r.n_rows, 64,
                                               float("inf"))])


def _engine(mod, graphs, names=None, **overrides):
    """One package's engine on a fresh VirtualClock, with an EDF pass on
    that clock, `names` (default: every graph) registered."""
    port = mod is P
    clock = mod.VirtualClock()
    cfg = dict(device_budget_bytes=_budget(graphs), clock=clock,
               plan_passes=[(PEDF if port else REDF)(clock=clock)])
    if port:
        cfg["device"] = "cpu"
    cfg.update(overrides)
    eng = mod.ServingEngine(mod.EngineConfig(**cfg))
    for name in names or graphs:
        eng.register_graph(name, graphs[name][int(port)])
    return eng


def _engines(graphs, **overrides):
    """(reference engine, port engine) over both graphs."""
    return tuple(_engine(mod, graphs, **overrides) for mod in (R, P))


def _feats(rng, a, width):
    return rng.standard_normal((a.n_rows, width)).astype(np.float32)


def _workload(graphs, widths, seed=10, hidden=8):
    """One make_request per package over the same arrays (the reference
    tests' `_make_workload`)."""
    rng = np.random.default_rng(seed)
    feats = {(n, w): _feats(rng, pair[0], w)
             for n, pair in graphs.items() for w in widths}
    weights = {w: rng.standard_normal((w, hidden)).astype(np.float32)
               for w in widths}

    def maker(mod):
        def make_request(arr):
            return mod.InferenceRequest(
                arr.graph, feats[(arr.graph, arr.feature_dim)],
                [weights[arr.feature_dim]], deadline_s=arr.deadline_s)
        return make_request

    return maker(R), maker(P)


def _close(p, r):
    return math.isclose(p, r, rel_tol=STAMP_REL, abs_tol=0.0)


def _same_report(p, r):
    """Two ServeReports: equal ids, order, verdicts and counters; stamps
    within STAMP_REL."""
    assert [(e.request_id, e.graph) for e in p.events] == [
        (e.request_id, e.graph) for e in r.events]
    for pe, re_ in zip(p.events, r.events):
        for f in ("submitted_s", "started_s", "finished_s", "predicted_s",
                  "latency_s"):
            assert _close(getattr(pe, f), getattr(re_, f)), (f, pe, re_)
        assert pe.deadline_s == re_.deadline_s or _close(pe.deadline_s,
                                                         re_.deadline_s)
        assert pe.on_time == re_.on_time
    for kind in ("expired", "rejected"):
        assert [(v.request_id, v.graph, v.reason) for v in getattr(p, kind)
                ] == [(v.request_id, v.graph, v.reason)
                      for v in getattr(r, kind)], kind
    for f in STAT_FIELDS:
        assert getattr(p.stats, f) == getattr(r.stats, f), f
    assert (p.served, p.on_time, p.deadline_misses, p.offered,
            p.groups_served) == (r.served, r.on_time, r.deadline_misses,
                                 r.offered, r.groups_served)
    assert _close(p.makespan_s, r.makespan_s)


def _same_summary(p, r):
    assert p.keys() == r.keys()
    for k, rv in r.items():
        pv = p[k]
        if isinstance(rv, float):
            assert _close(pv, rv), (k, pv, rv)
        else:
            assert pv == rv, (k, pv, rv)


# ---- the clock and the traces ---------------------------------------------

def test_virtual_clock_is_monotonic():
    clock = P.VirtualClock(1.0)
    assert clock() == 1.0
    clock.advance(0.5)
    assert clock() == 1.5
    clock.advance_to(1.5)            # no-op advance is fine
    with pytest.raises(ValueError):
        clock.advance_to(1.0)
    with pytest.raises(ValueError):
        clock.advance(-0.1)
    assert clock() == 1.5


@pytest.mark.parametrize("feature_dim", [16, (16, 32, 48)])
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("kind", ["poisson", "bursty"])
def test_traces_equal_reference(kind, seed, feature_dim):
    """Same seed, same arrival list: times, graphs, widths, deadlines."""
    kw = dict(n=40, graphs=["g", "road"], seed=seed,
              feature_dim=feature_dim, n_layers=2, deadline_s=0.25)
    if kind == "poisson":
        p, r = P.poisson_trace(rate_hz=7.0, **kw), R.poisson_trace(
            rate_hz=7.0, **kw)
    else:
        kw.update(burst_shape=0.25, episode=12)
        p, r = P.bursty_trace(base_rate_hz=7.0, **kw), R.bursty_trace(
            base_rate_hz=7.0, **kw)
    assert [dataclasses.astuple(a) for a in p] == [
        dataclasses.astuple(a) for a in r]
    assert all(isinstance(a, P.Arrival) for a in p)


# ---- replays through both packages ----------------------------------------

def _unit(eng, make_request, mod):
    """Modeled cost of one width-32 request on the costlier graph (socLJ1
    here, as the reference tests' `_unit` picks it), so deadlines of three
    units leave both graphs feasible."""
    return max(eng.estimate_request_cost(make_request(mod.Arrival(
        0.0, name, 32))) for name in ("g", "road"))


def _trace(mod, kind, graphs, unit, seed):
    """The reference tests' trace shapes, in units of one modeled pass."""
    widths = (16, 32, 48)
    if kind == "poisson":
        return mod.poisson_trace(n=30, rate_hz=2.5 / unit,
                                 graphs=sorted(graphs), seed=seed,
                                 feature_dim=widths, deadline_s=3.0 * unit)
    return mod.bursty_trace(n=36, base_rate_hz=3.5 / unit,
                            graphs=sorted(graphs), seed=seed,
                            feature_dim=widths, deadline_s=3.0 * unit,
                            burst_shape=0.25, episode=12)


@pytest.mark.parametrize("mode", ["continuous", "round"])
@pytest.mark.parametrize("kind,seed,cap", [
    ("poisson", 1, None), ("poisson", 1, 4.0),
    ("bursty", 2, None), ("bursty", 2, 4.0)])
def test_replay_matches_reference(graphs, kind, seed, cap, mode):
    """The same trace through `replay_continuous` or `replay_round` of
    each package: equal ids, order, verdicts and bytes, stamps within
    1e-12 relative, equal `summarize` dicts. The seeds give requests that
    expire on the queue; `cap` (max_queue_cost_s, in units) adds
    queue-full rejections."""
    r_make, p_make = _workload(graphs, (16, 32, 48))
    r_probe, p_probe = _engines(graphs)
    unit = _unit(r_probe, r_make, R)
    assert _close(_unit(p_probe, p_make, P), unit)
    r_trace, p_trace = (_trace(mod, kind, graphs, unit, seed=seed)
                        for mod in (R, P))
    kw = {} if cap is None else {"max_queue_cost_s": cap * unit}
    r_eng, p_eng = _engines(graphs, **kw)
    if mode == "continuous":
        r_rep = R.replay_continuous(R.ContinuousServer(r_eng), r_trace,
                                    r_make)
        p_rep = P.replay_continuous(P.ContinuousServer(p_eng), p_trace,
                                    p_make)
    else:
        r_rep = R.replay_round(r_eng, r_trace, r_make)
        p_rep = P.replay_round(p_eng, p_trace, p_make)
    assert p_rep.offered == len(r_trace)
    assert p_rep.served > 0 and p_rep.groups_served > 1
    _same_report(p_rep, r_rep)
    _same_summary(P.summarize(p_rep), R.summarize(r_rep))


def test_step_by_step_outputs_match_reference(graphs):
    """A mixed-width, mixed-graph queue drained one group per step: each
    step serves the same graph and requests in both packages, with the
    same stamps and bytes, and outputs within 1e-4."""
    rng = np.random.default_rng(4)
    r_eng, p_eng = _engines(graphs)
    r_srv, p_srv = R.ContinuousServer(r_eng), P.ContinuousServer(p_eng)
    assert p_srv.step() is None and r_srv.step() is None
    w = {f: rng.standard_normal((f, 8)).astype(np.float32)
         for f in (16, 40)}
    for i, (name, f) in enumerate([("g", 40), ("road", 16), ("g", 16),
                                   ("g", 40), ("road", 40), ("g", 16)]):
        h = _feats(rng, graphs[name][0], f)
        dl = None if i % 2 else 1.0
        rid_r = r_srv.submit(R.InferenceRequest(name, h, [w[f]],
                                                deadline_s=dl), at=0.0)
        rid_p = p_srv.submit(P.InferenceRequest(name, h, [w[f]],
                                                deadline_s=dl), at=0.0)
        assert int(rid_p) == int(rid_r)
    r_steps, p_steps = r_srv.drain(), p_srv.drain()
    assert len(p_steps) == len(r_steps) >= 3
    for ps, rs in zip(p_steps, r_steps):
        assert ps.graph == rs.graph
        assert [e.request_id for e in ps.events] == [
            e.request_id for e in rs.events]
        assert _close(ps.cost_s, rs.cost_s)
        assert _close(ps.finished_s, rs.finished_s)
        for f in STAT_FIELDS:
            assert getattr(ps.stats, f) == getattr(rs.stats, f), f
        for pr, rr in zip(ps.results, rs.results):
            assert pr.request_id == rr.request_id
            np.testing.assert_allclose(pr.output, np.asarray(rr.output),
                                       atol=OUT_ATOL)
    _same_report(p_srv.report(), r_srv.report())


def test_single_burst_byte_accounting_matches_round(graphs):
    """One burst of uniform-width no-deadline requests: both of the port's
    arms form the same groups, so their bytes agree exactly, and equal the
    reference's."""
    r_make, p_make = _workload(graphs, (16,), seed=11)
    traces = {mod: mod.poisson_trace(n=12, rate_hz=1e9,
                                     graphs=sorted(graphs), seed=2,
                                     feature_dim=16) for mod in (R, P)}
    reps = {}
    for mod, make in ((R, r_make), (P, p_make)):
        reps[mod, "round"] = mod.replay_round(_engine(mod, graphs),
                                              traces[mod], make)
        reps[mod, "cont"] = mod.replay_continuous(
            mod.ContinuousServer(_engine(mod, graphs)), traces[mod], make)
    p_round, p_cont = reps[P, "round"], reps[P, "cont"]
    assert p_round.served == p_cont.served == 12
    for f in ("uploaded_bytes", "cache_hit_bytes", "aggregation_passes"):
        assert getattr(p_cont.stats, f) == getattr(p_round.stats, f), f
    _same_report(p_round, reps[R, "round"])
    _same_report(p_cont, reps[R, "cont"])


@pytest.mark.parametrize("widths", [
    [40, 40], [16, 40, 16], [64], [70], [16, 16, 16, 16, 16], [48, 24, 8]])
def test_estimate_group_cost_straddling_cap_matches_reference(graphs,
                                                              widths):
    """Groups whose summed widths straddle max_batch_features (64), with
    two- and three-layer requests mixed: the same greedy chunking, the same
    cost to the last bit."""
    rng = np.random.default_rng(sum(widths))
    r_eng, p_eng = _engines(graphs)
    a = graphs["g"][0]
    r_group, p_group = [], []
    for i, f in enumerate(widths):
        hidden = [f, 24, 8][:2 + i % 2]
        ws = [rng.standard_normal((hidden[k], hidden[k + 1]))
              .astype(np.float32) for k in range(len(hidden) - 1)]
        h = _feats(rng, a, f)
        r_group.append(R.InferenceRequest("g", h, ws))
        p_group.append(P.InferenceRequest("g", h, ws))
    p_cost = p_eng.estimate_group_cost("g", p_group)
    assert p_cost == r_eng.estimate_group_cost("g", r_group)
    assert p_cost > 0.0
    assert p_eng.estimate_group_cost("g", []) == 0.0


# ---- the reference tests' behavioural checks, on the port -----------------

def _port_engine(graphs, names=("g",), **overrides):
    return _engine(P, graphs, names=names, **overrides)


def test_attach_requires_clean_queue_on_foreign_clock(graphs):
    """An engine that already queued work on another clock holds stamps
    the loop's virtual timeline cannot interpret."""
    a = graphs["g"][1]
    eng = P.ServingEngine(P.EngineConfig(
        device_budget_bytes=_budget(graphs), device="cpu"))
    eng.register_graph("g", a)
    eng.submit(P.InferenceRequest(
        "g", _feats(np.random.default_rng(0), a, 8)))
    with pytest.raises(ValueError, match="different.*clock"):
        P.ContinuousServer(eng)


def test_continuous_outputs_match_dense_reference(graphs):
    rng = np.random.default_rng(4)
    a = graphs["g"][1]
    server = P.ContinuousServer(_port_engine(graphs))
    assert server.step() is None                 # idle loop is a no-op
    hs = [_feats(rng, a, 16) for _ in range(3)]
    w = rng.standard_normal((16, 8)).astype(np.float32)
    rids = [int(server.submit(P.InferenceRequest("g", h, [w]))) for h in hs]
    steps = server.drain()
    outs = {r.request_id: r.output for s in steps for r in s.results}
    assert sorted(outs) == sorted(rids)
    for rid, h in zip(rids, hs):
        np.testing.assert_allclose(
            outs[rid], spgemm_csr_dense(a, h) @ w, atol=OUT_ATOL)
    report = server.report()
    assert report.served == 3 and report.on_time == 3
    assert report.makespan_s > 0.0               # modeled costs moved time


def test_midstream_submit_joins_next_forming_group(graphs):
    """Cap 64: two width-40 requests form separate groups; a width-16
    request submitted after the first step rides the second group."""
    rng = np.random.default_rng(5)
    a = graphs["g"][1]
    server = P.ContinuousServer(_port_engine(graphs))
    r1 = int(server.submit(P.InferenceRequest("g", _feats(rng, a, 40))))
    r2 = int(server.submit(P.InferenceRequest("g", _feats(rng, a, 40))))
    s1 = server.step()
    assert [e.request_id for e in s1.events] == [r1]
    r3 = int(server.submit(P.InferenceRequest("g", _feats(rng, a, 16))))
    s2 = server.step()
    assert sorted(e.request_id for e in s2.events) == sorted([r2, r3])
    assert server.step() is None


def test_backpressure_prices_remaining_queue(graphs):
    """max_queue_cost_s admits again as soon as a step drains a group."""
    rng = np.random.default_rng(6)
    a = graphs["g"][1]
    probe = P.ContinuousServer(_port_engine(graphs))
    est = probe.engine.estimate_request_cost(
        P.InferenceRequest("g", _feats(rng, a, 48)))
    server = P.ContinuousServer(_port_engine(
        graphs, max_queue_cost_s=2.5 * est))
    server.submit(P.InferenceRequest("g", _feats(rng, a, 48)))
    server.submit(P.InferenceRequest("g", _feats(rng, a, 48)))
    with pytest.raises(P.AdmissionError):        # 3*est > 2.5*est
        server.submit(P.InferenceRequest("g", _feats(rng, a, 48)))
    assert server.step() is not None             # one width-48 group leaves
    rid = server.submit(P.InferenceRequest("g", _feats(rng, a, 48)))
    assert int(rid) >= 0
    server.drain()
    report = server.report()
    assert report.served == 3
    assert [v.reason for v in report.rejected] == ["queue-full"]


def test_edf_serves_urgent_group_before_loose_backlog(graphs):
    """A tight-deadline arrival on one graph overtakes an earlier
    loose-deadline backlog on another."""
    rng = np.random.default_rng(7)
    g, road = graphs["g"][1], graphs["road"][1]
    server = P.ContinuousServer(_port_engine(graphs, names=("g", "road")))
    est = server.engine.estimate_request_cost(
        P.InferenceRequest("road", _feats(rng, road, 16)))
    server.submit(P.InferenceRequest("g", _feats(rng, g, 16),
                                     deadline_s=100.0))
    server.submit(P.InferenceRequest("g", _feats(rng, g, 16),
                                     deadline_s=100.0))
    server.submit(P.InferenceRequest("road", _feats(rng, road, 16),
                                     deadline_s=5.0 * est))
    step = server.step()
    assert step.graph == "road"
    server.drain()
    assert server.report().on_time == 3


def test_step_feeds_calibrator(graphs):
    """With a calibrator, every step feeds its group's latencies (the
    continuous loop never runs run_batch, which feeds them otherwise)."""
    rng = np.random.default_rng(8)
    a = graphs["g"][1]
    cal = CostCalibrator()
    server = P.ContinuousServer(_port_engine(graphs, calibrator=cal))
    for _ in range(3):
        server.submit(P.InferenceRequest("g", _feats(rng, a, 40)))
    steps = server.drain()
    assert len(steps) == 3
    assert cal.generation == 3


@pytest.mark.parametrize("seed", [0, 1])
def test_continuous_on_time_never_below_round(graphs, seed):
    """On the same bursty trace, admitting between every group serves at
    least as many requests on time as admitting between full drains."""
    _, p_make = _workload(graphs, (16, 32, 48))
    unit = _unit(_port_engine(graphs, names=("g", "road")), p_make, P)
    trace = _trace(P, "bursty", graphs, unit, seed)
    s_round = P.summarize(P.replay_round(
        _port_engine(graphs, names=("g", "road")), trace, p_make))
    s_cont = P.summarize(P.replay_continuous(P.ContinuousServer(
        _port_engine(graphs, names=("g", "road"))), trace, p_make))
    assert s_round["offered"] == s_cont["offered"] == 36
    assert s_cont["on_time"] >= s_round["on_time"]


# ---- the launcher ----------------------------------------------------------

def test_serve_continuous_defaults_match_reference():
    """`serve_continuous(device="cpu")` at the reference's defaults: the
    same report and summary."""
    p_rep, p_sum = p_serve_continuous(device="cpu")
    r_rep, r_sum = r_serve_continuous()
    _same_report(p_rep, r_rep)
    _same_summary(p_sum, r_sum)
    assert p_sum["offered"] == 24


def test_continuous_cli_prints_summary(capsys):
    from repro_torch.launch.serve import main
    main(["--mode", "continuous", "--trace", "bursty", "--requests", "12",
          "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("bursty trace: ")
    assert "/12 served in " in out and out.rstrip().endswith("on cpu")
