"""Sharded, multi-worker serving in the port against the JAX package: two
workers over four-shard caches sharing a cache directory, `serve_gcn` with
workers, shards, passes and calibration, the shard-placement pass, ring
topology charging, the shard lint rules and the cost probe's remote-shard
pricing. Byte counters, placements and findings must be equal; outputs
within 1e-5."""
import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.core.analysis as r_analysis
import repro.core.passes as r_passes
import repro.core.pipeline as r_pipe
import repro.io as r_io
import repro.io.tiers as r_tiers
from repro.core import SCHEDULERS as R_SCHEDULERS
from repro.core.memory_model import plan_memory_dense_features
from repro.data import (
    SUITESPARSE_SPECS, generate_graph, normalized_adjacency, scaled_spec,
)
from repro.launch.serve import serve_gcn as r_serve_gcn
from repro.runtime import (
    EngineConfig as REngineConfig, InferenceRequest as RRequest,
    ServingEngine as RServingEngine,
)

import repro_torch.core.analysis as p_analysis
import repro_torch.core.passes as p_passes
import repro_torch.core.pipeline as p_pipe
import repro_torch.io as p_io
import repro_torch.io.tiers as p_tiers
from repro_torch.core import SCHEDULERS as P_SCHEDULERS
from repro_torch.launch.serve import serve_gcn as p_serve_gcn
from repro_torch.runtime import (
    EngineConfig as PEngineConfig, InferenceRequest as PRequest,
    ServingEngine as PServingEngine,
)
from repro_torch.sparse import CSR

BYTE_FIELDS = ("uploaded_bytes", "cache_hit_bytes", "promoted_bytes",
               "segments_streamed", "aggregation_passes", "ici_bytes",
               "directory_hit_bytes", "duplicate_avoided_bytes")
SIDES = {"ref": (r_pipe, r_tiers, r_passes, r_io, r_analysis),
         "port": (p_pipe, p_tiers, p_passes, p_io, p_analysis)}


@pytest.fixture(autouse=True)
def _analyze_port_plans():
    """The port's static analyzer is on for every plan these tests
    interpret or stream, as the reference suite's is; restored after."""
    previous = p_analysis.set_default_analyze(True)
    yield
    p_analysis.set_default_analyze(previous)


@pytest.fixture(scope="module")
def graph():
    """The reference engine tests' quickstart graph, in both packages."""
    r = normalized_adjacency(generate_graph(
        scaled_spec(SUITESPARSE_SPECS["socLJ1"], 1e-4), seed=0))
    p = CSR(r.indptr.copy(), r.indices.copy(), r.data.copy(), r.shape)
    est = plan_memory_dense_features(r, r.n_rows, 64, float("inf"))
    return p, r, int(est.m_b + est.m_c + 0.6 * r.nbytes())


def _reports_equal(p_reps, r_reps, atol=1e-5):
    for p_rep, r_rep in zip(p_reps, r_reps, strict=True):
        for f in BYTE_FIELDS:
            assert getattr(p_rep, f) == getattr(r_rep, f), f
        for p_res, r_res in zip(p_rep.results, r_rep.results, strict=True):
            np.testing.assert_allclose(p_res.output, r_res.output,
                                       atol=atol, rtol=1e-5)


# ---- the engine ------------------------------------------------------------


@pytest.mark.parametrize("placement", [False, True])
def test_two_worker_four_shard_warm_epoch_matches_reference(graph,
                                                             placement):
    """The reference's acceptance scenario (tests/test_engine.py): four
    cache shards, two workers sharing a `CacheDirectory`, a device tier
    half the plan's wire bytes; with and without the placement pass."""
    p_a, r_a, budget = graph
    rng = np.random.default_rng(11)
    h = rng.standard_normal((r_a.n_rows, 32)).astype(np.float32)
    w = [rng.standard_normal((32, 16)).astype(np.float32)]
    probe = RServingEngine(REngineConfig(device_budget_bytes=budget,
                                         max_batch_features=64))
    probe.register_graph("lj", r_a)
    probe.infer("lj", h)
    wire = probe.cache_stats().hit_bytes + probe.cache_stats().miss_bytes

    def workers(side):
        directory = (p_io if side == "port" else r_io).CacheDirectory()
        out = []
        for wid in (0, 1):
            kw = dict(device_budget_bytes=budget,
                      cache_device_bytes=max(4, wire // 2), cache_shards=4,
                      worker_id=wid, max_batch_features=64)
            if placement:
                kw["plan_passes"] = [SIDES[side][2].ShardPlacementPass()]
            if side == "port":
                eng = PServingEngine(PEngineConfig(device="cpu", **kw),
                                     directory=directory)
                eng.register_graph("lj", p_a)
            else:
                eng = RServingEngine(REngineConfig(**kw), directory=directory)
                eng.register_graph("lj", r_a)
            out.append(eng)
        return out

    p_w, r_w = workers("port"), workers("ref")
    assert isinstance(p_w[0].cache, p_io.ShardedSegmentCache)
    p_reps, r_reps = [], []
    for _ in range(2):
        for pe, re in zip(p_w, r_w):
            pe.submit(PRequest("lj", h, w))
            re.submit(RRequest("lj", h, w))
            p_reps.append(pe.run_batch())
            r_reps.append(re.run_batch())
    _reports_equal(p_reps, r_reps)
    assert p_reps[0].uploaded_bytes > 0
    assert sum(r.duplicate_avoided_bytes for r in p_reps) > 0
    for rep in p_reps[2:]:
        assert rep.uploaded_bytes == 0 and rep.cache_hit_bytes == wire
    for pe, re in zip(p_w, r_w):
        ps, rs = pe.cache_stats(), re.cache_stats()
        for f in ("remote_hits", "ici_bytes", "directory_hits",
                  "directory_hit_bytes", "duplicate_avoided_bytes",
                  "demoted_bytes", "promoted_bytes", "hit_bytes"):
            assert getattr(ps, f) == getattr(rs, f), f
        assert ({p.value: b for p, b in pe.tms.bytes_by_path().items()}
                == {p.value: b for p, b in re.tms.bytes_by_path().items()})
    if not placement:
        assert all(rep.ici_bytes > 0 for rep in p_reps[2:])


def test_engine_rejects_contradictions(graph):
    _, _, budget = graph
    cfg = PEngineConfig(device_budget_bytes=budget, device="cpu",
                        cache_enabled=False)
    with pytest.raises(ValueError, match="mesh"):
        PServingEngine(cfg, mesh=object())
    directory = p_io.CacheDirectory()
    PServingEngine(PEngineConfig(device_budget_bytes=budget, device="cpu"),
                   directory=directory)
    with pytest.raises(ValueError, match="already claimed"):
        PServingEngine(PEngineConfig(device_budget_bytes=budget,
                                     device="cpu"), directory=directory)


@pytest.mark.parametrize("workers,shards,calibrate,passes", [
    (2, 4, True, True), (2, 1, False, False), (1, 4, False, True),
])
def test_serve_gcn_sharded_workers_match_reference(workers, shards,
                                                   calibrate, passes):
    p_summary, r_summary = {}, {}
    kw = dict(scale=1e-4, workers=workers, cache_shards=shards,
              calibrate=calibrate, passes=passes)
    port = p_serve_gcn(summary_out=p_summary, device="cpu", **kw)
    ref = r_serve_gcn(summary_out=r_summary, **kw)
    assert len(port) == len(ref) == 2
    for p_epoch, r_epoch in zip(port, ref):
        if workers == 1:
            p_epoch, r_epoch = [p_epoch], [r_epoch]
        assert len(p_epoch) == len(r_epoch) == workers
        _reports_equal(p_epoch, r_epoch, atol=1e-4)
    assert len(p_summary["epoch_errors"]) == len(r_summary["epoch_errors"])
    assert p_summary["installed_schedules"] == r_summary[
        "installed_schedules"] == {}
    if workers > 1:
        assert sum(r.directory_hit_bytes for r in port[0]) > 0


# ---- the shard-placement pass ----------------------------------------------


def _probe_plan(side, keys, nbytes):
    pipe, tiers = SIDES[side][0], SIDES[side][1]
    plan = pipe.PipelinePlan(scheduler="t")
    plan.phases = [pipe.PhaseSpec("p")]
    for k in keys:
        miss = pipe.TransferOp(tiers.Path.DMA, tiers.MemoryTier.HOST,
                               tiers.MemoryTier.DEVICE, nbytes,
                               tag="phaseII/seg")
        plan.add(pipe.CacheProbeOp(k, nbytes, miss, value=True), "p",
                 pipe.LANE_DMA)
    return plan


def _cache(side, **kw):
    io = SIDES[side][3]
    if side == "port":
        kw["device"] = "cpu"
    if "topology" in kw:
        kw["topology"] = SIDES[side][1].ICITopology(kw["topology"])
    return io.ShardedSegmentCache(**kw)


def _placed(plan, side):
    pipe = SIDES[side][0]
    return [b.op.place_shard for b in plan.ops
            if isinstance(b.op, pipe.CacheProbeOp)]


def _placement_matches(seed):
    """Random shard counts, budgets, brick sizes and topologies: the port
    places every probe where the reference does, and both interpret the
    cold and warm runs to the same metrics; placement never raises the
    warm run's ICI bytes."""
    rng = np.random.default_rng(seed)
    n_shards = int(rng.integers(2, 6))
    nbytes = int(rng.integers(1, 4096))
    n_keys = int(rng.integers(1, 24))
    budget = int(rng.integers(n_shards, n_shards * n_keys * 4096 + 1))
    topology = "ring" if rng.integers(0, 2) else "all_to_all"
    warm_ici = {}
    for side in SIDES:
        pipe, tiers, passes, io, _ = SIDES[side]
        keys = [io.SegmentKey(f"g{seed}", i, "bricks", (i,))
                for i in range(n_keys)]
        for on in (False, True):
            cache = _cache(side, device_budget_bytes=budget,
                           n_shards=n_shards, topology=topology)
            pp = passes.PassPipeline([passes.ShardPlacementPass()]
                                     if on else [])
            plan, _ = pp.apply(_probe_plan(side, keys, nbytes),
                               segment_cache=cache)
            warm_ici[side, on, "placed"] = _placed(plan, side)
            pipe.CostInterpreter(tiers.PAPER_GPU_SYSTEM,
                                 segment_cache=cache).run(plan)
            m, _ = pipe.CostInterpreter(tiers.PAPER_GPU_SYSTEM,
                                        segment_cache=cache).run(plan)
            warm_ici[side, on] = (m.bytes_by_path.get("ici", 0),
                                  m.cache_hit_bytes, m.makespan_s)
    for on in (False, True):
        assert warm_ici["port", on] == warm_ici["ref", on]
        assert (warm_ici["port", on, "placed"]
                == warm_ici["ref", on, "placed"])
    assert warm_ici["port", True][0] <= warm_ici["port", False][0]


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(st.integers(0, 2**32 - 1))
def test_placement_matches_reference_and_never_increases_ici(seed):
    _placement_matches(seed)


@pytest.mark.parametrize("case", ["local", "device_first", "host_pressure",
                                  "resident", "estimate"])
def test_placement_rules_match_reference(case):
    """The reference's placement cases (tests/test_passes.py): local
    pinning, device tiers before host with a near fallback on a ring, the
    local host under global device pressure, resident bricks left alone,
    and estimates that price the rewritten plan without touching the
    cache."""
    def run(side):
        pipe, tiers, passes, io, _ = SIDES[side]
        key = lambda i: io.SegmentKey("g", i, "bricks", (i,))  # noqa: E731
        pp = passes.PassPipeline([passes.ShardPlacementPass()])
        out = []
        if case == "local":
            cache = _cache(side, device_budget_bytes=1 << 20, n_shards=4)
            keys = [key(i) for i in range(8)]
            plan, _ = pp.apply(_probe_plan(side, keys, 256),
                               segment_cache=cache)
            out.append(_placed(plan, side))
            pipe.CostInterpreter(tiers.PAPER_GPU_SYSTEM,
                                 segment_cache=cache).run(plan)
            out.append([cache.owner_of(k) for k in keys])
            m, _ = pipe.CostInterpreter(tiers.PAPER_GPU_SYSTEM,
                                        segment_cache=cache).run(plan)
            out.append((m.bytes_by_path.get("ici", 0), m.cache_hit_bytes))
        elif case == "device_first":
            n = 8
            cache = _cache(side, device_budget_bytes=n * 512,
                           host_budget_bytes=n * 512, n_shards=n,
                           topology="ring")
            owners = {}
            for i in range(512):
                owners.setdefault(io.shard_of(key(i), n), []).append(key(i))
            owner = next(s for s in owners
                         if cache.ici_hops(s) >= 2 and len(owners[s]) >= 4)
            plan, _ = pp.apply(_probe_plan(side, owners[owner][:4], 400),
                               segment_cache=cache)
            out.append((owner, _placed(plan, side)))
        elif case == "host_pressure":
            cache = _cache(side, device_budget_bytes=4 * 64, n_shards=4)
            k = next(key(i) for i in range(64) if io.shard_of(key(i), 4))
            plan, _ = pp.apply(_probe_plan(side, [k], 4096),
                               segment_cache=cache)
            out.append(_placed(plan, side))
        elif case == "resident":
            cache = _cache(side, device_budget_bytes=1 << 20, n_shards=4)
            k = next(key(i) for i in range(64) if io.shard_of(key(i), 4))
            cache.put(k, "brick", 256)
            plan, _ = pp.apply(_probe_plan(side, [k], 256),
                               segment_cache=cache)
            out.append(_placed(plan, side))
        else:
            cache = _cache(side, device_budget_bytes=1 << 20, n_shards=4)
            plan = _probe_plan(side, [key(i) for i in range(8)], 256)
            out.append(plan.estimate(tiers.PAPER_GPU_SYSTEM,
                                     segment_cache=cache)
                       .bytes_by_path.get("ici", 0))
            plan, _ = pp.apply(plan, segment_cache=cache)
            out.append(plan.estimate(tiers.PAPER_GPU_SYSTEM,
                                     segment_cache=cache)
                       .bytes_by_path.get("ici", 0))
            out.append(len(cache))
        return out
    port, ref = run("port"), run("ref")
    assert port == ref
    if case == "local":
        assert port[2] == (0, 8 * 256)
    elif case == "estimate":
        assert port[0] > 0 and port[1:] == [0, 0]


def test_scheduler_warm_epoch_ici_lower_with_placement(graph):
    """The scheduler with a four-shard cache, cold then warm, with and
    without the placement pass: equal metrics on both packages, and the
    pass lowers the warm run's ICI bytes."""
    p_a, r_a, budget = graph
    feat = np.zeros((r_a.n_rows, 16), np.float32)
    warm = {}
    for side, scheds, a in (("port", P_SCHEDULERS, p_a),
                            ("ref", R_SCHEDULERS, r_a)):
        _, tiers, passes, _, _ = SIDES[side]
        for on in (False, True):
            cache = _cache(side, device_budget_bytes=budget, n_shards=4)
            pp = (passes.PassPipeline([passes.ShardPlacementPass()],
                                      spec=tiers.PAPER_GPU_SYSTEM)
                  if on else None)
            sched = scheds["aires"](tiers.PAPER_GPU_SYSTEM,
                                    device_budget=budget,
                                    segment_cache=cache, passes=pp)
            sched.run(a, feat)
            m = sched.run(a, feat).metrics
            warm[side, on] = (m.bytes_by_path.get("ici", 0),
                              m.cache_hit_bytes, m.makespan_s)
    assert warm["port", False] == warm["ref", False]
    assert warm["port", True] == warm["ref", True]
    assert 0 < warm["port", False][0]
    assert warm["port", True][0] < warm["port", False][0]


# ---- topology, lint rules, cost probe --------------------------------------


def test_ring_topology_charges_hop_scaled_ici():
    """A 3-hop remote put and get charge 3x the bytes and 3 per-hop
    latencies on a ring, 1x on all-to-all, in both packages."""
    n = 8
    got = {}
    for side in SIDES:
        _, tiers, _, io, _ = SIDES[side]
        key = next(io.SegmentKey("g", i, "bricks", (i,)) for i in range(256)
                   if tiers.ICI_RING.hops(io.shard_of(
                       io.SegmentKey("g", i, "bricks", (i,)), n), 0, n) == 3)
        for topology in ("all_to_all", "ring"):
            tms = tiers.TieredMemorySystem(tiers.PAPER_GPU_SYSTEM)
            cache = _cache(side, device_budget_bytes=1 << 20, n_shards=n,
                           tms=tms, topology=topology)
            cache.put(key, "v", 1000)
            after_put = (tms.bytes_by_path()[tiers.Path.ICI],
                         tms.seconds_by_path()[tiers.Path.ICI])
            cache.get(key, nbytes=1000)
            got[side, topology] = (after_put,
                                   tms.bytes_by_path()[tiers.Path.ICI],
                                   cache.stats.ici_bytes)
    for topology, hops in (("all_to_all", 1), ("ring", 3)):
        assert got["port", topology] == got["ref", topology]
        assert got["port", topology][0][0] == 1000 * hops
        assert got["port", topology][2] == 2 * 1000 * hops


def _lint_plans(side, cache):
    pipe, tiers, _, io, _ = SIDES[side]

    def probe(i, shard):
        miss = pipe.TransferOp(tiers.Path.DMA, tiers.MemoryTier.HOST,
                               tiers.MemoryTier.DEVICE, 1 << 10,
                               tag="phaseII/seg")
        return pipe.CacheProbeOp(io.SegmentKey("g", i, "bricks", (i,)),
                                 1 << 10, miss, place_shard=shard)

    def plan_of(shards):
        plan = pipe.PipelinePlan(scheduler="t")
        plan.phases = [pipe.PhaseSpec("p")]
        for i, s in enumerate(shards):
            plan.add(probe(i, s), "p", pipe.LANE_DMA)
        return plan
    return {"bad": plan_of([7]), "negative": plan_of([-1]),
            "skewed": plan_of([0] * 32),
            "even": plan_of([i % 4 for i in range(32)]),
            "small": plan_of([0] * 31)}


@pytest.mark.parametrize("with_cache", [False, True])
def test_shard_lint_rules_match_reference(with_cache):
    """`lint/bad-placement` and `lint/shard-imbalance` on a four-shard
    cache (and without one, where only negative shards are provably
    wrong), with the reference's findings."""
    found = {}
    for side in SIDES:
        analysis = SIDES[side][4]
        cache = (_cache(side, device_budget_bytes=1 << 20, n_shards=4)
                 if with_cache else None)
        for name, plan in _lint_plans(side, cache).items():
            rep = analysis.analyze_plan(plan, segment_cache=cache)
            found[side, name] = sorted((f.rule, f.severity.value
                                        if hasattr(f.severity, "value")
                                        else f.severity, f.ops)
                                       for f in rep.findings)
    for name in _lint_plans("port", None):
        assert found["port", name] == found["ref", name], name
    assert [r for r, _, _ in found["port", "negative"]] == [
        "lint/bad-placement"]
    if with_cache:
        assert [r for r, _, _ in found["port", "bad"]] == [
            "lint/bad-placement"]
        assert [r for r, _, _ in found["port", "skewed"]] == [
            "lint/shard-imbalance"]
        assert found["port", "even"] == found["port", "small"] == []


def test_estimate_prices_remote_shard_hits_over_ici():
    """A peeked device hit owned by a remote shard carries the ICI hop the
    real probe charges, in both packages."""
    got = {}
    for side in SIDES:
        pipe, tiers, _, io, _ = SIDES[side]
        cache = _cache(side, device_budget_bytes=1 << 20, n_shards=4)
        key = next(io.SegmentKey("g", i, "bricks", (1,)) for i in range(64)
                   if io.shard_of(io.SegmentKey("g", i, "bricks", (1,)), 4))
        cache.put(key, "brick", 4096)
        plan = _probe_plan(side, [key], 4096)
        est = plan.estimate(tiers.PAPER_GPU_SYSTEM, segment_cache=cache)
        m, _ = pipe.CostInterpreter(tiers.PAPER_GPU_SYSTEM,
                                    segment_cache=cache).run(plan)
        got[side] = (est.cache_hit_bytes, est.bytes_by_path.get("ici", 0),
                     est.makespan_s, m.bytes_by_path.get("ici", 0))
    assert got["port"] == got["ref"] == (4096, 4096, got["ref"][2], 4096)
