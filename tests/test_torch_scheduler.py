"""The port's schedulers, pipeline IR and the pieces they stand on against
the JAX package's: AIRES and its three baselines build the same plans and
read the same `ScheduleMetrics` on the paper's fig6 graphs, execute mode
computes the same product, and the interpreters' OOM, serial-phase and
peek-versus-mutate semantics agree.

Both packages get the same CSR (copied array for array) and the same
numpy-seeded features; the port runs on `device="cpu"`, where the Block-ELL
SpMM takes its plain version, and the reference's Pallas kernel runs in
interpret mode. The modeled fields are compared with `==`: the port runs
the same float operations in the same order.
"""
import dataclasses

import numpy as np
import pytest

import repro.core.pipeline as r_pipe
import repro.core.robw as r_robw
import repro.io.segment_cache as r_cache
import repro.io.tiers as r_tiers
from repro.core import SCHEDULERS as R_SCHEDULERS
from repro.core.memory_model import (
    FeatureSpec as RFeat, plan_memory_dense_features, required_bytes,
)
from repro.data import (
    SUITESPARSE_SPECS, generate_graph, normalized_adjacency, scaled_spec,
)

import repro_torch.core.analysis as p_analysis
import repro_torch.core.pipeline as p_pipe
import repro_torch.core.robw as p_robw
import repro_torch.io.segment_cache as p_cache
import repro_torch.io.tiers as p_tiers
from repro_torch.core import (
    SCHEDULERS as P_SCHEDULERS, AiresScheduler, FeatureSpec as PFeat,
)
from repro_torch.sparse import CSR

# The reference's own field list (tests/test_pipeline.py): every modeled
# field, and not the wall-clock `host_measured_s`.
METRIC_FIELDS = [
    "makespan_s", "io_modeled_s", "compute_modeled_s", "host_preprocess_s",
    "bytes_by_path", "seconds_by_path", "total_transfer_bytes",
    "cache_hit_bytes", "merge_events", "merge_io_s", "segments", "oom",
]
FIG6 = ["rUSA", "kV2a", "kU1a", "socLJ1", "kP1a"]
SCHEDS = ["maxmemory", "ucg", "etc", "aires"]
# Execute outputs against the reference's: f32 sums in another order (the
# reference's own execute limit, tests/test_pipeline.py).
EXEC_TOL = 1e-3


@pytest.fixture(autouse=True)
def _analyze_port_plans():
    """The port's static analyzer is on for every plan these tests
    interpret, as the reference suite's is; restored afterwards."""
    previous = p_analysis.set_default_analyze(True)
    yield
    p_analysis.set_default_analyze(previous)


def _port_csr(a):
    return CSR(a.indptr.copy(), a.indices.copy(), a.data.copy(), a.shape)


def _port_feat(feat):
    return PFeat(feat.n_rows, feat.n_cols, feat.dtype_bytes,
                 feat.sparsity_pct, feat.index_bytes)


def _stats(cache):
    """The cache's counters, by the port's field names (the reference's
    `CacheStats` adds the sharded and directory counters)."""
    return {f.name: getattr(cache.stats, f.name)
            for f in dataclasses.fields(p_cache.CacheStats)}


def _metrics_equal(pm, rm, fields=METRIC_FIELDS):
    for field in fields:
        assert getattr(pm, field) == getattr(rm, field), (
            f"{field}: port {getattr(pm, field)!r} != reference "
            f"{getattr(rm, field)!r}")


@pytest.fixture(scope="module")
def fig6():
    """The fig6 graphs, features and budgets at the benchmarks' SCALE."""
    from benchmarks.common import SCALE, budget_for, dataset, feature_spec

    assert SCALE == 1e-3, "the fig6 parity runs at the benchmarks' 1e-3"
    out = {}
    for name in FIG6:
        a = dataset(name)
        feat = feature_spec(a)
        out[name] = (a, _port_csr(a), feat, budget_for(name, a, feat))
    return out


@pytest.fixture(scope="module")
def small_graph():
    """The reference tests' small graph: socLJ1 at 1e-4, in both packages."""
    r = normalized_adjacency(generate_graph(
        scaled_spec(SUITESPARSE_SPECS["socLJ1"], 1e-4), seed=0))
    return r, _port_csr(r)


def _budget(a, width):
    est = plan_memory_dense_features(a, a.n_rows, width, float("inf"))
    return int(est.m_b + est.m_c + 0.6 * a.nbytes())


# ---- simulate: the fig6 configurations, field for field ----------------------


@pytest.mark.parametrize("sched", SCHEDS)
@pytest.mark.parametrize("name", FIG6)
def test_simulate_metrics_match_reference(fig6, name, sched):
    r, p, feat, budget = fig6[name]
    rm = R_SCHEDULERS[sched](r_tiers.PAPER_GPU_SYSTEM,
                             device_budget=budget).run(
        r, feat, mode="simulate", dataset=name).metrics
    pm = P_SCHEDULERS[sched](p_tiers.PAPER_GPU_SYSTEM,
                             device_budget=budget).run(
        p, _port_feat(feat), mode="simulate", dataset=name).metrics
    _metrics_equal(pm, rm, METRIC_FIELDS + ["dataset", "scheduler"])


def test_cached_simulate_cold_then_warm_matches_reference(fig6):
    """AIRES with a shared segment cache: the cold run fills it, the warm
    run hits every segment — both equal to the reference's, and the warm
    hit bytes equal the cold run's wire bytes."""
    from benchmarks.common import budget_for, feature_spec

    r, p, _, _ = fig6["kV2a"]
    feat = feature_spec(r, 64)
    budget = budget_for("kV2a", r, feat)
    rs = R_SCHEDULERS["aires"](
        r_tiers.PAPER_GPU_SYSTEM, device_budget=budget,
        segment_cache=r_cache.TieredSegmentCache(device_budget_bytes=budget))
    ps = P_SCHEDULERS["aires"](
        p_tiers.PAPER_GPU_SYSTEM, device_budget=budget,
        segment_cache=p_cache.TieredSegmentCache(device_budget_bytes=budget,
                                                 device="cpu"))
    got = []
    for _ in ("cold", "warm"):
        rm = rs.run(r, feat, dataset="kV2a").metrics
        pm = ps.run(p, _port_feat(feat), dataset="kV2a").metrics
        _metrics_equal(pm, rm)
        got.append(pm)
    cold, warm = got
    assert cold.cache_hit_bytes == 0
    assert warm.cache_hit_bytes == cold.bytes_by_path["dma"] > 0
    assert _stats(ps.segment_cache) == _stats(rs.segment_cache)


# ---- execute: the same product, the same plan --------------------------------


@pytest.mark.parametrize("sched", SCHEDS)
def test_execute_matches_reference(small_graph, sched):
    """Execute on socLJ1 1e-4 at 16 columns, above every scheduler's
    Table III floor: outputs within EXEC_TOL of the reference's, metrics
    field for field, and the execute metrics equal to a cost
    interpretation of the same plan."""
    r, p = small_graph
    h = np.random.default_rng(0).standard_normal(
        (r.n_rows, 16)).astype(np.float32)
    budget = int(1.1 * required_bytes(r, RFeat.of(h)))
    kw = dict(bm=8, bk=8) if sched == "aires" else {}
    rres = R_SCHEDULERS[sched](r_tiers.PAPER_GPU_SYSTEM,
                               device_budget=budget, **kw).run(
        r, h, mode="execute")
    psched = P_SCHEDULERS[sched](p_tiers.PAPER_GPU_SYSTEM,
                                 device_budget=budget, device="cpu", **kw)
    pres = psched.run(p, h, mode="execute")
    assert pres.x.device.type == "cpu" and pres.x.shape == (r.n_rows, 16)
    np.testing.assert_allclose(pres.x.numpy(), np.asarray(rres.x),
                               atol=EXEC_TOL, rtol=EXEC_TOL)
    _metrics_equal(pres.metrics, rres.metrics)
    plan = psched.build_plan(p, h, mode="execute")
    m_cost, x_cost = p_pipe.CostInterpreter(p_tiers.PAPER_GPU_SYSTEM).run(
        plan)
    assert x_cost is None
    _metrics_equal(m_cost, pres.metrics)


def test_aires_execute_segments_and_bricks_equal_reference(small_graph):
    """The AIRES execute plan streams the reference's RoBW segments and
    its Block-ELL bricks, array for array (read off the cache probes,
    whose retained value is the host brick)."""
    r, p = small_graph
    h = np.random.default_rng(1).standard_normal(
        (r.n_rows, 16)).astype(np.float32)
    budget = _budget(r, 16)
    kw = dict(device_budget=budget, bm=8, bk=8, wire_format="bricks")
    rplan = R_SCHEDULERS["aires"](
        r_tiers.PAPER_GPU_SYSTEM,
        segment_cache=r_cache.TieredSegmentCache(budget), **kw).build_plan(
        r, h, mode="execute")
    pplan = P_SCHEDULERS["aires"](
        p_tiers.PAPER_GPU_SYSTEM, device="cpu",
        segment_cache=p_cache.TieredSegmentCache(budget, device="cpu"),
        **kw).build_plan(p, h, mode="execute")
    assert pplan.segments == rplan.segments >= 2
    assert ([dataclasses.astuple(s) for s in pplan.robw.segments]
            == [dataclasses.astuple(s) for s in rplan.robw.segments])
    rvals = [b.op.value for b in rplan.ops
             if isinstance(b.op, r_pipe.CacheProbeOp)]
    pvals = [b.op.value for b in pplan.ops
             if isinstance(b.op, p_pipe.CacheProbeOp)]
    assert len(pvals) == len(rvals) == pplan.segments
    for pe, re_ in zip(pvals, rvals):
        for field in ("blocks", "col_tile", "n_tiles"):
            np.testing.assert_array_equal(getattr(pe, field),
                                          getattr(re_, field))
    assert ([b.op.key for b in pplan.ops
             if isinstance(b.op, p_pipe.CacheProbeOp)]
            == [p_cache.SegmentKey(*dataclasses.astuple(b.op.key))
                for b in rplan.ops if isinstance(b.op, r_pipe.CacheProbeOp)])


def test_run_is_build_plus_interpret(small_graph):
    r, p = small_graph
    feat = PFeat(p.n_rows, 32, 4, 0.0)
    sched = P_SCHEDULERS["aires"](p_tiers.PAPER_GPU_SYSTEM,
                                  device_budget=_budget(p, 32))
    res = sched.run(p, feat)
    m, x = p_pipe.CostInterpreter(p_tiers.PAPER_GPU_SYSTEM).run(
        sched.build_plan(p, feat))
    assert x is None
    _metrics_equal(res.metrics, m)
    assert res.pipeline.segments == res.metrics.segments >= 2


def test_run_releases_payloads_but_stays_estimable(small_graph):
    r, p = small_graph
    h = np.random.default_rng(3).standard_normal(
        (p.n_rows, 16)).astype(np.float32)
    res = P_SCHEDULERS["aires"](
        p_tiers.PAPER_GPU_SYSTEM, device_budget=_budget(p, 16), bm=8, bk=8,
        device="cpu").run(p, h, mode="execute")
    assert res.x is not None
    for bound in res.pipeline.ops:
        op = bound.op
        assert getattr(op, "payload", None) is None
        assert getattr(op, "kernel", None) is None
        assert getattr(op, "pin", None) is None
        assert not hasattr(op, "value") or op.value is True
    assert res.pipeline.reference_kernel is None
    again = res.pipeline.estimate(p_tiers.PAPER_GPU_SYSTEM)
    assert again.makespan_s == res.metrics.makespan_s
    assert p_analysis.analyze_plan(res.pipeline, released=True).findings == []


def test_partition_is_not_ported(small_graph):
    """Partition-aware tiling is ported now: a partition is accepted, and
    the plan it tiles and its modeled metrics are the reference's. The
    name is the one it had while it checked the refusal, so that runs of
    the suite before and after compare test by test; it now checks that
    the partition works."""
    from repro.core import AiresScheduler as RAiresScheduler
    from repro.sparse.partition import partition_graph as r_partition
    from repro_torch.sparse.partition import partition_graph as p_partition

    r, p = small_graph
    h = np.zeros((p.n_rows, 16), np.float32)
    budget = _budget(p, 16)
    res = AiresScheduler(p_tiers.PAPER_GPU_SYSTEM, device_budget=budget,
                         partition=p_partition(p, 8), device="cpu").run(p, h)
    ref = RAiresScheduler(r_tiers.PAPER_GPU_SYSTEM, device_budget=budget,
                          partition=r_partition(r, 8)).run(r, h)
    assert ([(s.row_start, s.row_end) for s in res.plan.segments]
            == [(s.row_start, s.row_end) for s in ref.plan.segments])
    _metrics_equal(res.metrics, ref.metrics)


def test_execute_without_a_card_raises(small_graph):
    """Simulate mode needs no device; execute on the default device
    raises without CUDA instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r, p = small_graph
    h = np.zeros((p.n_rows, 8), np.float32)
    for name in SCHEDS:
        sched = P_SCHEDULERS[name](p_tiers.PAPER_GPU_SYSTEM,
                                   device_budget=4 * _budget(p, 8))
        assert not sched.run(p, h).metrics.oom
        with pytest.raises(RuntimeError, match="is_available"):
            sched.run(p, h, mode="execute")


# ---- interpreter semantics on hand-built plans, both packages ---------------


def _mods(side):
    return (r_pipe, r_tiers) if side == "ref" else (p_pipe, p_tiers)


def _plan_lanes(side):
    pipe, tiers = _mods(side)
    plan = pipe.PipelinePlan(scheduler="t")
    plan.phases = [pipe.PhaseSpec("p")]
    plan.add(pipe.TransferOp(tiers.Path.GDS, tiers.MemoryTier.STORAGE,
                             tiers.MemoryTier.DEVICE, 1 << 20), "p",
             pipe.LANE_GDS)
    plan.add(pipe.TransferOp(tiers.Path.DMA, tiers.MemoryTier.HOST,
                             tiers.MemoryTier.DEVICE, 1 << 20), "p",
             pipe.LANE_DMA)
    return plan


def _plan_deps(side):
    pipe, tiers = _mods(side)
    plan = pipe.PipelinePlan(scheduler="t")
    plan.phases = [pipe.PhaseSpec("p")]
    for _ in range(3):
        i = plan.add(pipe.TransferOp(tiers.Path.DMA, tiers.MemoryTier.HOST,
                                     tiers.MemoryTier.DEVICE, 1 << 20),
                     "p", pipe.LANE_DMA)
        plan.add(pipe.ComputeOp(1e-4), "p", pipe.LANE_COMPUTE, deps=(i,))
    return plan


def _plan_serial(side):
    pipe, tiers = _mods(side)
    plan = pipe.PipelinePlan(scheduler="t")
    plan.phases = [pipe.PhaseSpec("p", overlap="serial"),
                   pipe.PhaseSpec("q")]
    plan.add(pipe.TransferOp(tiers.Path.DMA, tiers.MemoryTier.HOST,
                             tiers.MemoryTier.DEVICE, 1 << 20), "p")
    plan.add(pipe.HostPreprocessOp(2e-3, measured_s=0.5), "p")
    plan.add(pipe.ComputeOp(5e-3), "p")
    plan.add(pipe.TransferOp(tiers.Path.DMA, tiers.MemoryTier.DEVICE,
                             tiers.MemoryTier.HOST, 1 << 10, merge=True),
             "q", pipe.LANE_DMA)
    return plan


PLANS = {"lanes": _plan_lanes, "deps": _plan_deps, "serial": _plan_serial}


@pytest.mark.parametrize("kind", sorted(PLANS))
def test_hand_built_plans_interpret_as_reference(kind):
    rm, rx = r_pipe.CostInterpreter(r_tiers.PAPER_GPU_SYSTEM).run(
        PLANS[kind]("ref"))
    pm, px = p_pipe.CostInterpreter(p_tiers.PAPER_GPU_SYSTEM).run(
        PLANS[kind]("port"))
    assert rx is None and px is None
    _metrics_equal(pm, rm, METRIC_FIELDS + ["host_measured_s"])
    assert pm.merge_overhead_frac() == rm.merge_overhead_frac()


def test_serial_phase_sums_categories():
    spec = p_tiers.PAPER_GPU_SYSTEM
    plan = _plan_serial("port")
    plan.ops = plan.ops[:3]
    m, _ = p_pipe.CostInterpreter(spec).run(plan)
    t_dma = (spec.latency_s[p_tiers.Path.DMA]
             + (1 << 20) / spec.bw[p_tiers.Path.DMA])
    assert m.makespan_s == pytest.approx(t_dma + 2e-3 + 5e-3)
    assert m.host_preprocess_s == 2e-3 and m.host_measured_s == 0.5


def _oom_plan(side):
    pipe, tiers = _mods(side)
    plan = pipe.PipelinePlan(scheduler="t")
    plan.phases = [pipe.PhaseSpec("p", overlap="serial")]
    plan.add(pipe.AllocOp(tiers.MemoryTier.DEVICE, "huge",
                          tiers.PAPER_GPU_SYSTEM.device_capacity + 1), "p")
    plan.add(pipe.TransferOp(tiers.Path.DMA, tiers.MemoryTier.HOST,
                             tiers.MemoryTier.DEVICE, 1 << 20), "p")
    return plan


def test_alloc_op_oom_aborts_interpretation():
    """The runtime OOM path (analysis off: the analyzer would refuse the
    plan up front, as test_torch_analysis checks)."""
    got = []
    for side, pipe in (("ref", r_pipe), ("port", p_pipe)):
        m, x = pipe.CostInterpreter(_mods(side)[1].PAPER_GPU_SYSTEM,
                                    analyze=False).run(_oom_plan(side))
        assert m.oom and x is None
        assert m.bytes_by_path == {}   # nothing charged after the alloc
        got.append(m)
    _metrics_equal(got[1], got[0])
    with pytest.raises(p_analysis.PlanAnalysisError):
        p_pipe.CostInterpreter(p_tiers.PAPER_GPU_SYSTEM).run(
            _oom_plan("port"))


def test_oom_plan_short_circuits():
    plan = p_pipe.PipelinePlan(scheduler="t", oom=True)
    for interp in (p_pipe.CostInterpreter, p_pipe.ExecuteInterpreter):
        m, x = interp(p_tiers.PAPER_GPU_SYSTEM).run(plan)
        assert m.oom and x is None


def test_execute_interpreter_fills_output_buffer():
    """Kernel thunks write into a zeroed float32 buffer on the plan's
    device; a baseline's reference kernel replaces the buffer."""
    import torch

    plan = p_pipe.PipelinePlan(scheduler="t", out_shape=(4, 2))
    plan.phases = [p_pipe.PhaseSpec("p")]

    def rows(lo, hi):
        def kernel(out):
            out[lo:hi] = float(lo + 1)
        return kernel

    plan.add(p_pipe.ComputeOp(1e-6, kernel=rows(0, 2)), "p",
             p_pipe.LANE_COMPUTE)
    plan.add(p_pipe.ComputeOp(1e-6, kernel=rows(3, 4)), "p",
             p_pipe.LANE_COMPUTE)
    m, x = p_pipe.ExecuteInterpreter(p_tiers.PAPER_GPU_SYSTEM).run(plan)
    assert x.dtype == torch.float32 and x.device.type == "cpu"
    assert x.tolist() == [[1, 1], [1, 1], [0, 0], [4, 4]]
    _, x_cost = p_pipe.CostInterpreter(p_tiers.PAPER_GPU_SYSTEM).run(plan)
    assert x_cost is None
    plan.reference_kernel = lambda: torch.ones(4, 2)
    _, x = p_pipe.ExecuteInterpreter(p_tiers.PAPER_GPU_SYSTEM).run(plan)
    assert x.tolist() == [[1, 1]] * 4


# ---- cache probes: interpret mutates, estimate peeks ------------------------


def _probe_plan(side, key, nbytes):
    pipe, tiers = _mods(side)
    plan = pipe.PipelinePlan(scheduler="t")
    plan.phases = [pipe.PhaseSpec("p")]
    miss = pipe.TransferOp(tiers.Path.DMA, tiers.MemoryTier.HOST,
                           tiers.MemoryTier.DEVICE, nbytes,
                           tag="phaseII/seg")
    plan.add(pipe.CacheProbeOp(key, nbytes, miss, value=True), "p",
             pipe.LANE_DMA)
    return plan


@pytest.mark.parametrize("device_budget", [1 << 20, 1])
def test_probe_interpret_mutates_and_estimate_peeks(device_budget):
    """With a device tier that holds the brick, and with one that spills
    it to the host tier at once: a cold estimate inserts nothing, the
    cost interpretation inserts (through get_with_cost / put), and every
    estimate after it reads a hit without touching the cache — metrics,
    cache statistics and tiers equal to the reference's at each step."""
    sides = {}
    for side, cache_mod in (("ref", r_cache), ("port", p_cache)):
        pipe, tiers = _mods(side)
        kw = {} if side == "ref" else {"device": "cpu"}
        cache = cache_mod.TieredSegmentCache(device_budget_bytes=device_budget,
                                             **kw)
        key = cache_mod.SegmentKey("g", 0, "bricks", (1,))
        plan = _probe_plan(side, key, 4096)
        spec = tiers.PAPER_GPU_SYSTEM
        steps = [plan.estimate(spec, segment_cache=cache)]
        snap = [(len(cache), _stats(cache))]
        steps.append(pipe.CostInterpreter(spec, segment_cache=cache)
                     .run(plan)[0])
        snap.append((len(cache), _stats(cache)))
        steps.append(plan.estimate(spec, segment_cache=cache))
        snap.append((len(cache), _stats(cache), cache.tier_of(key).value))
        sides[side] = (steps, snap)
    (rsteps, rsnap), (psteps, psnap) = sides["ref"], sides["port"]
    for pm, rm in zip(psteps, rsteps):
        _metrics_equal(pm, rm)
    assert psnap == rsnap
    assert psnap[0][0] == 0 and psnap[1][0] == 1
    assert psnap[2][:2] == psnap[1][:2]          # the estimate mutated nothing
    assert psteps[2].cache_hit_bytes == 4096


# ---- the pieces the schedulers stand on --------------------------------------


def test_tiered_memory_allocation_matches_reference():
    seq = [("alloc", "DEVICE", "H", 10 << 30), ("alloc", "DEVICE", "C", 8 << 30),
           ("alloc", "DEVICE", "H", 4 << 30), ("free", "DEVICE", "C", 0),
           ("alloc", "HOST", "A", 100 << 30), ("alloc", "DEVICE", "X", 30 << 30),
           ("transfer", "GDS", "", 1 << 20), ("transfer", "DMA", "", 1 << 24),
           ("transfer", "DMA", "", 3)]
    out = {}
    for side in ("ref", "port"):
        tiers = _mods(side)[1]
        tms = tiers.TieredMemorySystem(tiers.PAPER_GPU_SYSTEM)
        log = []
        for op, tier, name, n in seq:
            if op == "transfer":
                path = tiers.Path[tier]
                log.append(tms.transfer(path, tiers.MemoryTier.HOST,
                                        tiers.MemoryTier.DEVICE, n))
                continue
            t = tiers.MemoryTier[tier]
            try:
                getattr(tms, op)(t, name, n) if op == "alloc" else \
                    tms.free(t, name)
                log.append(("ok", tms.headroom(t)))
            except tiers.OutOfMemory as err:
                log.append(("oom", str(err)))
        log += [tms.makespan_overlapped(), tms.makespan_serial(),
                {p.value: s for p, s in tms.busy_s.items()},
                {t.value: u for t, u in tms.used.items()}]
        tms.reset_accounting()
        log += [tms.total_bytes(), tms.bytes_by_path(), tms.transfers,
                tms.makespan_serial()]
        out[side] = log
    assert out["port"] == out["ref"]
    assert ("oom" in [e[0] for e in out["port"] if isinstance(e, tuple)])


@pytest.mark.parametrize("m_a_bytes", [64, 1000, 1 << 16])
def test_naive_partition_matches_reference(small_graph, m_a_bytes):
    r, p = small_graph
    cuts = p_robw.naive_partition(p, m_a_bytes)
    assert cuts == r_robw.naive_partition(r, m_a_bytes)
    assert cuts[0][0] == 0 and cuts[-1][1] == p.nnz
    tail, head = np.arange(3, dtype=np.float32), np.ones(2, np.float32)
    np.testing.assert_array_equal(p_robw.merge_partial_rows(tail, head),
                                  r_robw.merge_partial_rows(tail, head))


def test_robw_plan_properties_match_reference(small_graph):
    r, p = small_graph
    rp = r_robw.robw_partition(r, 4096, align=8)
    pp = p_robw.robw_partition(p, 4096, align=8)
    assert ((pp.n_segments, pp.max_rows(), pp.max_nnz())
            == (rp.n_segments, rp.max_rows(), rp.max_nnz()))
    assert pp.n_segments > 1


def test_get_with_cost_matches_reference():
    """A device hit, a host-tier hit (priced promotion) and a miss; a
    non-tensor value (a scheduler's host brick, a simulate token) passes
    through demotion and promotion untouched, and the device tier counts
    the declared wire bytes, not the value's size."""
    out = {}
    for side, cache_mod in (("ref", r_cache), ("port", p_cache)):
        tiers = _mods(side)[1]
        tms = tiers.TieredMemorySystem(tiers.PAPER_GPU_SYSTEM)
        kw = {} if side == "ref" else {"device": "cpu"}
        cache = cache_mod.TieredSegmentCache(device_budget_bytes=5000,
                                             tms=tms, **kw)
        keys = [cache_mod.SegmentKey("g", i, "bricks", (i,))
                for i in range(3)]
        token = ("brick", 7)
        cache.put(keys[0], token, 3000)
        cache.put(keys[1], True, 3000)          # demotes keys[0]
        log = [cache.device_used_bytes, cache.host_used_bytes]
        for k in (keys[1], keys[0], keys[2]):
            value, cost = cache.get_with_cost(k, nbytes=3000, tms=tms)
            log.append((value, cost))
        log.append(_stats(cache))
        log.append({p.value: b for p, b in tms.bytes_by_path().items()})
        out[side] = log
    assert out["port"] == out["ref"]
    assert out["port"][3] == (("brick", 7), pytest.approx(out["port"][3][1]))
    assert out["port"][3][1] > 0
