"""The port's plan-rewrite passes against the JAX package's: plan
validation fails with the same messages, transfer coalescing rewrites the
same plans into the same ops (conserving bytes per path), EDF orders
equal on random deadlines, shard placement is the identity on the
single-chip cache, pass reports carry the same deltas, and a coalesced
stream computes exactly what the plain stream computes.

Both packages build the same plans from the same numpy seeds; the port
runs on `device="cpu"`, where its Block-ELL SpMM is the deterministic
plain version, so a coalesced stream is held bit-equal to the plain one.
"""
import dataclasses
import enum

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core.passes as r_passes
import repro.core.pipeline as r_pipe
import repro.io.segment_cache as r_cache
import repro.io.tiers as r_tiers
from repro.core import (
    SCHEDULERS as R_SCHEDULERS, AiresConfig as RConfig,
    AiresSpGEMM as RSpGEMM, FeatureSpec as RFeat,
)
from repro.core.memory_model import plan_memory_dense_features
from repro.data import (
    SUITESPARSE_SPECS, generate_graph, normalized_adjacency, scaled_spec,
)
from repro.launch.serve import serve_gcn as r_serve_gcn

import repro_torch.core.analysis as p_analysis
import repro_torch.core.passes as p_passes
import repro_torch.core.pipeline as p_pipe
import repro_torch.io.segment_cache as p_cache
import repro_torch.io.tiers as p_tiers
from repro_torch.core import (
    SCHEDULERS as P_SCHEDULERS, AiresConfig as PConfig,
    AiresSpGEMM as PSpGEMM, FeatureSpec as PFeat,
)
from repro_torch.launch.serve import serve_gcn as p_serve_gcn
from repro_torch.sparse import CSR

METRIC_FIELDS = [
    "makespan_s", "io_modeled_s", "compute_modeled_s", "host_preprocess_s",
    "bytes_by_path", "seconds_by_path", "total_transfer_bytes",
    "cache_hit_bytes", "merge_events", "merge_io_s", "segments", "oom",
]
SIDES = {"ref": (r_pipe, r_tiers, r_passes, r_cache),
         "port": (p_pipe, p_tiers, p_passes, p_cache)}


@pytest.fixture(autouse=True)
def _analyze_port_plans():
    """The port's static analyzer is on for every plan these tests
    interpret or stream, as the reference suite's is; restored after."""
    previous = p_analysis.set_default_analyze(True)
    yield
    p_analysis.set_default_analyze(previous)


@pytest.fixture(scope="module")
def small_graph():
    r = normalized_adjacency(generate_graph(
        scaled_spec(SUITESPARSE_SPECS["socLJ1"], 1e-4), seed=0))
    return r, CSR(r.indptr.copy(), r.indices.copy(), r.data.copy(), r.shape)


def _budget(a, width=64, a_frac=0.6):
    est = plan_memory_dense_features(a, a.n_rows, width, float("inf"))
    return int(est.m_b + est.m_c + a_frac * a.nbytes())


def _norm(x):
    """A plan (or op, or value) as plain data, comparable across the two
    packages: enums by value, dataclasses by their fields, payloads by
    their segment indices. Left out: what is not the plan's modeled
    content (kernel closures, pins, the wall-clock `measured_s`)."""
    if isinstance(x, enum.Enum):
        return x.value
    if type(x).__name__ == "CoalescedPayload":
        return ("coalesced", [i for i, _ in x.payloads])
    if type(x).__name__ == "BlockELL":
        return ("ell", tuple(x.blocks.shape))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: _norm(getattr(x, f.name))
                 for f in dataclasses.fields(x)
                 if f.name not in ("kernel", "reference_kernel", "mem",
                                   "robw", "pin", "out_dtype", "device",
                                   "measured_s")})
    if isinstance(x, (list, tuple)):
        return type(x)(_norm(v) for v in x)
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    return x


def _metrics_equal(pm, rm):
    for field in METRIC_FIELDS:
        assert getattr(pm, field) == getattr(rm, field), field


# ---- plan validation: the same errors, message for message -----------------


def _malformed(side, case):
    pipe, tiers = SIDES[side][:2]

    def dma(n=8):
        return pipe.TransferOp(tiers.Path.DMA, tiers.MemoryTier.HOST,
                               tiers.MemoryTier.DEVICE, n)

    p = pipe.PipelinePlan(scheduler="t")
    p.phases = [pipe.PhaseSpec("p")]
    if case == "dangling":
        p.add(dma(), "p", pipe.LANE_DMA, deps=(3,))
    elif case == "negative":
        p.add(pipe.ComputeOp(1e-6), "p", pipe.LANE_COMPUTE, deps=(-1,))
    elif case == "forward":
        i0 = p.add(dma(), "p", pipe.LANE_DMA, deps=(1,))
        p.add(pipe.ComputeOp(1e-6), "p", pipe.LANE_COMPUTE, deps=(i0,))
    elif case == "self":
        p.add(pipe.ComputeOp(1e-6), "p", pipe.LANE_COMPUTE, deps=(0,))
    elif case == "no-phases":
        p.phases = []
        p.add(pipe.ComputeOp(1e-6), "p", pipe.LANE_COMPUTE)
    elif case == "undeclared":
        p.add(pipe.ComputeOp(1e-6), "nope", pipe.LANE_COMPUTE)
    elif case == "duplicate":
        p.phases = [pipe.PhaseSpec("p"), pipe.PhaseSpec("p")]
    return p


@pytest.mark.parametrize("case", ["dangling", "negative", "forward", "self",
                                  "no-phases", "undeclared", "duplicate"])
def test_validate_errors_match_reference(case):
    msgs = {}
    for side in SIDES:
        pipe, tiers = SIDES[side][:2]
        with pytest.raises(pipe.PlanValidationError) as err:
            _malformed(side, case).validate()
        msgs[side] = str(err.value)
        # ... and the interpreters refuse the plan before running it.
        with pytest.raises(pipe.PlanValidationError):
            pipe.CostInterpreter(tiers.PAPER_GPU_SYSTEM).run(
                _malformed(side, case))
    assert msgs["port"] == msgs["ref"]
    # Empty plans stay valid: builders return one (oom=True) for
    # infeasible budgets before declaring any phase.
    p_pipe.PipelinePlan(scheduler="t").validate()
    p_pipe.PipelinePlan(scheduler="t", oom=True).validate()


def test_builder_plans_validate(small_graph):
    r, p = small_graph
    for name in P_SCHEDULERS:
        plan = P_SCHEDULERS[name](p_tiers.PAPER_GPU_SYSTEM,
                                  device_budget=_budget(p)).build_plan(
            p, PFeat(p.n_rows, 32, 4, 0.0))
        assert plan.validate() is plan


# ---- transfer coalescing ----------------------------------------------------


def _random_plan(side, seed):
    """The reference tests' random multi-lane, multi-phase plan of small
    transfers, computes and host ops, built from `seed` in either
    package."""
    pipe, tiers = SIDES[side][:2]
    rng = np.random.default_rng(seed)
    plan = pipe.PipelinePlan(scheduler="prop")
    plan.phases = [pipe.PhaseSpec("a"), pipe.PhaseSpec("b", overlap="serial")]
    paths = [tiers.Path.DMA, tiers.Path.GDS, tiers.Path.STORAGE_HOST]
    lanes = [pipe.LANE_DMA, "gds", ""]
    last = None
    for _ in range(int(rng.integers(2, 40))):
        kind = rng.integers(0, 4)
        phase = "a" if rng.integers(0, 2) else "b"
        if kind < 2:
            path = paths[int(rng.integers(0, len(paths)))]
            deps = ((last,) if (last is not None and rng.integers(0, 3) == 0)
                    else ())
            last = plan.add(
                pipe.TransferOp(path, tiers.MemoryTier.HOST,
                                tiers.MemoryTier.DEVICE,
                                int(rng.integers(1, 1 << 20)),
                                merge=bool(rng.integers(0, 2))),
                phase, lanes[int(rng.integers(0, len(lanes)))], deps=deps)
        elif kind == 2:
            deps = (last,) if last is not None else ()
            last = plan.add(pipe.ComputeOp(float(rng.random()) * 1e-4),
                            phase, pipe.LANE_COMPUTE, deps=deps)
        else:
            last = plan.add(pipe.HostPreprocessOp(1e-6), phase, "host")
    return plan


def _coalesce(side, plan, min_bytes, **apply_kw):
    pipe, tiers, passes = SIDES[side][:3]
    pipeline = passes.PassPipeline(
        [passes.TransferCoalescingPass(min_bytes=min_bytes)],
        spec=tiers.PAPER_GPU_SYSTEM, strict=True)
    return pipeline.apply(plan, **apply_kw)


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(st.integers(0, 2**32 - 1), st.sampled_from([1 << 12, 1 << 20]))
def test_coalescing_matches_reference_and_conserves_bytes(seed, min_bytes):
    outs = {}
    for side in SIDES:
        plan = _random_plan(side, seed)
        before = path_totals = None
        if side == "port":
            before = plan.estimate(p_tiers.PAPER_GPU_SYSTEM)
            path_totals = p_analysis.path_byte_totals(plan)
        out, reports = _coalesce(side, plan, min_bytes)
        outs[side] = (_norm(out.ops), _norm(out.phases),
                      [(r.pass_name, _norm(r.findings)) for r in reports],
                      out.estimate(SIDES[side][1].PAPER_GPU_SYSTEM))
        if side == "port":
            assert p_analysis.diff_path_totals(
                path_totals, p_analysis.path_byte_totals(out)) == {}
            assert (sum(isinstance(b.op, p_pipe.TransferOp) for b in out.ops)
                    <= sum(isinstance(b.op, p_pipe.TransferOp)
                           for b in plan.ops))
            assert outs[side][3].io_modeled_s <= before.io_modeled_s + 1e-15
    assert outs["port"][:3] == outs["ref"][:3]
    _metrics_equal(outs["port"][3], outs["ref"][3])


def test_coalescing_merges_small_serial_transfers():
    plan = p_pipe.PipelinePlan(scheduler="t")
    plan.phases = [p_pipe.PhaseSpec("p", overlap="serial")]
    for _ in range(3):
        plan.add(p_pipe.TransferOp(p_tiers.Path.DMA, p_tiers.MemoryTier.HOST,
                                   p_tiers.MemoryTier.DEVICE, 1 << 10), "p")
    out, _ = p_passes.PassPipeline(
        [p_passes.TransferCoalescingPass(min_bytes=1 << 12)]).apply(plan)
    assert len(out.ops) == 1 and out.ops[0].op.nbytes == 3 << 10
    spec = p_tiers.PAPER_GPU_SYSTEM
    m, _ = p_pipe.CostInterpreter(spec).run(out)
    assert m.makespan_s == pytest.approx(
        spec.latency_s[p_tiers.Path.DMA]
        + (3 << 10) / spec.bw[p_tiers.Path.DMA])


def test_coalescing_remaps_scheduler_deps_as_reference(small_graph):
    """AIRES's stream phase: each compute deps on its segment's transfer;
    after coalescing every compute deps on its merged DMA, as in the
    reference's rewrite."""
    r, p = small_graph
    outs = {}
    for side, a, sched, feat in (
            ("ref", r, R_SCHEDULERS, RFeat(r.n_rows, 16, 4, 0.0)),
            ("port", p, P_SCHEDULERS, PFeat(p.n_rows, 16, 4, 0.0))):
        plan = sched["aires"](SIDES[side][1].PAPER_GPU_SYSTEM,
                              device_budget=_budget(a, width=16)
                              ).build_plan(a, feat)
        out, _ = _coalesce(side, plan, 1 << 30)
        outs[side] = (plan.segments, _norm(out.ops),
                      out.estimate(SIDES[side][1].PAPER_GPU_SYSTEM))
    assert outs["port"][:2] == outs["ref"][:2]
    _metrics_equal(outs["port"][2], outs["ref"][2])
    n_cmp = sum(op[0] == "ComputeOp" for op in
                (b[1]["op"] for b in outs["port"][1]))
    assert n_cmp == outs["port"][0] >= 2


@pytest.mark.parametrize("width", [16, 24])
def test_coalesced_stream_is_bit_equal_on_cpu(small_graph, width):
    """A cache-off engine with coalescing uploads every brick in fewer
    streamer issues and computes the plain stream's output bit for bit
    (the plain SpMM is deterministic on the CPU); bytes and issue counts
    equal the reference's coalesced stream, whose output agrees within the
    reference's execute limit."""
    r, p = small_graph
    h = np.random.default_rng(7).standard_normal(
        (r.n_rows, width)).astype(np.float32)
    budget = _budget(r, width=width)
    coalesce = [p_passes.TransferCoalescingPass(min_bytes=1 << 30)]
    plain = PSpGEMM(PConfig(budget, bm=8, bk=8, device="cpu"))
    co = PSpGEMM(PConfig(budget, bm=8, bk=8, device="cpu"),
                 plan_passes=p_passes.PassPipeline(coalesce))
    x0, x1 = plain(p, torch.from_numpy(h)), co(p, torch.from_numpy(h))
    s0, s1 = plain.last_stream_stats, co.last_stream_stats
    assert torch.equal(x0, x1)
    assert s0.segments >= 2 and s1.segments == 1
    assert s1.uploaded_bytes == s0.uploaded_bytes
    plan = co.stream_plan(p, (p.n_rows, width))
    merged = [b.op for b in plan.ops if isinstance(b.op, p_pipe.TransferOp)]
    assert len(merged) == 1
    assert isinstance(merged[0].payload[1], p_passes.CoalescedPayload)
    assert co.stream_plan(p, (p.n_rows, width),
                          apply_passes=False).segments == s0.segments

    ref = RSpGEMM(RConfig(budget, bm=8, bk=8), plan_passes=r_passes
                  .PassPipeline([r_passes.TransferCoalescingPass(1 << 30)]))
    xr = np.asarray(ref(r, h))
    sr = ref.last_stream_stats
    assert ((s1.segments, s1.uploaded_bytes)
            == (sr.segments, sr.uploaded_bytes))
    np.testing.assert_allclose(x1.numpy(), xr, atol=1e-3, rtol=1e-3)


def test_identity_pipeline_keeps_execute_bit_exact(small_graph):
    r, p = small_graph
    h = np.random.default_rng(5).standard_normal(
        (p.n_rows, 16)).astype(np.float32)
    kw = dict(device_budget=_budget(p, width=16), bm=8, bk=8, device="cpu")
    x0 = P_SCHEDULERS["aires"](p_tiers.PAPER_GPU_SYSTEM, **kw).run(
        p, h, mode="execute").x
    x1 = P_SCHEDULERS["aires"](p_tiers.PAPER_GPU_SYSTEM,
                               passes=p_passes.PassPipeline([]), **kw).run(
        p, h, mode="execute").x
    assert torch.equal(x0, x1)


# ---- shard placement: the identity on a single-chip cache -------------------


@pytest.mark.parametrize("cached", [False, True])
def test_shard_placement_is_identity_on_single_chip(small_graph, cached):
    r, p = small_graph
    budget = _budget(p)
    cache = (p_cache.TieredSegmentCache(budget, device="cpu")
             if cached else None)
    sched = P_SCHEDULERS["aires"](p_tiers.PAPER_GPU_SYSTEM,
                                  device_budget=budget, segment_cache=cache)
    plan = sched.build_plan(p, PFeat(p.n_rows, 64, 4, 0.0))
    before = _norm(plan.ops)
    out, reports = p_passes.PassPipeline(
        [p_passes.ShardPlacementPass()], spec=p_tiers.PAPER_GPU_SYSTEM,
        strict=True).apply(plan, segment_cache=cache)
    assert out is plan and _norm(out.ops) == before
    assert all(b.op.place_shard is None for b in out.ops
               if isinstance(b.op, p_pipe.CacheProbeOp))
    assert reports[0].makespan_delta_s == 0 and reports[0].findings == ()


# ---- EDF ordering -----------------------------------------------------------


def _deadline_items(seed):
    rng = np.random.default_rng(seed)
    return [(i, float(rng.random() * 10),
             None if rng.integers(0, 4) == 0 else float(rng.random() * 20))
            for i in range(int(rng.integers(1, 12)))]


@settings(max_examples=100, deadline=None, derandomize=True, database=None)
@given(st.integers(0, 2**32 - 1))
def test_edf_orders_match_reference(seed):
    items = _deadline_items(seed)
    cost, deadline = (lambda it: it[1]), (lambda it: it[2])
    assert (p_passes.deadline_order(items, cost, deadline)
            == r_passes.deadline_order(items, cost, deadline))
    assert (p_passes.edf_sort(items, deadline)
            == r_passes.edf_sort(items, deadline))

    @dataclasses.dataclass
    class Req:
        estimated_cost_s: float
        deadline_s: object
        submitted_s: float

    reqs = [Req(c, d, -1.0 if i % 3 == 0 else 0.5 * i)
            for i, c, d in items]
    groups = [reqs[i:i + 2] for i in range(0, len(reqs), 2)]
    pp, rp = (mod.EDFOrderingPass(clock=lambda: 3.0)
              for mod in (p_passes, r_passes))
    assert ([id(x) for x in pp.order_requests(reqs)]
            == [id(x) for x in rp.order_requests(reqs)])

    def gcost(group):
        return sum(x.estimated_cost_s for x in group)

    assert ([id(g) for g in pp.order_groups(groups, gcost)]
            == [id(g) for g in rp.order_groups(groups, gcost)])


def test_deadline_order_demotes_tardy_job():
    items = [("long", 10.0, 10.0), ("s1", 2.0, 11.0), ("s2", 2.0, 13.0)]
    ordered = p_passes.deadline_order(items, lambda it: it[1],
                                      lambda it: it[2])
    assert [it[0] for it in ordered] == ["s1", "s2", "long"]
    edf = p_passes.edf_sort(items, lambda it: it[2])
    assert [it[0] for it in edf] == ["long", "s1", "s2"]


# ---- pass reports ------------------------------------------------------------


def test_pass_reports_match_reference(small_graph):
    """One before/after reading per pass, equal to the reference's:
    coalescing's delta is non-positive on the serial MaxMemory baseline,
    placement's is zero without a sharded cache."""
    r, p = small_graph
    got = {}
    for side, a, sched, feat in (
            ("ref", r, R_SCHEDULERS, RFeat(r.n_rows, 16, 4, 0.0)),
            ("port", p, P_SCHEDULERS, PFeat(p.n_rows, 16, 4, 0.0))):
        passes, spec = SIDES[side][2], SIDES[side][1].PAPER_GPU_SYSTEM
        pipeline = passes.PassPipeline(
            [passes.TransferCoalescingPass(min_bytes=1 << 30),
             passes.ShardPlacementPass()], spec=spec)
        res = sched["maxmemory"](spec, device_budget=4 * _budget(a),
                                 passes=pipeline).run(a, feat)
        got[side] = res
    for pr, rr in zip(got["port"].pass_reports, got["ref"].pass_reports):
        assert pr.pass_name == rr.pass_name
        _metrics_equal(pr.before, rr.before)
        _metrics_equal(pr.after, rr.after)
        assert pr.makespan_delta_s == rr.makespan_delta_s
        assert pr.bytes_delta("dma") == rr.bytes_delta("dma") == 0
    reps = got["port"].pass_reports
    assert [x.pass_name for x in reps] == ["transfer-coalescing",
                                           "shard-placement"]
    assert reps[0].makespan_delta_s < 0 and reps[1].makespan_delta_s == 0
    _metrics_equal(got["port"].metrics, got["ref"].metrics)


# ---- serve_gcn(passes=True) ---------------------------------------------------


def test_serve_gcn_with_passes_matches_reference():
    """The reference's pass set (placement, coalescing, EDF) in the
    serving launcher: the same bytes per epoch, outputs within the
    launcher test's limit."""
    port = p_serve_gcn(scale=1e-4, passes=True, device="cpu")
    ref = r_serve_gcn(scale=1e-4, passes=True)
    assert len(port) == len(ref) == 2
    for p_rep, r_rep in zip(port, ref):
        for field in ("uploaded_bytes", "cache_hit_bytes", "promoted_bytes",
                      "segments_streamed", "aggregation_passes"):
            assert getattr(p_rep, field) == getattr(r_rep, field), field
        assert ([x.request_id for x in p_rep.results]
                == [x.request_id for x in r_rep.results])
        for p_res, r_res in zip(p_rep.results, r_rep.results):
            np.testing.assert_allclose(p_res.output, r_res.output,
                                       atol=1e-4, rtol=1e-5)
    assert port[1].cache_hit_bytes == port[0].uploaded_bytes > 0
