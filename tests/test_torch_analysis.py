"""The port's static plan analyzer against the JAX package's: the same
rule catalog, the same findings (rule, severity, op indices) on the
reference tests' hand-built plans and on every scheduler's and stream's
plans, strict pass pipelines that raise on the same byte deltas, and the
module default that gates the interpreters.

Each hand-built plan is built by one function in both packages; findings
are compared as (rule, severity, ops) tuples, in order.
"""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.core.analysis as r_analysis
import repro.core.passes as r_passes
import repro.core.pipeline as r_pipe
import repro.io.segment_cache as r_cache
import repro.io.tiers as r_tiers
from repro.core import SCHEDULERS as R_SCHEDULERS, FeatureSpec as RFeat
from repro.core.memory_model import plan_memory_dense_features
from repro.data import (
    SUITESPARSE_SPECS, generate_graph, normalized_adjacency, scaled_spec,
)

import repro_torch.core.analysis as p_analysis
import repro_torch.core.passes as p_passes
import repro_torch.core.pipeline as p_pipe
import repro_torch.io.segment_cache as p_cache
import repro_torch.io.tiers as p_tiers
from repro_torch.core import (
    SCHEDULERS as P_SCHEDULERS, AiresConfig, AiresSpGEMM, FeatureSpec as PFeat,
)
from repro_torch.runtime import EngineConfig, InferenceRequest, ServingEngine
from repro_torch.sparse import CSR

SIDES = {"ref": (r_pipe, r_tiers, r_analysis, r_cache, r_passes),
         "port": (p_pipe, p_tiers, p_analysis, p_cache, p_passes)}


@pytest.fixture(autouse=True)
def _analyze_port_plans():
    """The port's module default is on in these tests, as the reference
    suite turns its own on; restored afterwards."""
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


def _findings(report):
    return [(f.rule, f.severity, tuple(f.ops)) for f in report.findings]


def test_rule_catalog_equals_reference():
    assert p_analysis.RULES == r_analysis.RULES
    assert len(p_analysis.RULES) == 14


# ---- hand-built plans: one build function, both packages -------------------


class _Kit:
    """Plan-building shorthand over one package's modules."""

    def __init__(self, side):
        self.pipe, self.tiers, self.analysis, self.cache, _ = SIDES[side]
        self.spec = self.tiers.PAPER_GPU_SYSTEM
        self.T = self.tiers.MemoryTier
        self.P = self.tiers.Path

    def plan(self, *phases):
        p = self.pipe.PipelinePlan(scheduler="t")
        p.phases = [self.pipe.PhaseSpec(ph) if isinstance(ph, str)
                    else self.pipe.PhaseSpec(*ph) for ph in phases]
        return p

    def transfer(self, nbytes=1 << 10, dst=None, **kw):
        return self.pipe.TransferOp(self.P.DMA, self.T.HOST,
                                    dst or self.T.DEVICE, nbytes, **kw)

    def key(self, i=0, fp=""):
        return self.cache.SegmentKey("g", i, "bricks", (i,), fingerprint=fp)

    def probe(self, key, nbytes=1 << 10, **kw):
        return self.pipe.CacheProbeOp(
            key, nbytes, self.transfer(nbytes, tag="phaseII/seg"), **kw)

    def alloc(self, name, nbytes, tier=None):
        return self.pipe.AllocOp(tier or self.T.DEVICE, name, nbytes)


SERIAL = ("p", "serial")


def _oversub(k):
    plan = k.plan(SERIAL)
    plan.add(k.alloc("huge", k.spec.device_capacity + 1), "p")
    plan.add(k.transfer(), "p")
    return plan


def _oversub_joint(k):
    plan = k.plan(SERIAL)
    half = k.spec.device_capacity // 2 + 1
    plan.add(k.alloc("a", half), "p")
    plan.add(k.alloc("b", half), "p")
    return plan


def _realloc_replaces(k):
    plan = k.plan(SERIAL)
    half = k.spec.device_capacity // 2 + 1
    plan.add(k.alloc("a", half), "p")
    plan.add(k.alloc("a", half), "p")
    plan.add(k.transfer(), "p")
    return plan


def _race_key(lanes, phases=("p", "p"), dep=False, serial=False):
    def build(k):
        key = k.key()
        plan = k.plan(SERIAL) if serial else k.plan(*sorted(set(phases)))
        i = plan.add(k.probe(key), phases[0], lanes[0])
        plan.add(k.probe(key), phases[1], lanes[1],
                 deps=(i,) if dep else ())
        return plan
    return build


def _race_alloc(names):
    def build(k):
        plan = k.plan("p")
        plan.add(k.alloc(names[0], 64), "p", "dma")
        plan.add(k.alloc(names[1], 32), "p", "gds")
        return plan
    return build


def _race_pin(k):
    plan = k.plan("p")
    plan.add(k.probe(k.key(0), pin=object()), "p", "dma")
    plan.add(k.probe(k.key(1), pin=object()), "p", "gds")
    return plan


def _unconsumed(consumed):
    def build(k):
        plan = k.plan("stream")
        i = plan.add(k.probe(k.key(), payload=(0, "ell")), "stream", "dma")
        if consumed:
            plan.add(k.pipe.ComputeOp(1e-6), "stream", "compute", deps=(i,))
        return plan
    return build


def _bytes_lints(k):
    plan = k.plan(SERIAL)
    plan.add(k.transfer(-4, tag="neg"), "p")
    plan.add(k.transfer(0, tag="zero"), "p")
    return plan


def _miss_dst(k):
    plan = k.plan("p")
    plan.add(k.pipe.CacheProbeOp(k.key(), 64, k.transfer(64, dst=k.T.HOST)),
             "p", "dma")
    return plan


def _alloc_unreferenced(host_op):
    def build(k):
        plan = k.plan(SERIAL)
        plan.add(k.alloc("staging", 1 << 10, tier=k.T.HOST), "p")
        plan.add(k.pipe.ComputeOp(1e-6), "p")
        if host_op:
            plan.add(k.pipe.HostPreprocessOp(1e-6), "p")
        return plan
    return build


def _placement(shard):
    def build(k):
        plan = k.plan("p")
        plan.add(k.probe(k.key(), place_shard=shard), "p", "dma")
        return plan
    return build


def _duplicate_key(fp2):
    def build(k):
        plan = k.plan("p")
        plan.add(k.probe(k.key(0, fp="aaaa")), "p", "dma")
        plan.add(k.probe(k.key(0, fp=fp2)), "p", "dma")
        return plan
    return build


def _pinned_stream(release):
    def build(k):
        plan = k.plan("p")
        i = plan.add(k.probe(k.key(), pin=object(), payload=(0, "ell")),
                     "p", "dma")
        plan.add(k.pipe.ComputeOp(1e-6), "p", "compute", deps=(i,))
        if release:
            plan.release_payloads()
        return plan
    return build


CASES = {
    "oversubscription": (_oversub, {}),
    "oversubscription-joint": (_oversub_joint, {}),
    "realloc-replaces": (_realloc_replaces, {}),
    "no-spec-skips-budget": (_oversub, {"spec": None}),
    "race-key-lanes": (_race_key(("dma", "gds")), {}),
    "race-key-same-lane": (_race_key(("dma", "dma")), {}),
    "race-key-dep": (_race_key(("dma", "gds"), dep=True), {}),
    "race-key-phases": (_race_key(("dma", "gds"), phases=("p", "q")), {}),
    "race-key-serial": (_race_key(("", ""), serial=True), {}),
    "race-alloc": (_race_alloc(("H", "H")), {}),
    "race-alloc-distinct": (_race_alloc(("H", "C")), {}),
    "race-pin": (_race_pin, {}),
    "unconsumed-payload": (_unconsumed(False), {}),
    "consumed-payload": (_unconsumed(True), {}),
    "negative-and-zero-bytes": (_bytes_lints, {}),
    "miss-dst-tier": (_miss_dst, {}),
    "alloc-unreferenced": (_alloc_unreferenced(False), {}),
    "alloc-referenced": (_alloc_unreferenced(True), {}),
    "bad-placement-negative": (_placement(-1), {}),
    "placement-single-chip-cache": (_placement(7), {"cache": True}),
    "duplicate-key-conflict": (_duplicate_key("bbbb"), {}),
    "duplicate-key-same": (_duplicate_key("aaaa"), {}),
    "dangling-pin": (_pinned_stream(False), {"released": True}),
    "released-clean": (_pinned_stream(True), {"released": True}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_hand_built_plan_findings_match_reference(case):
    build, opts = CASES[case]
    got = {}
    for side in SIDES:
        k = _Kit(side)
        kw = {"spec": opts.get("spec", k.spec),
              "released": opts.get("released", False)}
        if opts.get("cache"):
            kw["segment_cache"] = (
                k.cache.TieredSegmentCache(1 << 20) if side == "ref" else
                k.cache.TieredSegmentCache(1 << 20, device="cpu"))
        report = k.analysis.analyze_plan(build(k), **kw)
        got[side] = (_findings(report), report.ok,
                     [str(f) for f in report.findings
                      if "pin" not in f.rule])
    assert got["port"] == got["ref"]


def test_expected_rules_fire():
    """A few of the cases, spelled out, so the parity above cannot pass
    on two analyzers that both stay silent."""
    k = _Kit("port")

    def rules(case):
        build, opts = CASES[case]
        return [f[0] for f in _findings(k.analysis.analyze_plan(
            build(k), spec=opts.get("spec", k.spec),
            released=opts.get("released", False)))]

    assert rules("oversubscription") == ["mem/oversubscription"]
    assert rules("realloc-replaces") == []
    assert rules("race-key-lanes") == ["race/segment-key"]
    assert rules("race-key-serial") == []
    assert rules("negative-and-zero-bytes") == ["lint/negative-bytes",
                                                "lint/zero-byte-transfer"]
    assert rules("dangling-pin") == ["lint/dangling-pin"]
    assert rules("released-clean") == []


# ---- the port's own plans analyze as the reference's -----------------------


@pytest.mark.parametrize("cached", [False, True])
def test_scheduler_plans_findings_match_reference(small_graph, cached):
    """Every scheduler's simulate plan (AIRES also through a segment
    cache), analyzed before and after interpretation and release."""
    r, p = small_graph
    budget = _budget(r)
    for name in P_SCHEDULERS:
        if cached and name != "aires":
            continue
        got = {}
        for side, a, scheds, feat in (
                ("ref", r, R_SCHEDULERS, RFeat(r.n_rows, 64, 4, 0.0)),
                ("port", p, P_SCHEDULERS, PFeat(p.n_rows, 64, 4, 0.0))):
            k = _Kit(side)
            kw = {}
            if cached:
                kw["segment_cache"] = (
                    k.cache.TieredSegmentCache(budget) if side == "ref" else
                    k.cache.TieredSegmentCache(budget, device="cpu"))
            sched = scheds[name](k.spec, device_budget=budget, **kw)
            plan = sched.build_plan(a, feat)
            fresh = k.analysis.analyze_plan(
                plan, spec=k.spec, segment_cache=kw.get("segment_cache"))
            res = sched.run(a, feat)
            released = k.analysis.analyze_plan(res.pipeline, spec=k.spec,
                                               released=True)
            got[side] = (_findings(fresh), _findings(released))
        assert got["port"] == got["ref"] == ([], []), name


def test_production_passes_analyze_clean_strict(small_graph):
    """The three production passes under strict mode on a cached AIRES
    plan: no raise, every report clean, bytes conserved."""
    r, p = small_graph
    budget = _budget(p)
    cache = p_cache.TieredSegmentCache(budget, device="cpu")
    plan = P_SCHEDULERS["aires"](p_tiers.PAPER_GPU_SYSTEM,
                                 device_budget=budget, segment_cache=cache
                                 ).build_plan(p, PFeat(p.n_rows, 64, 4, 0.0))
    out, reports = p_passes.PassPipeline(
        [p_passes.ShardPlacementPass(),
         p_passes.TransferCoalescingPass(min_bytes=1 << 12),
         p_passes.EDFOrderingPass()],
        spec=p_tiers.PAPER_GPU_SYSTEM, strict=True).apply(
        plan, segment_cache=cache)
    out.validate()
    assert len(reports) == 3 and all(x.findings == () for x in reports)
    assert p_analysis.diff_path_totals(
        p_analysis.path_byte_totals(plan),
        p_analysis.path_byte_totals(out)) == {}


def test_stream_plan_analyzes_clean(small_graph):
    r, p = small_graph
    budget = _budget(p, width=8)
    cache = p_cache.TieredSegmentCache(budget, device="cpu")
    eng = AiresSpGEMM(AiresConfig(budget, bm=8, bk=8, device="cpu"),
                      segment_cache=cache)
    plan = eng.stream_plan(p, (p.n_rows, 8), spec=p_tiers.PAPER_GPU_SYSTEM)
    assert p_analysis.analyze_plan(plan, spec=p_tiers.PAPER_GPU_SYSTEM,
                                   segment_cache=cache).findings == []


# ---- strict pass pipelines ---------------------------------------------------


def _byte_dropper(passes, opt_out=False):
    class ByteDroppingPass(passes.TransferCoalescingPass):
        """Adversarial rewrite: coalesce, then halve the merged bytes."""

        name = "byte-dropper"
        conserves_bytes = not opt_out

        def __call__(self, plan, ctx=None):
            plan = super().__call__(plan, ctx)
            for bound in plan.ops:
                if type(bound.op).__name__ == "TransferOp":
                    bound.op.nbytes //= 2
            return plan

    return ByteDroppingPass(min_bytes=1 << 12)


def test_strict_byte_delta_raises_as_reference():
    got = {}
    for side in SIDES:
        k = _Kit(side)
        passes = SIDES[side][4]

        def build():
            plan = k.plan(SERIAL)
            for _ in range(3):
                plan.add(k.transfer(1 << 10), "p")
            return plan

        with pytest.raises(k.analysis.PlanAnalysisError) as err:
            passes.PassPipeline([_byte_dropper(passes)],
                                strict=True).apply(build())
        out, _ = passes.PassPipeline([_byte_dropper(passes)]).apply(build())
        _, reports = passes.PassPipeline(
            [_byte_dropper(passes, opt_out=True)], strict=True).apply(build())
        got[side] = (str(err.value), _findings(err.value.report),
                     k.analysis.path_byte_totals(out), reports[-1].findings)
    assert got["port"] == got["ref"]
    assert "bytes/path-delta" in got["port"][0]
    assert got["port"][2] == {"dma": (3 << 10) // 2}


def test_strict_pipeline_attaches_warnings_to_reports():
    got = {}
    for side in SIDES:
        k = _Kit(side)
        passes = SIDES[side][4]
        plan = k.plan(SERIAL)
        plan.add(k.transfer(0, tag="empty"), "p")
        plan.add(k.transfer(1 << 20), "p")
        _, reports = passes.PassPipeline(
            [passes.TransferCoalescingPass(min_bytes=1 << 10)], spec=k.spec,
            strict=True).apply(plan)
        got[side] = [(f.rule, f.severity, f.ops)
                     for f in reports[0].findings]
    assert got["port"] == got["ref"] == [
        ("lint/zero-byte-transfer", "warning", (0,))]


# ---- the module default and the engine flag ----------------------------------


def test_module_default_gates_the_interpreters():
    k = _Kit("port")
    plan = _oversub(k)
    with pytest.raises(p_analysis.PlanAnalysisError):
        p_pipe.CostInterpreter(k.spec).run(plan)
    m, _ = p_pipe.CostInterpreter(k.spec, analyze=False).run(plan)
    assert m.oom
    assert plan.estimate(k.spec).oom            # estimate() never analyzes
    previous = p_analysis.set_default_analyze(False)
    try:
        assert p_analysis.default_analyze() is False
        assert p_pipe.CostInterpreter(k.spec).run(plan)[0].oom
    finally:
        p_analysis.set_default_analyze(previous)


def test_engine_analyze_plans_flag(small_graph, monkeypatch):
    """EngineConfig.analyze_plans=True streams a batch through the execute
    interpreter's analysis gate, with the module default off."""
    r, p = small_graph
    h = np.random.default_rng(0).standard_normal(
        (p.n_rows, 8)).astype(np.float32)
    p_analysis.set_default_analyze(False)    # the fixture restores it
    calls = []
    real = p_analysis.analyze_plan

    def spy(plan, **kw):
        calls.append(plan.scheduler)
        return real(plan, **kw)

    monkeypatch.setattr(p_analysis, "analyze_plan", spy)
    eng = ServingEngine(EngineConfig(
        device_budget_bytes=_budget(p, width=8), max_batch_features=8,
        analyze_plans=True, device="cpu"))
    eng.register_graph("g", p)
    eng.submit(InferenceRequest("g", h))
    report = eng.run_batch()
    assert calls == ["aires-stream"]
    assert report.results[0].output.shape == (p.n_rows, 8)


# ---- property: clean alloc replay <=> no runtime OutOfMemory ---------------


def _random_alloc_plan(k, rng, spec):
    plan = k.plan(SERIAL)
    names = ["H", "C", "A", "S"]
    tiers = [k.T.DEVICE, k.T.HOST]
    caps = {k.T.DEVICE: spec.device_capacity, k.T.HOST: spec.host_capacity}
    for _ in range(int(rng.integers(1, 12))):
        tier = tiers[int(rng.integers(0, len(tiers)))]
        plan.add(k.alloc(names[int(rng.integers(0, len(names)))],
                         int(rng.integers(0, caps[tier] // 2 + 2)),
                         tier=tier), "p")
    plan.add(k.transfer(1 << 10), "p")
    return plan


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(st.integers(0, 2**32 - 1))
def test_clean_liveness_implies_no_runtime_oom(seed):
    got = {}
    for side in SIDES:
        k = _Kit(side)
        spec = dataclasses.replace(k.spec, device_capacity=1 << 12,
                                   host_capacity=1 << 13)
        plan = _random_alloc_plan(k, np.random.default_rng(seed), spec)
        report = k.analysis.analyze_plan(plan, spec=spec)
        m, _ = k.pipe.CostInterpreter(spec, analyze=False).run(plan)
        clean = not report.by_rule("mem/oversubscription")
        assert clean == (not m.oom)
        got[side] = (_findings(report), m.oom)
    assert got["port"] == got["ref"]
