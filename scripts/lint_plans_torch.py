"""Lint every benchmark-built pipeline plan of the PyTorch port with its
static analyzer.

The port's counterpart of `scripts/lint_plans.py`: it builds the 20 fig6
configurations (5 datasets x 4 schedulers, the paper's budgets at
AIRES_BENCH_SCALE, default 1e-3), the cached and sharded engine stream
plans, and a partition-aware sharded plan on the port's SBM graph; runs
`repro_torch.core.analysis.analyze_plan` over each raw plan and analyzes
it again under `PassPipeline(strict=True)` with the three production
passes.

Exit status: nonzero if any plan yields an error-severity finding.
Warnings are printed but do not fail the gate, except in the
partition-aware section, where a `lint/shard-imbalance` warning means the
cluster->shard balance cap regressed and does fail it.

The plans are built and analyzed on the host; the engine plans' caches
live on `--device` (the card by default), and nothing is streamed.

Usage:  PYTHONPATH=src python scripts/lint_plans_torch.py [--device cpu]
"""
from __future__ import annotations

import argparse
import functools
import os
import sys

from repro_torch.core import (
    AiresConfig,
    AiresSpGEMM,
    EDFOrderingPass,
    FeatureSpec,
    PassPipeline,
    PlanAnalysisError,
    SCHEDULERS,
    ShardPlacementPass,
    TransferCoalescingPass,
    analyze_plan,
    plan_memory_dense_features,
    required_bytes,
)
from repro_torch.data import (
    SUITESPARSE_SPECS,
    generate_graph,
    generate_sbm_graph,
    normalized_adjacency,
    scaled_spec,
)
from repro_torch.io import ShardedSegmentCache, TieredSegmentCache
from repro_torch.io.tiers import ICI_RING, PAPER_GPU_SYSTEM
from repro_torch.sparse import partition_graph

DATASETS = ["rUSA", "kV2a", "kU1a", "socLJ1", "kP1a"]   # fig6 configs
SPEC = PAPER_GPU_SYSTEM
# The benchmarks' dataset scale and feature shape (paper §V-A).
SCALE = float(os.environ.get("AIRES_BENCH_SCALE", "1e-3"))
FEATURE_DIM = 256
FEATURE_SPARSITY = 99.0


@functools.lru_cache(maxsize=None)
def dataset(name: str):
    return normalized_adjacency(generate_graph(
        scaled_spec(SUITESPARSE_SPECS[name], SCALE), seed=0))


def feature_spec(a) -> FeatureSpec:
    return FeatureSpec(a.n_rows, FEATURE_DIM, 4,
                       sparsity_pct=FEATURE_SPARSITY)


def budget_for(name: str, a, feat: FeatureSpec) -> int:
    """The paper's budget (GB) as bytes at this scale, through its
    budget:requirement ratio."""
    spec = SUITESPARSE_SPECS[name]
    return int(spec.mem_constraint_gb / spec.mem_req_gb
               * required_bytes(a, feat))


def _lint(label, plan, cache=None):
    """Analyze one plan; returns its report (printed as we go)."""
    report = analyze_plan(plan, spec=SPEC, segment_cache=cache)
    status = "clean" if not report.findings else (
        f"{len(report.errors)} error(s), {len(report.warnings)} warning(s)")
    print(f"  {label:<44s} {status}")
    for f in report.findings:
        print(f"    {f}")
    return report


def _strict_rewrite(label, plan, cache) -> bool:
    """Run the production passes in strict mode: a finding on any pass's
    output raises, and fails the gate here."""
    pipeline = PassPipeline(
        [ShardPlacementPass(), TransferCoalescingPass(min_bytes=1 << 12),
         EDFOrderingPass()],
        spec=SPEC, strict=True)
    try:
        _, reports = pipeline.apply(plan, segment_cache=cache)
    except PlanAnalysisError as err:
        print(f"  {label:<44s} FAILED strict rewrite")
        print(f"    {err}")
        return False
    n = sum(len(r.findings) for r in reports)
    print(f"  {label:<44s} strict rewrite clean "
          f"({len(reports)} passes, {n} findings)")
    return n == 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu': where the engine "
                         "plans' caches live")
    device = ap.parse_args(argv).device
    errors = 0
    print(f"fig6 scheduler plans (scale={SCALE:g}):")
    for name in DATASETS:
        a = dataset(name)
        feat = feature_spec(a)
        budget = budget_for(name, a, feat)
        for sched_name, cls in SCHEDULERS.items():
            plan = cls(SPEC, device_budget=budget).build_plan(
                a, feat, dataset=name)
            report = _lint(f"{name}/{sched_name}"
                           + (" (oom)" if plan.oom else ""), plan)
            errors += len(report.errors)

    print("cached + sharded engine plans:")
    small = dataset(DATASETS[0])
    # The engine needs a feasible budget at the serving width; the fig6
    # paper ratios deliberately starve it.
    est = plan_memory_dense_features(small, small.n_rows, 16, float("inf"))
    budget = int(est.m_b + est.m_c + 0.6 * small.nbytes())
    for label, cache in (
            ("tiered cache", TieredSegmentCache(
                device_budget_bytes=budget, device=device)),
            ("sharded cache (4)", ShardedSegmentCache(
                device_budget_bytes=budget, n_shards=4, device=device))):
        eng = AiresSpGEMM(
            AiresConfig(device_budget_bytes=budget, bm=8, bk=8,
                        device=device),
            segment_cache=cache)
        plan = eng.stream_plan(small, (small.n_rows, 16), spec=SPEC)
        report = _lint(f"stream plan / {label}", plan, cache=cache)
        errors += len(report.errors)
        if not _strict_rewrite(f"strict passes / {label}", plan, cache):
            errors += 1

    print("partition-aware sharded plan (lint/shard-imbalance gate):")
    # The balance cap of `map_clusters_to_shards` keeps the heaviest shard
    # under the analyzer's 2x-mean threshold, so a partitioned plan must
    # lint clean; a regressed cap or clustering trips
    # `lint/shard-imbalance` here.
    sbm = normalized_adjacency(generate_sbm_graph(
        small.n_rows, 8 * small.n_rows, n_blocks=8, seed=0))
    est = plan_memory_dense_features(sbm, sbm.n_rows, 16, float("inf"))
    budget = int(est.m_b + est.m_c + 0.6 * sbm.nbytes())
    cache = ShardedSegmentCache(device_budget_bytes=budget, n_shards=4,
                                topology=ICI_RING, device=device)
    part = partition_graph(sbm, 8, n_shards=4, topology=ICI_RING,
                           local_shard=cache.local_shard)
    eng = AiresSpGEMM(
        AiresConfig(device_budget_bytes=budget, bm=8, bk=8, device=device),
        segment_cache=cache, partition=part)
    plan = eng.stream_plan(sbm, (sbm.n_rows, 16), spec=SPEC)
    report = _lint("stream plan / partitioned shards (4)", plan, cache=cache)
    errors += len(report.errors) + len(report.warnings)
    if not _strict_rewrite("strict passes / partitioned shards (4)",
                           plan, cache):
        errors += 1

    if errors:
        print(f"FAIL: {errors} error-severity finding(s)")
        return 1
    print("OK: every plan analyzed clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
