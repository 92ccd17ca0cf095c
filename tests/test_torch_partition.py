"""Partition-aware sharding in the port against the JAX package:
`generate_sbm_graph` (the same CSR from the same seed), `partition_graph`
(labels, cluster → shard map, token, `boundaries`, `row_permutation`,
`owners_for_plan`, `refine`, all array-equal), `map_clusters_to_shards`,
`robw_partition(boundaries=)`, `AiresScheduler(partition=)` (metrics and
owner maps equal) and the engine's `partition_shards` /
`register_graph(partition=)` (every epoch's byte counters, ICI included,
equal; outputs bit-identical to the CRC-owner engine's)."""
import dataclasses

import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import numpy as np
import pytest

import repro.io.tiers as r_tiers
from repro.core import AiresScheduler as RScheduler
from repro.core.memory_model import plan_memory_dense_features
from repro.core.robw import robw_partition as r_robw_partition
from repro.data import generate_sbm_graph as r_sbm
from repro.data import normalized_adjacency as r_normalized
from repro.io import ShardedSegmentCache as RShardCache
from repro.runtime import (
    EngineConfig as REngineConfig, InferenceRequest as RRequest,
    ServingEngine as RServingEngine,
)
from repro.sparse.formats import CSR as RCSR
from repro.sparse.partition import (
    Partition as RPartition, map_clusters_to_shards as r_map,
    partition_graph as r_partition,
)

import repro_torch.core.analysis as p_analysis
import repro_torch.io.tiers as p_tiers
from repro_torch.core import AiresScheduler as PScheduler
from repro_torch.core.robw import robw_partition as p_robw_partition
from repro_torch.data import generate_sbm_graph as p_sbm
from repro_torch.io import ShardedSegmentCache as PShardCache
from repro_torch.runtime import (
    EngineConfig as PEngineConfig, InferenceRequest as PRequest,
    ServingEngine as PServingEngine,
)
from repro_torch.sparse import CSR
from repro_torch.sparse.partition import (
    Partition as PPartition, map_clusters_to_shards as p_map,
    partition_graph as p_partition,
)

# Every modeled field of ScheduleMetrics (tests/test_pipeline.py's list).
METRIC_FIELDS = [
    "makespan_s", "io_modeled_s", "compute_modeled_s", "host_preprocess_s",
    "bytes_by_path", "seconds_by_path", "total_transfer_bytes",
    "cache_hit_bytes", "merge_events", "merge_io_s", "segments", "oom",
]
TOPOLOGIES = {"all_to_all": (r_tiers.ICI_ALL_TO_ALL, p_tiers.ICI_ALL_TO_ALL),
              "ring": (r_tiers.ICI_RING, p_tiers.ICI_RING)}


@pytest.fixture(autouse=True)
def _analyze_port_plans():
    """The port's static analyzer is on for every plan these tests
    interpret or stream, as the reference suite's is; restored after."""
    previous = p_analysis.set_default_analyze(True)
    yield
    p_analysis.set_default_analyze(previous)


def _port_csr(r):
    return CSR(r.indptr.copy(), r.indices.copy(), r.data.copy(), r.shape)


def _chain(n):
    """Path graph: row i links i-1 and i+1 (the reference tests' own)."""
    rows = [i for i in range(n) for j in (i - 1, i + 1) if 0 <= j < n]
    cols = [j for i in range(n) for j in (i - 1, i + 1) if 0 <= j < n]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, np.asarray(rows) + 1, 1)
    return RCSR(indptr=np.cumsum(indptr), indices=np.asarray(cols, np.int64),
                data=np.ones(len(rows), np.float32), shape=(n, n))


@pytest.fixture(scope="module")
def sbm():
    """The reference engine tests' SBM graph, in both packages."""
    r = r_normalized(r_sbm(512, 4096, n_blocks=4, p_in=0.95, seed=0))
    return r, _port_csr(r)


def _same_partition(p, r):
    np.testing.assert_array_equal(p.cluster_of, r.cluster_of)
    np.testing.assert_array_equal(p.cluster_to_shard, r.cluster_to_shard)
    np.testing.assert_array_equal(p.row_nnz, r.row_nnz)
    np.testing.assert_array_equal(p.boundaries(), r.boundaries())
    np.testing.assert_array_equal(p.row_permutation(), r.row_permutation())
    np.testing.assert_array_equal(p.cluster_nnz, r.cluster_nnz)
    np.testing.assert_array_equal(p.shard_nnz, r.shard_nnz)
    assert (p.n_shards, p.n_clusters, p.token, p.graph_prefix,
            p.describe()) == (r.n_shards, r.n_clusters, r.token,
                              r.graph_prefix, r.describe())


# ---- the SBM generator -----------------------------------------------------

@pytest.mark.parametrize("args", [
    (512, 4096, 4, 0.95, 0), (1000, 5000, 8, 0.9, 3), (97, 300, 1, 0.5, 1),
    (64, 640, 5, 0.0, 2), (64, 640, 5, 1.0, 2),
])
def test_generate_sbm_graph_matches_reference(args):
    n, m, blocks, p_in, seed = args
    r = r_sbm(n, m, n_blocks=blocks, p_in=p_in, seed=seed)
    p = p_sbm(n, m, n_blocks=blocks, p_in=p_in, seed=seed)
    for field in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(p, field), getattr(r, field))
        assert getattr(p, field).dtype == getattr(r, field).dtype
    assert p.shape == r.shape


def test_generate_sbm_graph_validates():
    for kw, match in ((dict(n_blocks=0), "n_blocks"),
                      (dict(p_in=1.5), "p_in")):
        with pytest.raises(ValueError, match=match):
            p_sbm(16, 32, **kw)


# ---- partition_graph and the cluster → shard map --------------------------

@pytest.mark.parametrize("clusters,shards,topo,local", [
    (4, 1, "all_to_all", 0), (8, 4, "all_to_all", 0), (8, 4, "ring", 0),
    (16, 4, "ring", 2), (4, 4, "ring", 1), (3, 2, "ring", 0),
])
def test_partition_graph_matches_reference(sbm, clusters, shards, topo,
                                           local):
    r, p = sbm
    rt, pt = TOPOLOGIES[topo]
    _same_partition(
        p_partition(p, clusters, n_shards=shards, topology=pt,
                    local_shard=local),
        r_partition(r, clusters, n_shards=shards, topology=rt,
                    local_shard=local))


@pytest.mark.parametrize("n,clusters", [(64, 4), (33, 2), (8, 100), (0, 4)])
def test_partition_graph_on_chains_matches_reference(n, clusters):
    r = _chain(n) if n else RCSR(
        indptr=np.zeros(1, np.int64), indices=np.empty(0, np.int64),
        data=np.empty(0, np.float32), shape=(0, 0))
    _same_partition(p_partition(_port_csr(r), clusters),
                    r_partition(r, clusters))
    with pytest.raises(ValueError, match="n_clusters"):
        p_partition(_port_csr(r), 0)


@pytest.mark.parametrize("nnz,shards,topo,local,balance", [
    ([10, 10, 10, 10], 4, "ring", 0, 1.75),
    ([10, 10, 7, 7, 3, 3], 4, "ring", 0, 1.75),
    ([100, 1, 1], 2, "all_to_all", 0, 1.0),
    ([5, 5], 1, "all_to_all", 0, 1.75),
    ([9, 1, 4, 4, 2, 8, 3, 3], 4, "ring", 3, 1.5),
])
def test_map_clusters_to_shards_matches_reference(nnz, shards, topo, local,
                                                  balance):
    rt, pt = TOPOLOGIES[topo]
    np.testing.assert_array_equal(
        p_map(nnz, shards, topology=pt, local_shard=local, balance=balance),
        r_map(nnz, shards, topology=rt, local_shard=local, balance=balance))


def test_map_clusters_to_shards_validates_like_reference():
    for kw, match in ((dict(local_shard=2), "local_shard"),
                      (dict(balance=0.5), "balance")):
        with pytest.raises(ValueError, match=match):
            r_map([5], 2, **kw)
        with pytest.raises(ValueError, match=match):
            p_map([5], 2, **kw)


# ---- plan projection and refine --------------------------------------------

@pytest.mark.parametrize("frac,align", [(6, 1), (6, 8), (3, 8), (12, 1)])
def test_plans_over_boundaries_match_reference(sbm, frac, align):
    r, p = sbm
    rp = r_partition(r, 8, n_shards=4, topology=r_tiers.ICI_RING)
    pp = p_partition(p, 8, n_shards=4, topology=p_tiers.ICI_RING)
    budget = r.nbytes() // frac
    r_plan = r_robw_partition(r, budget, align=align,
                              boundaries=rp.boundaries())
    p_plan = p_robw_partition(p, budget, align=align,
                              boundaries=pp.boundaries())
    assert ([dataclasses.astuple(s) for s in p_plan.segments]
            == [dataclasses.astuple(s) for s in r_plan.segments])
    labels = pp.cluster_of
    for seg in p_plan.segments:
        assert len(set(labels[seg.row_start:seg.row_end].tolist())) == 1
    assert pp.clusters_for_plan(p_plan) == rp.clusters_for_plan(r_plan)
    assert pp.owners_for_plan(p_plan) == rp.owners_for_plan(r_plan)
    row_nnz = np.arange(r.n_rows, dtype=np.int64) % 3
    assert (pp.owners_for_plan(p_plan, row_nnz=row_nnz)
            == rp.owners_for_plan(r_plan, row_nnz=row_nnz))
    # boundaries=None gives the unclamped plan, segment for segment.
    assert ([dataclasses.astuple(s) for s in p_robw_partition(
        p, budget, align=align).segments]
        == [dataclasses.astuple(s) for s in p_robw_partition(
            p, budget, align=align, boundaries=None).segments]
        == [dataclasses.astuple(s) for s in r_robw_partition(
            r, budget, align=align).segments])


def test_majority_votes_match_reference():
    labels = np.array([0, 0, 1, 1], np.int64)

    class _Seg:
        def __init__(self, lo, hi):
            self.row_start, self.row_end = lo, hi

    class _Plan:
        segments = [_Seg(0, 3), _Seg(3, 4)]

    for row_nnz in ([5, 5, 1, 1], [0, 0, 0, 0]):
        kw = dict(cluster_of=labels, cluster_to_shard=np.array([2, 3]),
                  n_shards=4, row_nnz=np.array(row_nnz, np.int64))
        p, r = PPartition(**kw), RPartition(**kw)
        assert p.clusters_for_plan(_Plan) == r.clusters_for_plan(_Plan)
        assert p.owners_for_plan(_Plan) == r.owners_for_plan(_Plan)
        assert p.token == r.token


@pytest.mark.parametrize("touched", [[0, 1, 2], [5, 300, 301], [], [511]])
def test_refine_matches_reference(sbm, touched):
    r, p = sbm
    rp = r_partition(r, 4, n_shards=4)
    pp = p_partition(p, 4, n_shards=4)
    # Scramble the touched rows' labels so the re-vote has work to do.
    scrambled = pp.cluster_of.copy()
    scrambled[touched] = (scrambled[touched] + 1) % 4
    kw = dict(cluster_of=scrambled, cluster_to_shard=pp.cluster_to_shard,
              n_shards=4, row_nnz=pp.row_nnz)
    _same_partition(PPartition(**kw).refine(p, touched),
                    RPartition(**kw).refine(r, touched))
    _same_partition(pp.refine(p, touched), rp.refine(r, touched))


def test_refine_validates_like_reference():
    r = _chain(32)
    p = p_partition(_port_csr(r), 2)
    with pytest.raises(ValueError, match="rows"):
        p.refine(_port_csr(_chain(16)), [0])
    for bad in ([99], [-1]):
        with pytest.raises(IndexError, match="touched"):
            p.refine(_port_csr(r), bad)


# ---- AiresScheduler(partition=) ---------------------------------------------

@pytest.mark.parametrize("wire", ["csr", "bricks"])
def test_scheduler_partition_matches_reference(sbm, wire):
    """Simulate mode over a four-shard ring cache, partitioned: the same
    metrics, namespaces and installed owner maps; a second run hits."""
    r, p = sbm
    rp = r_partition(r, 8, n_shards=4, topology=r_tiers.ICI_RING)
    pp = p_partition(p, 8, n_shards=4, topology=p_tiers.ICI_RING)
    feat = np.zeros((r.n_rows, 32), np.float32)
    est = plan_memory_dense_features(r, r.n_rows, 32, float("inf"))
    budget = int(est.m_b + est.m_c + 0.3 * r.nbytes())
    r_cache = RShardCache(device_budget_bytes=1 << 24, n_shards=4,
                          topology=r_tiers.ICI_RING)
    p_cache = PShardCache(device_budget_bytes=1 << 24, n_shards=4,
                          topology=p_tiers.ICI_RING, device="cpu")
    r_s = RScheduler(r_tiers.PAPER_GPU_SYSTEM, device_budget=budget, bm=8,
                     bk=8, wire_format=wire, segment_cache=r_cache,
                     partition=rp)
    p_s = PScheduler(p_tiers.PAPER_GPU_SYSTEM, device_budget=budget, bm=8,
                     bk=8, wire_format=wire, segment_cache=p_cache,
                     partition=pp, device="cpu")
    for _ in range(2):
        rm, pm = r_s.run(r, feat).metrics, p_s.run(p, feat).metrics
        for f in METRIC_FIELDS:
            rv, pv = getattr(rm, f), getattr(pm, f)
            if isinstance(rv, dict):
                rv = {getattr(k, "value", k): v for k, v in rv.items()}
                pv = {getattr(k, "value", k): v for k, v in pv.items()}
            assert pv == rv, f
    assert p_cache._owner_maps == r_cache._owner_maps
    assert p_cache._cluster_maps == r_cache._cluster_maps
    assert all(":p8" in ns for ns in p_cache._owner_maps)
    # A partition built for another graph is ignored, as in the reference.
    other = p_partition(_port_csr(_chain(16)), 2)
    PScheduler(p_tiers.PAPER_GPU_SYSTEM, device_budget=budget, bm=8, bk=8,
               partition=other, device="cpu").run(p, feat)


# ---- the engine: partition_shards and register_graph(partition=) -----------

def _engine_pair(r, p, clusters=8, **overrides):
    est = plan_memory_dense_features(r, r.n_rows, 32, float("inf"))
    budget = int(est.m_b + est.m_c + 0.15 * r.nbytes())
    kw = dict(device_budget_bytes=budget, cache_device_bytes=budget,
              cache_shards=4, partition_shards=clusters,
              max_batch_features=32)
    kw.update(overrides)
    r_eng = RServingEngine(REngineConfig(ici_topology=r_tiers.ICI_RING,
                                         **kw))
    p_eng = PServingEngine(PEngineConfig(ici_topology=p_tiers.ICI_RING,
                                         device="cpu", **kw))
    r_eng.register_graph("g", r)
    p_eng.register_graph("g", p)
    return r_eng, p_eng


def _workload(n, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 32)).astype(np.float32),
            [rng.standard_normal((32, 16)).astype(np.float32)])


BYTE_FIELDS = ("uploaded_bytes", "cache_hit_bytes", "promoted_bytes",
               "ici_bytes", "segments_streamed", "aggregation_passes")


def _epochs(r_eng, p_eng, h, w, n=2):
    outs = []
    for _ in range(n):
        r_eng.submit(RRequest("g", h, w))
        p_eng.submit(PRequest("g", h, w))
        r_rep, p_rep = r_eng.run_batch(), p_eng.run_batch()
        for f in BYTE_FIELDS:
            assert getattr(p_rep, f) == getattr(r_rep, f), f
        np.testing.assert_allclose(p_rep.results[0].output,
                                   r_rep.results[0].output,
                                   atol=1e-5, rtol=1e-5)
        outs.append((p_rep, p_rep.results[0].output))
    return outs


@pytest.mark.parametrize("clusters", [0, 4, 8, 16])
def test_partition_shards_serving_matches_reference(sbm, clusters):
    """Eager owner maps equal, every epoch's bytes (ICI included) equal,
    and outputs bit-identical to the CRC-owner port engine's."""
    r, p = sbm
    r_eng, p_eng = _engine_pair(r, p, clusters=clusters)
    spg = p_eng._engines["g"]
    if clusters:
        assert spg.partition is not None
        assert spg.partition.n_clusters == clusters
        assert p_eng.cache._owner_maps == r_eng.cache._owner_maps != {}
    else:
        assert spg.partition is None
    h, w = _workload(r.n_rows)
    got = _epochs(r_eng, p_eng, h, w)
    _, crc = _engine_pair(r, p, clusters=0)
    for rep, out in got:
        crc.submit(PRequest("g", h, w))
        np.testing.assert_array_equal(out, crc.run_batch().results[0].output)


def test_explicit_partition_and_unsharded_cache(sbm):
    r, p = sbm
    rp = r_partition(r, 8, n_shards=4, topology=r_tiers.ICI_RING)
    pp = p_partition(p, 8, n_shards=4, topology=p_tiers.ICI_RING)
    r_eng, p_eng = _engine_pair(r, p, clusters=0)
    r_eng.evict_graph("g")
    p_eng.evict_graph("g")
    r_eng.register_graph("g", r, partition=rp)
    p_eng.register_graph("g", p, partition=pp)
    assert p_eng.cache._owner_maps == r_eng.cache._owner_maps != {}
    _epochs(r_eng, p_eng, *_workload(r.n_rows))
    # partition_shards on an unsharded cache is off, as in the reference.
    _, single = _engine_pair(r, p, clusters=8, cache_shards=1)
    assert single._engines["g"].partition is None


def test_partition_owner_map_survives_warm_start(sbm, tmp_path):
    r, p = sbm
    h, w = _workload(r.n_rows)
    _, donor = _engine_pair(r, p)
    donor.submit(PRequest("g", h, w))
    cold = donor.run_batch()
    donor.checkpoint_cache(str(tmp_path))
    _, fresh = _engine_pair(r, p)
    assert fresh.cache._owner_maps
    assert fresh.warm_start(str(tmp_path)).bricks > 0
    for s, shard in enumerate(fresh.cache.shards):
        for key in list(shard._device) + list(shard._host):
            assert fresh.cache.owner_of(key) == s
    fresh.submit(PRequest("g", h, w))
    first = fresh.run_batch()
    assert first.uploaded_bytes == 0
    np.testing.assert_array_equal(first.results[0].output,
                                  cold.results[0].output)


def test_update_graph_keeps_partition_owner_maps(sbm):
    r, p = sbm
    r_eng, p_eng = _engine_pair(r, p)
    h, w = _workload(r.n_rows)
    _epochs(r_eng, p_eng, h, w, n=1)
    before = p_eng._engines["g"].partition
    delta = dict(inserts=[(5, 300, 0.5), (6, 301, 0.25)])
    r_rep, p_rep = r_eng.update_graph("g", **delta), p_eng.update_graph(
        "g", **delta)
    for f in ("plans_updated", "segments_retiled", "segments_reused",
              "retiled_bytes", "stale_keys", "cache_entries_dropped"):
        assert getattr(p_rep, f) == getattr(r_rep, f), f
    after = p_eng._engines["g"].partition
    np.testing.assert_array_equal(after.cluster_to_shard,
                                  before.cluster_to_shard)
    np.testing.assert_array_equal(
        after.cluster_of, r_eng._engines["g"].partition.cluster_of)
    assert p_eng.cache._owner_maps == r_eng.cache._owner_maps
    got = _epochs(r_eng, p_eng, h, w, n=1)[0][1]
    _, crc = _engine_pair(r_eng._graphs["g"], p_eng._graphs["g"],
                          clusters=0)
    crc.submit(PRequest("g", h, w))
    np.testing.assert_array_equal(got, crc.run_batch().results[0].output)


# ---- scripts/lint_plans_torch.py --------------------------------------------

def _script(name):
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / name
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lint_plans_torch_matches_reference(capsys):
    """The port's lint script, on the host, prints what the reference's
    prints line for line after its first heading (every fig6 plan, the
    engine plans and the partitioned SBM plan clean) and exits 0 like
    it."""
    assert _script("lint_plans_torch.py").main(["--device", "cpu"]) == 0
    port = capsys.readouterr().out.splitlines()
    assert _script("lint_plans.py").main() == 0
    ref = capsys.readouterr().out.splitlines()
    assert port[0].startswith("fig6 scheduler plans (scale=")
    assert port[1:] == ref[1:] and len(port) == len(ref)
    assert "partitioned shards (4)" in port[-3] and port[-1].startswith(
        "OK:")
