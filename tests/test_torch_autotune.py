"""The schedule autotuner in the port against the JAX package, on the same
graphs and specs: `segment_ell_widths`, `candidate_bucket_sets` and
`bucket_set_bytes` on the fig6 graphs, `autotune_schedule`'s
`TunedSchedule` (min_bytes, pass order, bucket set, cluster count, brick
and ICI bytes equal; makespans within 1 ulp, ROADMAP queue 3 R1),
`install_schedule` (namespaces with their `:e…` and `:p{k}` tags, every
epoch's byte counters) and `serve_gcn(autotune=True)`."""
import dataclasses
import math

import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import numpy as np
import pytest

import repro.io.tiers as r_tiers
from repro.core import (
    AiresConfig as RConfig, AiresSpGEMM as RSpGEMM,
    TunedSchedule as RTuned, autotune_schedule as r_autotune,
    bucket_set_bytes as r_bucket_bytes,
    candidate_bucket_sets as r_candidates,
    ell_bucket_capacity as r_capacity, plan_memory_dense_features,
    segment_ell_widths as r_widths,
)
from repro.data import (
    SUITESPARSE_SPECS, generate_graph, normalized_adjacency, scaled_spec,
)
from repro.data import generate_sbm_graph as r_sbm
from repro.launch.serve import serve_gcn as r_serve_gcn
from repro.runtime import (
    EngineConfig as REngineConfig, InferenceRequest as RRequest,
    ServingEngine as RServingEngine,
)

import repro_torch.core.analysis as p_analysis
import repro_torch.core.autotune as p_autotune_mod
import repro_torch.io.tiers as p_tiers
from repro_torch.core import (
    AiresConfig as PConfig, AiresSpGEMM as PSpGEMM,
    TransferCoalescingPass, TunedSchedule as PTuned,
    autotune_schedule as p_autotune, bucket_set_bytes as p_bucket_bytes,
    candidate_bucket_sets as p_candidates,
    ell_bucket_capacity as p_capacity, segment_ell_widths as p_widths,
)
from repro_torch.launch.serve import serve_gcn as p_serve_gcn
from repro_torch.runtime import (
    EngineConfig as PEngineConfig, InferenceRequest as PRequest,
    ServingEngine as PServingEngine,
)
from repro_torch.sparse import CSR

FIG6 = ["rUSA", "kV2a", "kU1a", "socLJ1", "kP1a"]
BYTE_FIELDS = ("uploaded_bytes", "cache_hit_bytes", "promoted_bytes",
               "ici_bytes", "segments_streamed", "aggregation_passes")
SPECS = {"tpu_v5e": (r_tiers.TPU_V5E_SYSTEM, p_tiers.TPU_V5E_SYSTEM),
         "paper_gpu": (r_tiers.PAPER_GPU_SYSTEM, p_tiers.PAPER_GPU_SYSTEM)}


@pytest.fixture(autouse=True)
def _analyze_port_plans():
    """The port's static analyzer is on for every plan these tests
    interpret or stream, as the reference suite's is; restored after."""
    previous = p_analysis.set_default_analyze(True)
    yield
    p_analysis.set_default_analyze(previous)


def _port_csr(r):
    return CSR(r.indptr.copy(), r.indices.copy(), r.data.copy(), r.shape)


def _budget(a, width, frac):
    est = plan_memory_dense_features(a, a.n_rows, width, float("inf"))
    return int(est.m_b + est.m_c + frac * a.nbytes())


def _within_ulp(p, r):
    assert abs(p - r) <= math.ulp(max(abs(p), abs(r))), (p, r)


def _same_tuned(p, r):
    """Equal in every field, the two makespans within 1 ulp (R1)."""
    assert isinstance(p, PTuned)
    for f in dataclasses.fields(r):
        pv, rv = getattr(p, f.name), getattr(r, f.name)
        if f.name.endswith("makespan_s"):
            _within_ulp(pv, rv)
        else:
            assert pv == rv, (f.name, pv, rv)
    assert p.is_default == r.is_default
    assert p.describe() == r.describe()


@pytest.fixture(scope="module")
def fig6():
    """The fig6 graphs at the benchmarks' scale, in both packages."""
    from benchmarks.common import SCALE, dataset

    assert SCALE == 1e-3, "the fig6 parity runs at the benchmarks' 1e-3"
    return {name: (dataset(name), _port_csr(dataset(name)))
            for name in FIG6}


@pytest.fixture(scope="module")
def quickstart():
    r = normalized_adjacency(generate_graph(
        scaled_spec(SUITESPARSE_SPECS["socLJ1"], 1e-4), seed=0))
    return r, _port_csr(r)


@pytest.fixture(scope="module")
def sbm():
    r = normalized_adjacency(r_sbm(512, 4096, n_blocks=4, p_in=0.95, seed=0))
    return r, _port_csr(r)


# ---- bucket pricing on the fig6 graphs -------------------------------------

@pytest.mark.parametrize("brick", [8, 128])
@pytest.mark.parametrize("name", FIG6)
def test_bucket_pricing_matches_reference_on_fig6(fig6, name, brick):
    """Per-segment true widths, the candidate sets and every candidate's
    exact brick bytes, at 256 dense features and a budget of several
    segments."""
    r, p = fig6[name]
    budget = _budget(r, 256, 0.3)
    _, r_plan = RSpGEMM(RConfig(device_budget_bytes=budget, bm=brick,
                                bk=brick)).plan(r, (r.n_rows, 256))
    _, p_plan = PSpGEMM(PConfig(device_budget_bytes=budget, bm=brick,
                                bk=brick, device="cpu")).plan(
        p, (p.n_rows, 256))
    widths = p_widths(p, p_plan, bm=brick, bk=brick)
    assert widths == r_widths(r, r_plan, bm=brick, bk=brick)
    rows = [s.n_rows for s in p_plan.segments]
    cands = p_candidates(widths)
    assert cands == r_candidates(widths)
    for cand in cands + [(max(widths),), tuple(range(1, max(widths) + 1))]:
        assert (p_bucket_bytes(widths, rows, cand, brick, brick)
                == r_bucket_bytes(widths, rows, cand, brick, brick))
    if max(widths) > 1:
        for bucket_bytes in (p_bucket_bytes, r_bucket_bytes):
            with pytest.raises(ValueError, match="exceeds every"):
                bucket_bytes(widths, rows, (max(widths) - 1,), brick, brick)


def test_bucket_helpers_match_reference():
    """The reference test's values, and the bucket capacity (with its
    refusal to truncate) on a sweep of widths and ladders."""
    widths, rows = [3, 5, 9], [128, 256, 128]
    for buckets in (None, (3, 5, 9), (4, 16), (9,)):
        assert (p_bucket_bytes(widths, rows, buckets, 128, 128)
                == r_bucket_bytes(widths, rows, buckets, 128, 128))
    assert (p_bucket_bytes(widths, rows, (3, 5, 9), 128, 128)
            < p_bucket_bytes(widths, rows, None, 128, 128))
    for w in (3, 5, 9):
        assert (p_bucket_bytes([w], [7], None, 8, 8, dtype_bytes=2)
                == r_bucket_bytes([w], [7], None, 8, 8, dtype_bytes=2))
    many = list(range(1, 20))
    assert p_candidates(many, max_buckets=4) == r_candidates(many,
                                                             max_buckets=4)
    assert p_candidates([]) == r_candidates([]) == [None]
    for ladder in (None, [49], [42, 49], [341, 467], [1, 2, 3]):
        for w in (0, 1, 2, 3, 41, 42, 43, 49, 64, 340, 341, 467):
            try:
                want = r_capacity(w, ladder)
            except ValueError as e:
                with pytest.raises(ValueError, match="truncate"):
                    p_capacity(w, ladder)
                assert "truncate" in str(e)
            else:
                assert p_capacity(w, ladder) == want
    assert (p_autotune_mod.DEFAULT_MIN_BYTES,
            p_autotune_mod.DEFAULT_PASS_ORDER,
            p_autotune_mod.MIN_BYTES_GRID) == (
        1 << 18, ("shard-placement", "transfer-coalescing"),
        (1 << 18, None, 1 << 14, 1 << 16, 1 << 20))


# ---- autotune_schedule ------------------------------------------------------

@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("name", ["rUSA", "socLJ1"])
def test_autotune_schedule_matches_reference_on_fig6(fig6, name, spec):
    r, p = fig6[name]
    rs, ps = SPECS[spec]
    budget = _budget(r, 256, 0.3)
    r_eng = RSpGEMM(RConfig(device_budget_bytes=budget, bm=8, bk=8,
                            plan_features=256))
    p_eng = PSpGEMM(PConfig(device_budget_bytes=budget, bm=8, bk=8,
                            plan_features=256, device="cpu"))
    tuned = p_autotune(p_eng, p, name, 256, ps)
    _same_tuned(tuned, r_autotune(r_eng, r, name, 256, rs))
    assert tuned.ell_buckets is not None
    assert tuned.ell_bytes < tuned.default_ell_bytes
    assert tuned.predicted_makespan_s <= tuned.default_makespan_s


def test_autotune_custom_grids_match_reference(quickstart):
    r, p = quickstart
    budget = _budget(r, 64, 0.6)
    r_eng = RSpGEMM(RConfig(device_budget_bytes=budget, bm=8, bk=8,
                            plan_features=64))
    p_eng = PSpGEMM(PConfig(device_budget_bytes=budget, bm=8, bk=8,
                            plan_features=64, device="cpu"))
    for kw in (dict(min_bytes_grid=(1 << 18,), bucket_sets=[None]),
               dict(min_bytes_grid=(1 << 18, None, 1 << 20),
                    bucket_sets=[None, (64,), (1, 2), (30, 60, 90)]),
               dict(max_buckets=1)):
        _same_tuned(
            p_autotune(p_eng, p, "g", 16, p_tiers.TPU_V5E_SYSTEM, **kw),
            r_autotune(r_eng, r, "g", 16, r_tiers.TPU_V5E_SYSTEM, **kw))


def _engine_pair(r, p, **kw):
    r_eng = RServingEngine(REngineConfig(**{
        k: getattr(r_tiers, v) if k == "ici_topology" else v
        for k, v in kw.items()}))
    p_eng = PServingEngine(PEngineConfig(device="cpu", **{
        k: getattr(p_tiers, v) if k == "ici_topology" else v
        for k, v in kw.items()}))
    r_eng.register_graph("g", r)
    p_eng.register_graph("g", p)
    return r_eng, p_eng


def test_autotune_partition_arm_matches_reference(sbm):
    """On a four-shard ring cache the partition arm prices cluster counts
    by modeled warm-epoch ICI bytes: the same verdict as the reference,
    and installing it round-trips the cluster count."""
    r, p = sbm
    b = _budget(r, 32, 0.6)
    r_eng, p_eng = _engine_pair(
        r, p, device_budget_bytes=b, cache_device_bytes=b, cache_shards=4,
        ici_topology="ICI_RING", max_batch_features=32)
    tuned, r_tuned = p_eng.autotune("g", width=32), r_eng.autotune(
        "g", width=32)
    _same_tuned(tuned, r_tuned)
    assert tuned.default_warm_ici_bytes > 0
    assert tuned.warm_ici_bytes <= tuned.default_warm_ici_bytes
    p_eng.install_schedule(tuned)
    r_eng.install_schedule(r_tuned)
    spg = p_eng._engines["g"]
    if tuned.partition_clusters is None:
        assert spg.partition is None
    else:
        assert spg.partition.n_clusters == tuned.partition_clusters
    for grid in ((2,), (4, 8, 1000), (1,)):
        _same_tuned(
            p_autotune(spg, p, "g", 32, p_eng.cost_spec(),
                       segment_cache=p_eng.cache, cluster_grid=grid),
            r_autotune(r_eng._engines["g"], r, "g", 32, r_eng.cost_spec(),
                       segment_cache=r_eng.cache, cluster_grid=grid))


def test_autotune_skips_partition_arm_without_sharded_cache(quickstart):
    r, p = quickstart
    b = _budget(r, 64, 0.6)
    r_eng, p_eng = _engine_pair(r, p, device_budget_bytes=b)
    tuned = p_eng.autotune("g")
    _same_tuned(tuned, r_eng.autotune("g"))
    assert tuned.partition_clusters is None
    assert tuned.warm_ici_bytes == tuned.default_warm_ici_bytes == 0
    names = ["transfer-coalescing" if isinstance(x, TransferCoalescingPass)
             else "shard-placement" for x in tuned.build_passes()]
    assert tuple(names) == tuned.pass_order
    with pytest.raises(KeyError):
        p_eng.autotune("nope")


# ---- install_schedule and the namespace tags --------------------------------

def _namespaces(eng):
    return sorted(prep.cache_ns for prep in eng._prepared.values())


@pytest.mark.parametrize("cache", ["single", "sharded"])
def test_install_schedule_matches_reference(quickstart, cache):
    """Autotune and install on both engines after a first epoch: the
    tuned pipeline, the bucket-tagged namespaces and every later epoch's
    bytes equal the reference's; outputs stay those of the untuned
    schedule."""
    r, p = quickstart
    b = _budget(r, 64, 0.6)
    kw = dict(device_budget_bytes=b)
    if cache == "sharded":
        kw.update(cache_shards=4, cache_device_bytes=b,
                  ici_topology="ICI_RING")
    r_eng, p_eng = _engine_pair(r, p, **kw)
    rng = np.random.default_rng(11)
    h = rng.standard_normal((r.n_rows, 16)).astype(np.float32)
    w = [rng.standard_normal((16, 16)).astype(np.float32)]

    def epoch():
        r_eng.submit(RRequest("g", h, w))
        p_eng.submit(PRequest("g", h, w))
        r_rep, p_rep = r_eng.run_batch(), p_eng.run_batch()
        for f in BYTE_FIELDS:
            assert getattr(p_rep, f) == getattr(r_rep, f), f
        return p_rep.results[0].output

    first = epoch()
    p_eng.estimate_request_cost(PRequest("g", h, w))
    assert p_eng._pass_costs
    tuned = p_eng.autotune("g", install=True)
    _same_tuned(tuned, r_eng.autotune("g", install=True))
    assert p_eng.installed_schedules["g"] == tuned
    assert not p_eng._pass_costs
    spg = p_eng._engines["g"]
    assert spg.plan_passes is not None and not spg._prepared
    assert spg.config.ell_buckets == list(tuned.ell_buckets)
    for _ in range(2):
        np.testing.assert_allclose(epoch(), first, rtol=1e-5, atol=1e-5)
    assert _namespaces(spg) == _namespaces(r_eng._engines["g"])
    tag = ":e" + "x".join(str(x) for x in tuned.ell_buckets)
    if tuned.partition_clusters is not None:
        tag += f":p{tuned.partition_clusters}"
    assert all(ns.endswith(tag) for ns in _namespaces(spg))
    p_eng.evict_graph("g")
    assert p_eng.installed_schedules == {}


def test_install_schedule_swaps_partition(sbm):
    r, p = sbm
    b = _budget(r, 32, 0.6)
    r_eng, p_eng = _engine_pair(
        r, p, device_budget_bytes=b, cache_device_bytes=b, cache_shards=4,
        ici_topology="ICI_RING", max_batch_features=32)

    def tuned(cls, clusters, buckets=None):
        return cls(graph="g", min_bytes=1 << 18,
                   pass_order=("shard-placement", "transfer-coalescing"),
                   ell_buckets=buckets, predicted_makespan_s=1.0,
                   default_makespan_s=1.0, partition_clusters=clusters)

    rng = np.random.default_rng(5)
    h = rng.standard_normal((r.n_rows, 32)).astype(np.float32)
    w = [rng.standard_normal((32, 16)).astype(np.float32)]
    outs = []
    for clusters, buckets in ((8, None), (8, (64,)), (None, None)):
        p_eng.install_schedule(tuned(PTuned, clusters, buckets))
        r_eng.install_schedule(tuned(RTuned, clusters, buckets))
        spg = p_eng._engines["g"]
        assert not spg._prepared
        assert (None if spg.partition is None
                else spg.partition.n_clusters) == clusters
        r_eng.submit(RRequest("g", h, w))
        p_eng.submit(PRequest("g", h, w))
        r_rep, p_rep = r_eng.run_batch(), p_eng.run_batch()
        for f in BYTE_FIELDS:
            assert getattr(p_rep, f) == getattr(r_rep, f), f
        assert _namespaces(spg) == _namespaces(r_eng._engines["g"])
        assert p_eng.cache._owner_maps == r_eng.cache._owner_maps
        outs.append(p_rep.results[0].output)
    assert ":p8:e64" not in "".join(_namespaces(spg))
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])


@pytest.mark.parametrize("buckets", [None, [64], [20, 40, 80]])
@pytest.mark.parametrize("clusters", [None, 4])
def test_namespace_tags_match_reference(sbm, buckets, clusters):
    """Both directions' cache namespaces, plans and bricks under a bucket
    ladder and a partition, tag for tag."""
    from repro.sparse.partition import partition_graph as r_partition
    from repro_torch.sparse.partition import partition_graph as p_partition

    r, p = sbm
    b = _budget(r, 32, 0.3)
    r_eng = RSpGEMM(RConfig(device_budget_bytes=b, bm=8, bk=8,
                            ell_buckets=buckets),
                    partition=(None if clusters is None
                               else r_partition(r, clusters)))
    p_eng = PSpGEMM(PConfig(device_budget_bytes=b, bm=8, bk=8,
                            ell_buckets=buckets, device="cpu"),
                    partition=(None if clusters is None
                               else p_partition(p, clusters)))
    for transpose in (False, True):
        rp = r_eng._prepare(r, (r.n_rows, 32), transpose=transpose)
        pp = p_eng._prepare(p, (p.n_rows, 32), transpose=transpose)
        assert pp.cache_ns == rp.cache_ns
        assert pp.fps == rp.fps
        for pe, re in zip(pp.ells, rp.ells):
            np.testing.assert_array_equal(pe.blocks, re.blocks)
            np.testing.assert_array_equal(pe.col_tile, re.col_tile)
    assert list(p_eng._prepared) == list(r_eng._prepared)


# ---- the launcher -----------------------------------------------------------

def test_serve_gcn_autotune_matches_reference():
    p_summary, r_summary = {}, {}
    port = p_serve_gcn(scale=1e-4, autotune=True, summary_out=p_summary,
                       device="cpu")
    ref = r_serve_gcn(scale=1e-4, autotune=True, summary_out=r_summary)
    assert p_summary == r_summary
    assert len(p_summary["installed_schedules"]) == 2
    for p_rep, r_rep in zip(port, ref):
        for f in BYTE_FIELDS:
            assert getattr(p_rep, f) == getattr(r_rep, f), f
        for p_res, r_res in zip(p_rep.results, r_rep.results):
            np.testing.assert_allclose(p_res.output, r_res.output,
                                       atol=1e-4, rtol=1e-5)


def test_estimate_group_cost_waits_for_the_serving_loop(quickstart):
    """`estimate_group_cost` came with the serving loop: it no longer
    raises, and prices groups as the reference does (the name is kept
    from when this test checked the raise). Widths straddling
    `max_batch_features` (64) split into the same passes, each priced at
    its concatenated width."""
    r, p = quickstart
    r_eng, p_eng = _engine_pair(r, p, device_budget_bytes=_budget(r, 64, 0.6))
    rng = np.random.default_rng(0)
    assert p_eng.estimate_group_cost("g", []) == 0.0
    r_group, p_group = [], []
    for f in (40, 16, 40, 8):
        h = rng.standard_normal((r.n_rows, f)).astype(np.float32)
        ws = [rng.standard_normal((f, 32)).astype(np.float32),
              rng.standard_normal((32, 8)).astype(np.float32)]
        r_group.append(RRequest("g", h, ws))
        p_group.append(PRequest("g", h, ws))
    cost = p_eng.estimate_group_cost("g", p_group)
    assert cost == r_eng.estimate_group_cost("g", r_group) > 0.0
