"""The port's checkpoints, brick checkpoints, warm start and graph eviction
against the JAX package's: a checkpoint written by either package loads in
the other, a port engine warm-started from a reference engine's bricks
serves its first epoch without uploading, and `evict_graph` leaves the same
cache and directory behind."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as r_ckpt
from repro.core import AiresSpGEMM as RSpGEMM
from repro.core.memory_model import plan_memory_dense_features
from repro.data import (
    SUITESPARSE_SPECS, generate_graph, normalized_adjacency, scaled_spec,
)
from repro.io import CacheDirectory as RDirectory, prefix_matches
from repro.runtime import (
    EngineConfig as REngineConfig, InferenceRequest as RRequest,
    ServingEngine as RServingEngine,
)

import repro_torch.checkpoint as p_ckpt
from repro_torch.core import AiresSpGEMM as PSpGEMM
from repro_torch.io import CacheDirectory as PDirectory
from repro_torch.runtime import (
    EngineConfig as PEngineConfig, InferenceRequest as PRequest,
    ServingEngine as PServingEngine,
)
from repro_torch.sparse import CSR

BYTE_FIELDS = ("uploaded_bytes", "cache_hit_bytes", "promoted_bytes",
               "segments_streamed", "aggregation_passes", "ici_bytes",
               "directory_hit_bytes", "duplicate_avoided_bytes")


@pytest.fixture(scope="module")
def graph():
    """The reference engine tests' quickstart graph, in both packages."""
    r = normalized_adjacency(generate_graph(
        scaled_spec(SUITESPARSE_SPECS["socLJ1"], 1e-4), seed=0))
    p = CSR(r.indptr.copy(), r.indices.copy(), r.data.copy(), r.shape)
    est = plan_memory_dense_features(r, r.n_rows, 64, float("inf"))
    return p, r, int(est.m_b + est.m_c + 0.6 * r.nbytes())


def _engines(budget, directory=(None, None), **kw):
    kw = dict(device_budget_bytes=budget, max_batch_features=64, **kw)
    return (PServingEngine(PEngineConfig(device="cpu", **kw),
                           directory=directory[0]),
            RServingEngine(REngineConfig(**kw), directory=directory[1]))


def _request(graph_rows, seed=21):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((graph_rows, 32)).astype(np.float32)
    w = [rng.standard_normal((32, 16)).astype(np.float32)]
    return h, w


def _by_path(tms) -> dict:
    return {p.value: b for p, b in tms.bytes_by_path().items()}


# ---- Checkpointer ----------------------------------------------------------


def _tree():
    g = torch.Generator().manual_seed(0)
    return {
        "params": {"w": torch.randn((4, 3), generator=g),
                   "layers": [{"a": torch.randn((2,), generator=g)},
                              {"a": torch.zeros((2,))}]},
        "opt_state": {"m": {"w": torch.zeros((4, 3)),
                            "layers": [{"a": torch.ones((2,))}] * 2},
                      "step": torch.tensor(7, dtype=torch.int32)},
    }


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_checkpointer_roundtrips_tensors(tmp_path):
    ck = p_ckpt.Checkpointer(str(tmp_path))
    tree = _tree()
    ck.save(10, tree["params"], tree["opt_state"])
    restored, step = ck.restore(tree)
    assert step == 10
    for a, b in zip(_leaves(tree), _leaves(restored)):
        assert isinstance(b, torch.Tensor) and b.dtype == a.dtype
        assert torch.equal(a, b)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_load_across_packages(tmp_path, writer):
    tree = _tree()
    np_tree = jax.tree_util.tree_map(lambda t: t.numpy(), tree)
    if writer == "port":
        p_ckpt.Checkpointer(str(tmp_path)).save(3, tree["params"],
                                                tree["opt_state"])
        restored, step = r_ckpt.Checkpointer(str(tmp_path)).restore(
            jax.tree_util.tree_map(jnp.asarray, np_tree))
    else:
        r_ckpt.Checkpointer(str(tmp_path)).save(
            3, jax.tree_util.tree_map(jnp.asarray, np_tree["params"]),
            np_tree["opt_state"])
        restored, step = p_ckpt.Checkpointer(str(tmp_path)).restore(tree)
    assert step == 3
    for a, b in zip(_leaves(tree), _leaves(restored)):
        np.testing.assert_array_equal(np.asarray(b), a.numpy())


def _bf16_tree():
    """A bf16 params tree with its AdamW state (f32 moments, int step) and
    an f16 leaf: the dtypes of a bf16 model in training."""
    g = torch.Generator().manual_seed(1)
    params = {"embed": torch.randn((6, 4), generator=g).bfloat16(),
              "layers": [{"w": torch.randn((4, 4), generator=g).bfloat16(),
                          "ln": torch.zeros((4,), dtype=torch.bfloat16)}],
              "h": torch.randn((3,), generator=g).half()}
    m = jax.tree_util.tree_map(lambda t: t.float() * 0.1, params)
    return params, {"m": m, "v": jax.tree_util.tree_map(torch.square, m),
                    "step": torch.tensor(3, dtype=torch.int32)}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.element_size() == 2 \
        else t.numpy()


def test_bf16_tree_roundtrips_bit_for_bit(tmp_path):
    """F1: a bf16 leaf is written as the reference writes one (`|V2`, its
    raw words) and restored by its bits, in the skeleton's dtype."""
    params, opt_state = _bf16_tree()
    ck = p_ckpt.Checkpointer(str(tmp_path))
    ck.save(2, params, opt_state)
    with np.load(tmp_path / "step_2" / "arrays.npz") as data:
        assert data["params/embed"].dtype == np.dtype("V2")
        assert data["params/h"].dtype == np.float16
        assert data["opt_state/m/embed"].dtype == np.float32
    tree = {"params": params, "opt_state": opt_state}
    restored, step = ck.restore(tree)
    assert step == 2
    for a, b in zip(_leaves(tree), _leaves(restored)):
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(_bits(b), _bits(a))


def test_bf16_checkpoints_cross_packages(tmp_path):
    """F1 and R4: the reference writes a bf16 leaf as `|V2` and its own
    restore returns those untyped words (R4); the port restores them as
    bf16 with the same bits, and what the port writes the reference reads
    back as the same `|V2` words."""
    params, opt_state = _bf16_tree()
    ref_params = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
        if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy()), params)
    r_ckpt.Checkpointer(str(tmp_path / "ref")).save(
        4, ref_params, jax.tree_util.tree_map(lambda t: t.numpy(), opt_state))
    restored, _ = p_ckpt.Checkpointer(str(tmp_path / "ref")).restore(
        {"params": params, "opt_state": opt_state})
    for a, b in zip(_leaves(params), _leaves(restored["params"])):
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(_bits(b), _bits(a))

    p_ckpt.Checkpointer(str(tmp_path / "port")).save(5, params, opt_state)
    back, _ = r_ckpt.Checkpointer(str(tmp_path / "port")).restore(
        {"params": ref_params, "opt_state": opt_state})
    raw = back["params"]["layers"][0]["w"]
    assert raw.dtype == np.dtype("V2")             # R4: untyped words
    np.testing.assert_array_equal(
        raw.view(np.int16), _bits(params["layers"][0]["w"]))
    np.testing.assert_array_equal(back["params"]["h"],
                                  params["h"].numpy())


def test_checkpointer_atomicity_and_pruning(tmp_path):
    ck = p_ckpt.Checkpointer(str(tmp_path), keep_last=2)
    tree = _tree()
    ck.save(5, tree["params"], tree["opt_state"])
    os.makedirs(tmp_path / "step_9.tmp")  # a crashed writer's leftovers
    assert p_ckpt.latest_step(str(tmp_path)) == 5
    for s in (6, 7, 8):
        ck.save(s, tree["params"], tree["opt_state"])
    steps = sorted(int(n.split("_")[1].split(".")[0])
                   for n in os.listdir(tmp_path) if not n.endswith(".tmp"))
    assert steps == [7, 8]
    assert p_ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        p_ckpt.Checkpointer(str(tmp_path / "empty")).restore(tree)


# ---- brick checkpoints -----------------------------------------------------


def _bricks(seed=0, count=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        meta = {"graph_id": f"g{seed}:fwd:w64", "segment_id": i,
                "wire_format": "bricks", "shape": [i + 1, 2, 8, 8],
                "fingerprint": f"s{i}", "nbytes": 100 + i, "bm": 8,
                "bk": 8, "n_rows": 8 * (i + 1), "n_cols": 40}
        arrays = {"blocks": rng.standard_normal(
                      (i + 1, 2, 8, 8)).astype(np.float32),
                  "col_tile": rng.integers(0, 5, (i + 1, 2)).astype(np.int32),
                  "n_tiles": rng.integers(0, 3, (i + 1,)).astype(np.int32)}
        out.append((meta, arrays))
    return out


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_brick_checkpoints_load_across_packages(tmp_path, writer):
    bricks = _bricks()
    save, load = ((p_ckpt.save_segment_bricks, r_ckpt.load_segment_bricks)
                  if writer == "port" else
                  (r_ckpt.save_segment_bricks, p_ckpt.load_segment_bricks))
    path = save(str(tmp_path), bricks, step=2)
    assert path == os.path.join(str(tmp_path), p_ckpt.BRICKS_SUBDIR,
                                "step_2")
    loaded = load(str(tmp_path))
    key = lambda mb: mb[0]["segment_id"]  # noqa: E731
    assert len(loaded) == len(bricks)
    for (m0, a0), (m1, a1) in zip(sorted(bricks, key=key),
                                  sorted(loaded, key=key)):
        assert m0 == m1
        assert a0.keys() == a1.keys()
        for k in a0:
            np.testing.assert_array_equal(a0[k], a1[k])
            assert a0[k].dtype == a1[k].dtype


def test_load_segment_bricks_ignores_foreign_checkpoints(tmp_path):
    p_ckpt.Checkpointer(str(tmp_path)).save(
        3, params={"layer0": {"w": torch.ones((2, 2))}}, opt_state={})
    assert p_ckpt.load_segment_bricks(str(tmp_path)) == []
    assert p_ckpt.load_segment_bricks(str(tmp_path / "missing")) == []


# ---- warm start ------------------------------------------------------------


@pytest.mark.parametrize("donor", ["reference", "port"])
@pytest.mark.parametrize("shards", [1, 4])
def test_warm_start_across_packages(graph, tmp_path, donor, shards):
    """A fresh engine of one package warm-started from the other's
    `checkpoint_cache` (and the reference's own warm start beside it):
    equal `WarmStartReport`s and per-path bytes, and a first epoch that
    uploads nothing and serves the donor's outputs."""
    p_a, r_a, budget = graph
    h, w = _request(r_a.n_rows)
    p_donor, r_donor = _engines(budget, cache_shards=shards)
    p_donor.register_graph("lj", p_a)
    r_donor.register_graph("lj", r_a)
    p_donor.submit(PRequest("lj", h, w))
    r_donor.submit(RRequest("lj", h, w))
    p_cold, r_cold = p_donor.run_batch(), r_donor.run_batch()
    assert p_cold.uploaded_bytes == r_cold.uploaded_bytes > 0
    (p_donor if donor == "port" else r_donor).checkpoint_cache(
        str(tmp_path))

    p_fresh, r_fresh = _engines(budget, cache_shards=shards)
    p_fresh.register_graph("lj", p_a)
    r_fresh.register_graph("lj", r_a)
    p_ws, r_ws = (p_fresh.warm_start(str(tmp_path)),
                  r_fresh.warm_start(str(tmp_path)))
    assert (p_ws.bricks, p_ws.wire_bytes) == (r_ws.bricks, r_ws.wire_bytes)
    assert p_ws.wire_bytes == r_cold.uploaded_bytes and p_ws.bricks > 0
    assert p_ws.modeled_seconds == pytest.approx(r_ws.modeled_seconds,
                                                 rel=1e-12)
    assert _by_path(p_fresh.tms) == _by_path(r_fresh.tms)

    p_fresh.submit(PRequest("lj", h, w))
    r_fresh.submit(RRequest("lj", h, w))
    p_first, r_first = p_fresh.run_batch(), r_fresh.run_batch()
    assert p_first.uploaded_bytes == 0
    for f in BYTE_FIELDS:
        assert getattr(p_first, f) == getattr(r_first, f), f
    assert p_first.cache_hit_bytes == r_cold.uploaded_bytes
    np.testing.assert_allclose(p_first.results[0].output,
                               r_cold.results[0].output, atol=1e-4,
                               rtol=1e-5)
    assert _by_path(p_fresh.tms) == _by_path(r_fresh.tms)


def test_warm_start_and_checkpoint_need_a_cache(graph, tmp_path):
    p_a, _, budget = graph
    eng = PServingEngine(PEngineConfig(device_budget_bytes=budget,
                                       cache_enabled=False, device="cpu"))
    with pytest.raises(ValueError, match="cache_enabled"):
        eng.warm_start(str(tmp_path))
    with pytest.raises(ValueError, match="cache_enabled"):
        eng.checkpoint_cache(str(tmp_path))
    with pytest.raises(ValueError, match="contradicts"):
        PServingEngine(PEngineConfig(device_budget_bytes=budget,
                                     cache_enabled=False, device="cpu"),
                       directory=PDirectory())


def test_checkpoint_cache_keeps_training_checkpoints(graph, tmp_path):
    p_a, _, budget = graph
    ckpt = p_ckpt.Checkpointer(str(tmp_path))
    ckpt.save(100, params={"w": torch.ones((2, 2))}, opt_state={})
    eng = PServingEngine(PEngineConfig(device_budget_bytes=budget,
                                       max_batch_features=64, device="cpu"))
    eng.register_graph("g", p_a)
    eng.infer("g", np.zeros((p_a.n_rows, 16), np.float32))
    eng.checkpoint_cache(str(tmp_path))
    assert os.path.isdir(tmp_path / "step_100")
    restored, step = ckpt.restore({"params": {"w": None}, "opt_state": {}})
    assert step == 100
    np.testing.assert_array_equal(restored["params"]["w"], np.ones((2, 2)))
    assert eng.warm_start(str(tmp_path)).bricks > 0


# ---- graph eviction --------------------------------------------------------


def test_evict_graph_matches_reference(graph):
    """Orphans come back, every namespace of the graph leaves the cache,
    and its engine (with its prepared bricks) is dropped."""
    p_a, r_a, budget = graph
    h, w = _request(r_a.n_rows, seed=8)
    p_eng, r_eng = _engines(budget)
    for eng, a, req in ((p_eng, p_a, PRequest), (r_eng, r_a, RRequest)):
        eng.register_graph("g", a)
        eng.infer("g", h)
        assert len(eng.cache) > 0
        eng.submit(req("g", h, w))
    p_orphans, r_orphans = p_eng.evict_graph("g"), r_eng.evict_graph("g")
    assert ([r.request_id for r in p_orphans]
            == [r.request_id for r in r_orphans] == [1])
    assert len(p_eng.cache) == len(r_eng.cache) == 0
    assert p_eng.cache._pins == {} and "g" not in p_eng._engines
    assert p_eng.graphs == r_eng.graphs == []
    assert p_eng.run_batch().results == []


def test_evict_graph_unpublishes_directory_holdings(graph):
    """Two four-shard workers sharing a directory: evicting on worker 0
    drops exactly worker 0's holdings under the graph, on both packages,
    and worker 1 then serves without a peer hit."""
    p_a, r_a, budget = graph
    h, _ = _request(r_a.n_rows, seed=13)
    probe = _engines(budget)[1]
    probe.register_graph("lj", r_a)
    probe.infer("lj", h)
    wire = probe.cache_stats().hit_bytes + probe.cache_stats().miss_bytes
    dirs = (PDirectory(), RDirectory())
    workers = [_engines(budget, directory=dirs,
                        cache_device_bytes=max(4, wire // 2),
                        cache_shards=4, worker_id=wid) for wid in (0, 1)]
    for p_w, r_w in workers:
        p_w.register_graph("lj", p_a)
        r_w.register_graph("lj", r_a)
        p_w.submit(PRequest("lj", h))
        r_w.submit(RRequest("lj", h))
        p_rep, r_rep = p_w.run_batch(), r_w.run_batch()
        for f in BYTE_FIELDS:
            assert getattr(p_rep, f) == getattr(r_rep, f), f

    def holdings(directory, prefix):
        return sorted((str(k.graph_id), k.segment_id, directory.holder(k))
                      for k in directory._entries
                      if prefix_matches(k.graph_id, prefix))
    p_prefix = PSpGEMM.graph_cache_prefix(p_a)
    assert p_prefix == RSpGEMM.graph_cache_prefix(r_a)
    assert holdings(dirs[0], p_prefix) == holdings(dirs[1], p_prefix)
    assert any(holder == 0 for *_, holder in holdings(dirs[0], p_prefix))
    workers[0][0].evict_graph("lj")
    workers[0][1].evict_graph("lj")
    assert holdings(dirs[0], p_prefix) == holdings(dirs[1], p_prefix)
    assert all(holder == 1 for *_, holder in holdings(dirs[0], p_prefix))
    assert not any(prefix_matches(str(k.graph_id), p_prefix)
                   for k, _, _ in workers[0][0].cache.export_entries())
    p_w1, r_w1 = workers[1]
    p_w1.submit(PRequest("lj", h))
    r_w1.submit(RRequest("lj", h))
    p_rep, r_rep = p_w1.run_batch(), r_w1.run_batch()
    for f in BYTE_FIELDS:
        assert getattr(p_rep, f) == getattr(r_rep, f), f
    assert p_rep.directory_hit_bytes == 0
