"""The port's sharded segment cache, cross-worker cache directory, cache
invalidation and ICI topology against the JAX package's: the same
operations give the same owners, tiers, `CacheStats`, per-path bytes and
directory holdings, exactly."""
import dataclasses
import zlib

import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.io as r_io
import repro.io.shard_cache as r_shard
import repro.io.tiers as r_tiers

import repro_torch.io as p_io
import repro_torch.io.shard_cache as p_shard
import repro_torch.io.tiers as p_tiers

STAT_FIELDS = [f.name for f in dataclasses.fields(p_io.CacheStats)]


def test_cache_stats_fields_are_the_references():
    assert STAT_FIELDS == [f.name for f in dataclasses.fields(
        r_io.CacheStats)]


def _key(mod, i, graph="g0"):
    return mod.SegmentKey(graph, i, "bricks", (i, 8, 8))


def _by_path(tms) -> dict:
    return {p.value: b for p, b in tms.bytes_by_path().items()}


def _seconds_by_path(tms) -> dict:
    return {p.value: s for p, s in tms.seconds_by_path().items()}


def _tier(t):
    return None if t is None else t.value


# ---- owners and topology ---------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 7, 8])
def test_shard_of_matches_reference(n_shards):
    rng = np.random.default_rng(n_shards)
    for _ in range(200):
        fp_graph = int(rng.integers(0, 10**6))
        graph = f"g{fp_graph:x}:fwd:w{int(rng.integers(1, 2048))}"
        i = int(rng.integers(0, 5000))
        dims = rng.integers(1, 9000, size=int(rng.integers(1, 5)))
        shape = tuple(int(d) for d in dims)
        fp = f"s{int(rng.integers(0, 99))}"
        pk = p_io.SegmentKey(graph, i, "bricks", shape, fingerprint=fp)
        rk = r_io.SegmentKey(graph, i, "bricks", shape, fingerprint=fp)
        assert p_shard._shard_blob(pk) == r_shard._shard_blob(rk)
        assert p_io.shard_of(pk, n_shards) == r_io.shard_of(rk, n_shards)


def test_shard_blob_is_pinned():
    """The reference test's pinned blob and CRC hold in the port, and the
    fingerprint stays out of the owner hash."""
    k = p_io.SegmentKey("g0", 3, "bricks", (3, 8, 8))
    assert p_shard._shard_blob(k) == b"('g0', 3, 'bricks', (3, 8, 8))"
    assert zlib.crc32(p_shard._shard_blob(k)) == 1050362079
    assert p_io.shard_of(k, 4) == 3
    k1 = p_io.SegmentKey("g0", 1, "bricks", (7,))
    assert p_shard._shard_blob(k1) == b"('g0', 1, 'bricks', (7,))"
    kf = dataclasses.replace(k, fingerprint="deadbeef")
    assert p_io.shard_of(kf, 4) == p_io.shard_of(k, 4)


@pytest.mark.parametrize("kind", ["all_to_all", "ring"])
def test_ici_hops_match_reference(kind):
    p_topo, r_topo = p_tiers.ICITopology(kind), r_tiers.ICITopology(kind)
    for n in range(1, 9):
        for src in range(n):
            for dst in range(n):
                assert p_topo.hops(src, dst, n) == r_topo.hops(src, dst, n)
    assert p_io.ICI_RING.hops(0, 4, 8) == 4
    assert p_io.ICI_ALL_TO_ALL.hops(0, 4, 8) == 1


def test_topology_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown ICI topology"):
        p_tiers.ICITopology("torus")


@pytest.mark.parametrize("hops", [1, 2, 3])
def test_multi_hop_transfer_matches_reference(hops):
    p_tms = p_tiers.TieredMemorySystem(p_tiers.PAPER_GPU_SYSTEM)
    r_tms = r_tiers.TieredMemorySystem(r_tiers.PAPER_GPU_SYSTEM)
    ps = p_tms.transfer(p_tiers.Path.ICI, p_tiers.MemoryTier.DEVICE,
                        p_tiers.MemoryTier.DEVICE, 1 << 20, tag="x",
                        hops=hops)
    rs = r_tms.transfer(r_tiers.Path.ICI, r_tiers.MemoryTier.DEVICE,
                        r_tiers.MemoryTier.DEVICE, 1 << 20, tag="x",
                        hops=hops)
    assert ps == rs
    assert _by_path(p_tms) == _by_path(r_tms) == {"ici": hops << 20}
    assert p_tms.transfers[0].hops == r_tms.transfers[0].hops == hops


# ---- a random op sequence on both packages ---------------------------------


class Pair:
    """One cache (or set of worker caches) per package, built alike, every
    operation applied to both and its result compared."""

    def __init__(self, build):
        self.r_tms = r_tiers.TieredMemorySystem(r_tiers.PAPER_GPU_SYSTEM)
        self.p_tms = p_tiers.TieredMemorySystem(p_tiers.PAPER_GPU_SYSTEM)
        self.ref = build(r_io, r_tiers, self.r_tms, {})
        self.port = build(p_io, p_tiers, self.p_tms, {"device": "cpu"})

    def both(self, fn):
        r, p = fn(self.ref, r_io), fn(self.port, p_io)
        if isinstance(r, tuple) and len(r) == 2 and isinstance(r[1], float):
            assert p[1] == r[1]
            r, p = r[0], p[0]
        assert p == r
        return p

    def check(self, caches_of, keys):
        for rc, pc in zip(caches_of(self.ref), caches_of(self.port)):
            for f in STAT_FIELDS:
                assert getattr(pc.stats, f) == getattr(rc.stats, f), f
            assert pc.device_used_bytes == rc.device_used_bytes
            assert pc.host_used_bytes == rc.host_used_bytes
            for rk, pk in keys:
                assert _tier(pc.tier_of(pk)) == _tier(rc.tier_of(rk))
                if hasattr(rc, "owner_of"):
                    assert pc.owner_of(pk) == rc.owner_of(rk)
        assert _by_path(self.p_tms) == _by_path(self.r_tms)
        assert _seconds_by_path(self.p_tms) == _seconds_by_path(self.r_tms)


def _run_random_ops(pair, caches_of, seed, n_keys=16, steps=150,
                    max_bytes=24, shards=1):
    rng = np.random.default_rng(seed)
    ids = [(j, f"g{j % 3}") for j in range(n_keys)]
    keys = [(_key(r_io, j, g), _key(p_io, j, g)) for j, g in ids]
    n_caches = len(caches_of(pair.ref))
    for _ in range(steps):
        c = int(rng.integers(0, n_caches))
        j, g = ids[int(rng.integers(0, n_keys))]
        nb = int(rng.integers(1, max_bytes))
        op = rng.random()

        def pick(caches, mod):
            return caches_of(caches)[c], _key(mod, j, g)
        if op < 0.4:
            pair.both(lambda cs, mod: pick(cs, mod)[0].get_with_cost(
                pick(cs, mod)[1], nbytes=nb))
        elif op < 0.55:
            shard = (int(rng.integers(0, shards))
                     if shards > 1 and rng.random() < 0.5 else None)
            pair.both(lambda cs, mod: pick(cs, mod)[0].peek_cost(
                pick(cs, mod)[1], nbytes=nb, shard=shard))
        elif op < 0.9:
            shard = (int(rng.integers(0, shards))
                     if shards > 1 and rng.random() < 0.3 else None)
            kw = {} if shard is None else {"shard": shard}
            pair.both(lambda cs, mod: pick(cs, mod)[0].put(
                pick(cs, mod)[1], ("payload", j, nb), nb, **kw))
        elif op < 0.95:
            pair.both(lambda cs, mod: pick(cs, mod)[0].invalidate_keys(
                [pick(cs, mod)[1]]))
        else:
            pair.both(lambda cs, mod: caches_of(cs)[c].invalidate_graph(g))
    pair.check(caches_of, keys)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("topology", ["all_to_all", "ring"])
def test_sharded_op_sequences_match_reference(seed, topology):
    rng = np.random.default_rng(1000 + seed)
    n_shards = int(rng.integers(2, 7))
    local = int(rng.integers(0, n_shards))
    dev = int(rng.integers(n_shards * 4, 160))
    host = int(rng.integers(n_shards * 4, 200)) if seed % 2 else None

    def build(io, tiers, tms, kw):
        return io.ShardedSegmentCache(
            dev, host, tms=tms, n_shards=n_shards, local_shard=local,
            topology=tiers.ICITopology(topology), **kw)
    pair = Pair(build)
    _run_random_ops(pair, lambda c: [c], seed, shards=n_shards)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n_shards", [1, 4])
def test_two_workers_with_a_directory_match_reference(seed, n_shards):
    """Two workers' caches sharing one `CacheDirectory`: dedup, peer
    serves and unpublishing give the same counters and holders."""
    def build(io, tiers, tms, kw):
        directory = io.CacheDirectory()
        if n_shards == 1:
            caches = [io.TieredSegmentCache(24, tms=tms, directory=directory,
                                            worker_id=w, **kw)
                      for w in (0, 1)]
        else:
            caches = [io.ShardedSegmentCache(
                48, tms=tms, n_shards=n_shards, directory=directory,
                worker_id=w, **kw) for w in (0, 1)]
        return caches, directory
    pair = Pair(build)
    _run_random_ops(pair, lambda c: c[0], seed, shards=n_shards)
    r_dir, p_dir = pair.ref[1], pair.port[1]
    for f in ("lookups", "hits", "hit_bytes", "duplicates_avoided",
              "duplicate_avoided_bytes"):
        assert getattr(p_dir, f) == getattr(r_dir, f), f
    assert len(p_dir) == len(r_dir)
    for j in range(16):
        assert (p_dir.holder(_key(p_io, j, f"g{j % 3}"))
                == r_dir.holder(_key(r_io, j, f"g{j % 3}")))


def check_one_shard_matches_tiered(seed):
    """A 1-shard port cache is byte-identical to the port's bare
    `TieredSegmentCache` under any op mix, and charges no ICI."""
    rng = np.random.default_rng(seed)
    dev_budget = int(rng.integers(4, 64))
    host_budget = int(rng.integers(4, 64)) if rng.random() < 0.5 else None
    tms_a = p_tiers.TieredMemorySystem(p_tiers.PAPER_GPU_SYSTEM)
    tms_b = p_tiers.TieredMemorySystem(p_tiers.PAPER_GPU_SYSTEM)
    ref = p_io.TieredSegmentCache(dev_budget, host_budget, tms=tms_a,
                                  device="cpu")
    one = p_io.ShardedSegmentCache(dev_budget, host_budget, tms=tms_b,
                                   n_shards=1, device="cpu")
    keys = [_key(p_io, j, graph=f"g{j % 3}") for j in range(12)]
    for _ in range(100):
        k = keys[int(rng.integers(0, len(keys)))]
        nb = int(rng.integers(1, dev_budget + 8))
        op = rng.random()
        if op < 0.45:
            assert ref.get(k, nbytes=nb) == one.get(k, nbytes=nb)
        elif op < 0.9:
            payload = ("payload", k.segment_id, nb)
            ref.put(k, payload, nb)
            one.put(k, payload, nb)
        else:
            assert ref.invalidate_graph(k.graph_id) \
                == one.invalidate_graph(k.graph_id)
    for f in STAT_FIELDS:
        assert getattr(ref.stats, f) == getattr(one.stats, f), f
    assert one.stats.ici_bytes == 0 and one.stats.remote_hits == 0
    assert ref.device_used_bytes == one.device_used_bytes
    assert ref.host_used_bytes == one.host_used_bytes
    for k in keys:
        assert ref.tier_of(k) == one.tier_of(k)
    assert tms_a.bytes_by_path() == tms_b.bytes_by_path()
    assert tms_a.seconds_by_path() == tms_b.seconds_by_path()


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(st.integers(0, 2**31 - 1))
def test_one_shard_matches_tiered(seed):
    check_one_shard_matches_tiered(seed)


def test_invalid_construction_raises_like_reference():
    for kw in ({"device_budget_bytes": 8, "n_shards": 0},
               {"device_budget_bytes": 8, "n_shards": 2, "local_shard": 2},
               {"device_budget_bytes": 3, "n_shards": 4},
               {"device_budget_bytes": 8, "n_shards": 2, "devices": [1]}):
        with pytest.raises(ValueError):
            r_io.ShardedSegmentCache(**kw)
        with pytest.raises(ValueError):
            p_io.ShardedSegmentCache(device="cpu", **kw)


# ---- owner maps ------------------------------------------------------------


def test_owner_maps_match_reference():
    """Owner maps route puts and gets, override the CRC owner, keep the
    per-key override out when a put lands on the mapped owner, survive
    clear() and invalidate_keys, and drop with their namespace."""
    def build(io, tiers, tms, kw):
        return io.ShardedSegmentCache(64, n_shards=4, local_shard=1,
                                      tms=tms, **kw)
    pair = Pair(build)
    keys = [(_key(r_io, i), _key(p_io, i)) for i in range(6)]
    pair.both(lambda c, mod: c.install_owner_map("g0", [1, 3, 2, 2],
                                                 clusters=[0, 1, 1, 1]))
    pair.both(lambda c, mod: [c.owner_of(_key(mod, i)) for i in range(6)])
    pair.both(lambda c, mod: [c.cluster_of_key(_key(mod, i))
                              for i in range(6)])
    for i in range(4):
        pair.both(lambda c, mod: c.put(_key(mod, i), f"v{i}", 8))
    pair.both(lambda c, mod: c.put(_key(mod, 2), "v2", 8, shard=0))
    assert pair.port._locations.keys() == {_key(p_io, 2)}
    for i in range(4):
        pair.both(lambda c, mod: c.get_with_cost(_key(mod, i), nbytes=8))
    pair.check(lambda c: [c], keys)
    pair.both(lambda c, mod: c.clear())
    pair.both(lambda c, mod: c.owner_map("g0"))
    pair.both(lambda c, mod: c.invalidate_keys([_key(mod, 0)]))
    pair.both(lambda c, mod: c.install_owner_map("g0", [0, 1]))
    assert pair.port.cluster_of_key(_key(p_io, 0)) is None
    pair.both(lambda c, mod: c.invalidate_prefix("g0"))
    assert pair.port.owner_map("g0") is None
    pair.both(lambda c, mod: c.drop_owner_map("g0"))
    pair.check(lambda c: [c], keys)
    with pytest.raises(ValueError, match="outside"):
        pair.port.install_owner_map("g0", [0, 4])
    with pytest.raises(ValueError, match="length"):
        pair.port.install_owner_map("g0", [0, 1], clusters=[0])


def test_remote_host_hit_promotes_then_ships_over_ici():
    tms = p_tiers.TieredMemorySystem(p_tiers.PAPER_GPU_SYSTEM)
    cache = p_io.ShardedSegmentCache(4, n_shards=2, tms=tms, device="cpu")
    i = 0
    while p_io.shard_of(_key(p_io, i), 2) != 1:
        i += 1
    k = _key(p_io, i)
    cache.put(k, "v", 2)
    start = i + 1
    for _ in range(2):
        while p_io.shard_of(_key(p_io, start), 2) != 1:
            start += 1
        cache.put(_key(p_io, start), "w", 1)
        start += 1
    assert cache.tier_of(k) == p_tiers.MemoryTier.HOST
    tms.reset_accounting()
    value, cost = cache.get_with_cost(k, nbytes=2)
    assert value == "v"
    by_tag = {}
    for t in tms.transfers:
        by_tag.setdefault(t.tag, []).append(t)
    assert [t.nbytes for t in by_tag["cache/promote"]] == [2]
    assert [t.nbytes for t in by_tag["cache/ici"]] == [2]
    assert cost == pytest.approx(by_tag["cache/promote"][0].seconds
                                 + by_tag["cache/ici"][0].seconds)


# ---- the cross-worker directory --------------------------------------------


def _pressured_pair(io, directory, budget=2, **kw):
    return [io.TieredSegmentCache(device_budget_bytes=budget,
                                  directory=directory, worker_id=w, **kw)
            for w in (0, 1)]


@pytest.mark.parametrize("case", ["dedup", "peer_serve", "unpublish"])
def test_directory_semantics_match_reference(case):
    """The reference directory tests' scenarios, on both packages, with
    every counter and holder compared."""
    def run(io, tiers, kw):
        tms = tiers.TieredMemorySystem(tiers.PAPER_GPU_SYSTEM)
        directory = io.CacheDirectory()
        w0, w1 = _pressured_pair(io, directory, tms=tms, **kw)
        k = [_key(io, i) for i in range(12)]
        out = []
        if case == "dedup":
            for i in range(4):
                w0.put(k[i], f"v{i}", 1)
            for i in range(4):
                w1.put(k[i], f"v{i}", 1)
        elif case == "peer_serve":
            for i in range(3):
                w0.put(k[i], f"v{i}", 1)
            tms.reset_accounting()
            out.append(w1.get(k[0], nbytes=1))
            out.append(tms.transfers[-1].tag)
            out.append(w1.peek_cost(k[1], nbytes=1, tms=tms))
            w1.put(k[10], "x", 1)
            w1.put(k[11], "y", 1)
        else:
            for i in range(3):
                w0.put(k[i], f"v{i}", 1)
            out.append(w0.get(k[0], nbytes=1))
            out.append(directory.holder(k[0]))
            for i in range(3):
                w1.put(_key(io, i, "gB"), f"b{i}", 1)
            out.append(directory.holder(_key(io, 0, "gB")))
            w1.invalidate_graph("gB")
            out.append(directory.holder(_key(io, 0, "gB")))
            out.append(w0.clear())
        out.append([directory.holder(key) for key in k])
        out.append([[getattr(w.stats, f) for f in STAT_FIELDS]
                    for w in (w0, w1)])
        out.append((directory.lookups, directory.hits, directory.hit_bytes,
                    directory.duplicates_avoided,
                    directory.duplicate_avoided_bytes, len(directory)))
        out.append({p.value: b for p, b in tms.bytes_by_path().items()})
        return out
    assert run(p_io, p_tiers, {"device": "cpu"}) == run(r_io, r_tiers, {})


def test_directory_rejects_duplicate_worker_claim():
    directory = p_io.CacheDirectory()
    directory.claim_worker(0)
    directory.claim_worker(1)
    with pytest.raises(ValueError, match="already claimed"):
        directory.claim_worker(0)


def test_directory_off_is_a_noop():
    plain = p_io.TieredSegmentCache(device_budget_bytes=2, device="cpu")
    for i in range(4):
        plain.put(_key(p_io, i), f"v{i}", 1)
        plain.get(_key(p_io, i % 2), nbytes=1)
    st_ = plain.stats
    assert st_.directory_hits == st_.directory_hit_bytes == 0
    assert st_.duplicate_avoided_bytes == 0


# ---- cache invalidation ----------------------------------------------------


@pytest.mark.parametrize("case", ["graph", "prefix", "keys", "fingerprint"])
def test_invalidation_matches_reference(case):
    """`invalidate_graph`, the delimiter-aware `invalidate_prefix`,
    `invalidate_keys` (both tiers, directory unpublished) and fingerprinted
    keys, on both packages (reference tests/test_segment_cache.py)."""
    def run(io, kw):
        directory = io.CacheDirectory()
        cache = io.TieredSegmentCache(device_budget_bytes=2,
                                      directory=directory, worker_id="w0",
                                      **kw)
        out = []
        if case == "graph":
            cache.put(_key(io, 0, "gA"), "a", 1, pin="graph-object-A")
            cache.put(_key(io, 1, "gA"), "b", 1)
            cache.put(_key(io, 2, "gB"), "c", 1)
            out.append(cache.invalidate_graph("gA"))
            keys = [_key(io, i, g) for i, g in ((0, "gA"), (1, "gA"),
                                                (2, "gB"))]
        elif case == "prefix":
            cache.device_budget_bytes = 8
            names = ["g12", "g12:fwd:w64", "g123", "g123:fwd:w64"]
            for i, g in enumerate(names):
                cache.put(_key(io, i, g), g, 1)
            out.append(cache.invalidate_prefix("g12"))
            keys = [_key(io, i, g) for i, g in enumerate(names)]
        elif case == "keys":
            for i in range(3):
                cache.put(_key(io, i), f"v{i}", 1)
            out.append(directory.holder(_key(io, 0)))
            out.append(cache.invalidate_keys([_key(io, 0), _key(io, 2),
                                              _key(io, 9)]))
            out.append(directory.holder(_key(io, 0)))
            keys = [_key(io, i) for i in range(3)]
        else:
            stale = io.SegmentKey("g0", 0, "bricks", (1, 8, 8),
                                  fingerprint="s8n4caaaa")
            fresh = io.SegmentKey("g0", 0, "bricks", (1, 8, 8),
                                  fingerprint="s8n5cbbbb")
            cache.put(stale, "old", 1)
            out.append(cache.get(fresh, nbytes=1))
            cache.put(fresh, "new", 1)
            out += [cache.get(fresh, nbytes=1), cache.get(stale, nbytes=1)]
            keys = [stale, fresh]
        out.append([None if cache.tier_of(k) is None
                    else cache.tier_of(k).value for k in keys])
        out.append([getattr(cache.stats, f) for f in STAT_FIELDS])
        out.append((len(cache), len(directory), sorted(cache._pins)))
        return out
    assert run(p_io, {"device": "cpu"}) == run(r_io, {})


def test_prefix_matches_and_drop_prefix_match_reference():
    cases = [("g12", "g12", None), ("g12:fwd:w64", "g12", None),
             ("g123", "g12", None), ("g123:fwd", "g12", None),
             ("g1", "g12", None), (1234, "x", 1234), (1234, "12", None)]
    for gid, prefix, exact in cases:
        assert (p_io.prefix_matches(gid, prefix, exact=exact)
                == r_io.prefix_matches(gid, prefix, exact=exact))

    def run(io):
        directory = io.CacheDirectory()
        directory.publish(_key(io, 0, "g12:fwd"), "w0", "a", 1)
        directory.publish(_key(io, 1, "g12:bwd"), "w1", "b", 1)
        directory.publish(_key(io, 2, "g123:fwd"), "w0", "c", 1)
        directory.unpublish(_key(io, 1, "g12:bwd"), "w0")  # not the holder
        out = [directory.drop_prefix("g12", worker_id="w0"),
               directory.holder(_key(io, 1, "g12:bwd")),
               directory.holder(_key(io, 2, "g123:fwd")),
               directory.drop_prefix("g12"), len(directory),
               directory.drop(_key(io, 2, "g123:fwd")),
               directory.drop(_key(io, 2, "g123:fwd"))]
        return out
    assert run(p_io) == run(r_io)


def test_export_entries_lists_both_tiers_without_evicting():
    cache = p_io.ShardedSegmentCache(4, n_shards=2, device="cpu")
    t = torch.arange(4.0)
    for i in range(6):
        cache.put(_key(p_io, i), (t + i, "meta"), 1)
    used = (cache.device_used_bytes, cache.host_used_bytes)
    entries = cache.export_entries()
    assert sorted(k.segment_id for k, _, _ in entries) == list(range(6))
    assert (cache.device_used_bytes, cache.host_used_bytes) == used
    for k, value, nbytes in entries:
        assert nbytes == 1 and value[1] == "meta"
        assert torch.equal(value[0], t + k.segment_id)


# ---- a mesh of devices -----------------------------------------------------


class _Mesh:
    """A duck-typed mesh: axis names and a numpy grid of torch devices."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)
        for idx in np.ndindex(*shape):
            self.devices[idx] = torch.device("cpu")


@pytest.mark.parametrize("shape,names,axis,n_shards", [
    ((4,), ("cache",), "cache", 4),
    ((2, 3), ("data", "cache"), "cache", 3),
    ((2, 3), ("cache", "model"), "cache", 2),
])
def test_from_mesh_reads_a_duck_typed_mesh(shape, names, axis, n_shards):
    cache = p_io.ShardedSegmentCache.from_mesh(
        _Mesh(shape, names), 1 << 12, axis=axis, local_index=1)
    assert cache.n_shards == n_shards and cache.local_shard == 1
    assert cache.devices == [torch.device("cpu")] * n_shards
    for s in range(n_shards):
        assert cache.shards[s].device == torch.device("cpu")
    ref = r_io.ShardedSegmentCache(1 << 12, n_shards=n_shards, local_shard=1)
    for i in range(20):
        value = torch.full((4,), float(i))
        cache.put(_key(p_io, i), (value, "ell"), 16)
        ref.put(_key(r_io, i), ("value", "ell"), 16)
        got = cache.get(_key(p_io, i), nbytes=16)
        ref.get(_key(r_io, i), nbytes=16)
        assert torch.equal(got[0], value) and got[1] == "ell"
    for f in STAT_FIELDS:
        assert getattr(cache.stats, f) == getattr(ref.stats, f), f
    assert cache.stats.remote_hits > 0


def test_from_mesh_rejects_a_missing_axis():
    with pytest.raises(ValueError, match="no axis"):
        p_io.ShardedSegmentCache.from_mesh(_Mesh((2,), ("data",)), 64)
