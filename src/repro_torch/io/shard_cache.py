"""Mesh-sharded device tier for the segment cache.

`TieredSegmentCache` models one device's tiered memory. `ShardedSegmentCache`
partitions the device tier across the shards of a mesh axis, so a brick is
retained once across the mesh instead of once per device:

  * every `SegmentKey` has one deterministic **owner shard**
    (`shard_of(key)`, a stable CRC over the key — not Python's salted
    `hash`); an **owner map** installed per namespace
    (`install_owner_map`) replaces the CRC default;
  * per-shard device budgets and LRU state are **independent** — one hot
    graph cannot evict another graph's bricks from a different shard;
  * a hit whose owner is a **remote** shard ships the brick over the ICI
    path (`Path.ICI`), and a miss stored on a remote owner ships the fresh
    brick there; both are charged through the `TieredMemorySystem` (tags
    ``cache/ici`` and ``cache/shard-place``), and moved for real
    (`Tensor.to(device, non_blocking=True)`) when the cache is built from
    a mesh whose shards are distinct devices;
  * host spill, promotion and the cross-worker `CacheDirectory` ride the
    per-shard `TieredSegmentCache`s unchanged.

A 1-shard cache is byte-identical to a bare `TieredSegmentCache`: shard 0
is local, so no ICI transfer is ever charged. Owners, charges and counters
are those of `repro.io.shard_cache.ShardedSegmentCache`, which the tests
hold them to.
"""
from __future__ import annotations

import zlib
from typing import Any, Dict, Hashable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.io.segment_cache import (
    CacheDirectory,
    CacheStats,
    SegmentKey,
    TieredSegmentCache,
    _map_tensors,
    prefix_matches,
)
from repro_torch.io.tiers import (
    ICI_ALL_TO_ALL,
    ICITopology,
    MemoryTier,
    Path,
    TieredMemorySystem,
)


def _shard_blob(key: SegmentKey) -> bytes:
    """Explicit field serialization of a key's four identity fields.

    Byte-identical to ``repr((graph_id, segment_id, wire_format, shape))``
    for canonical keys (str namespace, int segment id, str wire format,
    tuple-of-int shape) — including the 1-tuple trailing comma — but built
    field by field, so a `SegmentKey` dataclass change can never silently
    reshuffle every owner. The CRC of a known key is pinned in the tests.
    """
    dims = [repr(int(d)) for d in key.shape]
    shape = "(" + ", ".join(dims) + ("," if len(dims) == 1 else "") + ")"
    return (f"({key.graph_id!r}, {int(key.segment_id)!r}, "
            f"{key.wire_format!r}, {shape})").encode()


def shard_of(key: SegmentKey, n_shards: int) -> int:
    """Deterministic owner shard of a segment key: CRC32 of `_shard_blob`,
    stable across processes and identical for replicated workers.
    `SegmentKey.fingerprint` is left out, so a segment keeps its owner
    across content changes."""
    if n_shards <= 1:
        return 0
    return zlib.crc32(_shard_blob(key)) % n_shards


def _place(value: Any, device: Optional[torch.device]) -> Any:
    """A cached value's tensors on `device` (the ICI hop made real),
    copied without blocking the host; anything else — the host `BlockELL`
    of an engine payload — passes through."""
    if device is None:
        return value
    return _map_tensors(lambda t: t.to(device, non_blocking=True), value)


class ShardedSegmentCache:
    """Device tier partitioned over a mesh axis; a drop-in for
    `TieredSegmentCache` behind the stream's cache hooks.

    `device_budget_bytes` is the *aggregate* device budget; each of the
    `n_shards` shards gets an independent `device_budget_bytes // n_shards`
    slice (likewise the host budget). `local_shard` is the shard this
    worker's stream runs on: hits owned by any other shard are charged
    `nbytes` over `Path.ICI` (tag ``cache/ici``), and a remote put ships the
    fresh brick to its owner (tag ``cache/shard-place``).

    `device` is where every shard keeps its device tier when `devices` (one
    `torch.device` per shard, as `from_mesh` derives them) is not given.
    """

    def __init__(
        self,
        device_budget_bytes: int,
        host_budget_bytes: Optional[int] = None,
        tms: Optional[TieredMemorySystem] = None,
        n_shards: int = 1,
        local_shard: int = 0,
        devices: Optional[Sequence] = None,
        directory: Optional[CacheDirectory] = None,
        worker_id: Hashable = 0,
        topology: ICITopology = ICI_ALL_TO_ALL,
        device: "str | torch.device" = "cuda",
    ):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if not 0 <= local_shard < n_shards:
            raise ValueError(f"local_shard {local_shard} outside "
                             f"[0, {n_shards})")
        if device_budget_bytes < n_shards:
            raise ValueError(
                f"device_budget_bytes {device_budget_bytes} < n_shards "
                f"{n_shards}: every shard needs a positive budget")
        if devices is not None and len(devices) != n_shards:
            raise ValueError(f"devices ({len(devices)}) must match "
                             f"n_shards ({n_shards})")
        self.n_shards = int(n_shards)
        self.local_shard = int(local_shard)
        self.devices = ([torch.device(d) for d in devices]
                        if devices is not None else None)
        self.device_budget_bytes = int(device_budget_bytes)
        self.host_budget_bytes = (None if host_budget_bytes is None
                                  else int(host_budget_bytes))
        self.tms = tms
        self.directory = directory
        self.worker_id = worker_id
        self.topology = topology
        per_dev = self.device_budget_bytes // self.n_shards
        self._per_shard_device = per_dev
        per_host = self.host_budget_bytes
        if per_host is not None and self.n_shards > 1:
            per_host = max(1, per_host // self.n_shards)
        self._per_shard_host = per_host
        # Each shard promotes host hits onto its own device: the owner chip.
        self.shards: List[TieredSegmentCache] = [
            TieredSegmentCache(
                per_dev, per_host, tms=tms,
                device=(self.devices[s] if self.devices is not None
                        else device),
                directory=directory, worker_id=worker_id)
            for s in range(self.n_shards)]
        # Remote-hit accounting lives here (the shards know nothing of the
        # mesh); the aggregate `stats` folds it in.
        self._remote_hits = 0
        self._ici_bytes = 0
        # Placement overrides: keys whose owner differs from the default
        # because a put() carried an explicit shard (the shard-placement
        # pass pins bricks to the shard that consumes them).
        self._locations: Dict[SegmentKey, int] = {}
        # Owner maps per namespace (SegmentKey.graph_id): owners[segment_id]
        # replaces the CRC default, with an optional parallel cluster-id
        # map the placement pass co-places by. Placement policy, not
        # content: dropped with the namespace on prefix/graph invalidation,
        # kept by `clear()` and `invalidate_keys`.
        self._owner_maps: Dict[str, List[int]] = {}
        self._cluster_maps: Dict[str, List[int]] = {}

    @classmethod
    def from_mesh(cls, mesh, device_budget_bytes: int, axis: str = "cache",
                  local_index: int = 0, **kw) -> "ShardedSegmentCache":
        """Partition over `mesh`'s `axis`: one shard per index, each on the
        first device at that index (the owner chip). `mesh` is any object
        with `axis_names` and a numpy `devices` grid of `torch.device`s."""
        names = list(mesh.axis_names)
        if axis not in names:
            raise ValueError(f"mesh has no axis {axis!r} (has {names})")
        ax = names.index(axis)
        grid = np.asarray(mesh.devices, dtype=object)
        n_shards = grid.shape[ax]
        grid = np.moveaxis(grid, ax, 0).reshape(n_shards, -1)
        devices = [grid[s, 0] for s in range(n_shards)]
        return cls(device_budget_bytes, n_shards=n_shards,
                   local_shard=local_index, devices=devices, **kw)

    # ---- introspection ---------------------------------------------------

    @property
    def stats(self) -> CacheStats:
        """Aggregate across shards (recomputed per access: read deltas of
        it, do not mutate it)."""
        agg = CacheStats()
        for shard in self.shards:
            agg.add(shard.stats)
        agg.remote_hits += self._remote_hits
        agg.ici_bytes += self._ici_bytes
        return agg

    @property
    def device_used_bytes(self) -> int:
        return sum(s.device_used_bytes for s in self.shards)

    @property
    def host_used_bytes(self) -> int:
        return sum(s.host_used_bytes for s in self.shards)

    def __len__(self) -> int:
        return sum(len(s) for s in self.shards)

    def __contains__(self, key: SegmentKey) -> bool:
        return key in self._owner(key)

    def tier_of(self, key: SegmentKey) -> Optional[MemoryTier]:
        return self._owner(key).tier_of(key)

    def owner_of(self, key: SegmentKey) -> int:
        """The shard that owns (or would own) `key`: a placement override
        recorded by `put(..., shard=...)`, else the namespace's owner map,
        else the CRC owner."""
        loc = self._locations.get(key)
        if loc is not None:
            return loc
        return self._default_owner(key)

    def _default_owner(self, key: SegmentKey) -> int:
        owners = self._owner_maps.get(key.graph_id)
        if owners is not None and 0 <= key.segment_id < len(owners):
            return owners[key.segment_id]
        return shard_of(key, self.n_shards)

    def install_owner_map(self, namespace: str, owners: Sequence[int],
                          clusters: Optional[Sequence[int]] = None) -> None:
        """`owners[i]` owns segment i of `namespace` (per-key `put(shard=)`
        overrides still win); `clusters` is the parallel cluster id per
        segment that `cluster_of_key` serves to the placement pass.
        Reinstalling replaces the previous map."""
        owners = [int(s) for s in owners]
        for s in owners:
            if not 0 <= s < self.n_shards:
                raise ValueError(
                    f"owner map shard {s} outside [0, {self.n_shards})")
        if clusters is not None and len(clusters) != len(owners):
            raise ValueError(
                f"cluster map length {len(clusters)} != owner map "
                f"length {len(owners)}")
        self._owner_maps[str(namespace)] = owners
        if clusters is not None:
            self._cluster_maps[str(namespace)] = [int(c) for c in clusters]
        else:
            self._cluster_maps.pop(str(namespace), None)

    def drop_owner_map(self, namespace: str) -> bool:
        """Remove one namespace's owner (and cluster) map; returns whether
        a map was installed."""
        had = self._owner_maps.pop(str(namespace), None) is not None
        self._cluster_maps.pop(str(namespace), None)
        return had

    def owner_map(self, namespace: str) -> Optional[List[int]]:
        """The installed owner map for `namespace` (a copy), or None."""
        owners = self._owner_maps.get(str(namespace))
        return list(owners) if owners is not None else None

    def cluster_of_key(self, key: SegmentKey) -> Optional[int]:
        """`key`'s cluster id under its namespace's cluster map, or None."""
        clusters = self._cluster_maps.get(key.graph_id)
        if clusters is not None and 0 <= key.segment_id < len(clusters):
            return clusters[key.segment_id]
        return None

    def shard_index_of(self, key: SegmentKey) -> int:
        return self.owner_of(key)

    @property
    def shard_budget_bytes(self) -> int:
        """Device budget of each independent shard."""
        return self._per_shard_device

    def shard_headroom(self, shard: int) -> int:
        """Unused device-tier bytes on `shard`."""
        return self._per_shard_device - self.shards[shard].device_used_bytes

    def shard_host_headroom(self, shard: int) -> float:
        """Unused host-tier bytes on `shard` (inf when unbounded)."""
        if self._per_shard_host is None:
            return float("inf")
        return self._per_shard_host - self.shards[shard].host_used_bytes

    def ici_hops(self, shard: int) -> int:
        """Links between `shard` and the local shard under the cache's
        `ICITopology` (0 for the local shard itself)."""
        return self.topology.hops(shard, self.local_shard, self.n_shards)

    def _owner(self, key: SegmentKey) -> TieredSegmentCache:
        return self.shards[self.owner_of(key)]

    # ---- maintenance -----------------------------------------------------

    def pin(self, graph_id: Hashable, obj: Any) -> None:
        for shard in self.shards:
            shard.pin(graph_id, obj)

    def invalidate_graph(self, graph_id: Hashable) -> int:
        self._drop_locations(str(graph_id), exact=graph_id)
        return sum(s.invalidate_graph(graph_id) for s in self.shards)

    def invalidate_prefix(self, prefix: str, exact: Hashable = None) -> int:
        self._drop_locations(prefix, exact=exact)
        return sum(s.invalidate_prefix(prefix, exact=exact)
                   for s in self.shards)

    def invalidate_keys(self, keys) -> int:
        """Drop exactly the given keys, each at its owner shard, clearing
        any placement override too."""
        dropped = 0
        for key in keys:
            dropped += self._owner(key).invalidate_keys([key])
            self._locations.pop(key, None)
        return dropped

    def _drop_locations(self, prefix: str, exact: Hashable = None) -> None:
        for key in [k for k in self._locations
                    if prefix_matches(k.graph_id, prefix, exact)]:
            del self._locations[key]
        for ns in [ns for ns in self._owner_maps
                   if prefix_matches(ns, prefix, exact)]:
            del self._owner_maps[ns]
            self._cluster_maps.pop(ns, None)

    def clear(self) -> None:
        self._locations.clear()
        for shard in self.shards:
            shard.clear()

    def export_entries(self) -> list:
        """Every shard's entries (`TieredSegmentCache.export_entries`), in
        shard order."""
        out = []
        for shard in self.shards:
            out.extend(shard.export_entries())
        return out

    # ---- the cache protocol ----------------------------------------------

    def get(self, key: SegmentKey, nbytes: int = 0,
            tms: Optional[TieredMemorySystem] = None) -> Optional[Any]:
        return self.get_with_cost(key, nbytes=nbytes, tms=tms)[0]

    def get_with_cost(self, key: SegmentKey, nbytes: int = 0,
                      tms: Optional[TieredMemorySystem] = None):
        """(value, transfer_seconds). A remote-shard hit adds the ICI hop(s)
        to the owner shard's own promotion cost (if any)."""
        s = self.owner_of(key)
        value, cost = self.shards[s].get_with_cost(key, nbytes=nbytes,
                                                   tms=tms)
        if value is not None and s != self.local_shard:
            hops = self.ici_hops(s)
            self._remote_hits += 1
            self._ici_bytes += nbytes * hops
            cost += self._charge_ici(tms, nbytes, "cache/ici", hops=hops)
            if self.devices is not None:
                value = _place(value, self.devices[self.local_shard])
        return value, cost

    def peek_cost(self, key: SegmentKey, nbytes: int = 0,
                  tms: Optional[TieredMemorySystem] = None,
                  shard: Optional[int] = None):
        """Price a get WITHOUT performing it. A remote-owned key adds the
        ICI hop(s) a hit would ride — or, on a miss, the shard-place ship
        the following put() would pay; `shard` is the placement override
        that put would carry."""
        s = self.owner_of(key)
        hit, cost = self.shards[s].peek_cost(key, nbytes=nbytes, tms=tms)
        if hit:
            if s != self.local_shard:
                cost += self._charge_ici(tms, nbytes, "cache/ici",
                                         hops=self.ici_hops(s))
        else:
            dst = s if shard is None else int(shard)
            if dst != self.local_shard:
                cost += self._charge_ici(tms, nbytes, "cache/shard-place",
                                         hops=self.ici_hops(dst))
        return hit, cost

    def put(self, key: SegmentKey, value: Any, nbytes: int,
            tms: Optional[TieredMemorySystem] = None,
            pin: Any = None, shard: Optional[int] = None) -> None:
        """Insert at the owner shard; a remote owner costs one ICI ship of
        the fresh brick (the upload landed on the local device first).

        `shard` overrides the owner; the override is recorded so later
        get/peek calls resolve to the real location, and a stale copy at
        the previous owner is dropped."""
        cur = self.owner_of(key)
        dst = cur if shard is None else int(shard)
        if not 0 <= dst < self.n_shards:
            raise ValueError(f"placement shard {dst} outside "
                             f"[0, {self.n_shards})")
        if dst != cur:
            self.shards[cur].discard(key)
        # Record the override only when it differs from the default owner
        # (the owner map when one covers this key), so a reinstalled owner
        # map can still move a brick placed on its mapped owner.
        if dst != self._default_owner(key):
            self._locations[key] = dst
        else:
            self._locations.pop(key, None)
        if dst != self.local_shard:
            hops = self.ici_hops(dst)
            self._ici_bytes += nbytes * hops
            self._charge_ici(tms, nbytes, "cache/shard-place", hops=hops)
            if self.devices is not None:
                value = _place(value, self.devices[dst])
        self.shards[dst].put(key, value, nbytes, tms=tms, pin=pin)

    def _charge_ici(self, tms: Optional[TieredMemorySystem], nbytes: int,
                    tag: str, hops: int = 1) -> float:
        tms = tms if tms is not None else self.tms
        if tms is None or nbytes <= 0:
            return 0.0
        return tms.transfer(Path.ICI, MemoryTier.DEVICE, MemoryTier.DEVICE,
                            int(nbytes), tag=tag, hops=hops)
