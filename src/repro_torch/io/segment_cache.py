"""Tiered LRU segment cache — device-resident BlockELL bricks with host spill.

Uploaded device payloads are retained under a device byte budget; LRU
eviction *demotes* bricks device→host (into pinned memory) instead of
discarding them, and a later hit *promotes* them back with a non-blocking
copy. Both moves are charged through a `TieredMemorySystem` (DMA path,
tagged ``cache/demote`` / ``cache/promote``): a device-tier hit is free wire
traffic, a host-tier hit pays one HtoD transfer, a miss pays the full
upload. The byte counters and charges are those of
`repro.io.segment_cache.TieredSegmentCache`, which the tests hold them to.

Keys are `(graph_id, segment_id, wire_format, shape, fingerprint)`: graph
identity plus the segment's position in its RoBW plan plus the wire layout,
so two plans over the same graph never alias.

A `CacheDirectory` shared by replicated workers dedups demotion copies and
serves one worker's miss from a peer's host copy. A peer's host copy is
read by a non-blocking upload on the reader's stream; that is safe because
demotion is a blocking copy into pinned memory, so a published host copy
is complete before any peer can find it.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, Optional, Tuple

import torch

from repro_torch.io.tiers import MemoryTier, Path, TieredMemorySystem


@dataclasses.dataclass(frozen=True)
class SegmentKey:
    """Identity of one cached wire segment."""

    graph_id: Hashable
    segment_id: Hashable     # index in the plan
    wire_format: str         # "bricks" | "csr"
    shape: Tuple[int, ...]   # wire-payload shape (disambiguates re-plans)
    fingerprint: str = ""    # `segment_fingerprint` of the brick's rows;
    #                          left out of `shard_of`'s owner hash


def prefix_matches(graph_id: Hashable, prefix: str,
                   exact: Hashable = None) -> bool:
    """Does `graph_id` belong to the namespace family named by `prefix`?

    Delimiter-aware: matches the id itself or any `:`-separated extension
    of it (`g12:fwd:w64` under prefix `g12`), but never a sibling whose id
    merely shares leading characters (`g123:…` under `g12`). `exact`
    additionally matches a non-string id by equality."""
    if exact is not None and graph_id == exact:
        return True
    gid = str(graph_id)
    return gid == prefix or gid.startswith(prefix + ":")


@dataclasses.dataclass
class CacheStats:
    device_hits: int = 0
    host_hits: int = 0       # promoted device<-host
    misses: int = 0
    hit_bytes: int = 0       # wire bytes served from either tier
    miss_bytes: int = 0      # wire bytes the caller had to upload
    demoted_bytes: int = 0   # device->host spills
    promoted_bytes: int = 0  # host->device refills
    evicted_bytes: int = 0   # dropped from the host tier entirely
    # Sharded device tier (io/shard_cache.py): hits whose brick lives on a
    # remote shard, and the bytes that therefore crossed the ICI path.
    remote_hits: int = 0
    ici_bytes: int = 0
    # Cross-worker directory: hits served from a peer worker's host copy,
    # and demotion copies skipped because a peer already holds the brick.
    directory_hits: int = 0
    directory_hit_bytes: int = 0
    duplicate_avoided_bytes: int = 0

    @property
    def hits(self) -> int:
        return self.device_hits + self.host_hits + self.directory_hits

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def add(self, other: "CacheStats") -> "CacheStats":
        """Field-wise sum (aggregating per-shard stats)."""
        for f in dataclasses.fields(CacheStats):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))
        return self


@dataclasses.dataclass
class _Entry:
    value: Any
    nbytes: int


def _map_tensors(fn: Callable[[torch.Tensor], torch.Tensor], value: Any):
    """`fn` over the tensors of `value` (a tensor or a tuple of them);
    anything else — a host `BlockELL`, a simulate-mode token — passes
    through untouched."""
    if isinstance(value, torch.Tensor):
        return fn(value)
    if isinstance(value, tuple):
        return tuple(_map_tensors(fn, v) for v in value)
    return value


def demote_to_host(value: Any) -> Any:
    """Device tensors → bit-identical copies in pinned host memory (CPU
    tensors stay as they are)."""
    def down(t: torch.Tensor) -> torch.Tensor:
        if t.device.type == "cpu":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host
    return _map_tensors(down, value)


def promote_to_device(value: Any, device: torch.device) -> Any:
    """Host tensors → `device`, copied without blocking the host (the
    caller's stream orders the copy before its consumers)."""
    return _map_tensors(lambda t: t.to(device, non_blocking=True), value)


class CacheDirectory:
    """Cross-worker registry of demoted host copies.

    Replicated `ServingEngine` workers each run their own segment cache
    over the same graphs. A shared directory removes the duplicate work:

      * **dedup on demote** — a worker about to spill a brick first asks
        who holds its host copy; if a *peer* does, the local copy is
        dropped without the DtoH transfer (`stats.duplicate_avoided_bytes`).
      * **fetch on miss** — a worker that misses both its tiers asks the
        directory; a peer's host copy is promoted straight into the local
        device tier (one HtoD transfer, tag ``cache/peer-promote``) instead
        of a fresh wire upload (`stats.directory_hits` /
        `stats.directory_hit_bytes`).

    One holder per key (first demoter wins); the holder unpublishes when
    its host copy is promoted away, evicted or invalidated. Thread-safe;
    the directory stores the host value itself, so no cache lock is held
    while a peer cache's lock is taken.
    """

    def __init__(self):
        self._entries: Dict[SegmentKey, Tuple[Hashable, Any, int]] = {}
        self._claimed: set = set()
        self._lock = threading.Lock()
        self.lookups = 0
        self.hits = 0
        self.hit_bytes = 0
        self.duplicates_avoided = 0
        self.duplicate_avoided_bytes = 0

    def __len__(self) -> int:
        return len(self._entries)

    def claim_worker(self, worker_id: Hashable) -> None:
        """Register one worker identity (the shards of one worker's cache
        share its id). Two workers with one id would neutralize the
        directory — fetch excludes the caller's own id and demote-dedup
        trusts only *other* holders — so a duplicate claim is an error."""
        with self._lock:
            if worker_id in self._claimed:
                raise ValueError(
                    f"worker_id {worker_id!r} already claimed on this "
                    "CacheDirectory — replicated workers need distinct "
                    "EngineConfig.worker_id values, or the directory "
                    "silently never dedups or peer-serves")
            self._claimed.add(worker_id)

    def holder(self, key: SegmentKey) -> Optional[Hashable]:
        with self._lock:
            entry = self._entries.get(key)
            return entry[0] if entry is not None else None

    def publish(self, key: SegmentKey, worker_id: Hashable, value: Any,
                nbytes: int) -> None:
        """Record `worker_id` as the holder of `key`'s host copy."""
        with self._lock:
            self._entries[key] = (worker_id, value, int(nbytes))

    def unpublish(self, key: SegmentKey, worker_id: Hashable) -> None:
        """Drop the record — only if `worker_id` is still the holder."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry[0] == worker_id:
                del self._entries[key]

    def drop(self, key: SegmentKey) -> bool:
        """Drop the record for `key` whoever holds it (a stale key is
        stale in every worker's copy). Returns whether one existed."""
        with self._lock:
            return self._entries.pop(key, None) is not None

    def drop_prefix(self, prefix: str, worker_id: Hashable = None) -> int:
        """Drop every record whose graph_id falls under `prefix`
        (delimiter-aware, `prefix_matches`); with `worker_id`, only that
        worker's holdings — what `evict_graph` calls, so peers are never
        routed to entries the evicting worker no longer backs. Returns the
        number of records dropped."""
        with self._lock:
            victims = [k for k, (holder, _, _) in self._entries.items()
                       if prefix_matches(k.graph_id, prefix)
                       and (worker_id is None or holder == worker_id)]
            for k in victims:
                del self._entries[k]
            return len(victims)

    def fetch(self, key: SegmentKey,
              exclude: Hashable = None) -> Optional[Tuple[Any, Hashable, int]]:
        """(host value, holder, nbytes) if a worker ≠ `exclude` holds it."""
        with self._lock:
            self.lookups += 1
            entry = self._entries.get(key)
            if entry is None or entry[0] == exclude:
                return None
            self.hits += 1
            self.hit_bytes += entry[2]
            return entry[1], entry[0], entry[2]


class TieredSegmentCache:
    """Device-budget-aware LRU over wire segments, with a host spill tier.

    * device tier — entries live in upload form (tensors on `device`);
      `device_budget_bytes` is a hard cap, eviction demotes LRU-first.
    * host tier — demoted entries (pinned host copies); `host_budget_bytes`
      caps it (None = unbounded); overflow is dropped for good and counted
      in `stats.evicted_bytes`.

    `tms` receives the DMA transfer for every demotion/promotion. A shared
    `directory` (with this worker's `worker_id`) dedups demotion copies
    across workers and serves misses from a peer's host tier.

    The device budget models *spare* device memory dedicated to brick
    retention, beyond the streaming working set (M_B + M_C + M_A); the
    cache does not subtract from the scheduler's Eq. 5-7 budget.
    """

    def __init__(
        self,
        device_budget_bytes: int,
        host_budget_bytes: Optional[int] = None,
        tms: Optional[TieredMemorySystem] = None,
        device: "str | torch.device" = "cuda",
        directory: Optional[CacheDirectory] = None,
        worker_id: Hashable = 0,
    ):
        if device_budget_bytes <= 0:
            raise ValueError("device_budget_bytes must be > 0")
        self.device_budget_bytes = int(device_budget_bytes)
        self.host_budget_bytes = (None if host_budget_bytes is None
                                  else int(host_budget_bytes))
        self.tms = tms
        self.device = torch.device(device)
        self.directory = directory
        self.worker_id = worker_id
        self._device: "OrderedDict[SegmentKey, _Entry]" = OrderedDict()
        self._host: "OrderedDict[SegmentKey, _Entry]" = OrderedDict()
        self._device_used = 0
        self._host_used = 0
        self._pins: Dict[Hashable, Any] = {}
        self._lock = threading.Lock()
        self.stats = CacheStats()

    # ---- introspection ---------------------------------------------------

    @property
    def device_used_bytes(self) -> int:
        return self._device_used

    @property
    def host_used_bytes(self) -> int:
        return self._host_used

    def __len__(self) -> int:
        return len(self._device) + len(self._host)

    def __contains__(self, key: SegmentKey) -> bool:
        return key in self._device or key in self._host

    def tier_of(self, key: SegmentKey) -> Optional[MemoryTier]:
        if key in self._device:
            return MemoryTier.DEVICE
        if key in self._host:
            return MemoryTier.HOST
        return None

    def pin(self, graph_id: Hashable, obj: Any) -> None:
        """Hold a strong reference to the graph behind `graph_id` while its
        entries live."""
        self._pins[graph_id] = obj

    # ---- maintenance -----------------------------------------------------

    def invalidate_graph(self, graph_id: Hashable) -> int:
        """Drop every entry (both tiers) and the pin for one graph."""
        return self.invalidate_prefix(str(graph_id), exact=graph_id)

    def invalidate_prefix(self, prefix: str, exact: Hashable = None) -> int:
        """Drop entries whose graph_id is `exact` or a `:`-delimited
        extension of `prefix` (one graph spans several namespaces:
        direction × plan width × budget). Returns the entries dropped."""
        with self._lock:
            dropped = 0
            for store in (self._device, self._host):
                for key in [k for k in store
                            if prefix_matches(k.graph_id, prefix, exact)]:
                    dropped += 1
                    self._account(store, -store.pop(key).nbytes)
                    if store is self._host and self.directory is not None:
                        self.directory.unpublish(key, self.worker_id)
            for gid in [g for g in self._pins
                        if prefix_matches(g, prefix, exact)]:
                del self._pins[gid]
            return dropped

    def invalidate_keys(self, keys) -> int:
        """Drop exactly the given keys from both tiers. Returns the number
        of entries dropped."""
        with self._lock:
            dropped = 0
            for key in keys:
                for store in (self._device, self._host):
                    entry = store.pop(key, None)
                    if entry is not None:
                        dropped += 1
                        self._account(store, -entry.nbytes)
                        if store is self._host and self.directory is not None:
                            self.directory.unpublish(key, self.worker_id)
            return dropped

    def clear(self) -> None:
        with self._lock:
            if self.directory is not None:
                for key in self._host:
                    self.directory.unpublish(key, self.worker_id)
            self._device.clear()
            self._host.clear()
            self._device_used = 0
            self._host_used = 0
            self._pins.clear()

    def export_entries(self) -> list:
        """Snapshot every live entry as (key, value, wire bytes), device
        tier first, without evicting anything.

        Unlike the reference, device-tier values come back as they are
        (tensors on the device): exporting copies nothing off the card.
        The engine's payloads carry their host `BlockELL` as the fourth
        element, which is what a brick checkpoint writes."""
        with self._lock:
            out = [(key, e.value, e.nbytes) for key, e in self._device.items()]
            out.extend((key, e.value, e.nbytes)
                       for key, e in self._host.items())
            return out

    # ---- the cache protocol ----------------------------------------------

    def get(self, key: SegmentKey, nbytes: int = 0,
            tms: Optional[TieredMemorySystem] = None) -> Optional[Any]:
        """Lookup; `nbytes` (the wire size the caller would otherwise
        upload) feeds hit/miss byte accounting. Returns the device-form
        value, or None on miss. A host-tier hit is promoted back."""
        return self.get_with_cost(key, nbytes=nbytes, tms=tms)[0]

    def get_with_cost(self, key: SegmentKey, nbytes: int = 0,
                      tms: Optional[TieredMemorySystem] = None
                      ) -> Tuple[Optional[Any], float]:
        """Like get(), but returns (value, transfer_seconds): the modeled
        cost of the promotion this lookup triggered (0.0 for a device-tier
        hit or a miss)."""
        with self._lock:
            entry = self._device.get(key)
            if entry is not None:
                self._device.move_to_end(key)
                self.stats.device_hits += 1
                self.stats.hit_bytes += nbytes
                return entry.value, 0.0
            entry = self._host.pop(key, None)
            if entry is not None:
                self._host_used -= entry.nbytes
                if self.directory is not None:
                    # Our host copy is consumed by the promotion.
                    self.directory.unpublish(key, self.worker_id)
                value = promote_to_device(entry.value, self.device)
                cost = self._charge(tms, MemoryTier.HOST, MemoryTier.DEVICE,
                                    entry.nbytes, "cache/promote")
                self.stats.promoted_bytes += entry.nbytes
                self.stats.host_hits += 1
                self.stats.hit_bytes += nbytes
                self._insert_device(key, _Entry(value, entry.nbytes), tms)
                return value, cost
            if self.directory is not None:
                fetched = self.directory.fetch(key, exclude=self.worker_id)
                if fetched is not None:
                    # A peer's host tier holds the brick: promote its copy
                    # into our device tier — one HtoD transfer instead of a
                    # fresh wire upload. The peer keeps its copy (and stays
                    # the directory holder).
                    host_value, _, host_nbytes = fetched
                    value = promote_to_device(host_value, self.device)
                    cost = self._charge(
                        tms, MemoryTier.HOST, MemoryTier.DEVICE, host_nbytes,
                        "cache/peer-promote")
                    self.stats.promoted_bytes += host_nbytes
                    self.stats.directory_hits += 1
                    self.stats.directory_hit_bytes += nbytes
                    self.stats.hit_bytes += nbytes
                    self._insert_device(key, _Entry(value, host_nbytes), tms)
                    return value, cost
            self.stats.misses += 1
            self.stats.miss_bytes += nbytes
            return None, 0.0

    def peek_cost(self, key: SegmentKey, nbytes: int = 0,
                  tms: Optional[TieredMemorySystem] = None,
                  shard: Optional[int] = None) -> Tuple[bool, float]:
        """Price a `get` WITHOUT performing it: no promotion, no LRU
        reorder, no stats. Returns (would_hit, modeled_seconds); the
        promotion a host-tier or directory-peer hit would pay is charged to
        `tms`. `shard` (the placement override a miss's put would carry)
        is there for `ShardedSegmentCache`'s protocol: one shard ignores
        it."""
        tier = self.tier_of(key)
        if tier is MemoryTier.DEVICE:
            return True, 0.0
        if tier is MemoryTier.HOST:
            return True, self._charge(tms, MemoryTier.HOST,
                                      MemoryTier.DEVICE, nbytes,
                                      "cache/promote")
        if self.directory is not None:
            holder = self.directory.holder(key)
            if holder is not None and holder != self.worker_id:
                return True, self._charge(tms, MemoryTier.HOST,
                                          MemoryTier.DEVICE, nbytes,
                                          "cache/peer-promote")
        return False, 0.0

    def put(self, key: SegmentKey, value: Any, nbytes: int,
            tms: Optional[TieredMemorySystem] = None,
            pin: Any = None, shard: Optional[int] = None) -> None:
        """Insert/refresh a device-form value of `nbytes` wire bytes.
        `shard` (a placement override) is there for `ShardedSegmentCache`'s
        protocol: one shard ignores it."""
        with self._lock:
            if pin is not None:
                self._pins[key.graph_id] = pin
            stale = self._device.pop(key, None)
            if stale is not None:
                self._device_used -= stale.nbytes
            stale = self._host.pop(key, None)
            if stale is not None:
                self._host_used -= stale.nbytes
                if self.directory is not None:
                    self.directory.unpublish(key, self.worker_id)
            self._insert_device(key, _Entry(value, int(nbytes)), tms)

    def discard(self, key: SegmentKey) -> bool:
        """Drop `key` from both tiers — no stats, no modeled transfers.
        The sharded cache calls this when a placement override moves a key
        off its previous owner shard (the caller charges the move)."""
        with self._lock:
            entry = self._device.pop(key, None)
            if entry is not None:
                self._device_used -= entry.nbytes
                return True
            entry = self._host.pop(key, None)
            if entry is not None:
                self._host_used -= entry.nbytes
                if self.directory is not None:
                    self.directory.unpublish(key, self.worker_id)
                return True
            return False

    def _account(self, store, delta: int) -> None:
        if store is self._device:
            self._device_used += delta
        else:
            self._host_used += delta

    # ---- internals (lock held) -------------------------------------------

    def _charge(self, tms: Optional[TieredMemorySystem], src: MemoryTier,
                dst: MemoryTier, nbytes: int, tag: str) -> float:
        tms = tms if tms is not None else self.tms
        if tms is None or nbytes <= 0:
            return 0.0
        return tms.transfer(Path.DMA, src, dst, int(nbytes), tag=tag)

    def _insert_device(self, key: SegmentKey, entry: _Entry,
                       tms: Optional[TieredMemorySystem]) -> None:
        if entry.nbytes > self.device_budget_bytes:
            # Never holds on device: spill the fresh upload straight down.
            self._demote_entry(key, entry, tms)
            return
        while self._device_used + entry.nbytes > self.device_budget_bytes:
            victim_key, victim = self._device.popitem(last=False)
            self._device_used -= victim.nbytes
            self._demote_entry(victim_key, victim, tms)
        self._device[key] = entry
        self._device_used += entry.nbytes

    def _demote_entry(self, key: SegmentKey, entry: _Entry,
                      tms: Optional[TieredMemorySystem]) -> None:
        """Move a device-form entry down a tier (or drop it if it can't fit)."""
        if self.directory is not None:
            holder = self.directory.holder(key)
            if holder is not None and holder != self.worker_id:
                # A peer already keeps this brick's host copy: drop ours
                # without the DtoH transfer — the brick stays reachable
                # through the directory (fetch on miss).
                self.stats.duplicate_avoided_bytes += entry.nbytes
                self.directory.duplicates_avoided += 1
                self.directory.duplicate_avoided_bytes += entry.nbytes
                return
        if self.host_budget_bytes is not None \
                and entry.nbytes > self.host_budget_bytes:
            self.stats.evicted_bytes += entry.nbytes
            return
        self._charge(tms, MemoryTier.DEVICE, MemoryTier.HOST,
                     entry.nbytes, "cache/demote")
        self.stats.demoted_bytes += entry.nbytes
        entry = _Entry(demote_to_host(entry.value), entry.nbytes)
        if self.host_budget_bytes is not None:
            while self._host_used + entry.nbytes > self.host_budget_bytes:
                victim_key, dropped = self._host.popitem(last=False)
                self._host_used -= dropped.nbytes
                self.stats.evicted_bytes += dropped.nbytes
                if self.directory is not None:
                    self.directory.unpublish(victim_key, self.worker_id)
        self._host[key] = entry
        self._host_used += entry.nbytes
        if self.directory is not None:
            self.directory.publish(key, self.worker_id, entry.value,
                                   entry.nbytes)
