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
    fingerprint: str = ""    # `segment_fingerprint` of the brick's rows


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

    @property
    def hits(self) -> int:
        return self.device_hits + self.host_hits

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


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


class TieredSegmentCache:
    """Device-budget-aware LRU over wire segments, with a host spill tier.

    * device tier — entries live in upload form (tensors on `device`);
      `device_budget_bytes` is a hard cap, eviction demotes LRU-first.
    * host tier — demoted entries (pinned host copies); `host_budget_bytes`
      caps it (None = unbounded); overflow is dropped for good and counted
      in `stats.evicted_bytes`.

    `tms` receives the DMA transfer for every demotion/promotion.

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
    ):
        if device_budget_bytes <= 0:
            raise ValueError("device_budget_bytes must be > 0")
        self.device_budget_bytes = int(device_budget_bytes)
        self.host_budget_bytes = (None if host_budget_bytes is None
                                  else int(host_budget_bytes))
        self.tms = tms
        self.device = torch.device(device)
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
                value = promote_to_device(entry.value, self.device)
                cost = self._charge(tms, MemoryTier.HOST, MemoryTier.DEVICE,
                                    entry.nbytes, "cache/promote")
                self.stats.promoted_bytes += entry.nbytes
                self.stats.host_hits += 1
                self.stats.hit_bytes += nbytes
                self._insert_device(key, _Entry(value, entry.nbytes), tms)
                return value, cost
            self.stats.misses += 1
            self.stats.miss_bytes += nbytes
            return None, 0.0

    def peek_cost(self, key: SegmentKey, nbytes: int = 0,
                  tms: Optional[TieredMemorySystem] = None
                  ) -> Tuple[bool, float]:
        """Price a `get` WITHOUT performing it: no promotion, no LRU
        reorder, no stats. Returns (would_hit, modeled_seconds); the
        promotion a host-tier hit would pay is charged to `tms`."""
        tier = self.tier_of(key)
        if tier is MemoryTier.DEVICE:
            return True, 0.0
        if tier is MemoryTier.HOST:
            return True, self._charge(tms, MemoryTier.HOST,
                                      MemoryTier.DEVICE, nbytes,
                                      "cache/promote")
        return False, 0.0

    def put(self, key: SegmentKey, value: Any, nbytes: int,
            tms: Optional[TieredMemorySystem] = None,
            pin: Any = None) -> None:
        """Insert/refresh a device-form value of `nbytes` wire bytes."""
        with self._lock:
            if pin is not None:
                self._pins[key.graph_id] = pin
            stale = self._device.pop(key, None)
            if stale is not None:
                self._device_used -= stale.nbytes
            stale = self._host.pop(key, None)
            if stale is not None:
                self._host_used -= stale.nbytes
            self._insert_device(key, _Entry(value, int(nbytes)), tms)

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
                _, dropped = self._host.popitem(last=False)
                self._host_used -= dropped.nbytes
                self.stats.evicted_bytes += dropped.nbytes
        self._host[key] = entry
        self._host_used += entry.nbytes
