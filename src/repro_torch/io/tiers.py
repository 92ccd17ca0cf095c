"""Tiered memory system: device memory / host DRAM / secondary storage.

The paper's three tiers are device memory, host memory and NVMe (+GDS
path). `TieredMemorySystem` accounts every transfer (bytes, path, modeled
seconds) against a `TierSpec`, so cost estimates and byte accounting can be
read off a plan without running it.

Two specs are copied verbatim from `repro.io.tiers`, so that every modeled
cost matches the reference's:

  * `TPU_V5E_SYSTEM` — the reference package's default spec (serving
    admission control, stream-plan estimates);
  * `PAPER_GPU_SYSTEM` — the paper's RTX 4090-class system (§V-A: "We
    model the I/O transfer operations ... with simulations"), which the
    schedulers and the paper's figures price against.

Both are cost-model data only: neither describes the card this package
runs on, and a makespan priced under either is a modeled number, not a
time on the card. `core.calibration.CostCalibrator` refits either from
the card's measured latencies.
"""
from __future__ import annotations

import dataclasses
import enum
from collections import defaultdict
from typing import Dict, List, Tuple


class MemoryTier(enum.Enum):
    DEVICE = "device"
    HOST = "host"        # CPU DRAM
    STORAGE = "storage"  # NVMe SSD


class Path(enum.Enum):
    """Transfer path; bandwidth differs per path (paper Fig. 8)."""

    DMA = "dma"              # host <-> device (cudaMemcpy HtoD/DtoH)
    GDS = "gds"              # storage <-> device direct (GPU Direct Storage)
    STORAGE_HOST = "sio"     # storage <-> host
    UM = "um"                # unified-memory page faults (UCG baseline)
    ICI = "ici"              # chip-to-chip path (sharded cache)


@dataclasses.dataclass(frozen=True)
class ICITopology:
    """Chip-to-chip link topology: how many links a transfer crosses.

    ``all_to_all`` puts every pair of chips one hop apart; ``ring`` is a
    1-D mesh axis, where chip i reaches chip j over min(|i-j|, n-|i-j|)
    links. `TieredMemorySystem.transfer(..., hops=h)` prices an h-hop
    transfer as h per-link setup latencies plus one bandwidth term, and
    counts the payload on every link it crossed.

    The sharded segment cache charges remote hits and shard placements at
    the owner's hop distance, and `ShardPlacementPass` uses the same hop
    counts to prefer near shards when the local one is full.
    """

    kind: str = "all_to_all"   # "all_to_all" | "ring"

    def __post_init__(self):
        if self.kind not in ("all_to_all", "ring"):
            raise ValueError(f"unknown ICI topology kind {self.kind!r} "
                             "(expected 'all_to_all' or 'ring')")

    def hops(self, src: int, dst: int, n_chips: int) -> int:
        """Links crossed from chip `src` to chip `dst` on an `n_chips` axis."""
        if src == dst:
            return 0
        if self.kind == "all_to_all" or n_chips <= 2:
            return 1
        d = abs(int(src) - int(dst)) % n_chips
        return min(d, n_chips - d)


ICI_ALL_TO_ALL = ICITopology("all_to_all")
ICI_RING = ICITopology("ring")


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """Capacities in bytes, bandwidths in bytes/second."""

    device_capacity: int
    host_capacity: int
    storage_capacity: int
    bw: Dict[Path, float]
    latency_s: Dict[Path, float]  # fixed per-transfer setup cost
    hbm_bw: float = 1.0e12        # device memory bandwidth
    host_memcpy_bw: float = 12e9  # effective single-stream DRAM copy bandwidth
    host_op_latency_s: float = 2e-6  # per host staging/merge event
    peak_flops: float = 0.0       # roofline compute term


def _mk(caps, bw_gbs, lat_us, hbm_bw, host_bw=12e9,
        peak_flops=0.0) -> TierSpec:
    return TierSpec(
        device_capacity=caps[0], host_capacity=caps[1], storage_capacity=caps[2],
        bw={p: g * 1e9 for p, g in bw_gbs.items()},
        latency_s={p: u * 1e-6 for p, u in lat_us.items()},
        hbm_bw=hbm_bw, host_memcpy_bw=host_bw, peak_flops=peak_flops,
    )


# The paper's cost-model system (see the module docstring): RTX 4090 (24 GB,
# 1008 GB/s) + i9-13900KF (128 GB DDR5) + M.2 NVMe, PCIe gen4; ICI models an
# NVLink-class peer path for a sharded segment cache.
PAPER_GPU_SYSTEM = _mk(
    (24 << 30, 128 << 30, 2 << 40),
    {Path.DMA: 22.0, Path.GDS: 6.0, Path.STORAGE_HOST: 6.5, Path.UM: 9.0,
     Path.ICI: 100.0},
    {Path.DMA: 8.0, Path.GDS: 25.0, Path.STORAGE_HOST: 20.0, Path.UM: 4.0,
     Path.ICI: 2.0},
    hbm_bw=1008e9, peak_flops=82.6e12,
)

# The reference's default cost-model spec (see the module docstring).
TPU_V5E_SYSTEM = _mk(
    (16 << 30, 512 << 30, 16 << 40),
    {Path.DMA: 32.0, Path.GDS: 8.0, Path.STORAGE_HOST: 8.0, Path.UM: 8.0,
     Path.ICI: 50.0},
    {Path.DMA: 5.0, Path.GDS: 20.0, Path.STORAGE_HOST: 20.0, Path.UM: 4.0,
     Path.ICI: 1.0},
    hbm_bw=819e9, peak_flops=197e12,
)


@dataclasses.dataclass
class TransferRecord:
    path: Path
    src: MemoryTier
    dst: MemoryTier
    nbytes: int               # wire bytes: payload × hops
    seconds: float
    tag: str = ""
    hops: int = 1             # links crossed (payload = nbytes // hops)


class OutOfMemory(RuntimeError):
    """Raised when a tier allocation exceeds capacity (Table III '-')."""


class TieredMemorySystem:
    """Accounting of allocations and modeled transfers over the three-tier
    hierarchy: every transfer costs setup latency + bytes/bandwidth on its
    path. Busy time is kept per path, so independent channels (a GDS and a
    DMA transfer, dual-way) can be read as overlapped or serial."""

    def __init__(self, spec: TierSpec, keep_records: bool = True):
        self.spec = spec
        self.used: Dict[MemoryTier, int] = {t: 0 for t in MemoryTier}
        self.allocs: Dict[Tuple[MemoryTier, str], int] = {}
        # Per-transfer records feed fine-grained breakdowns (one fresh
        # instance per estimate). Long-lived accounting (a ServingEngine's
        # lifetime) sets keep_records=False so only the bounded per-path
        # aggregates grow.
        self.keep_records = keep_records
        self.transfers: List[TransferRecord] = []
        self._bytes_by_path: Dict[Path, int] = defaultdict(int)
        self._seconds_by_path: Dict[Path, float] = defaultdict(float)
        self.busy_s: Dict[Path, float] = defaultdict(float)
        self._total_bytes = 0

    # ---- allocation -----------------------------------------------------

    def _capacity(self, tier: MemoryTier) -> int:
        return {
            MemoryTier.DEVICE: self.spec.device_capacity,
            MemoryTier.HOST: self.spec.host_capacity,
            MemoryTier.STORAGE: self.spec.storage_capacity,
        }[tier]

    def alloc(self, tier: MemoryTier, name: str, nbytes: int) -> None:
        """Reserve `nbytes` of `tier` under `name`; a second allocation of
        the same name replaces the first. Raises OutOfMemory past the
        tier's capacity."""
        key = (tier, name)
        new_used = self.used[tier] - self.allocs.get(key, 0) + nbytes
        if new_used > self._capacity(tier):
            raise OutOfMemory(
                f"{tier.value}: need {new_used/2**30:.2f} GiB "
                f"> capacity {self._capacity(tier)/2**30:.2f} GiB ({name})")
        self.used[tier] = new_used
        self.allocs[key] = nbytes

    def free(self, tier: MemoryTier, name: str) -> None:
        key = (tier, name)
        self.used[tier] -= self.allocs.pop(key, 0)

    def headroom(self, tier: MemoryTier) -> int:
        return self._capacity(tier) - self.used[tier]

    # ---- transfer -------------------------------------------------------

    def transfer(self, path: Path, src: MemoryTier, dst: MemoryTier,
                 nbytes: int, tag: str = "", hops: int = 1) -> float:
        """Charge one transfer; returns its modeled seconds.

        `hops` > 1 is a multi-link hop (`ICITopology`): the payload pays
        the per-link setup latency once per link and one bandwidth term
        (links are pipelined), and the byte accounting counts it on every
        link it crossed."""
        hops = max(int(hops), 1)
        secs = self.spec.latency_s[path] * hops + nbytes / self.spec.bw[path]
        wire = int(nbytes) * hops
        if self.keep_records:
            self.transfers.append(
                TransferRecord(path, src, dst, wire, secs, tag, hops=hops))
        self.busy_s[path] += secs
        self._bytes_by_path[path] += wire
        self._seconds_by_path[path] += secs
        self._total_bytes += wire
        return secs

    def bytes_by_path(self) -> Dict[Path, int]:
        return dict(self._bytes_by_path)

    def seconds_by_path(self) -> Dict[Path, float]:
        return dict(self._seconds_by_path)

    def total_bytes(self) -> int:
        return self._total_bytes

    def makespan_overlapped(self) -> float:
        """Dual-way makespan: independent channels run concurrently."""
        return max(self.busy_s.values(), default=0.0)

    def makespan_serial(self) -> float:
        """Single-path makespan (baselines without dual-way transfer)."""
        return sum(self.busy_s.values())

    def reset_accounting(self) -> None:
        self.transfers.clear()
        self.busy_s.clear()
        self._bytes_by_path.clear()
        self._seconds_by_path.clear()
        self._total_bytes = 0
