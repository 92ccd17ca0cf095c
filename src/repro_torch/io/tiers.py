"""Tiered memory system: device memory / host DRAM / secondary storage.

The paper's three tiers are device memory, host memory and NVMe (+GDS
path). `TieredMemorySystem` accounts every transfer (bytes, path, modeled
seconds) against a `TierSpec`, so cost estimates and byte accounting can be
read off a plan without running it.

`TPU_V5E_SYSTEM` is the reference package's default spec, copied verbatim
from `repro.io.tiers` so that `PipelinePlan.estimate()` and the byte
accounting match the reference's. It is cost-model data only: it describes
no property of the card this package runs on. A spec fitted to the card is
the calibration slice's work.
"""
from __future__ import annotations

import dataclasses
import enum
from collections import defaultdict
from typing import Dict, List


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
    nbytes: int
    seconds: float
    tag: str = ""


class TieredMemorySystem:
    """Accounting of modeled transfers over the three-tier hierarchy:
    every transfer costs setup latency + bytes/bandwidth on its path."""

    def __init__(self, spec: TierSpec, keep_records: bool = True):
        self.spec = spec
        # Per-transfer records feed fine-grained breakdowns (one fresh
        # instance per estimate). Long-lived accounting (a ServingEngine's
        # lifetime) sets keep_records=False so only the bounded per-path
        # aggregates grow.
        self.keep_records = keep_records
        self.transfers: List[TransferRecord] = []
        self._bytes_by_path: Dict[Path, int] = defaultdict(int)
        self._seconds_by_path: Dict[Path, float] = defaultdict(float)
        self._total_bytes = 0

    def transfer(self, path: Path, src: MemoryTier, dst: MemoryTier,
                 nbytes: int, tag: str = "") -> float:
        """Charge one transfer; returns its modeled seconds."""
        secs = self.spec.latency_s[path] + nbytes / self.spec.bw[path]
        if self.keep_records:
            self.transfers.append(
                TransferRecord(path, src, dst, int(nbytes), secs, tag))
        self._bytes_by_path[path] += int(nbytes)
        self._seconds_by_path[path] += secs
        self._total_bytes += int(nbytes)
        return secs

    def bytes_by_path(self) -> Dict[Path, int]:
        return dict(self._bytes_by_path)

    def seconds_by_path(self) -> Dict[Path, float]:
        return dict(self._seconds_by_path)

    def total_bytes(self) -> int:
        return self._total_bytes
