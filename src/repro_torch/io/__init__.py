"""Memory tiers, the double-buffered stream, the tiered segment cache, its
mesh-sharded device tier, the cross-worker cache directory and the
streamed expert weights."""
from repro_torch.io.segment_cache import (
    CacheDirectory,
    CacheStats,
    SegmentKey,
    TieredSegmentCache,
    prefix_matches,
)
from repro_torch.io.shard_cache import ShardedSegmentCache, shard_of
from repro_torch.io.streamer import DoubleBufferedStreamer, StreamStats
from repro_torch.io.tiers import (
    ICI_ALL_TO_ALL,
    ICI_RING,
    PAPER_GPU_SYSTEM,
    TPU_V5E_SYSTEM,
    ICITopology,
    MemoryTier,
    OutOfMemory,
    Path,
    TieredMemorySystem,
    TierSpec,
    TransferRecord,
)
from repro_torch.io.weights import ExpertBank, StreamedWeightProvider

__all__ = [
    "CacheDirectory", "CacheStats", "SegmentKey", "TieredSegmentCache",
    "prefix_matches", "ShardedSegmentCache", "shard_of",
    "DoubleBufferedStreamer", "StreamStats",
    "ICI_ALL_TO_ALL", "ICI_RING", "ICITopology",
    "PAPER_GPU_SYSTEM", "TPU_V5E_SYSTEM", "MemoryTier", "OutOfMemory",
    "Path", "TieredMemorySystem", "TierSpec", "TransferRecord",
    "ExpertBank", "StreamedWeightProvider",
]
