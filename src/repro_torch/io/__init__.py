"""Memory tiers, the double-buffered stream and the tiered segment cache."""
from repro_torch.io.segment_cache import (
    CacheStats,
    SegmentKey,
    TieredSegmentCache,
)
from repro_torch.io.streamer import DoubleBufferedStreamer, StreamStats
from repro_torch.io.tiers import (
    PAPER_GPU_SYSTEM,
    TPU_V5E_SYSTEM,
    MemoryTier,
    OutOfMemory,
    Path,
    TieredMemorySystem,
    TierSpec,
)

__all__ = [
    "CacheStats", "SegmentKey", "TieredSegmentCache",
    "DoubleBufferedStreamer", "StreamStats",
    "PAPER_GPU_SYSTEM", "TPU_V5E_SYSTEM", "MemoryTier", "OutOfMemory",
    "Path", "TieredMemorySystem", "TierSpec",
]
