"""Double-buffered host→device streamer (Phase II of Alg. 2).

On a CUDA device the overlap is explicit: every upload (and every cache
promotion) is issued on a dedicated copy stream from pinned host memory
with `non_blocking=True`, a CUDA event is recorded after it, and the
compute stream waits on that event before the segment's kernel. The
device tensors are `record_stream`-ed on the compute stream so the caching
allocator cannot hand their memory to a later upload while a kernel still
reads them. `run_all` synchronises once at the end (paper Phase III
store), not per segment. On the CPU the same loop runs without streams.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, Iterator, List, Optional

import torch


@dataclasses.dataclass
class StreamStats:
    segments: int = 0
    put_seconds: float = 0.0       # host time issuing uploads (and promotions)
    compute_seconds: float = 0.0   # host time issuing the consumers
    reissues: int = 0              # straggler mitigations
    uploaded_bytes: int = 0        # wire bytes (when payload_nbytes is given)
    cache_hits: int = 0            # segments served from the segment cache
    cache_hit_bytes: int = 0       # wire bytes served from the cache
    promoted_bytes: int = 0        # of those, host-tier promotions that DID
    #                                re-cross the bus (true bus traffic is
    #                                uploaded_bytes + promoted_bytes)
    ici_bytes: int = 0             # sharded cache: bytes that crossed the
    #                                ICI path (remote hits + placements)
    directory_hit_bytes: int = 0   # wire bytes served from a peer worker's
    #                                host copy (CacheDirectory)


_END = object()


def _tensors(payload: Any) -> Iterator[torch.Tensor]:
    if isinstance(payload, torch.Tensor):
        yield payload
    elif isinstance(payload, (tuple, list)):
        for item in payload:
            yield from _tensors(item)
    elif isinstance(payload, dict):
        # A block of named weights (io/weights.py).
        for item in payload.values():
            yield from _tensors(item)
    elif hasattr(payload, "payloads"):
        # A coalesced upload (core.passes.CoalescedPayload): one issue,
        # every member segment's tensors.
        yield from _tensors(payload.payloads)


class DoubleBufferedStreamer:
    """Prefetch-ahead pipeline over host segments.

    upload(payload) -> device payload (tensors copied to the device)
    consume(device_payload, i) -> result (device computation, async)

    depth=2 is classic double buffering (paper Phase II). A deadline
    (seconds) per segment re-issues a slow upload — the straggler
    mitigation.

    Optional cache hooks (the tiered segment cache, io/segment_cache.py):
    `cache_lookup(payload)` returning non-None short-circuits the upload —
    its wire bytes land in `cache_hit_bytes` instead of `uploaded_bytes`;
    after a miss's upload, `cache_store(payload, device_payload)` retains
    it for the next epoch.
    """

    def __init__(
        self,
        upload: Callable[[Any], Any],
        consume: Callable[[Any, int], Any],
        depth: int = 2,
        deadline_s: Optional[float] = None,
        max_reissue: int = 1,
        payload_nbytes: Optional[Callable[[Any], int]] = None,
        cache_lookup: Optional[Callable[[Any], Optional[Any]]] = None,
        cache_store: Optional[Callable[[Any, Any], None]] = None,
        device: "str | torch.device" = "cuda",
    ):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.upload = upload
        self.consume = consume
        self.depth = depth
        self.deadline_s = deadline_s
        self.max_reissue = max_reissue
        self.payload_nbytes = payload_nbytes
        self.cache_lookup = cache_lookup
        self.cache_store = cache_store
        self.device = torch.device(device)
        self.copy_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)
        self.stats = StreamStats()

    def _upload_with_deadline(self, payload: Any) -> Any:
        nbytes = (int(self.payload_nbytes(payload))
                  if self.payload_nbytes is not None else 0)
        if self.cache_lookup is not None:
            t0 = time.perf_counter()
            cached = self.cache_lookup(payload)
            if cached is not None:
                # Lookup time includes any host->device promotion the cache
                # issued — that is real transfer work, count it.
                self.stats.put_seconds += time.perf_counter() - t0
                self.stats.cache_hits += 1
                self.stats.cache_hit_bytes += nbytes
                return cached
        self.stats.uploaded_bytes += nbytes
        t0 = time.perf_counter()
        dev = self.upload(payload)
        if self.deadline_s is not None:
            for _ in range(self.max_reissue):
                if time.perf_counter() - t0 <= self.deadline_s:
                    break
                # Straggler: re-issue the transfer; the retransmit is real
                # wire traffic, so count it.
                self.stats.reissues += 1
                self.stats.uploaded_bytes += nbytes
                t0 = time.perf_counter()
                dev = self.upload(payload)
        self.stats.put_seconds += time.perf_counter() - t0
        if self.cache_store is not None:
            self.cache_store(payload, dev)
        return dev

    def _issue(self, payload: Any):
        """Upload (or fetch from the cache) one payload; on CUDA, on the
        copy stream, returning the event that marks its arrival."""
        if self.copy_stream is None:
            return self._upload_with_deadline(payload), None
        with torch.cuda.stream(self.copy_stream):
            dev = self._upload_with_deadline(payload)
            ready = torch.cuda.Event()
            ready.record(self.copy_stream)
        return dev, ready

    def run(self, payloads: Iterable[Any]) -> Iterator[Any]:
        """Yield consume() results in order, depth-deep pipelined."""
        compute = (torch.cuda.current_stream(self.device)
                   if self.copy_stream is not None else None)
        it = iter(payloads)
        inflight: List[Any] = []
        for payload in it:
            inflight.append(self._issue(payload))
            if len(inflight) >= self.depth:
                break
        i = 0
        while inflight:
            dev, ready = inflight.pop(0)
            if ready is not None:
                compute.wait_event(ready)
                for t in _tensors(dev):
                    t.record_stream(compute)
            t0 = time.perf_counter()
            result = self.consume(dev, i)
            self.stats.compute_seconds += time.perf_counter() - t0
            self.stats.segments += 1
            # Refill the pipeline before handing back the result.
            nxt = next(it, _END)
            if nxt is not _END:
                inflight.append(self._issue(nxt))
            yield result
            i += 1

    def run_all(self, payloads: Iterable[Any]) -> List[Any]:
        out = list(self.run(payloads))
        if self.copy_stream is not None:
            torch.cuda.synchronize(self.device)
        return out
