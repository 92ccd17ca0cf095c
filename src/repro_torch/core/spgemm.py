"""AiresSpGEMM — the paper's technique as a composable, differentiable API.

`AiresSpGEMM` wraps the pipeline: Eq. 5-7 planning → RoBW partitioning →
tile densification → double-buffered streaming → the Block-ELL kernels.
X = A @ H runs on `AiresConfig.device` ("cuda" unless the caller asks for
"cpu"); on the CPU each kernel's plain version computes each segment.

Both entry points are `torch.autograd.Function`s. The backward of
`engine(a, h)` computes dH = Aᵀ dX by streaming the transposed RoBW plan
(`robw_transpose_plan`) through the same stream and SpMM kernel, so a
gradient through a GCN layer really moves the bricks of Aᵀ. `gcn_layer`
streams the fused kernel forward, relu((A H) W + b) with X kept on chip,
and its backward recomputes X with one forward stream.

`gcn_epoch` runs one training epoch of the Fig. 1 chain under a named
scheduler: modeled (`mode="simulate"`) or for real through the
differentiable engine (`mode="execute"`), with the scheduler's modeled
per-layer metrics beside the real `StreamStats`.

Evolving graphs: `apply_edge_update` migrates every prepared plan of a
graph to its edge-delta successor, re-tiling only the touched segments
(`robw_delta_partition`) and reporting the cache keys made stale
(`UpdateStats`). A `Partition` tiles plans over its cluster boundaries and
installs its owner map on a sharded segment cache; an explicit ELL bucket
ladder (`AiresConfig.ell_buckets`, the autotuner's) pads bricks to it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Literal, Optional

import numpy as np
import torch

from repro_torch.core.memory_model import FeatureSpec, plan_memory_unified
from repro_torch.core.passes import CoalescedPayload
from repro_torch.core.pipeline import (
    LANE_COMPUTE,
    LANE_DMA,
    CacheProbeOp,
    ComputeOp,
    ExecuteInterpreter,
    PhaseSpec,
    PipelinePlan,
    ScheduleMetrics,
    TransferOp,
    modeled_spgemm_seconds,
)
from repro_torch.core.robw import (
    densify_segment,
    robw_delta_partition,
    robw_partition,
    robw_transpose_plan,
    segments_to_block_ell,
)
from repro_torch.io.segment_cache import SegmentKey, TieredSegmentCache
from repro_torch.io.streamer import StreamStats
from repro_torch.io.tiers import MemoryTier, Path, TierSpec, TPU_V5E_SYSTEM
from repro_torch.kernels.ops import bcsr_spmm, fused_gcn_layer
from repro_torch.sparse.formats import (
    CSR,
    BlockELL,
    csr_fingerprint,
    csr_transpose,
    graph_cache_prefix,
    segment_fingerprint,
)
from repro_torch.sparse.partition import Partition
from repro_torch.sparse.updates import EdgeDelta


def resolve_device(device: "str | torch.device") -> torch.device:
    """The torch device for `device`; asking for CUDA without a card raises
    instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


@dataclasses.dataclass
class AiresConfig:
    device_budget_bytes: int
    bm: int = 128
    bk: int = 128
    align: int = 8
    stream_depth: int = 2            # double buffering (Phase II)
    straggler_deadline_s: Optional[float] = None
    wire_format: Literal["csr", "bricks"] = "bricks"
    device: str = "cuda"
    # Plan (and densify) as if the feature matrix were this wide, whatever
    # H is passed: one RoBW plan then serves every layer width and every
    # batched request width ≤ plan_features, so the segment cache hits
    # across layers, epochs and requests. Wider H gets its own plan.
    plan_features: Optional[int] = None
    # Explicit ELL bucket ladder for tile densification (see
    # `ell_bucket_capacity` and the autotuner, core.autotune). None keeps
    # the power-of-two buckets.
    ell_buckets: Optional[List[int]] = None


@dataclasses.dataclass
class _Prepared:
    """Host-side artifacts of one streaming direction for one graph."""

    a: CSR                    # the matrix actually streamed (A or Aᵀ)
    mem: object               # MemoryEstimate
    plan: object              # RoBWPlan
    segs: List[object]
    ells: List[BlockELL]
    # Host tensors of each brick (blocks, col_tile, n_tiles), pinned once
    # here when streaming to a CUDA device so every upload is asynchronous.
    host: List[tuple] = dataclasses.field(default_factory=list)
    cache_ns: str = ""        # segment-cache namespace (graph+direction+plan)
    fps: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class UpdateStats:
    """What one `AiresSpGEMM.apply_edge_update` changed, summed over every
    prepared plan (direction × width) of the updated graph."""

    plans_updated: int = 0
    segments_retiled: int = 0
    segments_reused: int = 0
    retiled_bytes: int = 0        # wire bytes of the re-densified bricks
    # Cache keys the update made stale (old keys absent from the updated
    # plans): exactly what the runtime must invalidate.
    stale_keys: List[SegmentKey] = dataclasses.field(default_factory=list)


def host_tensors(ell: BlockELL, pin: bool) -> tuple:
    """The brick as CPU tensors; pinned copies when `pin`, and the
    BlockELL's arrays then become views of them (one host copy, not two)."""
    tensors = [torch.from_numpy(arr) for arr in
               (ell.blocks, ell.col_tile, ell.n_tiles)]
    if pin:
        tensors = [t.pin_memory() for t in tensors]
        ell.blocks, ell.col_tile, ell.n_tiles = (t.numpy() for t in tensors)
    return tuple(tensors)


def upload_brick(host: tuple, ell: BlockELL, device: torch.device) -> tuple:
    """Upload one brick: `(blocks, col_tile, n_tiles, ell)` with the
    tensors copied from `host` (`host_tensors(ell, ...)`) to `device` — the
    payload format shared by the streamer, the segment cache and the
    engine's warm start. From pinned host tensors the copies are
    asynchronous on the caller's stream."""
    return tuple(t.to(device, non_blocking=True) for t in host) + (ell,)


class AiresSpGEMM:
    """Out-of-core X = A @ H with the AIRES schedule, executing for real.

    Per-call `StreamStats` accumulate in `forward_stats_log` and
    `backward_stats_log` (cleared by `reset_stats_logs`), the most recent
    also on `last_stream_stats` and `last_backward_stream_stats`.
    """

    # Per-engine cap on cached (graph × shape × direction) preparations:
    # densified bricks outweigh the source CSR, so the memo is a small LRU.
    PREPARED_CACHE_MAX = 8

    def __init__(self, config: AiresConfig,
                 segment_cache: Optional[TieredSegmentCache] = None,
                 plan_passes=None, analyze: Optional[bool] = None,
                 partition: Optional[Partition] = None):
        self.config = config
        self.device = resolve_device(config.device)
        # Partition-aware sharding (sparse.partition): plans tile over the
        # partition's cluster boundaries, cache namespaces carry a
        # `:p{n_clusters}` tag, and every prepared plan installs its owner
        # map on a sharded segment cache. None = unpartitioned.
        self.partition = partition
        self.segment_cache = segment_cache
        # Optional core.passes.PassPipeline applied to every stream plan
        # before it is estimated or executed (build → rewrite → interpret,
        # the schedulers' seam). None = identity.
        self.plan_passes = plan_passes
        # Static plan analysis before every real stream (core.analysis):
        # None defers to the module default; the serving engine forwards
        # EngineConfig.analyze_plans.
        self.analyze = analyze
        self._prepared: Dict[tuple, _Prepared] = {}
        self._transposes: Dict[tuple, CSR] = {}
        self.forward_stats_log: List[StreamStats] = []
        self.backward_stats_log: List[StreamStats] = []
        self.last_stream_stats: Optional[StreamStats] = None
        self.last_backward_stream_stats: Optional[StreamStats] = None

    def plan(self, a: CSR, h_shape, boundaries=None) -> tuple:
        mem = plan_memory_unified(
            a, FeatureSpec(h_shape[0], h_shape[1], 4, 0.0),
            m_total=self.config.device_budget_bytes)
        if not mem.feasible:
            raise MemoryError(
                f"AIRES plan infeasible: budget {self.config.device_budget_bytes}"
                f" < M_B+M_C = {mem.m_b + mem.m_c:.0f}")
        plan = robw_partition(a, int(mem.m_a), align=self.config.align,
                              boundaries=boundaries)
        return mem, plan

    def reset_stats_logs(self) -> None:
        self.forward_stats_log = []
        self.backward_stats_log = []

    def clear_cache(self) -> None:
        """Drop every prepared plan (with its pinned host bricks) and every
        memoized transpose. The shared segment cache is left alone:
        `segment_cache.invalidate_prefix(graph_cache_prefix(a))` drops a
        graph's entries there."""
        self._prepared.clear()
        self._transposes.clear()

    @staticmethod
    def graph_cache_prefix(a: CSR) -> str:
        """Identity prefix of every segment-cache namespace this engine
        derives for `a` (any direction, plan width or budget). Content
        addressed (`csr_fingerprint`), as in the reference, so bricks
        checkpointed by one process, by either package, warm-start a
        fresh one."""
        return graph_cache_prefix(a)

    # ---- host-side preparation (cached per graph × feature shape) --------
    #
    # CSR inputs are IMMUTABLE: the memo keys are content fingerprints,
    # memoized on the instance.

    def transpose_of(self, a: CSR) -> CSR:
        """Memoized Aᵀ, content-addressed and LRU-bounded like `_prepared`."""
        key = (csr_fingerprint(a), a.nnz, a.shape)
        hit = self._transposes.pop(key, None)
        if hit is not None:
            self._transposes[key] = hit  # re-insert: most-recently-used
            return hit
        a_t = csr_transpose(a)
        self._transposes[key] = a_t
        while len(self._transposes) > self.PREPARED_CACHE_MAX:
            self._transposes.pop(next(iter(self._transposes)))
        return a_t

    def _prepare(self, a: CSR, dense_shape, transpose: bool) -> _Prepared:
        """Plan + densify one streaming direction; LRU-cached for epoch
        reuse."""
        cfg = self.config
        # Plan at the pinned width when configured (conservative for any
        # narrower H): one plan, and one set of cacheable bricks.
        plan_shape = (dense_shape[0],
                      max(cfg.plan_features or 0, dense_shape[1]))
        part = self.partition
        key = (csr_fingerprint(a), a.nnz, a.shape, plan_shape, transpose,
               tuple(cfg.ell_buckets or ()),
               0 if part is None else part.token)
        hit = self._prepared.pop(key, None)
        if hit is not None:
            self._prepared[key] = hit  # re-insert: most-recently-used
            return hit
        # The partition tiles the streamed orientation: A's rows forward;
        # the transposed direction only lines up for square graphs.
        part_rows = a.shape[1] if transpose else a.shape[0]
        if part is not None and part.n_rows != part_rows:
            part = None
        bounds = None if part is None else part.boundaries()
        if transpose:
            # Plan on Aᵀ: the backward output dH is (n_cols, F), so M_C and
            # the Eq. 7 budget are sized for the transposed orientation.
            a_t = self.transpose_of(a)
            mem = plan_memory_unified(
                a_t, FeatureSpec(plan_shape[0], plan_shape[1], 4, 0.0),
                m_total=cfg.device_budget_bytes)
            if not mem.feasible:
                raise MemoryError(
                    "AIRES backward plan infeasible: budget "
                    f"{cfg.device_budget_bytes} < M_B+M_C = "
                    f"{mem.m_b + mem.m_c:.0f}")
            _, plan = robw_transpose_plan(a, int(mem.m_a), align=cfg.align,
                                          a_t=a_t, boundaries=bounds)
            stream_a = a_t
        else:
            mem, plan = self.plan(a, plan_shape, boundaries=bounds)
            stream_a = a
        # An explicit bucket ladder tags the namespace (`:e…`): its bricks
        # pad differently, so they never collide with the power-of-two
        # entries. A partition tags its cluster count (`:p{k}`) the same
        # way; count only, so `Partition.refine` after an edge delta keeps
        # the namespace and every untouched brick in it.
        bucket_tag = ("" if not cfg.ell_buckets else
                      ":e" + "x".join(str(b) for b in cfg.ell_buckets))
        part_tag = "" if part is None else f":p{part.n_clusters}"
        cache_ns = (f"{self.graph_cache_prefix(a)}"
                    f":{'bwd' if transpose else 'fwd'}"
                    f":w{plan_shape[1]}:b{cfg.device_budget_bytes}"
                    f"{bucket_tag}{part_tag}")
        ells = list(segments_to_block_ell(stream_a, plan, bm=cfg.bm,
                                          bk=cfg.bk,
                                          buckets=cfg.ell_buckets))
        pin = self.device.type == "cuda"
        prepared = _Prepared(
            a=stream_a, mem=mem, plan=plan, segs=list(plan.segments),
            ells=ells, host=[host_tensors(ell, pin) for ell in ells],
            cache_ns=cache_ns,
            fps=[segment_fingerprint(stream_a, s.row_start, s.row_end)
                 for s in plan.segments])
        if self.segment_cache is not None:
            self.segment_cache.pin(cache_ns, a)
        if part is not None:
            self._install_owner_map(part, prepared, transpose)
        self._prepared[key] = prepared
        while len(self._prepared) > self.PREPARED_CACHE_MAX:
            self._prepared.pop(next(iter(self._prepared)))
        return prepared

    def _install_owner_map(self, part: Partition, prepared: _Prepared,
                           transpose: bool) -> None:
        """Project `part` onto one prepared plan's segments and install the
        owner map (and cluster ids) on the sharded segment cache.

        No-op for unsharded caches and shard-count mismatches. The
        transposed orientation votes with Aᵀ's row nnz (`part.row_nnz`
        counts A's rows, which are Aᵀ's columns)."""
        cache = self.segment_cache
        if (cache is None or part.n_shards <= 1
                or not hasattr(cache, "install_owner_map")
                or part.n_shards != getattr(cache, "n_shards", 1)):
            return
        row_nnz = (np.diff(prepared.a.indptr).astype(np.int64)
                   if transpose else None)
        clusters = part.clusters_for_plan(prepared.plan, row_nnz=row_nnz)
        owners = [int(part.cluster_to_shard[c]) for c in clusters]
        cache.install_owner_map(prepared.cache_ns, owners, clusters)

    # ---- incremental updates (evolving graphs) ---------------------------

    def _segment_keys(self, prepared: _Prepared) -> List[SegmentKey]:
        """Every SegmentKey one prepared plan emits (`_build_stream_plan`'s
        keys). The id is the segment's position in the plan, as in the
        reference, so a re-pack that shifts a reused segment stales its
        key."""
        cfg = self.config
        return [SegmentKey(prepared.cache_ns, i, cfg.wire_format,
                           tuple(ell.blocks.shape), fingerprint=fp)
                for i, (ell, fp) in enumerate(zip(prepared.ells,
                                                  prepared.fps))]

    def apply_edge_update(self, old: CSR, new: CSR,
                          delta: EdgeDelta) -> UpdateStats:
        """Migrate every prepared plan of `old` to `new` incrementally.

        Forward plans re-tile by `delta.touched_rows`, transposed plans by
        `delta.touched_cols`: untouched segments keep their bricks (and
        pinned host copies) and fingerprints, touched spans re-partition
        under the old budget (`robw_delta_partition`) and re-densify only
        their rows (`densify_segment`, bit-identical to a from-scratch
        re-tile). The cache namespace carries over (`new` inherits `old`'s
        `graph_key` lineage), so untouched segments keep hitting. Returns
        the stale keys the caller must invalidate.
        """
        old_fp = csr_fingerprint(old)
        cfg = self.config
        stats = UpdateStats()
        if (self.partition is not None
                and self.partition.n_rows == new.shape[0]):
            # Only the touched rows re-vote their cluster; the cluster →
            # shard map, the `:p{k}` namespace and every untouched brick's
            # owner carry over.
            self.partition = self.partition.refine(new, delta.touched_rows)
        token = 0 if self.partition is None else self.partition.token
        pin = self.device.type == "cuda"
        for key in [k for k in self._prepared if k[0] == old_fp]:
            prep = self._prepared.pop(key)
            _, _, _, plan_shape, transpose, buckets, _ = key
            if transpose:
                stream_new = self.transpose_of(new)
                touched = delta.touched_cols
            else:
                stream_new = new
                touched = delta.touched_rows
            new_plan, reuse = robw_delta_partition(stream_new, prep.plan,
                                                   touched)
            ells, host, fps = [], [], []
            for seg, src in zip(new_plan.segments, reuse):
                if src is not None:
                    ells.append(prep.ells[src])
                    host.append(prep.host[src])
                    fps.append(prep.fps[src])
                    stats.segments_reused += 1
                else:
                    ell = densify_segment(stream_new, seg,
                                          bm=cfg.bm, bk=cfg.bk,
                                          buckets=cfg.ell_buckets)
                    ells.append(ell)
                    host.append(host_tensors(ell, pin))
                    fps.append(segment_fingerprint(
                        stream_new, seg.row_start, seg.row_end))
                    stats.segments_retiled += 1
                    stats.retiled_bytes += ell.nbytes()
            old_keys = self._segment_keys(prep)
            # mem is reused: the budget depends on shape and width, both
            # unchanged by an edge delta.
            new_prep = _Prepared(a=stream_new, mem=prep.mem, plan=new_plan,
                                 segs=list(new_plan.segments), ells=ells,
                                 host=host, cache_ns=prep.cache_ns, fps=fps)
            self._prepared[(csr_fingerprint(new), new.nnz, new.shape,
                            plan_shape, transpose, buckets,
                            token)] = new_prep
            if self.segment_cache is not None:
                # The namespace now answers for the updated graph.
                self.segment_cache.pin(prep.cache_ns, new)
            part = self.partition
            if part is not None and part.n_rows == stream_new.shape[0]:
                # Refined labels may move rows between clusters, and the
                # re-tiled plan's segments need owners.
                self._install_owner_map(part, new_prep, transpose)
            fresh = set(self._segment_keys(new_prep))
            stats.stale_keys.extend(k for k in old_keys if k not in fresh)
            stats.plans_updated += 1
        self._transposes.pop((old_fp, old.nnz, old.shape), None)
        return stats

    # ---- pipeline-plan building + streaming executors --------------------

    def _build_stream_plan(self, prepared: _Prepared,
                           feat: Optional[FeatureSpec] = None,
                           spec: Optional[TierSpec] = None) -> PipelinePlan:
        """Phase II of one streamed pass as a `PipelinePlan`: the execute
        interpreter streams its `(i, ell)` payloads, `estimate()` reads its
        modeled cost."""
        cfg = self.config
        spec = spec if spec is not None else TPU_V5E_SYSTEM
        if feat is None:
            feat = FeatureSpec(prepared.a.shape[0],
                               cfg.plan_features or 1, 4, 0.0)
        plan = PipelinePlan(scheduler="aires-stream")
        plan.phases = [PhaseSpec("stream")]
        plan.mem = prepared.mem
        plan.robw = prepared.plan
        plan.segments = len(prepared.ells)
        cached = self.segment_cache is not None
        for i, (seg, ell) in enumerate(zip(prepared.segs, prepared.ells)):
            nbytes = ell.nbytes()
            miss = TransferOp(Path.DMA, MemoryTier.HOST, MemoryTier.DEVICE,
                              nbytes, tag="phaseII/seg", payload=(i, ell))
            if cached:
                key = SegmentKey(prepared.cache_ns, i, cfg.wire_format,
                                 tuple(ell.blocks.shape),
                                 fingerprint=prepared.fps[i])
                i_io = plan.add(CacheProbeOp(key, nbytes, miss,
                                             payload=(i, ell)),
                                "stream", LANE_DMA)
            else:
                i_io = plan.add(miss, "stream", LANE_DMA)
            plan.add(ComputeOp(modeled_spgemm_seconds(seg.nnz, feat, spec)),
                     "stream", LANE_COMPUTE, deps=(i_io,))
        return plan

    def stream_plan(self, a: CSR, h_shape, spec: Optional[TierSpec] = None,
                    transpose: bool = False,
                    apply_passes: bool = True) -> PipelinePlan:
        """Plan (and prepare) one streamed pass of `a` (of Aᵀ with
        `transpose`, the backward direction) at `h_shape`.

        The configured `plan_passes` are applied, so estimates price the
        plan the stream will actually run; ``apply_passes=False`` returns
        the raw pre-rewrite plan."""
        h_shape = tuple(int(s) for s in h_shape)
        feat = FeatureSpec(h_shape[0], h_shape[1], 4, 0.0)
        prepared = self._prepare(a, h_shape, transpose)
        plan = self._build_stream_plan(prepared, feat=feat, spec=spec)
        if apply_passes and self.plan_passes is not None:
            plan, _ = self.plan_passes.apply(
                plan, spec=spec, segment_cache=self.segment_cache)
        return plan

    def _stream(self, prepared: _Prepared, consume_one: Callable,
                feat: Optional[FeatureSpec] = None) -> tuple:
        """One double-buffered pass over `prepared`'s segments through the
        execute interpreter, after the configured `plan_passes`.
        consume_one(ell_dev, i) -> per-segment device result. Returns
        (row-concatenated output, StreamStats)."""
        cfg = self.config
        plan = self._build_stream_plan(prepared, feat=feat)
        if self.plan_passes is not None:
            plan, _ = self.plan_passes.apply(
                plan, segment_cache=self.segment_cache)

        def upload(payload):
            i, ell = payload
            if isinstance(ell, CoalescedPayload):
                # One streamer issue uploads every member brick of a
                # coalesced transfer (the pass merged adjacent small DMAs).
                return CoalescedPayload(
                    [(j, upload_brick(prepared.host[j], e, self.device))
                     for j, e in ell.payloads])
            return upload_brick(prepared.host[i], ell, self.device)

        def consume_device(dev_payload, i):
            blocks, col_tile, n_tiles, ell = dev_payload
            return consume_one(dataclasses.replace(
                ell, blocks=blocks, col_tile=col_tile, n_tiles=n_tiles), i)

        def consume(dev_payload, i):
            if isinstance(dev_payload, CoalescedPayload):
                # The member segments, back to back, in plan order.
                return [consume_device(dp, j)
                        for j, dp in dev_payload.payloads]
            return consume_device(dev_payload, i)

        cache = self.segment_cache
        # Copy, not alias: the cache mutates its stats in place.
        before = (dataclasses.replace(cache.stats)
                  if cache is not None else None)
        interp = ExecuteInterpreter(segment_cache=cache,
                                    analyze=self.analyze)
        parts, stats = interp.stream(
            plan, upload, consume, depth=cfg.stream_depth,
            deadline_s=cfg.straggler_deadline_s, device=self.device)
        if cache is not None:
            # Host-tier and peer hits re-crossed the bus as promotions, and
            # a sharded cache moved bytes between shards: surface both, so
            # uploaded_bytes=0 cannot read as zero traffic. `cache.stats`
            # may be a recomputed aggregate (ShardedSegmentCache), so
            # snapshot and diff.
            after = cache.stats
            stats.promoted_bytes = (after.promoted_bytes
                                    - before.promoted_bytes)
            stats.ici_bytes = after.ici_bytes - before.ici_bytes
            stats.directory_hit_bytes = (after.directory_hit_bytes
                                         - before.directory_hit_bytes)
        # Flatten coalesced-group results back into per-segment plan order.
        flat = []
        for p in parts:
            if isinstance(p, list):
                flat.extend(p)
            else:
                flat.append(p)
        out = torch.cat([p[: s.n_rows] for p, s in zip(flat, prepared.segs)],
                        dim=0)
        return out, stats

    def _stream_spmm(self, prepared: _Prepared, dense: torch.Tensor) -> tuple:
        """X = stream(A) @ dense."""
        # Phase I: the resident feature matrix.
        dense_dev = dense.to(self.device).contiguous()
        feat = FeatureSpec(int(dense.shape[0]), int(dense.shape[1]), 4, 0.0)
        return self._stream(
            prepared, lambda ell_dev, i: bcsr_spmm(ell_dev, dense_dev),
            feat=feat)

    # ---- differentiable public API --------------------------------------

    def __call__(self, a: CSR, h) -> torch.Tensor:
        """X = A @ H on this engine's device, differentiable w.r.t. H (dH
        streams Aᵀ). X is float32; dH comes back in H's dtype, on H's
        device."""
        h = torch.as_tensor(h)
        fwd = self._prepare(a, tuple(h.shape), transpose=False)
        return _SpGEMM.apply(h, self, a, fwd)

    def _backward_stream(self, a: CSR, g: torch.Tensor) -> torch.Tensor:
        """dH = Aᵀ @ g via the transposed RoBW plan, with stats recorded."""
        bwd = self._prepare(a, tuple(g.shape), transpose=True)
        dh, stats = self._stream_spmm(bwd, g)
        self.last_backward_stream_stats = stats
        self.backward_stats_log.append(stats)
        return dh

    def gcn_layer(self, a: CSR, h, w, b) -> torch.Tensor:
        """Differentiable fused layer Y = relu((A H) W + b), Fig. 1 chain.

        Forward streams the fused kernel: the aggregation X never reaches
        device memory. Backward therefore recomputes X with one forward
        stream (activation recomputation), then:
            dXW = dY ⊙ 1[Y>0];  dW = Xᵀ dXW;  db = Σ dXW;
            dH  = Aᵀ (dXW Wᵀ)   — one transposed stream.
        Y is float32 on this engine's device; each gradient comes back in
        its input's dtype, on its input's device.
        """
        h, w, b = (torch.as_tensor(t) for t in (h, w, b))
        fwd = self._prepare(a, tuple(h.shape), transpose=False)
        return _GCNLayer.apply(h, w, b, self, a, fwd)


class _SpGEMM(torch.autograd.Function):
    """X = A @ H through the forward stream; dH = Aᵀ dX through the
    transposed one."""

    @staticmethod
    def forward(ctx, h, engine, a, fwd):
        x, stats = engine._stream_spmm(fwd, h)
        engine.last_stream_stats = stats
        engine.forward_stats_log.append(stats)
        ctx.engine, ctx.a = engine, a
        ctx.h_dtype, ctx.h_device = h.dtype, h.device
        return x

    @staticmethod
    def backward(ctx, g):
        dh = ctx.engine._backward_stream(ctx.a, g)
        return dh.to(device=ctx.h_device, dtype=ctx.h_dtype), None, None, None


class _GCNLayer(torch.autograd.Function):
    """Y = relu((A H) W + b) through the fused kernel; the backward of
    `repro.core.spgemm.AiresSpGEMM.gcn_layer`, with the dense products as
    plain `torch.matmul` (the reference leaves them to XLA)."""

    @staticmethod
    def forward(ctx, h, w, b, engine, a, fwd):
        h_dev, w_dev, b_dev = (t.to(device=engine.device,
                                    dtype=torch.float32).contiguous()
                               for t in (h, w, b))
        y, stats = engine._stream(fwd, lambda ell_dev, i: fused_gcn_layer(
            ell_dev, h_dev, w_dev, b_dev))
        engine.last_stream_stats = stats
        engine.forward_stats_log.append(stats)
        ctx.save_for_backward(h_dev, w_dev, y)
        ctx.engine, ctx.a, ctx.fwd = engine, a, fwd
        ctx.like = [(t.dtype, t.device) for t in (h, w, b)]
        return y

    @staticmethod
    def backward(ctx, dy):
        engine = ctx.engine
        h_dev, w_dev, y = ctx.saved_tensors
        # Recompute X = A H with one forward stream (counted in the
        # backward log: it is backward-phase I/O).
        x, stats = engine._stream_spmm(ctx.fwd, h_dev)
        engine.backward_stats_log.append(stats)
        dxw = (dy * (y > 0)).to(torch.float32)
        dw = torch.matmul(x.T, dxw)
        db = torch.sum(dxw, dim=0)
        dx = torch.matmul(dxw, w_dev.T)
        dh = engine._backward_stream(ctx.a, dx)
        # All three, always: the stats logs then match the reference's.
        grads = tuple(g.to(device=device, dtype=dtype)
                      for g, (dtype, device) in zip((dh, dw, db), ctx.like))
        return grads + (None, None, None)


# ---- one training epoch under a scheduler ----------------------------------


@dataclasses.dataclass
class EpochMetrics:
    per_layer: List[ScheduleMetrics]
    epoch_makespan_s: float
    total_transfer_bytes: int
    # execute mode: modeled backward metrics (transposed stream) per layer
    per_layer_backward: List[ScheduleMetrics] = dataclasses.field(
        default_factory=list)
    # execute mode: real streaming stats, one entry per layer, layer order
    forward_stream: List[StreamStats] = dataclasses.field(default_factory=list)
    backward_stream: List[StreamStats] = dataclasses.field(default_factory=list)
    wall_seconds: float = 0.0

    def speedup_over(self, other: "EpochMetrics") -> float:
        return other.epoch_makespan_s / max(self.epoch_makespan_s, 1e-12)


def gcn_epoch(
    a: CSR,
    h0,
    weights: List,
    scheduler_name: str,
    spec: TierSpec,
    device_budget: int,
    mode: Literal["simulate", "execute"] = "simulate",
    dataset: str = "",
    backward_factor: float = 2.0,
    engine_config: Optional[AiresConfig] = None,
    segment_cache: Optional[TieredSegmentCache] = None,
) -> EpochMetrics:
    """One training epoch of the Fig. 1 chain under a given scheduler.

    Per layer: X = Ã H (out-of-core SpGEMM, scheduled), H' = σ(X W) (dense,
    on the device).

    simulate — backward is modeled as `backward_factor`× the forward cost
    with the same streaming pattern, matching the paper's per-epoch
    accounting (§V-A) at scales where execution is impractical.

    execute — a true forward+backward pass runs through the differentiable
    `AiresSpGEMM` engine (torch autograd over the layer chain) on
    `engine_config.device`: the backward really streams the transposed
    RoBW plan, and `EpochMetrics` carries the per-layer forward/backward
    `StreamStats` plus modeled per-layer metrics for the chosen scheduler
    over A (forward) and Aᵀ (backward). `backward_factor` is ignored in
    execute mode. Modeled seconds are priced under `spec`, not measured.
    """
    if mode == "execute":
        return _execute_epoch(a, h0, weights, scheduler_name, spec,
                              device_budget, dataset, engine_config,
                              segment_cache)
    return _simulate_epoch(a, h0, weights, scheduler_name, spec,
                           device_budget, dataset, backward_factor,
                           segment_cache)


def _simulate_epoch(a, h0, weights, scheduler_name, spec, device_budget,
                    dataset, backward_factor,
                    segment_cache=None) -> EpochMetrics:
    from repro_torch.core.scheduler import SCHEDULERS

    kw = ({"segment_cache": segment_cache}
          if segment_cache is not None and scheduler_name == "aires" else {})
    sched = SCHEDULERS[scheduler_name](spec, device_budget=device_budget, **kw)
    per_layer: List[ScheduleMetrics] = []
    makespan = 0.0
    total_bytes = 0
    h = h0
    for w in weights:
        res = sched.run(a, h, mode="simulate", dataset=dataset)
        m = res.metrics
        per_layer.append(m)
        if m.oom:
            return EpochMetrics(per_layer, float("inf"), 0)
        # forward + modeled backward streaming cycles
        makespan += m.makespan_s * (1.0 + backward_factor)
        total_bytes += int(m.total_transfer_bytes * (1.0 + backward_factor))
        if isinstance(h, FeatureSpec):
            h = FeatureSpec(h.n_rows, w.shape[1], h.dtype_bytes,
                            h.sparsity_pct)
        else:
            h = np.zeros((h.shape[0], w.shape[1]), dtype=np.float32)
    return EpochMetrics(per_layer, makespan, total_bytes)


def _execute_epoch(a, h0, weights, scheduler_name, spec, device_budget,
                   dataset, engine_config, segment_cache=None) -> EpochMetrics:
    from repro_torch.core.scheduler import SCHEDULERS

    cfg = engine_config or AiresConfig(device_budget_bytes=device_budget)
    engine = AiresSpGEMM(cfg, segment_cache=segment_cache)
    engine.reset_stats_logs()
    sched = SCHEDULERS[scheduler_name](spec, device_budget=device_budget)
    # One transpose, shared with the engine's backward streaming plans.
    a_t = engine.transpose_of(a)

    # ---- modeled per-layer accounting: forward over A, backward over Aᵀ.
    per_layer: List[ScheduleMetrics] = []
    per_layer_bwd: List[ScheduleMetrics] = []
    makespan = 0.0
    total_bytes = 0
    n, f = h0.shape
    width = f
    for w in weights:
        feat_f = FeatureSpec(n, width, 4, 0.0)
        res_f = sched.run(a, feat_f, mode="simulate", dataset=dataset)
        # dX arriving at this layer's aggregation has the layer's own width.
        res_b = sched.run(a_t, FeatureSpec(n, width, 4, 0.0),
                          mode="simulate", dataset=dataset)
        per_layer.append(res_f.metrics)
        per_layer_bwd.append(res_b.metrics)
        if res_f.metrics.oom or res_b.metrics.oom:
            return EpochMetrics(per_layer, float("inf"), 0,
                                per_layer_backward=per_layer_bwd)
        makespan += res_f.metrics.makespan_s + res_b.metrics.makespan_s
        total_bytes += (res_f.metrics.total_transfer_bytes
                        + res_b.metrics.total_transfer_bytes)
        width = w.shape[1]

    # ---- real forward+backward through the differentiable engine.
    dev = engine.device
    h, *ws = (torch.as_tensor(t, dtype=torch.float32, device=dev).detach()
              .requires_grad_(True) for t in (h0, *weights))

    t0 = time.perf_counter()
    out = h
    for w in ws:
        out = torch.relu(engine(a, out) @ w)
    torch.autograd.backward(out, torch.ones_like(out) / out.numel())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    return EpochMetrics(
        per_layer=per_layer,
        epoch_makespan_s=makespan,
        total_transfer_bytes=total_bytes,
        per_layer_backward=per_layer_bwd,
        forward_stream=list(engine.forward_stats_log),
        backward_stream=list(reversed(engine.backward_stats_log)),
        wall_seconds=wall,
    )
