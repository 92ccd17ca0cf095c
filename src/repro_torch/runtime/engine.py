"""Out-of-core GCN serving engine: multi-graph batching over AiresSpGEMM.

Requests against many resident graphs are queued, grouped by graph, and
served through one `AiresSpGEMM` per graph — all engines sharing one tiered
segment cache, so streaming BlockELL bricks host→device amortizes across
requests, layers and epochs:

  * one prepared plan per graph — every engine plans at the pinned width
    `EngineConfig.max_batch_features`, so all layer and batch widths up to
    the pin share one RoBW plan and its cached bricks;
  * column-concat batching — X = A·[H₁|H₂|…] computes every queued
    request's aggregation for a graph in one streamed pass;
  * Phase III chaining — activations stay on the device between layers;
    only each request's final output is copied to the host.

Request semantics: a request with L weight matrices computes
    h ← relu((A h) Wₗ) for l < L-1;  output = (A h) W_{L-1}
(final layer linear); L = 0 returns the bare aggregation A·H.

Scale-out: `cache_shards > 1` (or a `mesh`) partitions the cache's device
tier over shards (`ShardedSegmentCache`, remote hits charged on the ICI
path), and a `CacheDirectory` shared by replicated workers serves one
worker's miss from a peer's host copy and skips duplicate demotions. The
cache's bricks can be checkpointed (`checkpoint_cache`) and a fresh engine
warm-started from them (`warm_start`), across the two packages. A
`CostCalibrator` refits the spec every admission decision prices against
from each batch's measured latencies.

Per graph, `autotune` searches the plan's knobs (coalescing threshold,
pass order, ELL bucket set, partition cluster count) under the calibrated
cost model and `install_schedule` installs the winner; `partition_shards`
(or `register_graph(partition=)`) replaces CRC brick owners with a
connectivity clustering's; `update_graph` applies an edge delta, re-tiling
and invalidating only the segments it touched.

`repro.runtime.engine` without the continuous serving loop's
`estimate_group_cost`; its byte accounting and cost predictions are the
reference's, which the tests hold them to.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import (
    load_segment_bricks,
    save_segment_bricks,
)
from repro_torch.core.autotune import TunedSchedule, autotune_schedule
from repro_torch.core.calibration import CostCalibrator
from repro_torch.core.passes import PassPipeline, PlanPass
from repro_torch.core.spgemm import (
    AiresConfig,
    AiresSpGEMM,
    host_tensors,
    resolve_device,
    upload_brick,
)
from repro_torch.io.segment_cache import (
    CacheDirectory,
    CacheStats,
    SegmentKey,
    TieredSegmentCache,
)
from repro_torch.io.shard_cache import ShardedSegmentCache
from repro_torch.io.tiers import (
    ICI_ALL_TO_ALL,
    ICITopology,
    MemoryTier,
    Path,
    TieredMemorySystem,
    TierSpec,
    TPU_V5E_SYSTEM,
)
from repro_torch.sparse.formats import CSR, BlockELL
from repro_torch.sparse.partition import Partition, partition_graph
from repro_torch.sparse.updates import EdgeDelta, apply_edge_updates


@dataclasses.dataclass
class EngineConfig:
    """Knobs for the serving engine."""

    device_budget_bytes: int
    cache_enabled: bool = True
    # Segment-cache tiers: device defaults to the streaming budget, host
    # None = unbounded spill.
    cache_device_bytes: Optional[int] = None
    cache_host_bytes: Optional[int] = None
    # Sharded device tier (io/shard_cache.py): > 1 partitions the cache's
    # device budget over `cache_shards` independent LRU shards, remote hits
    # riding the ICI path; 1 keeps the single-device cache. A mesh passed
    # to ServingEngine overrides this with the size of `cache_shard_axis`.
    cache_shards: int = 1
    cache_shard_axis: str = "cache"
    # Identity of this replicated worker in a shared CacheDirectory.
    worker_id: int = 0
    # Planning width: one plan serves all request/layer widths up to this,
    # and batches are chunked so concatenated width never exceeds it.
    max_batch_features: int = 64
    bm: int = 8
    bk: int = 8
    align: int = 8
    stream_depth: int = 2
    straggler_deadline_s: Optional[float] = None
    device: str = "cuda"
    # Cost model for admission control: each request is priced with
    # `PipelinePlan.estimate()` under this TierSpec.
    tier_spec: TierSpec = TPU_V5E_SYSTEM
    # Reject a submit() once the estimated cost of the queued requests plus
    # the new one exceeds this many modeled seconds (None = unbounded).
    max_queue_cost_s: Optional[float] = None
    # Plan-rewrite passes (core.passes): a PassPipeline — or a sequence of
    # PlanPass instances — applied to every stream plan before it is
    # estimated or executed; an EDFOrderingPass in the pipeline also
    # reorders run_batch() work earliest-deadline-first. None (default)
    # and the empty pipeline keep the pass-free behavior.
    plan_passes: Optional["PassPipeline | Sequence[PlanPass]"] = None
    # Static plan analysis (core.analysis) before every real stream: True
    # forces it on, False off, None defers to the module default. An
    # error-severity finding raises PlanAnalysisError instead of streaming
    # a semantically broken plan.
    analyze_plans: Optional[bool] = None
    # Clock for submit stamps and deadline expiry (None = time.monotonic).
    clock: Optional[Callable[[], float]] = None
    # Chip-to-chip link topology for the sharded cache's ICI charges.
    ici_topology: ICITopology = ICI_ALL_TO_ALL
    # Online cost calibration (core.calibration): when set, every estimate
    # prices against `calibrator.calibrated(tier_spec)`, each batch's
    # RequestLatency stream is fed back into it, and a generation bump
    # drops the memoized pass costs and reprices queued requests. None =
    # static costs.
    calibrator: Optional[CostCalibrator] = None
    # Explicit ELL bucket ladder for every registered graph's bricks
    # (AiresConfig.ell_buckets); None keeps power-of-two buckets. Usually
    # installed per graph by `install_schedule` rather than set here.
    ell_buckets: Optional[Sequence[int]] = None
    # Partition-aware sharding (sparse.partition): cluster count of the
    # connectivity clustering run over every registered graph when the
    # segment cache is sharded (`cache_shards > 1`); its owner map replaces
    # CRC owners for that graph's bricks. 0 (default) = off; ignored on
    # unsharded caches. Per graph: `register_graph(partition=)`, or an
    # installed schedule whose `partition_clusters` is set.
    partition_shards: int = 0


@dataclasses.dataclass
class InferenceRequest:
    """One GCN inference against a registered graph.

    `deadline_s` is relative: the request must finish within that many
    seconds of submit(). Submission rejects requests whose modeled cost
    alone exceeds the deadline, and run_batch() expires requests whose
    deadline passed while queued.
    """

    graph: str
    features: np.ndarray                  # (n_nodes, F)
    weights: Sequence[np.ndarray] = ()    # per-layer (F_in, F_out) chain
    request_id: int = -1                  # assigned by submit()
    deadline_s: Optional[float] = None
    submitted_s: float = -1.0             # clock stamp set by submit()
    estimated_cost_s: float = 0.0         # modeled cost set by submit()


@dataclasses.dataclass
class InferenceResult:
    request_id: int
    graph: str
    output: np.ndarray


@dataclasses.dataclass
class RejectedRequest:
    """Admission-control verdict for a request that never joined the queue
    (or expired on it). Reported in the next BatchReport."""

    graph: str
    reason: str                    # "deadline-infeasible" | "queue-full" | "deadline-expired"
    estimated_cost_s: float
    deadline_s: Optional[float] = None
    request_id: int = -1           # -1: rejected before an id was assigned


class AdmissionError(RuntimeError):
    """submit() refused a request; `.decision` carries the verdict."""

    def __init__(self, decision: RejectedRequest):
        self.decision = decision
        super().__init__(
            f"request on graph {decision.graph!r} rejected "
            f"({decision.reason}): estimated cost "
            f"{decision.estimated_cost_s:.3g}s"
            + (f" vs deadline {decision.deadline_s:.3g}s"
               if decision.deadline_s is not None else ""))


class SubmitReceipt(int):
    """What `submit()` returns: the request id (an int) carrying the
    `PipelinePlan.estimate()` cost admission control priced it with (0.0
    when no admission policy was in force)."""

    estimated_cost_s: float

    def __new__(cls, request_id: int, estimated_cost_s: float = 0.0):
        obj = super().__new__(cls, request_id)
        obj.estimated_cost_s = float(estimated_cost_s)
        return obj


@dataclasses.dataclass
class RequestLatency:
    """Predicted-vs-actual story of one served request.

    `predicted_s` is the request's `PipelinePlan.estimate()` cost.
    `actual_s` is the wall time from the batch's start until this request's
    output reached the host; `processing_s` the same stamp measured from
    its own graph group's start (the number comparable to `predicted_s`).
    """

    request_id: int
    graph: str
    predicted_s: float
    actual_s: float
    processing_s: float = 0.0

    @property
    def error_s(self) -> float:
        return self.processing_s - self.predicted_s


@dataclasses.dataclass
class GraphUpdateReport:
    """What one `update_graph` edge delta changed, end to end."""

    graph: str
    delta: EdgeDelta
    plans_updated: int            # prepared plans migrated (direction×width)
    segments_retiled: int         # bricks re-densified (touched rows only)
    segments_reused: int          # bricks carried over verbatim
    retiled_bytes: int            # wire bytes of the re-densified bricks
    stale_keys: int               # segment keys made stale by the delta
    cache_entries_dropped: int    # of those, entries actually evicted
    wall_seconds: float = 0.0


@dataclasses.dataclass
class WarmStartReport:
    """What warm_start() restored into the segment cache."""

    bricks: int = 0
    wire_bytes: int = 0
    modeled_seconds: float = 0.0   # storage→host + host→device, via the tms


@dataclasses.dataclass
class GroupStats:
    """I/O story of one served column-concat group."""

    uploaded_bytes: int = 0
    cache_hit_bytes: int = 0
    promoted_bytes: int = 0
    ici_bytes: int = 0
    directory_hit_bytes: int = 0
    segments_streamed: int = 0
    aggregation_passes: int = 0

    def accumulate(self, stats) -> None:
        """Fold one stream's `StreamStats` into the group totals."""
        self.uploaded_bytes += stats.uploaded_bytes
        self.cache_hit_bytes += stats.cache_hit_bytes
        self.promoted_bytes += stats.promoted_bytes
        self.ici_bytes += stats.ici_bytes
        self.directory_hit_bytes += stats.directory_hit_bytes
        self.segments_streamed += stats.segments
        self.aggregation_passes += 1

    def merge(self, other: "GroupStats") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))


@dataclasses.dataclass
class BatchReport:
    """One run_batch() drain: results + the I/O story of the batch."""

    results: List[InferenceResult]
    uploaded_bytes: int       # wire bytes freshly streamed host->device
    cache_hit_bytes: int      # wire bytes served from the segment cache
    promoted_bytes: int       # of those, host-tier hits re-crossing the bus
    segments_streamed: int    # consume() invocations (incl. cache hits)
    aggregation_passes: int   # streamed SpGEMM passes (batching merges these)
    wall_seconds: float = 0.0
    # Sharded cache: bytes that crossed the inter-chip path this batch
    # (remote-shard hits + shard placements). 0 for a 1-shard cache.
    ici_bytes: int = 0
    # Cross-worker directory: wire bytes served from a peer worker's host
    # copy, and demotion copies this worker skipped because a peer already
    # holds the brick. 0 with no directory attached.
    directory_hit_bytes: int = 0
    duplicate_avoided_bytes: int = 0
    rejected: List[RejectedRequest] = dataclasses.field(default_factory=list)
    expired: List[RejectedRequest] = dataclasses.field(default_factory=list)
    request_latency: List[RequestLatency] = dataclasses.field(
        default_factory=list)

    @property
    def bus_bytes(self) -> int:
        """Everything that actually crossed host->device this batch."""
        return self.uploaded_bytes + self.promoted_bytes

    @property
    def hit_rate(self) -> float:
        total = self.uploaded_bytes + self.cache_hit_bytes
        return self.cache_hit_bytes / total if total else 0.0


class ServingEngine:
    """Multi-graph out-of-core GCN inference with a shared segment cache.

    Usage:
        eng = ServingEngine(EngineConfig(device_budget_bytes=...))
        eng.register_graph("socLJ1", adjacency_csr)
        rid = eng.submit(InferenceRequest("socLJ1", h, weights=[w0, w1]))
        report = eng.run_batch()          # drains the queue, grouped by graph

    With `cache_enabled=False` every batch re-streams every segment.

    `directory` (a `CacheDirectory` shared by replicated workers, each with
    its own `EngineConfig.worker_id`) and `mesh` (an object with
    `axis_names` and a numpy `devices` grid of `torch.device`s, sharding
    the cache over `config.cache_shard_axis`) are cache features.
    """

    def __init__(self, config: EngineConfig,
                 directory: Optional[CacheDirectory] = None,
                 mesh=None):
        self.config = config
        self.directory = directory
        self.device = resolve_device(config.device)
        self.clock: Callable[[], float] = config.clock or time.monotonic
        # Plan-rewrite pipeline every batch's stream plans route through
        # (build → rewrite → interpret). A bare sequence of passes is
        # wrapped here; track_costs=False keeps per-stream estimates off
        # the serving hot path.
        pp = config.plan_passes
        if pp is None:
            self.plan_pipeline: Optional[PassPipeline] = None
        elif isinstance(pp, PassPipeline):
            self.plan_pipeline = pp
        else:
            self.plan_pipeline = PassPipeline(
                list(pp), spec=config.tier_spec, track_costs=False)
        # Modeled I/O outside a stream's own window (cache demote/promote
        # churn) lands here. keep_records=False: a serving process lives
        # long, only the bounded per-path aggregates may grow.
        self.tms = TieredMemorySystem(config.tier_spec, keep_records=False)
        self.cache: Optional["TieredSegmentCache | ShardedSegmentCache"] = None
        if not config.cache_enabled and (directory is not None
                                         or mesh is not None):
            raise ValueError(
                "cache_enabled=False contradicts an explicit "
                f"{'directory' if directory is not None else 'mesh'}: "
                "the sharded tier and the cross-worker directory are "
                "cache features")
        if directory is not None:
            # Distinct replica identities, or the directory silently no-ops.
            directory.claim_worker(config.worker_id)
        if config.cache_enabled:
            device_bytes = (config.cache_device_bytes
                            or config.device_budget_bytes)
            shared = dict(host_budget_bytes=config.cache_host_bytes,
                          tms=self.tms, directory=directory,
                          worker_id=config.worker_id)
            if mesh is not None:
                self.cache = ShardedSegmentCache.from_mesh(
                    mesh, device_bytes, axis=config.cache_shard_axis,
                    topology=config.ici_topology, **shared)
            elif config.cache_shards > 1:
                self.cache = ShardedSegmentCache(
                    device_budget_bytes=device_bytes,
                    n_shards=config.cache_shards,
                    topology=config.ici_topology, device=self.device,
                    **shared)
            else:
                self.cache = TieredSegmentCache(
                    device_budget_bytes=device_bytes, device=self.device,
                    **shared)
        self._graphs: "OrderedDict[str, CSR]" = OrderedDict()
        self._engines: Dict[str, AiresSpGEMM] = {}
        self._queue: List[InferenceRequest] = []
        self._next_id = 0
        # Memoized per-(graph, width) pass cost estimates, and the verdicts
        # awaiting their BatchReport.
        self._pass_costs: Dict[tuple, float] = {}
        self._rejected: List[RejectedRequest] = []
        # Calibration generation the memos were priced under; when the
        # calibrator moves past it, cost_spec() clears the memos and
        # reprices the queue. Installed autotuned schedules, per graph.
        self._cost_generation = (config.calibrator.generation
                                 if config.calibrator is not None else 0)
        self._installed_schedules: Dict[str, TunedSchedule] = {}

    # ---- graph registry --------------------------------------------------

    def register_graph(self, name: str, a: CSR,
                       partition: Optional[Partition] = None) -> None:
        """Make a graph servable. CSRs are immutable once registered.

        `partition` installs a connectivity-clustered owner map for this
        graph's bricks; without one, `EngineConfig.partition_shards > 0`
        on a sharded cache clusters the graph here. A partitioned graph
        prepares its forward plan at once, so the owner map is on the
        cache before any `warm_start` routes bricks to their owners.
        """
        if name in self._graphs:
            raise ValueError(f"graph {name!r} already registered")
        a.validate()
        cfg = self.config
        if partition is None:
            partition = self._auto_partition(a)
        self._graphs[name] = a
        eng = AiresSpGEMM(
            AiresConfig(
                device_budget_bytes=cfg.device_budget_bytes,
                bm=cfg.bm, bk=cfg.bk, align=cfg.align,
                stream_depth=cfg.stream_depth,
                straggler_deadline_s=cfg.straggler_deadline_s,
                device=str(self.device),
                plan_features=cfg.max_batch_features,
                ell_buckets=(list(cfg.ell_buckets)
                             if cfg.ell_buckets else None),
            ),
            segment_cache=self.cache,
            plan_passes=self.plan_pipeline,
            analyze=cfg.analyze_plans,
            partition=partition)
        self._engines[name] = eng
        if partition is not None and self.cache is not None:
            eng._prepare(a, (a.n_rows, cfg.max_batch_features),
                         transpose=False)

    def _auto_partition(self, a: CSR) -> Optional[Partition]:
        """Cluster `a` per `EngineConfig.partition_shards`; None when the
        knob is off or the cache is not sharded (CRC owners are then
        already right)."""
        k = int(self.config.partition_shards or 0)
        n_shards = int(getattr(self.cache, "n_shards", 1) or 1)
        if k <= 0 or n_shards <= 1:
            return None
        return partition_graph(
            a, k, n_shards=n_shards,
            topology=self.config.ici_topology,
            local_shard=int(getattr(self.cache, "local_shard", 0)))

    def evict_graph(self, name: str) -> List[InferenceRequest]:
        """Drop a graph, its engine (with the prepared plans' pinned host
        bricks), its cached segments in every namespace, this worker's
        directory holdings under it, and any queued requests against it —
        which are returned so the caller can re-route them."""
        a = self._graphs.pop(name, None)
        self._engines.pop(name, None)
        self._installed_schedules.pop(name, None)
        self._pass_costs = {k: v for k, v in self._pass_costs.items()
                            if k[0] != name}
        if a is not None:
            prefix = AiresSpGEMM.graph_cache_prefix(a)
            if self.cache is not None:
                self.cache.invalidate_prefix(prefix)
            if self.directory is not None:
                # Peers must not be routed a peer-promote for entries this
                # worker no longer backs.
                self.directory.drop_prefix(prefix,
                                           worker_id=self.config.worker_id)
        orphaned = [r for r in self._queue if r.graph == name]
        self._queue = [r for r in self._queue if r.graph != name]
        return orphaned

    def update_graph(self, name: str, inserts=None,
                     deletes=None) -> GraphUpdateReport:
        """Apply an edge delta to a registered graph instead of evicting and
        registering it again: prepared plans migrate incrementally
        (`AiresSpGEMM.apply_edge_update` re-tiles only touched row blocks),
        and exactly the stale segment keys are invalidated, in every tier
        and shard and in the `CacheDirectory`. Untouched bricks stay
        resident, so the next epoch uploads only what the delta touched.
        Queued requests resolve the graph by name at serve time and see
        the update."""
        a = self._graphs.get(name)
        if a is None:
            raise KeyError(f"graph {name!r} not registered")
        t0 = time.perf_counter()
        new, delta = apply_edge_updates(a, inserts=inserts, deletes=deletes)
        stats = self._engines[name].apply_edge_update(a, new, delta)
        self._graphs[name] = new
        dropped = 0
        if stats.stale_keys:
            if self.cache is not None:
                dropped = self.cache.invalidate_keys(stats.stale_keys)
            if self.directory is not None:
                for key in stats.stale_keys:
                    self.directory.drop(key)
        # Cost memos price segment count and nnz; both may have changed.
        self._pass_costs = {k: v for k, v in self._pass_costs.items()
                            if k[0] != name}
        return GraphUpdateReport(
            graph=name, delta=delta, plans_updated=stats.plans_updated,
            segments_retiled=stats.segments_retiled,
            segments_reused=stats.segments_reused,
            retiled_bytes=stats.retiled_bytes,
            stale_keys=len(stats.stale_keys),
            cache_entries_dropped=dropped,
            wall_seconds=time.perf_counter() - t0)

    @property
    def graphs(self) -> List[str]:
        return list(self._graphs)

    def cache_stats(self) -> Optional[CacheStats]:
        return self.cache.stats if self.cache is not None else None

    # ---- brick checkpointing + warm start --------------------------------
    #
    # Cache keys are content-addressed (`graph_cache_prefix` namespaces), so
    # the bricks one serving process checkpoints are the bricks the next
    # process's streams look up. The on-disk format is the reference's.

    def checkpoint_cache(self, directory: str, step: int = 0) -> str:
        """Persist the segment cache's bricks (both tiers) for warm_start.

        Only engine payloads — `(blocks, col_tile, n_tiles, ell)` — are
        checkpointed, and only from their host `BlockELL` (`ell`): nothing
        is read back from the card."""
        if self.cache is None:
            raise ValueError("cache_enabled=False: nothing to checkpoint")
        bricks = []
        for key, value, nbytes in self.cache.export_entries():
            if not (isinstance(value, tuple) and len(value) == 4
                    and isinstance(value[3], BlockELL)):
                continue
            ell = value[3]
            meta = {
                "graph_id": key.graph_id,
                "segment_id": key.segment_id,
                "wire_format": key.wire_format,
                "shape": list(key.shape),
                "fingerprint": key.fingerprint,
                "nbytes": int(nbytes),
                "bm": ell.bm, "bk": ell.bk,
                "n_rows": ell.n_rows, "n_cols": ell.n_cols,
            }
            bricks.append((meta, {"blocks": np.asarray(ell.blocks),
                                  "col_tile": np.asarray(ell.col_tile),
                                  "n_tiles": np.asarray(ell.n_tiles)}))
        return save_segment_bricks(directory, bricks, step=step)

    def warm_start(self, checkpoint_dir: str) -> WarmStartReport:
        """Pre-populate the segment cache from checkpointed bricks (written
        by either package).

        Every restored brick is charged through the engine's
        `TieredMemorySystem` — one storage→host read plus one host→device
        upload — so `tms.bytes_by_path()` stays honest from the first
        epoch. The bricks are pinned and uploaded without blocking; one
        synchronisation before returning keeps the uploads out of the first
        epoch's wall time."""
        if self.cache is None:
            raise ValueError("cache_enabled=False contradicts warm_start")
        report = WarmStartReport()
        pin = self.device.type == "cuda"
        for meta, arrays in load_segment_bricks(checkpoint_dir):
            ell = BlockELL(
                blocks=arrays["blocks"], col_tile=arrays["col_tile"],
                n_tiles=arrays["n_tiles"], bm=int(meta["bm"]),
                bk=int(meta["bk"]), n_rows=int(meta["n_rows"]),
                n_cols=int(meta["n_cols"]))
            key = SegmentKey(meta["graph_id"], meta["segment_id"],
                             meta["wire_format"], tuple(meta["shape"]),
                             fingerprint=meta.get("fingerprint", ""))
            nbytes = int(meta["nbytes"])
            report.modeled_seconds += self.tms.transfer(
                Path.STORAGE_HOST, MemoryTier.STORAGE, MemoryTier.HOST,
                nbytes, tag="warmstart/load")
            report.modeled_seconds += self.tms.transfer(
                Path.DMA, MemoryTier.HOST, MemoryTier.DEVICE,
                nbytes, tag="warmstart/promote")
            payload = upload_brick(host_tensors(ell, pin), ell, self.device)
            self.cache.put(key, payload, nbytes, tms=self.tms)
            report.bricks += 1
            report.wire_bytes += nbytes
        if pin:
            torch.cuda.synchronize(self.device)
        return report

    # ---- admission control -----------------------------------------------

    def cost_spec(self) -> TierSpec:
        """The `TierSpec` every cost estimate prices against: the configured
        spec without a calibrator; with one, `calibrator.calibrated(
        tier_spec)`. Whenever the calibrator's generation has moved since
        the memos were priced, the `_pass_costs` memo is dropped and every
        queued request an admission policy already priced is repriced."""
        cal = self.config.calibrator
        if cal is None:
            return self.config.tier_spec
        if cal.generation != self._cost_generation:
            # Mark current *first*: repricing below re-enters cost_spec()
            # through estimate_request_cost, which must not recurse.
            self._cost_generation = cal.generation
            self._pass_costs.clear()
            self._queue = [
                dataclasses.replace(
                    r, estimated_cost_s=self.estimate_request_cost(r))
                if r.estimated_cost_s > 0.0 else r
                for r in self._queue]
        return cal.calibrated(self.config.tier_spec)

    def _pass_cost(self, name: str, width: int,
                   spec: Optional[TierSpec] = None) -> float:
        """Modeled makespan of one streamed aggregation pass at `width`,
        via `PipelinePlan.estimate()` (cold-cache reading: admission must
        hold even if the cache is evicted underneath the queue). Memoized
        under the current `cost_spec()`: the plan is pinned per graph, so
        it varies only with the width (and the calibration generation,
        which clears the memo). An explicit `spec` bypasses the memo — how
        callers compare calibrated and uncalibrated pricing."""
        if spec is not None:
            a = self._graphs[name]
            plan = self._engines[name].stream_plan(
                a, (a.n_rows, int(width)), spec=spec)
            return plan.estimate(spec).makespan_s
        sp = self.cost_spec()   # first: a generation move clears the memo
        key = (name, int(width))
        if key not in self._pass_costs:
            a = self._graphs[name]
            plan = self._engines[name].stream_plan(
                a, (a.n_rows, int(width)), spec=sp)
            self._pass_costs[key] = plan.estimate(sp).makespan_s
        return self._pass_costs[key]

    def estimate_request_cost(self, request: InferenceRequest,
                              spec: Optional[TierSpec] = None) -> float:
        """Modeled seconds to serve `request`: one streamed pass per layer,
        each at that layer's activation width. `spec` pins the pricing
        spec (unmemoized); the default is the calibrated `cost_spec()`."""
        widths = [int(request.features.shape[1])]
        for w in list(request.weights)[:-1]:
            widths.append(int(w.shape[1]))
        return sum(self._pass_cost(request.graph, wd, spec=spec)
                   for wd in widths)

    def estimate_group_cost(self, name: str,
                            group: Sequence[InferenceRequest]) -> float:
        """Modeled seconds for one column-concat group of requests against
        `name`: mirrors `_batched_aggregate`'s greedy chunking exactly —
        per layer level, live request widths pack into passes capped at
        `max_batch_features`, each pass priced by the memoized
        `PipelinePlan.estimate()` cost at its concatenated width. This is
        the per-group cost the continuous loop's queue-position EDF
        accumulates into time-to-front."""
        cap = self.config.max_batch_features
        per_req: List[List[int]] = []
        for r in group:
            ws = list(r.weights)
            per_req.append([int(r.features.shape[1])]
                           + [int(w.shape[1]) for w in ws[:-1]])
        total = 0.0
        for layer in range(max((len(lv) for lv in per_req), default=0)):
            width = 0
            for lv in per_req:
                if layer >= len(lv):
                    continue
                f = lv[layer]
                if width and width + f > cap:
                    total += self._pass_cost(name, width)
                    width = 0
                width += f
            if width:
                total += self._pass_cost(name, width)
        return total

    def queued_cost_s(self) -> float:
        """Estimated cost of everything still awaiting service."""
        if self.config.calibrator is not None:
            self.cost_spec()  # reprice stale entries before summing
        return sum(r.estimated_cost_s for r in self._queue)

    def feed_latencies(self, latencies: Sequence[RequestLatency]) -> int:
        """Feed one batch's `RequestLatency` stream into the configured
        calibrator (no-op without one); `run_batch` calls this after every
        drain. Returns the number of samples folded in."""
        cal = self.config.calibrator
        if cal is None or not latencies:
            return 0
        return cal.observe_batch(latencies)

    # ---- autotuned schedules (core.autotune) -------------------------------

    def autotune(self, name: str, width: Optional[int] = None,
                 install: bool = False) -> TunedSchedule:
        """Search (coalescing min_bytes × pass order × ELL bucket set ×
        partition cluster count) for one registered graph, priced under the
        calibrated `cost_spec()`; optionally install the winner. Never
        predicted worse than the default, which is always a candidate."""
        if name not in self._graphs:
            raise KeyError(f"graph {name!r} not registered")
        tuned = autotune_schedule(
            self._engines[name], self._graphs[name], graph=name,
            width=int(width or self.config.max_batch_features),
            spec=self.cost_spec(), segment_cache=self.cache)
        if install:
            self.install_schedule(tuned)
        return tuned

    def install_schedule(self, tuned: TunedSchedule) -> None:
        """Install an autotuned schedule for `tuned.graph`: that graph's
        `AiresSpGEMM` gets its own `PassPipeline` in tuned order; a changed
        ELL bucket set or cluster count drops the graph's prepared plans
        (and their pinned bricks) and its cached bricks (the namespaces
        carry bucket and cluster tags, so the old entries are reclaimed,
        not shadowed); the graph's cost memos are invalidated."""
        name = tuned.graph
        if name not in self._graphs:
            raise KeyError(f"graph {name!r} not registered")
        eng = self._engines[name]
        eng.plan_passes = PassPipeline(
            tuned.build_passes(), spec=self.config.tier_spec,
            track_costs=False)
        changed = False
        new_buckets = (list(tuned.ell_buckets)
                       if tuned.ell_buckets is not None else None)
        if new_buckets != (eng.config.ell_buckets or None):
            eng.config = dataclasses.replace(eng.config,
                                             ell_buckets=new_buckets)
            changed = True
        # A changed cluster count re-partitions the graph with the
        # clustering the autotuner's trial arm priced.
        old_clusters = (eng.partition.n_clusters
                        if eng.partition is not None else None)
        if tuned.partition_clusters != old_clusters:
            if tuned.partition_clusters is None:
                eng.partition = None
            else:
                eng.partition = partition_graph(
                    self._graphs[name], int(tuned.partition_clusters),
                    n_shards=int(getattr(self.cache, "n_shards", 1) or 1),
                    topology=self.config.ici_topology,
                    local_shard=int(getattr(self.cache, "local_shard", 0)))
            changed = True
        if changed:
            eng.clear_cache()
            if self.cache is not None:
                self.cache.invalidate_prefix(
                    AiresSpGEMM.graph_cache_prefix(self._graphs[name]))
        self._pass_costs = {k: v for k, v in self._pass_costs.items()
                            if k[0] != name}
        self._installed_schedules[name] = tuned

    @property
    def installed_schedules(self) -> Dict[str, TunedSchedule]:
        return dict(self._installed_schedules)

    def _reject(self, request: InferenceRequest, reason: str,
                est: float) -> None:
        decision = RejectedRequest(
            graph=request.graph, reason=reason, estimated_cost_s=est,
            deadline_s=request.deadline_s, request_id=request.request_id)
        self._rejected.append(decision)
        raise AdmissionError(decision)

    # ---- request queue ---------------------------------------------------

    def submit(self, request: InferenceRequest) -> SubmitReceipt:
        """Queue a request; returns its id as a `SubmitReceipt` carrying the
        admission-control cost prediction."""
        if request.graph not in self._graphs:
            raise KeyError(f"graph {request.graph!r} not registered")
        n = self._graphs[request.graph].n_rows
        if request.features.shape[0] != n:
            raise ValueError(
                f"features rows {request.features.shape[0]} != graph nodes {n}")
        cap = self.config.max_queue_cost_s
        est = 0.0
        if request.deadline_s is not None or cap is not None:
            # Price only when an admission policy can act on it: the first
            # estimate per (graph, width) runs RoBW + densification.
            est = self.estimate_request_cost(request)
        if request.deadline_s is not None and est > request.deadline_s:
            self._reject(request, "deadline-infeasible", est)
        if cap is not None and self.queued_cost_s() + est > cap:
            self._reject(request, "queue-full", est)
        request = dataclasses.replace(
            request, request_id=self._next_id, estimated_cost_s=est,
            submitted_s=self.clock())
        self._next_id += 1
        self._queue.append(request)
        return SubmitReceipt(request.request_id, est)

    def infer(self, graph: str, features: np.ndarray,
              weights: Sequence[np.ndarray] = (),
              deadline_s: Optional[float] = None) -> np.ndarray:
        """Run one request now, without draining (or disturbing) other
        callers' queued requests or their pending admission verdicts."""
        pending, self._queue = self._queue, []
        foreign, self._rejected = self._rejected, []
        try:
            rid = self.submit(InferenceRequest(graph, features, weights,
                                               deadline_s=deadline_s))
            report = self.run_batch()
        finally:
            self._queue = pending + self._queue
            self._rejected = foreign + self._rejected
        for r in report.results:
            if r.request_id == rid:
                return r.output
        for verdict in report.expired:
            if verdict.request_id == rid:
                raise AdmissionError(verdict)
        raise RuntimeError(
            f"infer request {int(rid)} on graph {graph!r} produced no "
            f"result and no expiry verdict")

    # ---- batched execution -----------------------------------------------

    def prepare_queue(self, queue: List[InferenceRequest], now: float
                      ) -> Tuple[List[InferenceRequest],
                                 List[RejectedRequest]]:
        """Stamp, expire, price. Returns the serve-ready queue (new
        `InferenceRequest` copies; callers' objects are never mutated) and
        the expiry verdicts. A request that reached the queue without
        submit() is stamped `now`; unpriced requests get their estimate,
        and every request is repriced when the calibrator moved since the
        queue was priced (`queue` is detached from `self._queue`, so the
        sweep in `cost_spec()` cannot reach it)."""
        stale = False
        cal = self.config.calibrator
        if cal is not None and cal.generation != self._cost_generation:
            self.cost_spec()
            stale = True
        ready: List[InferenceRequest] = []
        expired: List[RejectedRequest] = []
        for r in queue:
            if r.submitted_s < 0.0:
                r = dataclasses.replace(r, submitted_s=now)
            if r.deadline_s is not None and now - r.submitted_s > r.deadline_s:
                expired.append(RejectedRequest(
                    graph=r.graph, reason="deadline-expired",
                    estimated_cost_s=r.estimated_cost_s,
                    deadline_s=r.deadline_s, request_id=r.request_id))
                continue
            if r.estimated_cost_s <= 0.0 or stale:
                r = dataclasses.replace(
                    r, estimated_cost_s=self.estimate_request_cost(r))
            ready.append(r)
        return ready, expired

    def order_queue(self, queue: List[InferenceRequest]
                    ) -> Tuple[List[InferenceRequest], List[str]]:
        """Deadline-aware ordering: an EDFOrderingPass in the configured
        pipeline reorders the queue (earliest deadline first, Moore–Hodgson
        tardy demotion over `estimated_cost_s`), and graph groups then run
        in first-appearance order of that queue. Without an ordering pass,
        registration order."""
        if (self.plan_pipeline is not None
                and self.plan_pipeline.orders_requests):
            queue = self.plan_pipeline.order_requests(queue)
            return queue, list(dict.fromkeys(r.graph for r in queue))
        return queue, list(self._graphs)

    def run_batch(self) -> BatchReport:
        """Drain the queue: group by graph, batch aggregations per layer."""
        queue, self._queue = self._queue, []
        results: List[InferenceResult] = []
        t0 = time.perf_counter()
        unknown = sorted({r.graph for r in queue} - set(self._graphs))
        if unknown:
            self._queue = queue + self._queue  # nothing consumed
            raise KeyError(
                f"queued requests reference unregistered graphs {unknown}")
        queue, expired = self.prepare_queue(queue, self.clock())
        queue, graph_order = self.order_queue(queue)
        totals = GroupStats()
        latency: List[RequestLatency] = []
        # Duplicate-avoided demotions happen inside put() and evictions,
        # outside any stream's stats window: diff the cache's counter.
        dup0 = (self.cache.stats.duplicate_avoided_bytes
                if self.cache is not None else 0)
        for name in graph_order:
            group = [r for r in queue if r.graph == name]
            if not group:
                continue
            group_results, done_s, stats = self.serve_group(name, group, t0)
            results.extend(group_results)
            latency.extend(
                RequestLatency(r.request_id, name, r.estimated_cost_s,
                               *done_s[r.request_id])
                for r in group)
            totals.merge(stats)
        results.sort(key=lambda r: r.request_id)
        latency.sort(key=lambda lat: lat.request_id)
        self.feed_latencies(latency)
        dup = ((self.cache.stats.duplicate_avoided_bytes - dup0)
               if self.cache is not None else 0)
        rejected, self._rejected = self._rejected, []
        return BatchReport(
            results=results, uploaded_bytes=totals.uploaded_bytes,
            cache_hit_bytes=totals.cache_hit_bytes,
            promoted_bytes=totals.promoted_bytes,
            segments_streamed=totals.segments_streamed,
            aggregation_passes=totals.aggregation_passes,
            wall_seconds=time.perf_counter() - t0,
            ici_bytes=totals.ici_bytes,
            directory_hit_bytes=totals.directory_hit_bytes,
            duplicate_avoided_bytes=dup,
            rejected=rejected, expired=expired, request_latency=latency)

    def serve_group(self, name: str, group: List[InferenceRequest],
                    t0: float) -> tuple:
        """Serve one graph's requests through column-concat streamed
        passes; returns (results, completion stamps keyed by request id —
        `(since_batch_t0, since_group_start)` wall seconds, taken when each
        output reaches the host — and the group's `GroupStats`)."""
        a = self._graphs[name]
        eng = self._engines[name]
        mark = len(eng.forward_stats_log)
        g0 = time.perf_counter()
        dev = self.device
        # Activations and weights live on the device for the whole chain.
        acts = [torch.as_tensor(np.asarray(r.features, dtype=np.float32)
                                ).to(dev) for r in group]
        wss = [[torch.as_tensor(np.asarray(w, dtype=np.float32)).to(dev)
                for w in r.weights] for r in group]
        n_aggs = [max(len(ws), 1) for ws in wss]
        outputs: Dict[int, np.ndarray] = {}
        done_s: Dict[int, tuple] = {}
        for layer in range(max(n_aggs)):
            live = [i for i in range(len(group)) if layer < n_aggs[i]]
            aggregated = self._batched_aggregate(
                eng, a, [acts[i] for i in live])
            for i, x in zip(live, aggregated):
                ws = wss[i]
                if layer < len(ws):
                    h = x @ ws[layer]
                    if layer < len(ws) - 1:
                        h = torch.relu(h)         # relu between layers
                else:                             # bare aggregation request
                    h = x
                acts[i] = h
                if layer == n_aggs[i] - 1:
                    outputs[i] = h.cpu().numpy()
                    now = time.perf_counter()
                    done_s[group[i].request_id] = (now - t0, now - g0)
        results = [InferenceResult(group[i].request_id, name, outputs[i])
                   for i in range(len(group))]
        stats = GroupStats()
        for s in eng.forward_stats_log[mark:]:
            stats.accumulate(s)
        return results, done_s, stats

    def _batched_aggregate(self, eng: AiresSpGEMM, a: CSR,
                           hs: List[torch.Tensor]) -> List[torch.Tensor]:
        """A @ each h, merging requests into column-concat streamed passes.

        Greedy chunking: pack requests into passes while the concatenated
        width stays within max_batch_features; a single over-wide request
        streams alone (AiresSpGEMM re-plans conservatively for it).
        """
        cap = self.config.max_batch_features
        out: List[Optional[torch.Tensor]] = [None] * len(hs)
        chunk: List[int] = []
        width = 0
        for i, h in enumerate(hs):
            f = int(h.shape[1])
            if chunk and width + f > cap:
                self._aggregate_chunk(eng, a, hs, chunk, out)
                chunk, width = [], 0
            chunk.append(i)
            width += f
        if chunk:
            self._aggregate_chunk(eng, a, hs, chunk, out)
        return out

    @staticmethod
    def _aggregate_chunk(eng, a, hs, chunk, out) -> None:
        if len(chunk) == 1:
            out[chunk[0]] = eng(a, hs[chunk[0]])
            return
        x_cat = eng(a, torch.cat([hs[i] for i in chunk], dim=1))
        col = 0
        for i in chunk:
            f = int(hs[i].shape[1])
            out[i] = x_cat[:, col:col + f]
            col += f
