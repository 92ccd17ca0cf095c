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

The serving subset of `repro.runtime.engine`; its byte accounting and cost
predictions are the reference's, which the tests hold them to.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.passes import PassPipeline, PlanPass
from repro_torch.core.spgemm import AiresConfig, AiresSpGEMM, resolve_device
from repro_torch.io.segment_cache import CacheStats, TieredSegmentCache
from repro_torch.io.tiers import TieredMemorySystem, TierSpec, TPU_V5E_SYSTEM
from repro_torch.sparse.formats import CSR


@dataclasses.dataclass
class EngineConfig:
    """Knobs for the serving engine."""

    device_budget_bytes: int
    cache_enabled: bool = True
    # Segment-cache tiers: device defaults to the streaming budget, host
    # None = unbounded spill.
    cache_device_bytes: Optional[int] = None
    cache_host_bytes: Optional[int] = None
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
class GroupStats:
    """I/O story of one served column-concat group."""

    uploaded_bytes: int = 0
    cache_hit_bytes: int = 0
    promoted_bytes: int = 0
    segments_streamed: int = 0
    aggregation_passes: int = 0

    def accumulate(self, stats) -> None:
        """Fold one stream's `StreamStats` into the group totals."""
        self.uploaded_bytes += stats.uploaded_bytes
        self.cache_hit_bytes += stats.cache_hit_bytes
        self.promoted_bytes += stats.promoted_bytes
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
    """

    def __init__(self, config: EngineConfig):
        self.config = config
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
        self.cache: Optional[TieredSegmentCache] = None
        if config.cache_enabled:
            self.cache = TieredSegmentCache(
                device_budget_bytes=(config.cache_device_bytes
                                     or config.device_budget_bytes),
                host_budget_bytes=config.cache_host_bytes, tms=self.tms,
                device=self.device)
        self._graphs: "OrderedDict[str, CSR]" = OrderedDict()
        self._engines: Dict[str, AiresSpGEMM] = {}
        self._queue: List[InferenceRequest] = []
        self._next_id = 0
        # Memoized per-(graph, width) pass cost estimates, and the verdicts
        # awaiting their BatchReport.
        self._pass_costs: Dict[tuple, float] = {}
        self._rejected: List[RejectedRequest] = []

    # ---- graph registry --------------------------------------------------

    def register_graph(self, name: str, a: CSR) -> None:
        """Make a graph servable. CSRs are immutable once registered."""
        if name in self._graphs:
            raise ValueError(f"graph {name!r} already registered")
        a.validate()
        cfg = self.config
        self._graphs[name] = a
        self._engines[name] = AiresSpGEMM(
            AiresConfig(
                device_budget_bytes=cfg.device_budget_bytes,
                bm=cfg.bm, bk=cfg.bk, align=cfg.align,
                stream_depth=cfg.stream_depth,
                straggler_deadline_s=cfg.straggler_deadline_s,
                device=str(self.device),
                plan_features=cfg.max_batch_features,
            ),
            segment_cache=self.cache,
            plan_passes=self.plan_pipeline,
            analyze=cfg.analyze_plans)

    @property
    def graphs(self) -> List[str]:
        return list(self._graphs)

    def cache_stats(self) -> Optional[CacheStats]:
        return self.cache.stats if self.cache is not None else None

    # ---- admission control -----------------------------------------------

    def cost_spec(self) -> TierSpec:
        """The `TierSpec` every cost estimate prices against."""
        return self.config.tier_spec

    def _pass_cost(self, name: str, width: int) -> float:
        """Modeled makespan of one streamed aggregation pass at `width`,
        via `PipelinePlan.estimate()` (cold-cache reading: admission must
        hold even if the cache is evicted underneath the queue). Memoized:
        the plan is pinned per graph, so it varies only with the width."""
        key = (name, int(width))
        if key not in self._pass_costs:
            a = self._graphs[name]
            spec = self.cost_spec()
            plan = self._engines[name].stream_plan(
                a, (a.n_rows, int(width)), spec=spec)
            self._pass_costs[key] = plan.estimate(spec).makespan_s
        return self._pass_costs[key]

    def estimate_request_cost(self, request: InferenceRequest) -> float:
        """Modeled seconds to serve `request`: one streamed pass per layer,
        each at that layer's activation width."""
        widths = [int(request.features.shape[1])]
        for w in list(request.weights)[:-1]:
            widths.append(int(w.shape[1]))
        return sum(self._pass_cost(request.graph, wd) for wd in widths)

    def queued_cost_s(self) -> float:
        """Estimated cost of everything still awaiting service."""
        return sum(r.estimated_cost_s for r in self._queue)

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
        submit() is stamped `now`; unpriced requests get their estimate."""
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
            if r.estimated_cost_s <= 0.0:
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
        rejected, self._rejected = self._rejected, []
        return BatchReport(
            results=results, uploaded_bytes=totals.uploaded_bytes,
            cache_hit_bytes=totals.cache_hit_bytes,
            promoted_bytes=totals.promoted_bytes,
            segments_streamed=totals.segments_streamed,
            aggregation_passes=totals.aggregation_passes,
            wall_seconds=time.perf_counter() - t0,
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
