"""Pipeline-plan IR — one typed op-graph for every scheduler.

Plan builders (the schedulers of `core.scheduler`, `AiresSpGEMM`) emit a
:class:`PipelinePlan`: a typed list of ops (:class:`TransferOp`,
:class:`ComputeOp`, :class:`CacheProbeOp`, :class:`HostPreprocessOp`,
:class:`AllocOp`) grouped into phases, each op on a declared resource lane
(DMA channel, GDS path, host CPU, compute unit) with explicit dependencies.
Two interpreters consume the same plan:

  * :class:`CostInterpreter` charges every transfer through a
    `TieredMemorySystem` and computes the overlap-aware makespan from
    per-lane availability — this *is* simulate mode;
  * :class:`ExecuteInterpreter` additionally runs the plan's kernel thunks
    into an output buffer on the plan's device (scheduler execute mode)
    and, for the engine path, drives a `DoubleBufferedStreamer` over the
    plan's stream ops (:meth:`ExecuteInterpreter.stream`).

Simulate-vs-execute agreement is therefore true by construction: one plan,
two interpreters. `PipelinePlan.estimate()` is a side-effect-free cost
reading (cache probes peek, never mutate) that the serving engine uses for
admission control.

Makespan semantics per phase (`PhaseSpec.overlap`):

  * ``"lanes"`` — ops on the same lane serialize on that lane's
    availability; an op additionally waits for its `deps`. The phase span
    is the latest completion. This reproduces the paper's Fig. 5 overlap:
    Phase I's GDS load rides its own lane against the A-load + RoBW chain,
    and Phase II's double buffering falls out of DMA-lane serialization
    plus compute→transfer dependencies.
  * ``"serial"`` — no overlap: the span is (transfer seconds) + (host
    seconds) + (compute seconds), the accounting the MaxMemory/UCG
    baselines use.

The plan-level makespan is the sum of phase spans, in declared phase order.
The modeled numbers follow `repro.core.pipeline` operation for operation,
which the tests hold them to.
"""
from __future__ import annotations

import dataclasses
from typing import (
    Any, Callable, Dict, List, Literal, Optional, Sequence, Tuple, Union,
)

import torch

from repro_torch.io.tiers import (
    MemoryTier,
    OutOfMemory,
    Path,
    TieredMemorySystem,
    TierSpec,
)

# Resource lanes. Lanes are per-phase serial resources: two ops on the same
# lane of the same phase never overlap; ops on different lanes do (unless
# tied by deps). Names match the transfer paths they model where relevant.
LANE_DMA = "dma"
LANE_GDS = "gds"
LANE_SIO = "sio"
LANE_UM = "um"
LANE_HOST = "host"
LANE_COMPUTE = "compute"


@dataclasses.dataclass
class ScheduleMetrics:
    """Everything the paper's figures read off a run.

    Produced by the interpreters; also exported by `core.scheduler`.
    """

    scheduler: str
    dataset: str = ""
    # Latency components (seconds)
    host_preprocess_s: float = 0.0   # modeled: RoBW / densify / merge / pack
    host_measured_s: float = 0.0     # wall-clock of the real host work (diagnostic)
    io_modeled_s: float = 0.0        # modeled: sum of transfer seconds
    compute_modeled_s: float = 0.0   # modeled: device kernel seconds
    makespan_s: float = 0.0          # overlapped end-to-end estimate
    # I/O accounting (Fig. 7/8)
    bytes_by_path: Dict[str, int] = dataclasses.field(default_factory=dict)
    seconds_by_path: Dict[str, float] = dataclasses.field(default_factory=dict)
    total_transfer_bytes: int = 0
    cache_hit_bytes: int = 0         # wire bytes served by the segment cache
    merge_events: int = 0
    merge_io_s: float = 0.0          # modeled DtoH/HtoD seconds for merges
    segments: int = 0
    oom: bool = False

    def merge_overhead_frac(self) -> float:
        """Fig. 3 metric: 'merging the partial segments, and data transfer
        time between the GPU and host memory ... measured over the
        computation latency'."""
        denom = max(self.compute_modeled_s, 1e-12)
        return (self.host_preprocess_s + self.merge_io_s) / denom


def modeled_spgemm_seconds(nnz: int, feat, spec: TierSpec,
                           compute_efficiency: float = 0.20) -> float:
    """Device time for a compressed-×-compressed partial product.

    Hypersparse SpGEMM is memory-bound, not FLOP-bound: per A-nonzero the
    kernel reads the A entry, gathers the matching B row segment
    (dens_B·F values+ids) and writes ~E[matches] C entries. Effective
    bandwidth is a fraction of peak (irregular access). Shared by the
    scheduler plan builders and `AiresSpGEMM.stream_plan` so cost
    estimates agree wherever a plan is built.
    """
    dens_b = (100.0 - feat.sparsity_pct) / 100.0
    val = feat.dtype_bytes
    idx = feat.index_bytes
    per_nnz = (val + idx) + dens_b * feat.n_cols * (val + idx) \
        + max(dens_b * feat.n_cols, 1.0) * (val + idx)
    bytes_touched = nnz * per_nnz
    return bytes_touched / (spec.hbm_bw * compute_efficiency)


# ---- ops -------------------------------------------------------------------


@dataclasses.dataclass
class AllocOp:
    """Reserve `nbytes` of `tier` under `name` (raises OutOfMemory at
    interpret time if the tier's capacity is exceeded — Table III '-')."""

    tier: MemoryTier
    name: str
    nbytes: int


@dataclasses.dataclass
class TransferOp:
    """One modeled transfer over `path`. `merge` marks partial-row merge
    traffic (feeds `ScheduleMetrics.merge_io_s`, the Fig. 3 numerator).
    `payload` optionally carries the real host payload `(index, data)` for
    the execute interpreter's streaming backend."""

    path: Path
    src: MemoryTier
    dst: MemoryTier
    nbytes: int
    tag: str = ""
    merge: bool = False
    payload: Any = None


@dataclasses.dataclass
class ComputeOp:
    """One device-kernel slot: `seconds` of modeled time, optionally a
    real `kernel(out)` thunk the execute interpreter runs (writes its
    row-slice of the plan's output buffer, a tensor on the plan's
    device)."""

    seconds: float
    flops: float = 0.0
    kernel: Optional[Callable[[torch.Tensor], None]] = None


@dataclasses.dataclass
class CacheProbeOp:
    """Probe the segment cache for `key`; on miss, perform the fallback
    `miss` transfer and retain `value` under the key. A device-tier hit is
    free wire traffic; a host-tier hit costs the promotion DMA (charged by
    the cache itself). `payload` as on TransferOp.

    `place_shard` is a placement override written by the shard-placement
    rewrite pass (`core.passes.ShardPlacementPass`): the miss's
    retain lands on that cache shard instead of the key's CRC owner, so a
    graph's hot bricks live where they are consumed. None = default owner.
    """

    key: Any                 # io.segment_cache.SegmentKey
    wire_bytes: int
    miss: TransferOp
    value: Any = True
    pin: Any = None
    payload: Any = None
    place_shard: Optional[int] = None


@dataclasses.dataclass
class HostPreprocessOp:
    """Host CPU work (RoBW pass, staging memcpy, partial-row merge):
    `modeled_s` enters the makespan, `measured_s` is the wall-clock of the
    real work the plan builder performed (diagnostic only)."""

    modeled_s: float
    measured_s: float = 0.0


OpKind = Union[AllocOp, TransferOp, ComputeOp, CacheProbeOp, HostPreprocessOp]


class PlanValidationError(ValueError):
    """A structurally malformed `PipelinePlan`: dangling, self-, forward or
    cyclic dependencies, or ops in undeclared phases. Raised by
    `PipelinePlan.validate()` — and by the interpreters before running —
    instead of letting a bad dep silently read a completion time of 0.0
    and mis-order the lane-availability makespan."""


@dataclasses.dataclass
class PlanOp:
    """An op bound into the plan: its phase, its resource lane, and the
    indices of ops it must wait for (beyond lane availability)."""

    op: OpKind
    phase: str
    lane: str = ""
    deps: Tuple[int, ...] = ()


@dataclasses.dataclass
class PhaseSpec:
    name: str
    overlap: Literal["lanes", "serial"] = "lanes"


@dataclasses.dataclass
class PipelinePlan:
    """A scheduler's entire I/O + compute schedule as data.

    Built once by a plan builder; consumed by either interpreter. `oom`
    marks a plan the builder already knows is infeasible (Eq. 7 p ≤ 0,
    static split cannot fit B, ...): interpreters return an OOM result
    without touching the op list.
    """

    scheduler: str
    dataset: str = ""
    phases: List[PhaseSpec] = dataclasses.field(default_factory=list)
    ops: List[PlanOp] = dataclasses.field(default_factory=list)
    segments: int = 0
    merge_events: int = 0
    oom: bool = False
    mem: Any = None                  # MemoryEstimate (Eq. 5-7), when planned
    robw: Any = None                 # RoBWPlan, when RoBW-partitioned
    out_shape: Optional[Tuple[int, int]] = None   # execute: output buffer
    out_dtype: Any = torch.float32
    device: Any = "cpu"              # execute: where the output buffer lives
    # Baselines execute a single reference kernel instead of per-segment
    # thunks (their correctness path is not the streamed pipeline).
    reference_kernel: Optional[Callable[[], torch.Tensor]] = None

    def add(self, op: OpKind, phase: str, lane: str = "",
            deps: Sequence[int] = ()) -> int:
        """Append an op; returns its index (for later `deps`)."""
        self.ops.append(PlanOp(op, phase, lane, tuple(deps)))
        return len(self.ops) - 1

    def validate(self) -> "PipelinePlan":
        """Structural validation; returns self, raises PlanValidationError.

        The interpreters evaluate ops in list order, reading each dep's
        completion time from earlier iterations — so list order must be a
        topological order of the dep graph. A dangling index, a self-dep,
        or a forward reference (which every dependency cycle necessarily
        contains) would read a completion time of 0.0 and silently
        mis-order the lane-availability makespan. `PassPipeline`
        revalidates after every rewrite pass; builder plans are checked on
        interpretation.
        """
        names = [ph.name for ph in self.phases]
        if len(set(names)) != len(names):
            raise PlanValidationError(
                f"duplicate phase declarations: {names}")
        declared = set(names)
        if self.ops and not declared:
            # An op-bearing plan with no declared phases used to slip
            # through (the per-op check was guarded on `declared` being
            # non-empty) — and then every op landed in an undeclared
            # phase whose span never entered the makespan.
            raise PlanValidationError(
                f"plan {self.scheduler!r} carries {len(self.ops)} ops but "
                "declares no phases: every op would sit in an undeclared "
                "phase and its span would never enter the makespan")
        n = len(self.ops)
        for idx, bound in enumerate(self.ops):
            if bound.phase not in declared:
                raise PlanValidationError(
                    f"op {idx} ({type(bound.op).__name__}) sits in "
                    f"undeclared phase {bound.phase!r} "
                    f"(declared: {sorted(declared)})")
            for d in bound.deps:
                d = int(d)
                if not 0 <= d < n:
                    raise PlanValidationError(
                        f"op {idx} ({type(bound.op).__name__}) has a "
                        f"dangling dependency on op {d} "
                        f"(plan has {n} ops)")
                if d == idx:
                    raise PlanValidationError(
                        f"op {idx} ({type(bound.op).__name__}) depends on "
                        "itself (dependency cycle)")
                if d > idx:
                    raise PlanValidationError(
                        f"op {idx} ({type(bound.op).__name__}) depends on "
                        f"later op {d}: list order must be a topological "
                        "order (forward references — including every "
                        "dependency cycle — would silently mis-order the "
                        "makespan)")
        return self

    def phase_ops(self, phase: str) -> List[OpKind]:
        return [p.op for p in self.ops if p.phase == phase]

    def stream_payloads(self) -> List[Any]:
        """The real host payloads of the plan's stream ops, in order."""
        return [p.op.payload for p in self.ops
                if isinstance(p.op, (TransferOp, CacheProbeOp))
                and p.op.payload is not None]

    def wire_bytes(self) -> int:
        """Total Phase II wire bytes (the cache-relevant traffic)."""
        total = 0
        for p in self.ops:
            if isinstance(p.op, CacheProbeOp):
                total += p.op.wire_bytes
            elif isinstance(p.op, TransferOp) and p.op.payload is not None:
                total += p.op.nbytes
        return total

    def release_payloads(self) -> None:
        """Drop the heavy references interpretation needed: brick payloads,
        cache-probe values, kernel thunks (which close over bricks and the
        feature matrix), and the baseline reference kernel.

        Called by the schedulers after `run()` so a retained
        `ScheduleResult.pipeline` costs op metadata, not the densified
        working set — this is an out-of-core library; results must not pin
        every graph's bricks. The plan stays fully cost-interpretable.
        """
        for bound in self.ops:
            op = bound.op
            if isinstance(op, TransferOp):
                op.payload = None
            elif isinstance(op, CacheProbeOp):
                op.payload = None
                op.value = True
                op.pin = None       # pin=a would keep the whole CSR alive
                op.miss.payload = None
            elif isinstance(op, ComputeOp):
                op.kernel = None
        self.reference_kernel = None

    def estimate(self, spec: TierSpec,
                 segment_cache: Any = None) -> ScheduleMetrics:
        """Side-effect-free cost reading of this plan.

        Cache probes *peek* (`tier_of`) instead of get/put, so estimating a
        request never promotes, demotes, or inserts — the serving engine
        calls this on live shared caches for admission control.
        """
        interp = CostInterpreter(spec, segment_cache=segment_cache,
                                 peek_only=True, analyze=False)
        metrics, _ = interp.run(self)
        return metrics


# ---- interpreters ----------------------------------------------------------


class CostInterpreter:
    """Charge a plan through a `TieredMemorySystem`; derive the makespan
    from lane availability. This is simulate mode for every scheduler."""

    execute = False

    def __init__(self, spec: TierSpec, segment_cache: Any = None,
                 peek_only: bool = False, analyze: Optional[bool] = None):
        self.spec = spec
        self.segment_cache = segment_cache
        self.peek_only = peek_only
        # Static analysis before interpreting (core.analysis): None defers
        # to the module default, off unless `set_default_analyze(True)`.
        # `estimate()` always passes False: admission control prices plans
        # constantly and analysis there would only re-check an
        # already-checked plan.
        self.analyze = analyze

    def _analyze_enabled(self) -> bool:
        if self.analyze is not None:
            return self.analyze
        from repro_torch.core.analysis import default_analyze
        return default_analyze()

    def _analyze(self, plan: "PipelinePlan") -> None:
        from repro_torch.core.analysis import analyze_plan
        analyze_plan(plan, spec=self.spec,
                     segment_cache=self.segment_cache).raise_for_errors()

    def run(self, plan: PipelinePlan,
            tms: Optional[TieredMemorySystem] = None
            ) -> Tuple[ScheduleMetrics, Optional[torch.Tensor]]:
        """Interpret `plan`; returns (metrics, output-or-None)."""
        tms = tms if tms is not None else TieredMemorySystem(self.spec)
        m = ScheduleMetrics(scheduler=plan.scheduler, dataset=plan.dataset)
        if plan.oom:
            m.oom = True
            return m, None
        plan.validate()
        if self._analyze_enabled():
            self._analyze(plan)
        out = (torch.zeros(plan.out_shape, dtype=plan.out_dtype,
                           device=plan.device)
               if self.execute and plan.out_shape is not None else None)

        overlap = {ph.name: ph.overlap for ph in plan.phases}
        completion = [0.0] * len(plan.ops)
        lane_free: Dict[Tuple[str, str], float] = {}
        lane_span: Dict[str, float] = {}
        serial_io: Dict[str, float] = {}
        serial_host: Dict[str, float] = {}
        serial_cmp: Dict[str, float] = {}

        for idx, bound in enumerate(plan.ops):
            op = bound.op
            secs = 0.0
            kind = ""
            if isinstance(op, AllocOp):
                try:
                    tms.alloc(op.tier, op.name, op.nbytes)
                except OutOfMemory:
                    m.oom = True
                    return m, None
            elif isinstance(op, TransferOp):
                secs = tms.transfer(op.path, op.src, op.dst, op.nbytes,
                                    tag=op.tag)
                if op.merge:
                    m.merge_io_s += secs
                kind = "io"
            elif isinstance(op, CacheProbeOp):
                secs = self._probe(op, tms, m)
                kind = "io"
            elif isinstance(op, HostPreprocessOp):
                m.host_preprocess_s += op.modeled_s
                m.host_measured_s += op.measured_s
                secs = op.modeled_s
                kind = "host"
            elif isinstance(op, ComputeOp):
                secs = op.seconds
                m.compute_modeled_s += secs
                kind = "compute"
                if self.execute and op.kernel is not None and out is not None:
                    op.kernel(out)
            else:  # pragma: no cover - new op kinds must be handled here
                raise TypeError(f"unknown plan op {type(op).__name__}")

            if overlap.get(bound.phase, "lanes") == "serial":
                if kind == "io":
                    serial_io[bound.phase] = \
                        serial_io.get(bound.phase, 0.0) + secs
                elif kind == "host":
                    serial_host[bound.phase] = \
                        serial_host.get(bound.phase, 0.0) + secs
                elif kind == "compute":
                    serial_cmp[bound.phase] = \
                        serial_cmp.get(bound.phase, 0.0) + secs
            else:
                start = lane_free.get((bound.phase, bound.lane), 0.0)
                for d in bound.deps:
                    start = max(start, completion[d])
                completion[idx] = start + secs
                if bound.lane:
                    lane_free[(bound.phase, bound.lane)] = completion[idx]
                lane_span[bound.phase] = max(
                    lane_span.get(bound.phase, 0.0), completion[idx])

        makespan = 0.0
        for ph in plan.phases:
            if ph.overlap == "serial":
                span = (serial_io.get(ph.name, 0.0)
                        + serial_host.get(ph.name, 0.0)
                        + serial_cmp.get(ph.name, 0.0))
            else:
                span = lane_span.get(ph.name, 0.0)
            makespan = makespan + span

        if self.execute and plan.reference_kernel is not None:
            out = plan.reference_kernel()

        m.io_modeled_s = sum(t.seconds for t in tms.transfers)
        m.makespan_s = makespan
        m.bytes_by_path = {p.value: b for p, b in tms.bytes_by_path().items()}
        m.seconds_by_path = {p.value: s
                             for p, s in tms.seconds_by_path().items()}
        m.total_transfer_bytes = tms.total_bytes()
        m.segments = plan.segments
        m.merge_events = plan.merge_events
        return m, out

    # -- cache probe ---------------------------------------------------------

    def _probe(self, op: CacheProbeOp, tms: TieredMemorySystem,
               m: ScheduleMetrics) -> float:
        cache = self.segment_cache
        if cache is None:
            t = op.miss
            return tms.transfer(t.path, t.src, t.dst, t.nbytes, tag=t.tag)
        if self.peek_only:
            return self._peek(op, cache, tms, m)
        hit, promote_s = cache.get_with_cost(op.key, nbytes=op.wire_bytes,
                                             tms=tms)
        if hit is not None:
            m.cache_hit_bytes += op.wire_bytes
            # Device-tier hit: free. Host-tier hit: the promotion DMA
            # (already charged into tms by the cache) is this segment's
            # pipeline I/O slot.
            return promote_s
        t = op.miss
        secs = tms.transfer(t.path, t.src, t.dst, t.nbytes, tag=t.tag)
        cache.put(op.key, op.value, op.wire_bytes, tms=tms, pin=op.pin,
                  shard=op.place_shard)
        return secs

    @staticmethod
    def _peek(op: CacheProbeOp, cache: Any, tms: TieredMemorySystem,
              m: ScheduleMetrics) -> float:
        """Estimate-mode probe: the cache prices its own would-be hit
        (`peek_cost` — tier promotion, remote-shard ICI, directory
        peer-promote — the pricing lives next to `get_with_cost`, so the
        two readings cannot drift); a would-be miss adds the fallback
        wire transfer. Nothing is mutated."""
        hit, cost = cache.peek_cost(op.key, nbytes=op.wire_bytes, tms=tms,
                                    shard=op.place_shard)
        if hit:
            m.cache_hit_bytes += op.wire_bytes
            return cost
        t = op.miss
        return cost + tms.transfer(t.path, t.src, t.dst, t.nbytes, tag=t.tag)


class ExecuteInterpreter(CostInterpreter):
    """Cost interpretation + real execution.

    For scheduler plans, `run()` additionally invokes kernel thunks
    (AIRES's per-segment Block-ELL SpMM into the plan's output buffer, or a
    baseline's single reference product) — the metrics side is identical to
    `CostInterpreter` by inheritance, which is the whole point.

    For the engine path, :meth:`stream` drives the plan's stream ops
    through a `DoubleBufferedStreamer`: uploads on a copy stream overlap
    the kernels on the compute stream, cache probes become the streamer's
    lookup/store hooks, and the plan's wire-byte declarations feed
    `StreamStats` — one plan, the same keys and byte counts the cost
    interpreter models.
    """

    execute = True

    def __init__(self, spec: Optional[TierSpec] = None,
                 segment_cache: Any = None, peek_only: bool = False,
                 analyze: Optional[bool] = None):
        # `spec` is only needed by run(); stream() is pure execution.
        super().__init__(spec, segment_cache=segment_cache,
                         peek_only=peek_only, analyze=analyze)

    def stream(self, plan: PipelinePlan,
               upload: Callable[[Any], Any],
               consume: Callable[[Any, int], Any],
               depth: int = 2,
               deadline_s: Optional[float] = None,
               max_reissue: int = 1,
               device: Any = "cuda") -> Tuple[List[Any], Any]:
        """Run the plan's stream ops for real on `device`; returns
        (results, StreamStats).

        Payloads are the `(index, data)` pairs the plan builder attached to
        its stream ops; cache keys and wire bytes come from the same ops the
        cost interpreter charges, so the two accountings cannot drift.
        """
        from repro_torch.io.streamer import DoubleBufferedStreamer

        if self._analyze_enabled():
            # run() validates before interpreting; stream() is the real
            # engine path and deserves the same gate when analysis is on
            # (spec may be None here — the budget rules then skip).
            plan.validate()
            self._analyze(plan)

        payloads: List[Any] = []
        meta: Dict[Any, Tuple[Any, int, Optional[int]]] = {}
        probed = False
        for bound in plan.ops:
            op = bound.op
            if isinstance(op, CacheProbeOp) and op.payload is not None:
                payloads.append(op.payload)
                meta[op.payload[0]] = (op.key, op.wire_bytes, op.place_shard)
                probed = True
            elif isinstance(op, TransferOp) and op.payload is not None:
                payloads.append(op.payload)
                meta[op.payload[0]] = (None, op.nbytes, None)

        cache = self.segment_cache
        cache_lookup = cache_store = None
        if cache is not None and probed:
            def cache_lookup(payload):
                key, nbytes, _ = meta[payload[0]]
                return cache.get(key, nbytes=nbytes)

            def cache_store(payload, dev):
                key, nbytes, place = meta[payload[0]]
                cache.put(key, dev, nbytes, shard=place)

        streamer = DoubleBufferedStreamer(
            upload, consume, depth=depth, deadline_s=deadline_s,
            max_reissue=max_reissue,
            payload_nbytes=lambda payload: meta[payload[0]][1],
            cache_lookup=cache_lookup, cache_store=cache_store,
            device=device)
        results = streamer.run_all(payloads)
        return results, streamer.stats
