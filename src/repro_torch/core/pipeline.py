"""Pipeline-plan IR — the streamed pass as a typed op list, two interpreters.

A plan builder (`AiresSpGEMM._build_stream_plan`) emits a
:class:`PipelinePlan`: transfers, cache probes and compute slots, each on a
declared resource lane (DMA channel, compute unit) with explicit
dependencies. Two interpreters consume the same plan:

  * :class:`CostInterpreter` charges every transfer through a
    `TieredMemorySystem` and computes the overlap-aware makespan from
    per-lane availability. It never mutates a segment cache: probes peek.
    `PipelinePlan.estimate()` is this reading; the serving engine prices
    requests with it.
  * :class:`ExecuteInterpreter` drives the plan's stream ops through a
    `DoubleBufferedStreamer` for real (:meth:`ExecuteInterpreter.stream`).

One plan, two readings: the keys and byte counts the stream uses are the
ones the cost model charges. This is the serving subset of
`repro.core.pipeline`; makespans match the reference's, which the tests
hold them to.

Makespan semantics: ops on the same lane of a phase serialize on that
lane's availability; an op additionally waits for its `deps`. A phase's
span is its latest completion; the plan's makespan is the sum of phase
spans, in declared order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.io.tiers import MemoryTier, Path, TieredMemorySystem, TierSpec

# Resource lanes: two ops on the same lane of the same phase never overlap;
# ops on different lanes do (unless tied by deps).
LANE_DMA = "dma"
LANE_GDS = "gds"
LANE_SIO = "sio"
LANE_UM = "um"
LANE_HOST = "host"
LANE_COMPUTE = "compute"


@dataclasses.dataclass
class ScheduleMetrics:
    """What the cost interpreter reads off a plan."""

    scheduler: str
    io_modeled_s: float = 0.0        # modeled: sum of transfer seconds
    compute_modeled_s: float = 0.0   # modeled: device kernel seconds
    makespan_s: float = 0.0          # overlapped end-to-end estimate
    bytes_by_path: Dict[str, int] = dataclasses.field(default_factory=dict)
    seconds_by_path: Dict[str, float] = dataclasses.field(default_factory=dict)
    total_transfer_bytes: int = 0
    cache_hit_bytes: int = 0         # wire bytes the segment cache would serve
    segments: int = 0


def modeled_spgemm_seconds(nnz: int, feat, spec: TierSpec,
                           compute_efficiency: float = 0.20) -> float:
    """Modeled device time for one segment's partial product.

    Hypersparse SpGEMM is memory-bound: per A-nonzero the kernel reads the
    A entry, gathers the matching B row segment (dens_B·F values+ids) and
    writes ~E[matches] C entries, at a fraction of the spec's device
    memory rate (irregular access).
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
class TransferOp:
    """One modeled transfer over `path`. `payload` optionally carries the
    real host payload `(index, data)` for the execute interpreter."""

    path: Path
    src: MemoryTier
    dst: MemoryTier
    nbytes: int
    tag: str = ""
    payload: Any = None


@dataclasses.dataclass
class ComputeOp:
    """One device-kernel slot of `seconds` modeled time."""

    seconds: float


@dataclasses.dataclass
class CacheProbeOp:
    """Probe the segment cache for `key`; on miss, the fallback `miss`
    transfer is paid and the uploaded value retained under the key. A
    device-tier hit is free wire traffic; a host-tier hit costs the
    promotion DMA. `payload` as on TransferOp."""

    key: Any                 # io.segment_cache.SegmentKey
    wire_bytes: int
    miss: TransferOp
    payload: Any = None


OpKind = Union[TransferOp, ComputeOp, CacheProbeOp]


class PlanValidationError(ValueError):
    """A structurally malformed `PipelinePlan`: dangling, self-, forward or
    cyclic dependencies, or ops in undeclared phases."""


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


@dataclasses.dataclass
class PipelinePlan:
    """A streamed pass's whole I/O + compute schedule as data."""

    scheduler: str
    phases: List[PhaseSpec] = dataclasses.field(default_factory=list)
    ops: List[PlanOp] = dataclasses.field(default_factory=list)
    segments: int = 0
    mem: Any = None                  # MemoryEstimate (Eq. 5-7)
    robw: Any = None                 # RoBWPlan

    def add(self, op: OpKind, phase: str, lane: str = "",
            deps: Sequence[int] = ()) -> int:
        """Append an op; returns its index (for later `deps`)."""
        self.ops.append(PlanOp(op, phase, lane, tuple(deps)))
        return len(self.ops) - 1

    def validate(self) -> "PipelinePlan":
        """Structural validation; returns self, raises PlanValidationError.

        The interpreter evaluates ops in list order, reading each dep's
        completion time from earlier iterations — so list order must be a
        topological order of the dep graph. A dangling index, a self-dep or
        a forward reference would read a completion time of 0.0 and
        silently mis-order the makespan.
        """
        names = [ph.name for ph in self.phases]
        if len(set(names)) != len(names):
            raise PlanValidationError(
                f"duplicate phase declarations: {names}")
        declared = set(names)
        n = len(self.ops)
        for idx, bound in enumerate(self.ops):
            kind = type(bound.op).__name__
            if bound.phase not in declared:
                raise PlanValidationError(
                    f"op {idx} ({kind}) sits in undeclared phase "
                    f"{bound.phase!r} (declared: {sorted(declared)})")
            for d in bound.deps:
                d = int(d)
                if not 0 <= d < n:
                    raise PlanValidationError(
                        f"op {idx} ({kind}) has a dangling dependency on "
                        f"op {d} (plan has {n} ops)")
                if d >= idx:
                    raise PlanValidationError(
                        f"op {idx} ({kind}) depends on op {d}: list order "
                        "must be a topological order (self-, forward and "
                        "cyclic dependencies would mis-order the makespan)")
        return self

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

    def estimate(self, spec: TierSpec,
                 segment_cache: Any = None) -> ScheduleMetrics:
        """Side-effect-free cost reading of this plan: cache probes peek
        instead of get/put, so estimating never promotes, demotes or
        inserts."""
        return CostInterpreter(spec, segment_cache=segment_cache).run(self)


# ---- interpreters ----------------------------------------------------------


class CostInterpreter:
    """Charge a plan through a `TieredMemorySystem`; derive the makespan
    from lane availability. Cache probes peek (`peek_cost`), never mutate."""

    def __init__(self, spec: Optional[TierSpec], segment_cache: Any = None):
        self.spec = spec
        self.segment_cache = segment_cache

    def run(self, plan: PipelinePlan,
            tms: Optional[TieredMemorySystem] = None) -> ScheduleMetrics:
        tms = tms if tms is not None else TieredMemorySystem(self.spec)
        m = ScheduleMetrics(scheduler=plan.scheduler)
        plan.validate()
        completion = [0.0] * len(plan.ops)
        lane_free: Dict[Tuple[str, str], float] = {}
        span: Dict[str, float] = {}
        for idx, bound in enumerate(plan.ops):
            op = bound.op
            if isinstance(op, TransferOp):
                secs = tms.transfer(op.path, op.src, op.dst, op.nbytes,
                                    tag=op.tag)
            elif isinstance(op, CacheProbeOp):
                secs = self._probe(op, tms, m)
            elif isinstance(op, ComputeOp):
                secs = op.seconds
                m.compute_modeled_s += secs
            else:
                raise TypeError(f"unknown plan op {type(op).__name__}")
            start = lane_free.get((bound.phase, bound.lane), 0.0)
            for d in bound.deps:
                start = max(start, completion[d])
            completion[idx] = start + secs
            if bound.lane:
                lane_free[(bound.phase, bound.lane)] = completion[idx]
            span[bound.phase] = max(span.get(bound.phase, 0.0),
                                    completion[idx])
        makespan = 0.0
        for ph in plan.phases:
            makespan = makespan + span.get(ph.name, 0.0)
        m.io_modeled_s = sum(t.seconds for t in tms.transfers)
        m.makespan_s = makespan
        m.bytes_by_path = {p.value: b for p, b in tms.bytes_by_path().items()}
        m.seconds_by_path = {p.value: s
                             for p, s in tms.seconds_by_path().items()}
        m.total_transfer_bytes = tms.total_bytes()
        m.segments = plan.segments
        return m

    def _probe(self, op: CacheProbeOp, tms: TieredMemorySystem,
               m: ScheduleMetrics) -> float:
        """The cache prices its own would-be hit (`peek_cost`); a would-be
        miss pays the fallback wire transfer."""
        cost = 0.0
        cache = self.segment_cache
        if cache is not None:
            hit, cost = cache.peek_cost(op.key, nbytes=op.wire_bytes, tms=tms)
            if hit:
                m.cache_hit_bytes += op.wire_bytes
                return cost
        t = op.miss
        return cost + tms.transfer(t.path, t.src, t.dst, t.nbytes, tag=t.tag)


class ExecuteInterpreter(CostInterpreter):
    """Cost interpretation + real execution: :meth:`stream` drives the
    plan's stream ops through a `DoubleBufferedStreamer`. Cache probes
    become the streamer's lookup/store hooks and the plan's wire-byte
    declarations feed `StreamStats`."""

    def __init__(self, spec: Optional[TierSpec] = None,
                 segment_cache: Any = None):
        # `spec` is only needed by run(); stream() is pure execution.
        super().__init__(spec, segment_cache=segment_cache)

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
        its stream ops; cache keys and wire bytes come from the same ops
        the cost interpreter charges.
        """
        from repro_torch.io.streamer import DoubleBufferedStreamer

        payloads: List[Any] = []
        meta: Dict[Any, Tuple[Any, int]] = {}
        probed = False
        for bound in plan.ops:
            op = bound.op
            if isinstance(op, CacheProbeOp) and op.payload is not None:
                payloads.append(op.payload)
                meta[op.payload[0]] = (op.key, op.wire_bytes)
                probed = True
            elif isinstance(op, TransferOp) and op.payload is not None:
                payloads.append(op.payload)
                meta[op.payload[0]] = (None, op.nbytes)

        cache = self.segment_cache
        cache_lookup = cache_store = None
        if cache is not None and probed:
            def cache_lookup(payload):
                key, nbytes = meta[payload[0]]
                return cache.get(key, nbytes=nbytes)

            def cache_store(payload, dev):
                key, nbytes = meta[payload[0]]
                cache.put(key, dev, nbytes)

        streamer = DoubleBufferedStreamer(
            upload, consume, depth=depth, deadline_s=deadline_s,
            max_reissue=max_reissue,
            payload_nbytes=lambda payload: meta[payload[0]][1],
            cache_lookup=cache_lookup, cache_store=cache_store,
            device=device)
        results = streamer.run_all(payloads)
        return results, streamer.stats
