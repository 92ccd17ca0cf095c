"""Continuous-batching serving loop over the ServingEngine.

`ServingEngine.run_batch` serves traffic in synchronous rounds: drain the
queue, stream every group, hand back one report. Production traffic (the
paper's recommendation/PPI workloads) arrives continuously — a request
that lands just after a drain starts waits for the *entire* round even if
its deadline is tighter than everything in it. The fix, per the batched
SpGEMM argument of arXiv:1903.11409 (and GE-SpMM's kernel-side case for
wide batched passes), is to let new requests join the column-concat
groups still *forming* while the previous group streams:

  * :class:`ContinuousServer` — a step-driven loop over an existing
    `ServingEngine`: ``submit()`` at any virtual time, ``step()`` streams
    exactly **one** group and advances the clock by its modeled cost.
    Between steps, fresh submissions join the next forming group
    (`form_groups`), so a burst never waits behind a full drain.
  * **Backpressure** rides the engine's own admission control: the loop
    shares the engine's clock, so `EngineConfig.max_queue_cost_s` prices
    each submit against the *remaining* queue (served groups leave it
    step by step), not a round snapshot.
  * **Queue-position EDF**: groups are ordered by
    `EDFOrderingPass.order_groups` — Moore–Hodgson over per-group
    `ServingEngine.estimate_group_cost` rollups, so a group's deadline is
    checked against its time-to-front (the modeled cost of every group
    ahead), not just its within-round rank.
  * :class:`VirtualClock` + the trace generators (`poisson_trace`,
    `bursty_trace`) + the replay functions (`replay_round`,
    `replay_continuous`) make whole serving timelines deterministic:
    the reference package's `benchmarks/bench_serve.py` replays identical
    arrival traces through both the round engine and this loop.

Byte accounting is the engine's own: every group runs through
`ServingEngine.serve_group`, the same group-run piece `run_batch` uses,
so uploaded/cache-hit/ICI bytes stay comparable across serving modes.

A copy of `repro.runtime.serving_loop`. The virtual clock moves by each
group's modeled cost while the group streams for real on the engine's
device; the wall time a group takes is measured beside the loop (the
engine's `serve_group` copies every output to the host before it stamps
it, so on a card the stamp follows the group's last kernel).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.passes import (
    EDFOrderingPass, edf_sort, remaining_deadline,
)
from repro_torch.runtime.engine import (
    AdmissionError,
    GroupStats,
    InferenceRequest,
    InferenceResult,
    RejectedRequest,
    RequestLatency,
    ServingEngine,
)

__all__ = [
    "Arrival", "ContinuousServer", "ServeEvent", "ServeReport", "StepReport",
    "VirtualClock", "bursty_trace", "poisson_trace", "replay_continuous",
    "replay_round", "summarize",
]


class VirtualClock:
    """Deterministic monotonic clock for trace replay: a callable drop-in
    for `time.monotonic` (the engine's `EngineConfig.clock` hook) whose
    time only moves when its caller advances it — by arrival stamps and by
    modeled group costs, never by wall time."""

    def __init__(self, start_s: float = 0.0):
        self.now_s = float(start_s)

    def __call__(self) -> float:
        return self.now_s

    def advance_to(self, t_s: float) -> float:
        if t_s < self.now_s:
            raise ValueError(
                f"virtual clock cannot run backwards: {t_s} < {self.now_s}")
        self.now_s = float(t_s)
        return self.now_s

    def advance(self, dt_s: float) -> float:
        if dt_s < 0:
            raise ValueError(f"negative advance {dt_s}")
        return self.advance_to(self.now_s + dt_s)


@dataclasses.dataclass
class ServeEvent:
    """One served request on the virtual timeline (all stamps in virtual
    seconds; `finished_s - started_s` is the modeled cost of the group the
    request rode — column-concat members finish together)."""

    request_id: int
    graph: str
    submitted_s: float
    started_s: float
    finished_s: float
    predicted_s: float
    deadline_s: Optional[float] = None

    @property
    def latency_s(self) -> float:
        return self.finished_s - self.submitted_s

    @property
    def on_time(self) -> bool:
        return self.deadline_s is None or self.latency_s <= self.deadline_s


@dataclasses.dataclass
class StepReport:
    """What one `ContinuousServer.step()` served: exactly one group."""

    graph: str
    started_s: float
    finished_s: float
    cost_s: float
    events: List[ServeEvent]
    results: List[InferenceResult]
    stats: GroupStats
    expired: List[RejectedRequest]


@dataclasses.dataclass
class ServeReport:
    """Cumulative story of a serving timeline (either mode)."""

    events: List[ServeEvent]
    expired: List[RejectedRequest]
    rejected: List[RejectedRequest]
    stats: GroupStats
    groups_served: int
    makespan_s: float

    @property
    def served(self) -> int:
        return len(self.events)

    @property
    def on_time(self) -> int:
        return sum(1 for e in self.events if e.on_time)

    @property
    def deadline_misses(self) -> int:
        """Requests that produced no timely answer: served late, expired
        on the queue, or refused admission."""
        return (self.served - self.on_time
                + len(self.expired) + len(self.rejected))

    @property
    def offered(self) -> int:
        return self.served + len(self.expired) + len(self.rejected)

    @property
    def goodput_rps(self) -> float:
        return self.on_time / self.makespan_s if self.makespan_s > 0 else 0.0


class ContinuousServer:
    """Step-driven continuous batching over an existing `ServingEngine`.

    Usage:
        clock = VirtualClock()
        eng = ServingEngine(EngineConfig(..., clock=clock))
        server = ContinuousServer(eng)
        server.submit(request, at=0.3)       # any virtual time
        step = server.step()                 # streams exactly one group
        report = server.report()             # cumulative ServeReport

    The loop owns no scheduling machinery of its own: admission (deadline
    feasibility + `max_queue_cost_s` against the remaining queue) is the
    engine's `submit`, group formation mirrors `_batched_aggregate`'s
    greedy width packing, execution is `serve_group` — the group-run piece
    `run_batch` itself uses — and ordering is `EDFOrderingPass` at group
    granularity. With `edf=False` groups run in formation (FIFO) order.
    """

    def __init__(self, engine: ServingEngine,
                 clock: Optional[VirtualClock] = None, edf: bool = True):
        if clock is None:
            clock = (engine.clock if isinstance(engine.clock, VirtualClock)
                     else VirtualClock())
        if engine.clock is not clock:
            if engine._queue or engine._rejected:
                raise ValueError(
                    "attach the continuous loop before queueing work: the "
                    "engine holds requests/verdicts stamped on a different "
                    "clock")
            engine.clock = clock
        self.engine = engine
        self.clock = clock
        # Group ordering shares the replay clock; the engine's own
        # configured EDF pass (if any) may sit on wall time, so the loop
        # carries its own instance.
        self._edf = EDFOrderingPass(clock=clock) if edf else None
        self._events: List[ServeEvent] = []
        self._expired: List[RejectedRequest] = []
        self._rejected: List[RejectedRequest] = []
        self._stats = GroupStats()
        self._groups_served = 0
        self._t_start = clock()

    # ---- admission (the engine's, on the shared clock) -------------------

    @property
    def pending(self) -> int:
        return len(self.engine._queue)

    def submit(self, request: InferenceRequest,
               at: Optional[float] = None):
        """Admit a request at virtual time `at` (default: now). Raises the
        engine's `AdmissionError` on rejection; the verdict is folded into
        this loop's `ServeReport.rejected` rather than a BatchReport."""
        if at is not None:
            self.clock.advance_to(at)
        try:
            return self.engine.submit(request)
        except AdmissionError:
            self._drain_verdicts()
            raise

    def _drain_verdicts(self) -> None:
        """Admission verdicts normally surface in the next BatchReport;
        the continuous loop never runs one, so collect them here."""
        if self.engine._rejected:
            self._rejected.extend(self.engine._rejected)
            self.engine._rejected.clear()

    # ---- evolving graphs -------------------------------------------------

    def update_graph(self, name: str, inserts=None, deletes=None):
        """Apply an edge delta between steps WITHOUT draining the queue.

        Delegates to `ServingEngine.update_graph`: prepared plans migrate
        incrementally and only the touched segments' cache keys are
        invalidated. Queued and mid-forming requests keep working — the
        node count is unchanged and groups resolve the graph by name at
        `serve_group` time, so requests admitted before the delta are
        served against the updated graph from the next step on. Returns
        the engine's `GraphUpdateReport`."""
        return self.engine.update_graph(name, inserts=inserts,
                                        deletes=deletes)

    # ---- group formation -------------------------------------------------

    def form_groups(self, queue: List[InferenceRequest], now: float
                    ) -> List[Tuple[str, List[InferenceRequest]]]:
        """Column-concat group formation over the pending queue: per
        graph, requests in EDF (remaining-deadline) order pack greedily
        into groups whose layer-0 concatenated width stays within
        `max_batch_features` — the unit `step()` serves. Requests admitted
        between steps land here, joining the next forming group instead
        of waiting for a full drain."""
        cap = self.engine.config.max_batch_features
        by_graph: Dict[str, List[InferenceRequest]] = {}
        for r in queue:
            by_graph.setdefault(r.graph, []).append(r)
        groups: List[Tuple[str, List[InferenceRequest]]] = []
        for name, rs in by_graph.items():
            if self._edf is not None:
                rs = edf_sort(rs, lambda r: remaining_deadline(r, now))
            chunk: List[InferenceRequest] = []
            width = 0
            for r in rs:
                f = int(r.features.shape[1])
                if chunk and width + f > cap:
                    groups.append((name, chunk))
                    chunk, width = [], 0
                chunk.append(r)
                width += f
            if chunk:
                groups.append((name, chunk))
        return groups

    def _group_cost(self, group: Tuple[str, List[InferenceRequest]]) -> float:
        name, members = group
        return self.engine.estimate_group_cost(name, members)

    # ---- the step --------------------------------------------------------

    def step(self) -> Optional[StepReport]:
        """Serve exactly one group: stamp/expire/price the pending queue
        (`prepare_queue`), form groups, pick the queue-position-EDF winner,
        stream it for real (`serve_group`), and advance the virtual clock
        by the group's modeled cost. Returns None when nothing is
        servable (idle)."""
        now = self.clock()
        self._drain_verdicts()
        queue = self.engine._queue
        unknown = sorted({r.graph for r in queue} - set(self.engine._graphs))
        if unknown:
            raise KeyError(
                f"queued requests reference unregistered graphs {unknown}")
        queue, expired = self.engine.prepare_queue(queue, now)
        self._expired.extend(expired)
        groups = self.form_groups(queue, now)
        if not groups:
            self.engine._queue = queue
            return None if not expired else StepReport(
                graph="", started_s=now, finished_s=now, cost_s=0.0,
                events=[], results=[], stats=GroupStats(), expired=expired)
        if self._edf is not None:
            groups = self._edf.order_groups(groups, self._group_cost)
        name, members = groups[0]
        taken = {id(r) for r in members}
        self.engine._queue = [r for r in queue if id(r) not in taken]
        cost = self._group_cost((name, members))
        results, done_s, stats = self.engine.serve_group(
            name, members, time.perf_counter())
        if self.engine.config.calibrator is not None:
            # Continuous mode never runs run_batch, so the per-group
            # latency stream must be fed to the calibrator here.
            self.engine.feed_latencies([
                RequestLatency(r.request_id, name, r.estimated_cost_s,
                               *done_s[r.request_id])
                for r in members])
        finished = self.clock.advance_to(now + cost)
        events = [
            ServeEvent(request_id=r.request_id, graph=name,
                       submitted_s=r.submitted_s, started_s=now,
                       finished_s=finished, predicted_s=r.estimated_cost_s,
                       deadline_s=r.deadline_s)
            for r in members
        ]
        self._events.extend(events)
        self._stats.merge(stats)
        self._groups_served += 1
        return StepReport(graph=name, started_s=now, finished_s=finished,
                          cost_s=cost, events=events, results=results,
                          stats=stats, expired=expired)

    def drain(self) -> List[StepReport]:
        """Serve until idle (no admissions in between — a synchronous
        drain, step-reported)."""
        steps = []
        while True:
            step = self.step()
            if step is None:
                return steps
            steps.append(step)

    def report(self) -> ServeReport:
        self._drain_verdicts()
        return ServeReport(
            events=list(self._events), expired=list(self._expired),
            rejected=list(self._rejected),
            stats=dataclasses.replace(self._stats),
            groups_served=self._groups_served,
            makespan_s=self.clock() - self._t_start)


# ---- arrival traces --------------------------------------------------------


@dataclasses.dataclass
class Arrival:
    """One trace entry: a request template arriving at virtual `t_s`."""

    t_s: float
    graph: str
    feature_dim: int = 16
    n_layers: int = 1
    deadline_s: Optional[float] = None


def _pick_dim(rng, feature_dim) -> int:
    """`feature_dim` may be one width or a sequence to sample uniformly —
    heterogeneous widths keep column-concat groups from absorbing a whole
    burst into one pass (the realistic serving mix)."""
    if isinstance(feature_dim, (list, tuple)):
        return int(feature_dim[int(rng.integers(len(feature_dim)))])
    return int(feature_dim)


def poisson_trace(n: int, rate_hz: float, graphs: Sequence[str],
                  seed: int = 0, feature_dim=16, n_layers: int = 1,
                  deadline_s: Optional[float] = None) -> List[Arrival]:
    """Homogeneous Poisson arrivals: i.i.d. exponential inter-arrival
    times at `rate_hz`, graphs drawn uniformly."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for _ in range(n):
        t += float(rng.exponential(1.0 / rate_hz))
        out.append(Arrival(t, graphs[int(rng.integers(len(graphs)))],
                           _pick_dim(rng, feature_dim), n_layers, deadline_s))
    return out


def bursty_trace(n: int, base_rate_hz: float, graphs: Sequence[str],
                 seed: int = 0, feature_dim=16, n_layers: int = 1,
                 deadline_s: Optional[float] = None,
                 burst_shape: float = 0.35, episode: int = 8) -> List[Arrival]:
    """Gamma-modulated (doubly-stochastic) Poisson arrivals: every
    `episode` arrivals the rate is re-drawn as ``base_rate_hz · m`` with
    ``m ~ Gamma(shape=burst_shape, scale=1/burst_shape)`` (mean 1). Small
    shapes give heavy on/off burstiness — tight request clumps separated
    by long lulls — the regime where round-based serving tails out."""
    rng = np.random.default_rng(seed)
    t = 0.0
    mult = 1.0
    out = []
    for i in range(n):
        if i % episode == 0:
            mult = max(float(rng.gamma(burst_shape, 1.0 / burst_shape)), 1e-3)
        t += float(rng.exponential(1.0 / (base_rate_hz * mult)))
        out.append(Arrival(t, graphs[int(rng.integers(len(graphs)))],
                           _pick_dim(rng, feature_dim), n_layers, deadline_s))
    return out


# ---- trace replay: round-based vs continuous -------------------------------


def replay_continuous(server: ContinuousServer, trace: Sequence[Arrival],
                      make_request: Callable[[Arrival], InferenceRequest]
                      ) -> ServeReport:
    """Replay an arrival trace through the continuous loop: arrivals due
    by the current virtual time are admitted (rejections counted, not
    raised), then one group streams; arrivals landing during that group
    join the next formation. Idle time jumps straight to the next
    arrival."""
    trace = sorted(trace, key=lambda a: a.t_s)
    i, n = 0, len(trace)
    while True:
        while i < n and trace[i].t_s <= server.clock():
            try:
                server.submit(make_request(trace[i]))
            except AdmissionError:
                pass  # verdict already folded into the report
            i += 1
        if server.step() is None:
            if i >= n:
                return server.report()
            server.clock.advance_to(trace[i].t_s)


def replay_round(engine: ServingEngine, trace: Sequence[Arrival],
                 make_request: Callable[[Arrival], InferenceRequest]
                 ) -> ServeReport:
    """Replay the same trace through the round-based `run_batch` path:
    arrivals admitted only between drains, every drain serving its whole
    queue. The virtual timeline of each round is reconstructed from the
    engine's own group-form pieces (`prepare_queue` + `order_queue` +
    `estimate_group_cost`) *before* the drain, so per-request completion
    stamps use exactly the costs the continuous arm is priced with —
    requests complete when their graph group does, and arrivals during
    the round wait for the entire drain."""
    clock = engine.clock
    if not isinstance(clock, VirtualClock):
        raise ValueError("replay_round needs an engine built with "
                         "EngineConfig(clock=VirtualClock())")
    trace = sorted(trace, key=lambda a: a.t_s)
    events: List[ServeEvent] = []
    expired: List[RejectedRequest] = []
    rejected: List[RejectedRequest] = []
    stats = GroupStats()
    groups_served = 0
    t_start = clock()
    i, n = 0, len(trace)
    while True:
        while i < n and trace[i].t_s <= clock():
            try:
                engine.submit(make_request(trace[i]))
            except AdmissionError:
                pass  # surfaces via the next BatchReport.rejected
            i += 1
        if not engine._queue:
            if i >= n:
                break
            clock.advance_to(trace[i].t_s)
            continue
        round_start = clock()
        # Peek the round's virtual timeline with the same deterministic
        # pieces run_batch composes (prepare_queue is pure; estimates are
        # memoized; the EDF pass reads the shared frozen clock), so the
        # spans below name exactly the groups the drain will serve.
        ready, _ = engine.prepare_queue(list(engine._queue), round_start)
        ordered, graph_order = engine.order_queue(ready)
        t = round_start
        spans: Dict[int, tuple] = {}
        for gname in graph_order:
            group = [r for r in ordered if r.graph == gname]
            if not group:
                continue
            cost = engine.estimate_group_cost(gname, group)
            for r in group:
                spans[r.request_id] = (t, t + cost, r)
            t += cost
            groups_served += 1
        report = engine.run_batch()
        for res in report.results:
            start, fin, r = spans[res.request_id]
            events.append(ServeEvent(
                request_id=res.request_id, graph=res.graph,
                submitted_s=r.submitted_s, started_s=start, finished_s=fin,
                predicted_s=r.estimated_cost_s, deadline_s=r.deadline_s))
        expired.extend(report.expired)
        rejected.extend(report.rejected)
        stats.merge(GroupStats(
            uploaded_bytes=report.uploaded_bytes,
            cache_hit_bytes=report.cache_hit_bytes,
            promoted_bytes=report.promoted_bytes,
            ici_bytes=report.ici_bytes,
            directory_hit_bytes=report.directory_hit_bytes,
            segments_streamed=report.segments_streamed,
            aggregation_passes=report.aggregation_passes))
        clock.advance_to(t)
    if engine._rejected:  # verdicts whose round never came
        rejected.extend(engine._rejected)
        engine._rejected.clear()
    return ServeReport(events=events, expired=expired, rejected=rejected,
                       stats=stats, groups_served=groups_served,
                       makespan_s=clock() - t_start)


def summarize(report: ServeReport) -> dict:
    """One serving arm → the flat stats dict `BENCH_serve.json` persists."""
    lat = sorted(e.latency_s for e in report.events)

    def pct(p):
        return float(np.percentile(lat, p)) if lat else None

    return {
        "offered": report.offered,
        "served": report.served,
        "on_time": report.on_time,
        "expired": len(report.expired),
        "rejected": len(report.rejected),
        "deadline_misses": report.deadline_misses,
        "deadline_miss_rate": (report.deadline_misses / report.offered
                               if report.offered else 0.0),
        "p50_latency_s": pct(50),
        "p99_latency_s": pct(99),
        "mean_latency_s": float(np.mean(lat)) if lat else None,
        "goodput_rps": report.goodput_rps,
        "makespan_s": report.makespan_s,
        "groups_served": report.groups_served,
        "uploaded_bytes": report.stats.uploaded_bytes,
        "cache_hit_bytes": report.stats.cache_hit_bytes,
        "promoted_bytes": report.stats.promoted_bytes,
        "ici_bytes": report.stats.ici_bytes,
        "aggregation_passes": report.stats.aggregation_passes,
    }
