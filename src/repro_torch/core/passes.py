"""Plan-rewrite pass framework: optimizer passes over the pipeline IR.

Every scheduler's I/O + compute schedule is data — a typed
:class:`~repro_torch.core.pipeline.PipelinePlan` consumed by two
interpreters. AIRES's remaining wins (shard-aware RoBW placement, transfer
batching, deadline-aware serving order) re-arrange the *same bytes*, so
they are plan **transformations**, not new schedulers — the same post-hoc
schedule-rewriting that pays off for HC-SpMM's hybrid-core kernel
selection and the batched-SpGEMM reordering of arXiv:1903.11409. This
module is the pass manager between plan builders and interpreters:

  * :class:`PlanPass` — one rewrite, pure ``PipelinePlan -> PipelinePlan``
    (a pass may *annotate* ops — e.g. placement overrides — or rebuild the
    op list, but never executes anything);
  * :class:`PassPipeline` — runs passes in order, **revalidates the plan
    after every pass** (`PipelinePlan.validate()`: deps stay a topological
    order, phases stay declared) and, when a `TierSpec` is available,
    records a per-pass before/after cost delta via the `CostInterpreter`
    (`PipelinePlan.estimate()` — cache probes peek, nothing mutates);
  * three production passes:

      - :class:`ShardPlacementPass` — pin a plan's cache-probed bricks to
        the shard that streams them: remote owners become `place_shard`
        overrides, bounded by per-shard device headroom, falling back to
        the fewest-hop shard with room. It reads the cache by duck typing
        and is the identity unless `cache.n_shards > 1`, so on the
        single-chip `TieredSegmentCache` it returns the plan unchanged.
      - :class:`TransferCoalescingPass` — merge adjacent small same-lane,
        same-path transfers into one DMA: total bytes per path are
        conserved, per-transfer setup latency is paid once per merged
        group, and on the real streamer the merged group becomes a single
        upload issue (`CoalescedPayload`).
      - :class:`EDFOrderingPass` — deadline-aware batch ordering for
        `ServingEngine.run_batch`, priced by the same
        `PipelinePlan.estimate()` cost admission control uses. The order
        is earliest-deadline-first refined by Moore–Hodgson tardy
        demotion (`deadline_order`), which is optimal in on-time count —
        so it never misses more deadlines than the submission order.

The identity pipeline (``PassPipeline([])``) is behavior-preserving by
construction: it validates and returns the plan untouched.

A copy of `repro.core.passes`; the tests hold the rewrites, reports and
orders equal.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.analysis import (
    SEVERITY_ERROR,
    Finding,
    analyze_plan,
    diff_path_totals,
    path_byte_totals,
)
from repro_torch.core.pipeline import (
    CacheProbeOp,
    PipelinePlan,
    PlanOp,
    ScheduleMetrics,
    TransferOp,
)
from repro_torch.io.tiers import TierSpec

__all__ = [
    "CoalescedPayload", "EDFOrderingPass", "PassContext", "PassPipeline",
    "PassReport", "PlanPass", "ShardPlacementPass", "TransferCoalescingPass",
    "deadline_order", "edf_sort", "remaining_deadline",
]


@dataclasses.dataclass
class PassContext:
    """What a pass may *read* while rewriting: the cost model and the live
    segment cache (owner map, budgets, hop counts). Passes never mutate
    either — cache state changes only when the rewritten plan is
    interpreted."""

    spec: Optional[TierSpec] = None
    segment_cache: Any = None


class PlanPass:
    """One plan rewrite. Subclasses override `__call__` (return the
    rewritten plan — annotating ops in place or rebuilding the op list)
    and/or `order_requests` (batch-level work ordering for the serving
    engine). The base class is the identity on both."""

    name = "identity"
    # Passes re-arrange the same bytes; `PassPipeline(strict=True)`
    # enforces it via `analysis.path_byte_totals` after every rewrite.
    # A future pass that legitimately changes traffic (layer fusion
    # dropping a round trip, say) opts out by setting this False.
    conserves_bytes = True

    def __call__(self, plan: PipelinePlan,
                 ctx: Optional[PassContext] = None) -> PipelinePlan:
        return plan

    def order_requests(self, requests: List[Any]) -> List[Any]:
        return requests


@dataclasses.dataclass
class PassReport:
    """Before/after cost reading of one pass (both via
    `PipelinePlan.estimate()` under the pipeline's TierSpec).

    Under `PassPipeline(strict=True)`, `findings` carries the static
    analyzer's verdict on the pass's output (core.analysis) —
    empty means the rewrite analyzed clean."""

    pass_name: str
    # None when the pipeline runs strict-only (no TierSpec to estimate
    # under); the cost-delta properties assume a tracked run.
    before: Optional[ScheduleMetrics]
    after: Optional[ScheduleMetrics]
    findings: Tuple[Any, ...] = ()

    @property
    def makespan_delta_s(self) -> float:
        """Negative = the pass made the modeled plan faster."""
        return self.after.makespan_s - self.before.makespan_s

    def bytes_delta(self, path: str) -> int:
        return (self.after.bytes_by_path.get(path, 0)
                - self.before.bytes_by_path.get(path, 0))


class PassPipeline:
    """Ordered passes + revalidation + per-pass cost deltas.

    `apply(plan)` validates the incoming plan, runs each pass, revalidates
    after every rewrite, and (when a `TierSpec` is known and `track_costs`
    is on) estimates the plan before and after each pass so callers can
    see exactly what each rewrite bought. The last run's reports are kept
    on `last_reports`.

    An empty pipeline is the identity: validate, touch nothing — the
    refactor's behavior-preservation anchor.
    """

    def __init__(self, passes: Sequence[PlanPass] = (),
                 spec: Optional[TierSpec] = None,
                 track_costs: bool = True, strict: bool = False):
        self.passes: List[PlanPass] = list(passes)
        self.spec = spec
        self.track_costs = track_costs
        # strict: statically analyze the plan after every pass
        # (core.analysis), attach the findings to the PassReports,
        # enforce per-path byte conservation for every pass that does not
        # declare `conserves_bytes = False`, and raise PlanAnalysisError
        # on any error-severity finding — so a byte-dropping or
        # hazard-introducing rewrite dies at the pass boundary instead of
        # surfacing as wrong interpreter output.
        self.strict = strict
        self.last_reports: List[PassReport] = []

    def __len__(self) -> int:
        return len(self.passes)

    def __iter__(self):
        return iter(self.passes)

    @property
    def orders_requests(self) -> bool:
        """True if any pass reorders batch work (the engine only re-groups
        its queue when one does, keeping the default path byte-identical)."""
        return any(type(p).order_requests is not PlanPass.order_requests
                   for p in self.passes)

    def order_requests(self, requests: List[Any]) -> List[Any]:
        for p in self.passes:
            requests = p.order_requests(requests)
        return requests

    def apply(self, plan: PipelinePlan, spec: Optional[TierSpec] = None,
              segment_cache: Any = None
              ) -> Tuple[PipelinePlan, List[PassReport]]:
        plan.validate()
        if not self.passes or plan.oom:
            self.last_reports = []
            return plan, []
        spec = spec if spec is not None else self.spec
        ctx = PassContext(spec=spec, segment_cache=segment_cache)
        track = self.track_costs and spec is not None
        reports: List[PassReport] = []
        before = plan.estimate(spec, segment_cache) if track else None
        totals = path_byte_totals(plan) if self.strict else None
        for p in self.passes:
            plan = p(plan, ctx)
            plan.validate()
            findings: Tuple[Any, ...] = ()
            verdict = None
            if self.strict:
                verdict = analyze_plan(plan, spec=spec,
                                       segment_cache=segment_cache)
                after_totals = path_byte_totals(plan)
                delta = diff_path_totals(totals, after_totals)
                if delta and getattr(p, "conserves_bytes", True):
                    verdict.findings.append(Finding(
                        "bytes/path-delta", SEVERITY_ERROR,
                        f"pass {p.name!r} changed per-path byte totals "
                        f"by {delta} (set conserves_bytes=False if the "
                        "pass legitimately re-routes traffic)"))
                totals = after_totals
                findings = tuple(verdict.findings)
            if track or self.strict:
                after = plan.estimate(spec, segment_cache) if track \
                    else None
                reports.append(PassReport(p.name, before, after,
                                          findings=findings))
                before = after
            if verdict is not None:
                self.last_reports = reports
                verdict.raise_for_errors()
        self.last_reports = reports
        return plan, reports


# ---- pass 1: shard-aware RoBW placement ------------------------------------


class ShardPlacementPass(PlanPass):
    """Pin a plan's cache-probed bricks to the shard that consumes them.

    The CRC owner map spreads bricks uniformly over the mesh — good for
    aggregate capacity, but every brick this worker streams from a remote
    owner pays ICI twice (shard-place on insert, cache/ici on every warm
    hit). This pass walks the plan's `CacheProbeOp`s in stream order (the
    RoBW plan's hot order — every pass streams all of them) and decides,
    for each not-yet-resident key owned remotely, where the miss's insert
    should land — by the tier the brick is expected to settle in, since
    that is what a warm hit will cost:

      1. **local device** headroom left → pin local (`place_shard =
         local`): warm hits become free, no ICI ever again;
      2. else **owner device** headroom left → keep the CRC owner: a
         remote *device* hit costs only the ICI hop, which is cheaper
         than converting it into a local host-tier promotion over the
         PCIe-class DMA path;
      3. else another shard has device headroom at no more `ici_hops`
         than the owner → place there (device residency at
         equal-or-fewer hops);
      4. else the brick will settle on a host tier wherever it lands —
         prefer the **local** host tier (promotion without the ICI
         add-on), then the nearest host tier strictly closer than the
         owner.

    Per-shard device/host headrooms are budgeted down as the walk assigns
    bricks, so the pass never plans past capacity. Keys already resident
    somewhere are left alone (migrating warm bricks would charge the move
    against this batch). Monotonicity — placement never increases modeled
    `ici_bytes` — holds by construction (every override sits at
    equal-or-fewer hops than the CRC owner) and is property-tested.

    **Cluster co-placement** (partition-aware sharding): when the cache
    carries a partition-derived cluster map (`ShardedSegmentCache.
    cluster_of_key`, installed by `install_owner_map(..., clusters=...)`),
    probes of the same cluster are placed as ONE unit through device
    rules 1–3 — co-clustered bricks share neighbors, so splitting a
    cluster across shards forfeits exactly the locality the partitioner
    bought. A cluster that fits nowhere as a unit falls back to the
    per-brick walk (host tiers included); probes with no cluster id take
    the per-brick path bit-exactly as before.
    """

    name = "shard-placement"

    def __call__(self, plan: PipelinePlan,
                 ctx: Optional[PassContext] = None) -> PipelinePlan:
        cache = getattr(ctx, "segment_cache", None)
        if cache is None or getattr(cache, "n_shards", 1) <= 1:
            return plan
        local = cache.local_shard
        shards = range(cache.n_shards)
        dev = {s: max(cache.shard_headroom(s), 0) for s in shards}
        host = {s: max(cache.shard_host_headroom(s), 0) for s in shards}

        def nearest(budgets, nbytes, max_hops):
            """Closest non-local shard with room, at most `max_hops` away
            (ties broken toward the lowest shard index, deterministic)."""
            best, best_hops = None, max_hops + 1
            for s in shards:
                if s == local or nbytes > budgets[s]:
                    continue
                h = cache.ici_hops(s)
                if h < best_hops:
                    best, best_hops = s, h
            return best

        def place_one(op, owner):
            nbytes = int(op.wire_bytes)
            owner_hops = cache.ici_hops(owner)
            if nbytes <= dev[local]:
                op.place_shard = local
                dev[local] -= nbytes
                return
            if nbytes <= dev[owner]:
                dev[owner] -= nbytes        # reserve; keep the owner
                return
            s = nearest(dev, nbytes, owner_hops)
            if s is not None:
                op.place_shard = s
                dev[s] -= nbytes
                return
            if nbytes <= host[local]:
                op.place_shard = local
                host[local] -= nbytes
                return
            s = nearest(host, nbytes, owner_hops - 1)
            if s is not None:
                op.place_shard = s
                host[s] -= nbytes
            elif nbytes <= host[owner]:
                host[owner] -= nbytes       # settles at the owner's host

        def needs_placement(op):
            return (cache.owner_of(op.key) != local
                    and cache.tier_of(op.key) is None)

        # Cluster groups among the probes that need placement: the
        # members move as one unit through device rules 1-3. Grouping
        # reads only static cache state (owner maps, residency), so the
        # precomputed groups match the walk's own filter.
        clustered = hasattr(cache, "cluster_of_key")
        groups: dict = {}
        if clustered:
            for bound in plan.ops:
                op = bound.op
                if not isinstance(op, CacheProbeOp):
                    continue
                c = cache.cluster_of_key(op.key)
                if c is not None and needs_placement(op):
                    groups.setdefault(c, []).append(op)

        placed_clusters: set = set()
        for bound in plan.ops:
            op = bound.op
            if not isinstance(op, CacheProbeOp):
                continue
            if not needs_placement(op):
                continue
            owner = cache.owner_of(op.key)
            c = cache.cluster_of_key(op.key) if clustered else None
            if c is None:
                place_one(op, owner)
                continue
            if c in placed_clusters:
                continue
            placed_clusters.add(c)
            members = groups.get(c, [op])
            total = sum(int(m.wire_bytes) for m in members)
            owner_hops = cache.ici_hops(owner)
            if total <= dev[local]:
                for m in members:
                    m.place_shard = local
                dev[local] -= total
                continue
            if total <= dev[owner]:
                dev[owner] -= total         # co-resident at the owner
                continue
            s = nearest(dev, total, owner_hops)
            if s is not None:
                for m in members:
                    m.place_shard = s
                dev[s] -= total
                continue
            # The cluster fits nowhere as a unit: per-brick rescue, in
            # stream order, host tiers included.
            for m in members:
                place_one(m, cache.owner_of(m.key))
        return plan


# ---- pass 2: transfer coalescing -------------------------------------------


@dataclasses.dataclass
class CoalescedPayload:
    """Stream payloads of a merged transfer, in original segment order.

    `AiresSpGEMM` uploads all member bricks in one streamer issue and
    consumes them back-to-back; per-segment results are flattened back
    into plan order, so outputs are bit-identical to the unmerged stream.
    """

    payloads: List[Any]


class TransferCoalescingPass(PlanPass):
    """Merge adjacent small same-lane, same-path transfers into one DMA.

    Per-transfer setup latency (`TierSpec.latency_s`) dominates transfers
    below ~bw·latency bytes; RoBW segmentation and the baselines' merge
    bounces produce long runs of them. Two transfers coalesce when they
    share (phase, lane, path, src/dst tier, merge flag, payload-ness),
    each is below `min_bytes`, and merging cannot break the dep order:

      * a dependent of any member now waits for the whole merged DMA —
        exactly the semantics of a real coalesced transfer;
      * a candidate whose deps do not all resolve *before* the open run's
        position starts a fresh run instead (list order must remain a
        topological order — revalidated by the PassPipeline);
      * in a ``lanes`` phase, a non-mergeable op on the same lane closes
        the run (lane traffic order is preserved); ``serial`` phases sum
        regardless, so only dep order gates there.

    Total bytes per path are conserved (property-tested); only the
    per-transfer latency count — and, for payload-bearing stream plans,
    the real streamer's issue count — drops. `CacheProbeOp`s are never
    merged: each brick must stay individually addressable in the cache.

    ``min_bytes=None`` derives the threshold per path from the
    (calibrated) spec in the `PassContext` as ``bw·latency`` — the byte
    count at which setup cost equals streaming cost, which is exactly
    where merging stops paying. With no spec in context it falls back to
    the documented ``1<<18`` default.
    """

    name = "transfer-coalescing"

    DEFAULT_MIN_BYTES = 1 << 18

    def __init__(self, min_bytes: Optional[int] = DEFAULT_MIN_BYTES):
        if min_bytes is not None and min_bytes <= 0:
            raise ValueError("min_bytes must be > 0")
        self.min_bytes = int(min_bytes) if min_bytes is not None else None

    def threshold(self, spec: Optional[TierSpec], path) -> int:
        """Coalescing threshold for one path: the explicit `min_bytes`,
        or the spec-derived ``bw·latency`` crossover when None."""
        if self.min_bytes is not None:
            return self.min_bytes
        if spec is None or path not in spec.bw:
            return self.DEFAULT_MIN_BYTES
        return max(1, int(spec.bw[path] * spec.latency_s.get(path, 0.0)))

    def __call__(self, plan: PipelinePlan,
                 ctx: Optional[PassContext] = None) -> PipelinePlan:
        spec = ctx.spec if ctx is not None else None
        overlap = {ph.name: ph.overlap for ph in plan.phases}
        groups: List[List[int]] = []     # member op indices, consecutive
        group_of: Dict[int, int] = {}
        open_runs: Dict[tuple, int] = {}  # run key -> group id

        for idx, bound in enumerate(plan.ops):
            op = bound.op
            run_key = None
            if (isinstance(op, TransferOp)
                    and op.nbytes < self.threshold(spec, op.path)):
                run_key = (bound.phase, bound.lane, op.path, op.src, op.dst,
                           op.merge, op.payload is None)
            if run_key is None:
                if overlap.get(bound.phase, "lanes") == "lanes":
                    for k in [k for k in open_runs
                              if k[0] == bound.phase and k[1] == bound.lane]:
                        del open_runs[k]
                group_of[idx] = len(groups)
                groups.append([idx])
                continue
            gid = open_runs.get(run_key)
            if gid is not None:
                run_first = groups[gid][0]
                if all(group_of[d] == gid
                       or groups[group_of[d]][0] < run_first
                       for d in bound.deps):
                    group_of[idx] = gid
                    groups[gid].append(idx)
                    continue
            gid = len(groups)
            group_of[idx] = gid
            groups.append([idx])
            open_runs[run_key] = gid

        if all(len(g) == 1 for g in groups):
            return plan

        # Rebuild: groups were created in first-member order, so group id
        # IS the new op index — deps remap straight through group_of.
        out_ops: List[PlanOp] = []
        for gid, members in enumerate(groups):
            bound0 = plan.ops[members[0]]
            deps = tuple(sorted({group_of[int(d)]
                                 for m in members
                                 for d in plan.ops[m].deps
                                 if group_of[int(d)] != gid}))
            if len(members) == 1:
                out_ops.append(PlanOp(bound0.op, bound0.phase, bound0.lane,
                                      deps))
                continue
            op0 = bound0.op
            payload = None
            if op0.payload is not None:
                member_payloads = [plan.ops[m].op.payload for m in members]
                payload = (member_payloads[0][0],
                           CoalescedPayload(member_payloads))
            merged = TransferOp(
                op0.path, op0.src, op0.dst,
                sum(int(plan.ops[m].op.nbytes) for m in members),
                tag=op0.tag, merge=op0.merge, payload=payload)
            out_ops.append(PlanOp(merged, bound0.phase, bound0.lane, deps))
        return dataclasses.replace(plan, ops=out_ops)


# ---- pass 3: deadline-aware (EDF) batch ordering ---------------------------


def _edf_order(deadlines: Sequence[float]) -> List[int]:
    """Index permutation: stable earliest-deadline-first (deadlines are
    already None→inf normalized). The single EDF primary order shared by
    `edf_sort` and `deadline_order`, so the two cannot drift."""
    return sorted(range(len(deadlines)), key=lambda i: (deadlines[i], i))


def _normalized(items, deadline_of) -> List[float]:
    inf = float("inf")
    return [deadline_of(it) if deadline_of(it) is not None else inf
            for it in items]


def edf_sort(items: Sequence[Any],
             deadline_of: Callable[[Any], Optional[float]]) -> List[Any]:
    """Stable earliest-deadline-first order; deadline-free items keep their
    relative order at the tail. Optimal for *maximum lateness* (Jackson's
    rule) — the guarantee pure EDF actually carries."""
    return [items[i] for i in _edf_order(_normalized(items, deadline_of))]


def deadline_order(items: Sequence[Any],
                   cost_of: Callable[[Any], float],
                   deadline_of: Callable[[Any], Optional[float]]
                   ) -> List[Any]:
    """EDF refined by Moore–Hodgson tardy demotion.

    Process items in EDF order, tracking the running completion time under
    `cost_of`; whenever the current item would finish past its deadline,
    demote the *most expensive* scheduled item to the tardy tail. The
    on-time set this yields is maximum (Moore–Hodgson is optimal for
    1‖ΣUⱼ), so the returned order never misses more deadlines than the
    submission order — pure EDF alone does not guarantee that (it is
    optimal for max lateness, not miss count). Tardy items run last, in
    submission order; deadline-free items never miss and sort after all
    deadlines. Returns a permutation of `items`.
    """
    dl = _normalized(items, deadline_of)
    order = _edf_order(dl)
    scheduled: List[int] = []
    tardy: List[int] = []
    t = 0.0
    for i in order:
        scheduled.append(i)
        t += max(float(cost_of(items[i])), 0.0)
        if t > dl[i]:
            k = max(range(len(scheduled)),
                    key=lambda j: (cost_of(items[scheduled[j]]),
                                   scheduled[j]))
            dropped = scheduled.pop(k)
            t -= max(float(cost_of(items[dropped])), 0.0)
            tardy.append(dropped)
    tardy.sort()
    return [items[i] for i in scheduled + tardy]


def remaining_deadline(r: Any, now: float) -> Optional[float]:
    """Seconds a request has left on its relative deadline, on one clock:
    `InferenceRequest.deadline_s` counts from submit time, so two requests
    submitted at different moments compare via `submitted_s + deadline_s −
    now`. Unstamped requests (never passed `submit()`) fall back to the
    raw relative field — their deadline starts counting now."""
    d = getattr(r, "deadline_s", None)
    if d is None:
        return None
    submitted = getattr(r, "submitted_s", -1.0)
    return d if submitted < 0 else submitted + d - now


class EDFOrderingPass(PlanPass):
    """Deadline-aware `run_batch` ordering.

    Plans pass through untouched — the rewrite is the *work list*: the
    serving engine hands its drained queue to `order_requests`, which
    orders by `deadline_order` over each request's
    `PipelinePlan.estimate()` cost (the same prediction admission control
    prices with, filled in by `run_batch` before ordering). The engine
    then serves graph groups in first-appearance order of the reordered
    queue, so the earliest deadlines stream first.

    Deadlines are compared on one clock: `InferenceRequest.deadline_s` is
    *relative to submit time*, so two requests submitted at different
    moments cannot be ordered by the raw field — the pass converts each
    to the seconds **remaining** now (`remaining_deadline`), which is also
    the unit the Moore–Hodgson completion clock (cumulative cost from
    batch start) is checked against.

    `clock` defaults to `time.monotonic`; the continuous serving loop
    passes its `VirtualClock` so remaining-time math runs on the replay
    timeline. `order_groups` is the continuous loop's *queue-position*
    variant: the schedulable unit is a whole column-concat group, priced
    by `ServingEngine.estimate_group_cost`, so Moore–Hodgson's completion
    clock accumulates whole-group costs — each group's deadline is checked
    against its time-to-front (the modeled cost of every group ahead of
    it), not just its within-round rank.
    """

    name = "edf-ordering"

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self.clock: Callable[[], float] = clock or time.monotonic

    def order_requests(self, requests: List[Any]) -> List[Any]:
        now = self.clock()
        return deadline_order(
            requests,
            cost_of=lambda r: getattr(r, "estimated_cost_s", 0.0),
            deadline_of=lambda r: remaining_deadline(r, now))

    def order_groups(self, groups: Sequence[Any],
                     cost_of: Callable[[Any], float]) -> List[Any]:
        """Queue-position EDF over request groups. Each group's deadline is
        the *tightest* remaining deadline among its members (the group
        completes as a unit — column-concat passes finish together), its
        cost the caller-supplied per-group `PipelinePlan.estimate()`
        rollup. `deadline_order`'s running completion clock then *is* the
        time-to-front of each group."""
        now = self.clock()

        def tightest(group) -> Optional[float]:
            ds = [remaining_deadline(r, now) for r in _members(group)]
            ds = [d for d in ds if d is not None]
            return min(ds) if ds else None

        return deadline_order(list(groups), cost_of, tightest)


def _members(group: Any) -> Sequence[Any]:
    """A group is either a bare request sequence or a (name, requests)
    pair (the serving loop's shape); normalize to the request list."""
    if (isinstance(group, tuple) and len(group) == 2
            and isinstance(group[0], str)):
        return group[1]
    return group
