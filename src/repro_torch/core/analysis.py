"""Static plan analyzer: semantic verification of `PipelinePlan`s.

`PipelinePlan.validate()` catches *structural* malformation (dangling,
self-, forward deps; undeclared phases). Semantic bugs — a rewrite pass
that oversubscribes a tier, drops bytes, or leaves a cache retain racing
its consumer — would otherwise surface only as wrong interpreter output or
a runtime `OutOfMemory`. This module is the semantic layer: it runs over
any plan *without interpreting it* and returns an :class:`AnalysisReport`
of coded :class:`Finding`s, the way TVM/Halide verify schedules before
lowering. Three analyses:

1. **Tier-budget liveness** (``mem/*``) — replay the plan's `AllocOp`s
   symbolically against the `TierSpec` capacities, with the same
   same-name-realloc-replaces semantics as `TieredMemorySystem.alloc`,
   and flag point-in-time oversubscription. A plan with no
   ``mem/oversubscription`` finding interprets without `OutOfMemory` at
   those capacities (allocs are the interpreters' only OOM source).

2. **Lane-hazard race detection** (``race/*``) — build the
   happens-before relation the cost model defines (explicit `deps`;
   lane serialization within a ``lanes`` phase; total order within a
   ``serial`` phase; declared phase order as a barrier, since the
   makespan sums phase spans in that order) and flag pairs of ops that
   touch the same resource — a cache `SegmentKey`, an alloc ``(tier,
   name)`` slot, a pin — while unordered. Unordered same-resource ops
   mean list order is carrying semantics the dep graph does not, so a
   legal rewrite pass could reorder them and change behavior.

3. **Byte conservation + semantic lints** (``bytes/*``, ``lint/*``) —
   :func:`path_byte_totals` reads a plan's cold per-path byte totals
   statically; `PassPipeline(strict=True)` diffs them across every
   rewrite, plus rules for zero/negative-byte transfers, a probe's miss
   transfer not landing in the device tier, allocs whose tier no later op
   touches, out-of-range placement overrides, duplicate `SegmentKey`
   retains with conflicting fingerprints, and pins/payloads dangling
   after `release_payloads`.

The shard rules (``lint/bad-placement``, ``lint/shard-imbalance``) read
the cache by duck typing (`n_shards`, `owner_of`), so they stay silent on
the single-chip `TieredSegmentCache`.

Wiring: the interpreters take ``analyze=`` (None → the module default,
off unless `set_default_analyze(True)`); `PassPipeline(strict=True)`
analyzes after every pass and attaches findings to its `PassReport`s;
`EngineConfig.analyze_plans` forces it per serving engine.

The rule catalog and every finding follow `repro.core.analysis`, which the
tests hold them to.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.pipeline import (
    AllocOp,
    CacheProbeOp,
    ComputeOp,
    HostPreprocessOp,
    PipelinePlan,
    TransferOp,
)
from repro_torch.io.tiers import MemoryTier, TierSpec

__all__ = [
    "AnalysisReport",
    "Finding",
    "PlanAnalysisError",
    "RULES",
    "analyze_plan",
    "default_analyze",
    "diff_path_totals",
    "path_byte_totals",
    "set_default_analyze",
]

SEVERITY_ERROR = "error"
SEVERITY_WARNING = "warning"
SEVERITY_INFO = "info"

# The rule catalog, code for code and text for text `repro.core.analysis`'s.
# Codes are stable API: never renumber, only append.
RULES: Dict[str, str] = {
    "mem/oversubscription":
        "Replaying the plan's AllocOps exceeds a TierSpec capacity — the "
        "interpreters would raise OutOfMemory at this op.",
    "race/segment-key":
        "Two cache probes of the same SegmentKey are unordered in "
        "happens-before: a rewrite pass could legally reorder a retain "
        "past the probe that expects it resident.",
    "race/alloc-name":
        "Two AllocOps of the same (tier, name) slot are unordered: the "
        "surviving reservation depends on list order alone.",
    "race/pin":
        "Two probes pin the same graph's working set with different pin "
        "objects while unordered: which pin the cache ends up holding "
        "depends on list order alone.",
    "race/unconsumed-payload":
        "A payload-bearing stream op has no ComputeOp ordered after it: "
        "the upload's consumer is not tied down, so a rewrite could "
        "consume the double-buffer slot before the upload is ordered.",
    "bytes/path-delta":
        "A rewrite pass changed a plan's per-path byte totals (emitted "
        "by PassPipeline(strict=True), not by analyze_plan).",
    "lint/negative-bytes":
        "A transfer, alloc or probe declares negative bytes.",
    "lint/zero-byte-transfer":
        "A transfer moves zero bytes: it pays full path setup latency "
        "for no traffic.",
    "lint/miss-dst-tier":
        "A cache probe's miss transfer does not land in the device tier, "
        "but the probe's retain puts the value in the cache's device "
        "tier — the two accountings disagree.",
    "lint/alloc-unreferenced":
        "An AllocOp reserves a tier that no later op transfers through, "
        "computes on, or probes into.",
    "lint/bad-placement":
        "A probe's place_shard override is outside the segment cache's "
        "shard range.",
    "lint/dangling-pin":
        "A released plan (release_payloads ran) still holds a pin, "
        "payload or kernel closure — it would pin the working set the "
        "release exists to drop.",
    "lint/duplicate-key-conflict":
        "Two probes retain the same logical segment (graph, segment, "
        "wire format, shape) under conflicting content fingerprints — "
        "one of them is serving a stale generation.",
    "lint/shard-imbalance":
        "One shard owns more than 2x the mean per-shard wire bytes of "
        "the plan's cache probes — the owner map (CRC, partition, or "
        "placement overrides) is concentrating the working set on one "
        "shard. Emitted only for plans with at least 8 probes per shard; "
        "smaller plans cannot spread evenly by pigeonhole.",
}

# Module default for the interpreters' `analyze=None`: off in production
# (analysis costs O(ops²/64) per interpretation); tests and smoke runs turn
# it on with `set_default_analyze(True)`.
_DEFAULT_ANALYZE = False


def default_analyze() -> bool:
    return _DEFAULT_ANALYZE


def set_default_analyze(value: bool) -> bool:
    """Set the module default; returns the previous value (for restore)."""
    global _DEFAULT_ANALYZE
    previous = _DEFAULT_ANALYZE
    _DEFAULT_ANALYZE = bool(value)
    return previous


@dataclasses.dataclass(frozen=True)
class Finding:
    """One coded analyzer finding. `ops` are indices into `plan.ops`."""

    rule: str
    severity: str
    message: str
    ops: Tuple[int, ...] = ()

    def __str__(self) -> str:
        where = f" @ ops {list(self.ops)}" if self.ops else ""
        return f"[{self.severity}] {self.rule}{where}: {self.message}"


class PlanAnalysisError(ValueError):
    """A plan carries error-severity findings. Raised by
    `AnalysisReport.raise_for_errors()` — i.e. by the interpreters under
    ``analyze=True`` and by `PassPipeline(strict=True)` after a pass."""

    def __init__(self, report: "AnalysisReport"):
        self.report = report
        lines = "\n  ".join(str(f) for f in report.errors)
        super().__init__(
            f"plan {report.scheduler!r} failed static analysis with "
            f"{len(report.errors)} error(s):\n  {lines}")


@dataclasses.dataclass
class AnalysisReport:
    """All findings of one `analyze_plan` run, most severe first."""

    scheduler: str
    findings: List[Finding] = dataclasses.field(default_factory=list)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == SEVERITY_ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == SEVERITY_WARNING]

    @property
    def ok(self) -> bool:
        return not self.errors

    def by_rule(self, rule: str) -> List[Finding]:
        return [f for f in self.findings if f.rule == rule]

    def raise_for_errors(self) -> "AnalysisReport":
        if self.errors:
            raise PlanAnalysisError(self)
        return self


# ---- byte accounting (shared with PassPipeline strict mode + pass tests) ---


def path_byte_totals(plan: PipelinePlan) -> Dict[str, int]:
    """A plan's cold per-path byte totals, read statically.

    Every `TransferOp` counts its declared bytes; every `CacheProbeOp`
    counts its miss transfer (the cold, cache-empty reading — what the
    plan *moves* independent of live cache state). Rewrite passes
    re-arrange the same bytes, so this reading must be invariant across
    `PassPipeline.apply` — the `bytes/path-delta` rule."""
    totals: Dict[str, int] = {}
    for bound in plan.ops:
        op = bound.op
        if isinstance(op, TransferOp):
            t = op
        elif isinstance(op, CacheProbeOp):
            t = op.miss
        else:
            continue
        totals[t.path.value] = totals.get(t.path.value, 0) + int(t.nbytes)
    return totals


def diff_path_totals(before: Dict[str, int],
                     after: Dict[str, int]) -> Dict[str, int]:
    """Nonzero per-path deltas (after − before); {} iff bytes conserved."""
    return {p: after.get(p, 0) - before.get(p, 0)
            for p in set(before) | set(after)
            if after.get(p, 0) != before.get(p, 0)}


# ---- happens-before ---------------------------------------------------------


def _ancestor_masks(plan: PipelinePlan) -> List[int]:
    """Per-op bitmask of transitive happens-before predecessors.

    Edges mirror the cost model exactly: explicit `deps`; same-lane list
    order within a ``lanes`` phase (lane availability serializes); full
    list order within a ``serial`` phase (no overlap at all); and every
    op of an earlier-declared phase precedes every op of a later one
    (the makespan sums phase spans in declared order — a barrier)."""
    n = len(plan.ops)
    overlap = {ph.name: ph.overlap for ph in plan.phases}
    phase_mask: Dict[str, int] = {ph.name: 0 for ph in plan.phases}
    for i, bound in enumerate(plan.ops):
        phase_mask[bound.phase] |= 1 << i
    earlier: Dict[str, int] = {}
    acc = 0
    for ph in plan.phases:
        earlier[ph.name] = acc
        acc |= phase_mask[ph.name]

    anc = [0] * n
    last_serial: Dict[str, int] = {}
    last_lane: Dict[Tuple[str, str], int] = {}
    for i, bound in enumerate(plan.ops):
        mask = earlier.get(bound.phase, 0)
        if overlap.get(bound.phase, "lanes") == "serial":
            p = last_serial.get(bound.phase)
            if p is not None:
                mask |= anc[p] | (1 << p)
            last_serial[bound.phase] = i
        elif bound.lane:
            key = (bound.phase, bound.lane)
            p = last_lane.get(key)
            if p is not None:
                mask |= anc[p] | (1 << p)
            last_lane[key] = i
        for d in bound.deps:
            mask |= anc[d] | (1 << d)
        anc[i] = mask
    return anc


def _ordered(anc: List[int], i: int, j: int) -> bool:
    return bool((anc[j] >> i) & 1 or (anc[i] >> j) & 1)


# ---- the analyzer -----------------------------------------------------------


def analyze_plan(plan: PipelinePlan,
                 spec: Optional[TierSpec] = None,
                 segment_cache: Any = None,
                 released: bool = False) -> AnalysisReport:
    """Statically analyze `plan`; never interprets, charges or mutates.

    `spec` enables the tier-budget liveness rules (without capacities
    there is nothing to oversubscribe). `segment_cache` bounds placement
    overrides. `released=True` additionally checks the post-
    `release_payloads` contract (`lint/dangling-pin`). Structural
    problems still raise `PlanValidationError` — analysis assumes a
    structurally valid plan (deps backward, phases declared).
    """
    plan.validate()
    report = AnalysisReport(scheduler=plan.scheduler)
    if plan.oom:
        # The plan builder declared this plan infeasible; interpreters
        # return an OOM result without touching the op list, so there is
        # nothing to analyze.
        return report
    findings = report.findings
    anc = _ancestor_masks(plan)

    _check_liveness(plan, spec, findings)
    _check_races(plan, anc, findings)
    _check_lints(plan, segment_cache, findings)
    if released:
        _check_released(plan, findings)

    order = {SEVERITY_ERROR: 0, SEVERITY_WARNING: 1, SEVERITY_INFO: 2}
    findings.sort(key=lambda f: (order.get(f.severity, 3), f.rule, f.ops))
    return report


def _check_liveness(plan: PipelinePlan, spec: Optional[TierSpec],
                    findings: List[Finding]) -> None:
    """mem/*: symbolic AllocOp replay against the TierSpec capacities."""
    for i, bound in enumerate(plan.ops):
        op = bound.op
        if isinstance(op, AllocOp) and int(op.nbytes) < 0:
            findings.append(Finding(
                "lint/negative-bytes", SEVERITY_ERROR,
                f"alloc {op.name!r} reserves {op.nbytes} bytes", (i,)))
    if spec is None:
        return
    caps = {
        MemoryTier.DEVICE: spec.device_capacity,
        MemoryTier.HOST: spec.host_capacity,
        MemoryTier.STORAGE: spec.storage_capacity,
    }
    used: Dict[MemoryTier, int] = {t: 0 for t in caps}
    held: Dict[Tuple[MemoryTier, str], int] = {}
    blown: set = set()
    for i, bound in enumerate(plan.ops):
        op = bound.op
        if not isinstance(op, AllocOp) or int(op.nbytes) < 0:
            continue
        slot = (op.tier, op.name)
        # Same-name realloc replaces — mirror TieredMemorySystem.alloc.
        used[op.tier] += int(op.nbytes) - held.get(slot, 0)
        held[slot] = int(op.nbytes)
        if used[op.tier] > caps[op.tier] and op.tier not in blown:
            blown.add(op.tier)
            findings.append(Finding(
                "mem/oversubscription", SEVERITY_ERROR,
                f"alloc {op.name!r} brings {op.tier.value} residency to "
                f"{used[op.tier]} bytes, over the {caps[op.tier]}-byte "
                "capacity — interpretation would raise OutOfMemory here",
                (i,)))


def _check_races(plan: PipelinePlan, anc: List[int],
                 findings: List[Finding]) -> None:
    """race/*: same-resource op pairs unordered in happens-before."""
    by_key: Dict[Any, List[int]] = {}
    by_slot: Dict[Tuple[MemoryTier, str], List[int]] = {}
    by_pin: Dict[Any, List[int]] = {}
    payload_ops: List[int] = []
    consumed = 0
    for i, bound in enumerate(plan.ops):
        op = bound.op
        if isinstance(op, CacheProbeOp):
            by_key.setdefault(op.key, []).append(i)
            if op.pin is not None:
                gid = getattr(op.key, "graph_id", op.key)
                by_pin.setdefault(gid, []).append(i)
            if op.payload is not None:
                payload_ops.append(i)
        elif isinstance(op, AllocOp):
            by_slot.setdefault((op.tier, op.name), []).append(i)
        elif isinstance(op, TransferOp) and op.payload is not None:
            payload_ops.append(i)
        elif isinstance(op, ComputeOp):
            consumed |= anc[i]

    def flag_unordered(groups: Dict[Any, List[int]], rule: str,
                       severity: str, what: str) -> None:
        for res, members in groups.items():
            for a_pos, i in enumerate(members):
                for j in members[a_pos + 1:]:
                    if not _ordered(anc, i, j):
                        findings.append(Finding(
                            rule, severity,
                            f"ops {i} and {j} both touch {what} {res!r} "
                            "but neither happens-before the other",
                            (i, j)))

    flag_unordered(by_key, "race/segment-key", SEVERITY_ERROR,
                   "cache key")
    flag_unordered(by_slot, "race/alloc-name", SEVERITY_ERROR,
                   "alloc slot")
    # Pins race only when the pinned objects differ — re-pinning the same
    # working set from two unordered probes is idempotent.
    distinct_pins = {
        gid: members for gid, members in by_pin.items()
        if len({id(plan.ops[i].op.pin) for i in members}) > 1}
    flag_unordered(distinct_pins, "race/pin", SEVERITY_WARNING, "pin for")

    for i in payload_ops:
        if not (consumed >> i) & 1:
            findings.append(Finding(
                "race/unconsumed-payload", SEVERITY_WARNING,
                f"payload-bearing op {i} has no ComputeOp ordered after "
                "it — its double-buffer slot is consumed at an order the "
                "plan does not pin down", (i,)))


def _check_lints(plan: PipelinePlan, segment_cache: Any,
                 findings: List[Finding]) -> None:
    """lint/*: per-op semantic rules."""
    n_shards = getattr(segment_cache, "n_shards", None)
    tiers_after: List[set] = [set() for _ in plan.ops]
    touched: set = set()
    by_identity: Dict[Tuple, Dict[str, int]] = {}
    owner_bytes: Dict[int, int] = {}
    owned_probes = 0
    for i in range(len(plan.ops) - 1, -1, -1):
        tiers_after[i] = set(touched)
        touched |= _touched_tiers(plan.ops[i].op)

    for i, bound in enumerate(plan.ops):
        op = bound.op
        if isinstance(op, TransferOp):
            if int(op.nbytes) < 0:
                findings.append(Finding(
                    "lint/negative-bytes", SEVERITY_ERROR,
                    f"transfer {op.tag!r} moves {op.nbytes} bytes", (i,)))
            elif int(op.nbytes) == 0:
                findings.append(Finding(
                    "lint/zero-byte-transfer", SEVERITY_WARNING,
                    f"transfer {op.tag!r} on {op.path.value} moves zero "
                    "bytes but pays full setup latency", (i,)))
        elif isinstance(op, CacheProbeOp):
            if int(op.wire_bytes) < 0 or int(op.miss.nbytes) < 0:
                findings.append(Finding(
                    "lint/negative-bytes", SEVERITY_ERROR,
                    f"probe of {op.key!r} declares negative bytes", (i,)))
            if op.miss.dst is not MemoryTier.DEVICE:
                findings.append(Finding(
                    "lint/miss-dst-tier", SEVERITY_ERROR,
                    f"probe miss transfer lands in {op.miss.dst.value}, "
                    "but the retain puts the value in the cache's device "
                    "tier", (i,)))
            if op.place_shard is not None:
                bad = op.place_shard < 0 or (
                    n_shards is not None and op.place_shard >= n_shards)
                if bad:
                    findings.append(Finding(
                        "lint/bad-placement", SEVERITY_ERROR,
                        f"place_shard={op.place_shard} is outside the "
                        f"cache's shard range [0, {n_shards})", (i,)))
            ident = (getattr(op.key, "graph_id", None),
                     getattr(op.key, "segment_id", None),
                     getattr(op.key, "wire_format", None),
                     getattr(op.key, "shape", None))
            fp = getattr(op.key, "fingerprint", None)
            if None not in ident and fp is not None:
                by_identity.setdefault(ident, {}).setdefault(fp, i)
            # Owner-balance accounting: a place_shard override wins, else
            # the cache's owner map (partition or CRC) resolves the key.
            if n_shards is not None and n_shards > 1:
                s = op.place_shard
                if s is None and hasattr(segment_cache, "owner_of"):
                    s = segment_cache.owner_of(op.key)
                if s is not None and 0 <= int(s) < n_shards:
                    owner_bytes[int(s)] = (owner_bytes.get(int(s), 0)
                                           + int(op.wire_bytes))
                    owned_probes += 1
        elif isinstance(op, AllocOp):
            if op.tier not in tiers_after[i]:
                findings.append(Finding(
                    "lint/alloc-unreferenced", SEVERITY_WARNING,
                    f"alloc {op.name!r} reserves {op.tier.value} but no "
                    "later op transfers through, computes on, or probes "
                    "into that tier", (i,)))

    for ident, fps in by_identity.items():
        if len(fps) > 1:
            findings.append(Finding(
                "lint/duplicate-key-conflict", SEVERITY_ERROR,
                f"segment {ident!r} is retained under "
                f"{len(fps)} conflicting fingerprints "
                f"{sorted(fps)!r} — one generation is stale",
                tuple(sorted(fps.values()))))

    # Probe-count gate: below 8 probes per shard, one big segment can
    # exceed 2x the mean by pigeonhole alone — only enough probes make
    # imbalance a property of the owner map rather than of granularity.
    if (n_shards is not None and n_shards > 1
            and owned_probes >= 8 * n_shards):
        total = sum(owner_bytes.values())
        mean = total / n_shards
        worst = max(owner_bytes, key=lambda s: (owner_bytes[s], -s))
        if mean > 0 and owner_bytes[worst] > 2 * mean:
            findings.append(Finding(
                "lint/shard-imbalance", SEVERITY_WARNING,
                f"shard {worst} owns {owner_bytes[worst]} of the plan's "
                f"{total} probe wire bytes — more than 2x the "
                f"{mean:.0f}-byte per-shard mean across {n_shards} "
                "shards", ()))


def _touched_tiers(op: Any) -> set:
    """Which memory tiers an op reads or writes (for alloc-unreferenced)."""
    if isinstance(op, TransferOp):
        return {op.src, op.dst}
    if isinstance(op, CacheProbeOp):
        return {op.miss.src, op.miss.dst, MemoryTier.DEVICE}
    if isinstance(op, ComputeOp):
        return {MemoryTier.DEVICE}
    if isinstance(op, HostPreprocessOp):
        return {MemoryTier.HOST}
    return set()


def _check_released(plan: PipelinePlan, findings: List[Finding]) -> None:
    """lint/dangling-pin: the post-release_payloads contract."""
    for i, bound in enumerate(plan.ops):
        op = bound.op
        leftovers = []
        if isinstance(op, CacheProbeOp):
            if op.pin is not None:
                leftovers.append("pin")
            if op.payload is not None or op.miss.payload is not None:
                leftovers.append("payload")
        elif isinstance(op, TransferOp) and op.payload is not None:
            leftovers.append("payload")
        elif isinstance(op, ComputeOp) and op.kernel is not None:
            leftovers.append("kernel")
        if leftovers:
            findings.append(Finding(
                "lint/dangling-pin", SEVERITY_ERROR,
                f"released plan still holds {'+'.join(leftovers)} on op "
                f"{i} — release_payloads exists to drop exactly these",
                (i,)))
    if plan.reference_kernel is not None:
        findings.append(Finding(
            "lint/dangling-pin", SEVERITY_ERROR,
            "released plan still holds its reference kernel", ()))
