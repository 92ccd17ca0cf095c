"""Schedule autotuner: search plan knobs by calibrated predicted makespan.

AIRES's schedule has knobs the static defaults cannot pick per graph:

  * `TransferCoalescingPass.min_bytes` — the merge threshold below which
    per-transfer setup latency dominates depends on the (calibrated)
    path's ``bw·latency`` product, not a universal ``1<<18``;
  * the **ELL bucket set** — power-of-two buckets bound compiled-kernel
    count but can pad a narrow-spread graph's bricks far past its true
    tile widths (rUSA-style near-planar graphs pad ~2×); an explicit
    bucket set fitted to the width distribution streams fewer bytes;
  * **pass order** — shard placement before coalescing sees per-brick
    probes; after, it sees merged DMAs.

`autotune_schedule` prices candidates over the plan IR itself: rebuild
the raw stream plan (`AiresSpGEMM.stream_plan(..., apply_passes=False)` —
rewrite passes mutate ops in place, so every trial gets a fresh plan),
apply the candidate `PassPipeline`, and read
`PipelinePlan.estimate(spec)` under the **calibrated** spec the caller
passes (`ServingEngine.cost_spec()`), cold-cache like admission control.
Bucket sets are pre-screened analytically — per-segment true tile widths
(`segment_ell_widths`, no densification) price each candidate set's
exact BlockELL bytes — and only the byte-minimizing set is densified for
a full plan trial. The default arm (power-of-two buckets, documented
``1<<18`` threshold, default pass order) is always in the candidate set,
so the returned `TunedSchedule` is never predicted worse than default.

The engine installs the result via `ServingEngine.install_schedule`.

A copy of `repro.core.autotune`; the tests hold the `TunedSchedule` of
both packages equal on the same graph and spec. Trial engines plan on the
CPU: they price plans and never stream, so no brick of theirs is pinned.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.passes import (
    PassPipeline,
    PlanPass,
    ShardPlacementPass,
    TransferCoalescingPass,
)
from repro_torch.core.memory_model import ell_bucket_capacity
from repro_torch.core.robw import segment_ell_widths
from repro_torch.io.tiers import TierSpec
from repro_torch.sparse.formats import CSR

__all__ = ["TunedSchedule", "autotune_schedule", "candidate_bucket_sets",
           "bucket_set_bytes"]

DEFAULT_MIN_BYTES = 1 << 18
DEFAULT_PASS_ORDER: Tuple[str, ...] = ("shard-placement",
                                       "transfer-coalescing")
# min_bytes grid: the documented default, a decade around it, and None —
# the spec-derived bw·latency threshold (calibration moves it).
MIN_BYTES_GRID: Tuple[Optional[int], ...] = (
    DEFAULT_MIN_BYTES, None, 1 << 14, 1 << 16, 1 << 20)


@dataclasses.dataclass(frozen=True)
class TunedSchedule:
    """One (graph, system) tuning verdict — what the engine installs.

    `min_bytes=None` means the spec-derived coalescing threshold;
    `ell_buckets=None` keeps the power-of-two bucket ladder (the
    bit-exact default)."""

    graph: str
    min_bytes: Optional[int]
    pass_order: Tuple[str, ...]
    ell_buckets: Optional[Tuple[int, ...]]
    predicted_makespan_s: float
    default_makespan_s: float
    # Exact BlockELL bytes the plan streams under the chosen vs the
    # power-of-two bucket set (equal when ell_buckets is None).
    ell_bytes: int = 0
    default_ell_bytes: int = 0
    # Partition-aware sharding (sparse.partition): cluster count for
    # connectivity-clustered owner maps, None = CRC owners (the bit-exact
    # default). Priced by modeled warm-epoch ICI bytes, not makespan — a
    # cold plan cannot see owner placement.
    partition_clusters: Optional[int] = None
    warm_ici_bytes: int = 0
    default_warm_ici_bytes: int = 0

    @property
    def predicted_speedup(self) -> float:
        return self.default_makespan_s / max(self.predicted_makespan_s,
                                             1e-300)

    @property
    def is_default(self) -> bool:
        return (self.min_bytes == DEFAULT_MIN_BYTES
                and self.pass_order == DEFAULT_PASS_ORDER
                and self.ell_buckets is None
                and self.partition_clusters is None)

    def build_passes(self) -> List[PlanPass]:
        """Instantiate the tuned plan-rewrite passes, in tuned order."""
        made: List[PlanPass] = []
        for name in self.pass_order:
            if name == "shard-placement":
                made.append(ShardPlacementPass())
            elif name == "transfer-coalescing":
                made.append(TransferCoalescingPass(min_bytes=self.min_bytes))
            else:
                raise ValueError(f"unknown tuned pass {name!r}")
        return made

    def describe(self) -> str:
        mb = ("spec-derived" if self.min_bytes is None
              else str(self.min_bytes))
        buckets = ("pow2" if self.ell_buckets is None
                   else list(self.ell_buckets))
        part = ("crc" if self.partition_clusters is None
                else f"{self.partition_clusters} clusters "
                     f"({self.warm_ici_bytes}B warm-ICI vs "
                     f"{self.default_warm_ici_bytes}B)")
        return (f"TunedSchedule({self.graph}: min_bytes={mb}, "
                f"order={'>'.join(self.pass_order)}, buckets={buckets}, "
                f"owners={part}, "
                f"predicted {self.predicted_makespan_s:.3e}s vs default "
                f"{self.default_makespan_s:.3e}s, "
                f"x{self.predicted_speedup:.3f})")


# ---- ELL bucket-set pricing (analytical, no densification) -----------------


def bucket_set_bytes(widths: Sequence[int], seg_rows: Sequence[int],
                     buckets: Optional[Sequence[int]],
                     bm: int, bk: int, dtype_bytes: int = 4) -> int:
    """Exact bytes of every segment's BlockELL brick under a bucket set.

    Mirrors `BlockELL.nbytes()` exactly: blocks
    ``(n_row_blocks, cap, bm, bk)`` at `dtype_bytes` + int32 col_tile
    ``(n_row_blocks, cap)`` + int32 n_tiles ``(n_row_blocks,)``, with
    ``cap = ell_bucket_capacity(true_width, buckets)``. Raises
    ValueError when a segment's true width exceeds every bucket (the
    set would truncate nonzeros — `ell_bucket_capacity` refuses)."""
    total = 0
    for w, rows in zip(widths, seg_rows):
        cap = ell_bucket_capacity(int(w), list(buckets) if buckets else None)
        nrb = max(1, (int(rows) + bm - 1) // bm)
        total += nrb * cap * bm * bk * dtype_bytes   # blocks
        total += nrb * cap * 4                       # col_tile (int32)
        total += nrb * 4                             # n_tiles (int32)
    return total


def candidate_bucket_sets(widths: Sequence[int], max_buckets: int = 4
                          ) -> List[Optional[Tuple[int, ...]]]:
    """Candidate ELL bucket sets for a graph's true-width distribution:
    always None (the power-of-two default), plus the exact distinct-width
    set when small enough, else a quantile ladder capped at
    `max_buckets` buckets (always including the max width — a set that
    cannot hold the widest segment is invalid)."""
    cands: List[Optional[Tuple[int, ...]]] = [None]
    uniq = sorted(set(int(w) for w in widths))
    if not uniq:
        return cands
    if len(uniq) <= max_buckets:
        cands.append(tuple(uniq))
    else:
        qs = {uniq[int(q * (len(uniq) - 1))]
              for q in (0.25, 0.5, 0.75)} | {uniq[-1]}
        cands.append(tuple(sorted(qs)))
    return cands


# ---- the search ------------------------------------------------------------


def _trial_makespan(engine, a: CSR, shape, spec: TierSpec,
                    passes: List[PlanPass], segment_cache) -> float:
    """Price one candidate: fresh raw plan → candidate pipeline →
    cold-cache estimate (the same reading admission control uses)."""
    plan = engine.stream_plan(a, shape, spec=spec, apply_passes=False)
    pipe = PassPipeline(passes, spec=spec, track_costs=False)
    plan, _ = pipe.apply(plan, spec=spec, segment_cache=segment_cache)
    return plan.estimate(spec).makespan_s


def autotune_schedule(engine, a: CSR, graph: str, width: int,
                      spec: TierSpec, segment_cache=None,
                      min_bytes_grid: Sequence[Optional[int]] = MIN_BYTES_GRID,
                      bucket_sets: Optional[Sequence[Optional[Sequence[int]]]]
                      = None, max_buckets: int = 4,
                      cluster_grid: Optional[Sequence[int]] = None
                      ) -> TunedSchedule:
    """Search (min_bytes × pass order × ELL bucket set) for one graph on
    one (calibrated) system spec; returns the best `TunedSchedule`.

    `engine` is the graph's `AiresSpGEMM`; `spec` the spec to price
    against — pass `ServingEngine.cost_spec()` for the calibrated view.
    The default configuration is always a candidate, so the result's
    `predicted_makespan_s` is ≤ `default_makespan_s` by construction.
    """
    shape = (a.shape[0], int(width))
    cfg = engine.config

    # Arm 1: (min_bytes, pass order) over the current bucket config.
    orders = [DEFAULT_PASS_ORDER] + [
        o for o in itertools.permutations(DEFAULT_PASS_ORDER)
        if tuple(o) != DEFAULT_PASS_ORDER]
    best: Optional[Tuple[float, Optional[int], Tuple[str, ...]]] = None
    default_makespan = None
    for order in orders:
        for mb in min_bytes_grid:
            passes: List[PlanPass] = []
            for name in order:
                passes.append(ShardPlacementPass()
                              if name == "shard-placement"
                              else TransferCoalescingPass(min_bytes=mb))
            makespan = _trial_makespan(engine, a, shape, spec, passes,
                                       segment_cache)
            if (tuple(order) == DEFAULT_PASS_ORDER
                    and mb == DEFAULT_MIN_BYTES):
                default_makespan = makespan
            # Strict < : ties keep the earlier (more default) candidate.
            if best is None or makespan < best[0]:
                best = (makespan, mb, tuple(order))
    assert best is not None and default_makespan is not None
    best_makespan, best_mb, best_order = best

    # Arm 2: ELL bucket sets, pre-screened by exact brick bytes. Only the
    # byte-minimizing non-default set is densified for a full plan trial.
    plan = engine._prepare(a, shape, transpose=False).plan
    widths = segment_ell_widths(a, plan, bm=cfg.bm, bk=cfg.bk)
    seg_rows = [s.row_end - s.row_start for s in plan.segments]
    default_bytes = bucket_set_bytes(widths, seg_rows, None, cfg.bm, cfg.bk)
    cands = (list(bucket_sets) if bucket_sets is not None
             else candidate_bucket_sets(widths, max_buckets=max_buckets))
    best_buckets: Optional[Tuple[int, ...]] = None
    best_bytes = default_bytes
    for cand in cands:
        if cand is None:
            continue
        try:
            nbytes = bucket_set_bytes(widths, seg_rows, cand,
                                      cfg.bm, cfg.bk)
        except ValueError:
            continue  # set cannot hold the widest segment
        if nbytes < best_bytes:
            best_bytes, best_buckets = nbytes, tuple(int(b) for b in cand)

    if best_buckets is not None:
        # Full-plan trial under the candidate bucket set: a throwaway
        # AiresSpGEMM (its cache namespaces carry a bucket tag, so the
        # live engine's keys are untouched) densifies once.
        from repro_torch.core.spgemm import AiresSpGEMM
        cfg2 = dataclasses.replace(cfg, ell_buckets=list(best_buckets),
                                   device="cpu")
        eng2 = AiresSpGEMM(cfg2, segment_cache=segment_cache)
        passes = []
        for name in best_order:
            passes.append(ShardPlacementPass()
                          if name == "shard-placement"
                          else TransferCoalescingPass(min_bytes=best_mb))
        bucket_makespan = _trial_makespan(eng2, a, shape, spec, passes,
                                          segment_cache)
        if bucket_makespan < best_makespan:
            best_makespan = bucket_makespan
        else:
            best_buckets = None
    if best_buckets is None:
        best_bytes = default_bytes

    # Arm 3: partition cluster count, priced by modeled warm-epoch ICI
    # bytes (Σ brick bytes × hops to its owner) — the quantity
    # connectivity-clustered owner maps exist to cut. Cold makespan
    # cannot see it: a cold plan streams every brick from host no matter
    # who owns it. Trials run on throwaway engines with NO cache
    # attached, so the live cache's namespaces, pins, and owner maps are
    # untouched (and the `:p{k}` namespace tag isolates them even if a
    # caller wires a cache in later). Strict <, so a uniform graph — or
    # an unsharded cache — keeps the bit-exact CRC default.
    partition_clusters: Optional[int] = None
    warm_ici = default_ici = 0
    n_shards = int(getattr(segment_cache, "n_shards", 1) or 1)
    if n_shards > 1 and hasattr(segment_cache, "ici_hops"):
        from repro_torch.core.spgemm import AiresSpGEMM
        from repro_torch.io.shard_cache import shard_of
        from repro_torch.sparse.partition import partition_graph
        prep0 = engine._prepare(a, shape, transpose=False)
        default_ici = sum(
            ell.nbytes() * segment_cache.ici_hops(shard_of(k, n_shards))
            for ell, k in zip(prep0.ells, engine._segment_keys(prep0)))
        warm_ici = default_ici
        grid = (tuple(cluster_grid) if cluster_grid is not None
                else (n_shards, 2 * n_shards, 4 * n_shards))
        cfg3 = dataclasses.replace(
            cfg, device="cpu",
            ell_buckets=(list(best_buckets) if best_buckets is not None
                         else cfg.ell_buckets))
        for k in grid:
            if not 1 < int(k) <= a.shape[0]:
                continue
            part = partition_graph(
                a, int(k), n_shards=n_shards,
                topology=segment_cache.topology,
                local_shard=segment_cache.local_shard)
            eng3 = AiresSpGEMM(cfg3, partition=part)
            prep3 = eng3._prepare(a, shape, transpose=False)
            owners = part.owners_for_plan(prep3.plan)
            trial = sum(ell.nbytes() * segment_cache.ici_hops(o)
                        for ell, o in zip(prep3.ells, owners))
            if trial < warm_ici:  # ties keep fewer clusters / the default
                warm_ici, partition_clusters = trial, int(k)

    return TunedSchedule(
        graph=graph, min_bytes=best_mb, pass_order=best_order,
        ell_buckets=best_buckets, predicted_makespan_s=best_makespan,
        default_makespan_s=default_makespan,
        ell_bytes=best_bytes, default_ell_bytes=default_bytes,
        partition_clusters=partition_clusters,
        warm_ici_bytes=int(warm_ici),
        default_warm_ici_bytes=int(default_ici))
