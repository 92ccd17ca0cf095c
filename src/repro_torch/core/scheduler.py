"""AIRES three-phase dynamic scheduling (paper Alg. 2, Fig. 5) + baselines.

The paper's methodology: host-side preprocessing (RoBW partitioning, tile
densification, partial-row merging for baselines) is **executed and
wall-clock measured**; I/O transfers and device kernel latency are
**modeled** with the tiered-memory cost model — the split the paper uses
(§V-A: "We model the I/O transfer operations and kernel-level computation
latency with simulations"). The modeled seconds are priced under the
`TierSpec` a scheduler is given (`PAPER_GPU_SYSTEM` for the paper's
figures): they are cost-model output, not times on the card.

Every scheduler is a pure **plan builder**: `build_plan()` emits a typed
`core.pipeline.PipelinePlan` (ops on declared resource lanes, grouped into
phases), and `run()` hands that one plan to an interpreter —
`CostInterpreter` for ``simulate`` (the paper's large-scale accounting),
`ExecuteInterpreter` for ``execute`` (the product computed for real on the
scheduler's device). Simulate and execute cannot diverge on I/O
accounting: they interpret the same op list.

Schedulers:
  AiresScheduler     — C1+C2+C4+C5: RoBW alignment, Eq.5-7 planning,
                       dual-way Phase I, double-buffered Phase II,
                       on-device C for chaining (Phase III). Execute mode
                       streams each segment's bricks through the Block-ELL
                       SpMM kernel (`kernels.bcsr_spmm`) against a
                       resident H.
  MaxMemoryScheduler — naive max-rows static split; partial-row merge cost.
  UCGScheduler       — unified-memory reads, CPU-GPU split, no alignment.
  ETCScheduler       — batched DMA with dedup + pipeline, output allocated
                       at the larger-input size (paper §III-B), no alignment.
  The baselines' execute mode computes the exact product with one plain
  sparse product on the device: their correctness story is not the
  streamed pipeline.

Policy flags mirror paper Table I (Alignment / DMA / UM / Dual-way). The
plans and their modeled metrics follow `repro.core.scheduler` op for op,
which the tests hold them to.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Literal, Optional

import numpy as np
import torch

from repro_torch.core.memory_model import (
    FeatureSpec,
    MemoryEstimate,
    plan_memory_unified,
    required_bytes,
)
from repro_torch.core.pipeline import (
    LANE_COMPUTE,
    LANE_DMA,
    LANE_GDS,
    LANE_HOST,
    LANE_SIO,
    LANE_UM,
    AllocOp,
    CacheProbeOp,
    ComputeOp,
    CostInterpreter,
    ExecuteInterpreter,
    HostPreprocessOp,
    PhaseSpec,
    PipelinePlan,
    ScheduleMetrics,
    TransferOp,
    modeled_spgemm_seconds,
)
from repro_torch.core.robw import (
    RoBWPlan,
    merge_partial_rows,
    naive_partition,
    robw_partition,
    segments_to_block_ell,
)
from repro_torch.io.segment_cache import SegmentKey, TieredSegmentCache
from repro_torch.io.tiers import (
    MemoryTier,
    Path,
    TierSpec,
)
from repro_torch.sparse.formats import CSR, csr_fingerprint

__all__ = [
    "SCHEDULERS", "AiresScheduler", "ETCScheduler", "MaxMemoryScheduler",
    "ScheduleMetrics", "ScheduleResult", "UCGScheduler",
]


@dataclasses.dataclass
class ScheduleResult:
    x: Optional[torch.Tensor]        # output on the device (execute) or None
    metrics: ScheduleMetrics
    plan: Optional[RoBWPlan] = None
    mem: Optional[MemoryEstimate] = None
    pipeline: Optional[PipelinePlan] = None   # the IR both interpreters read
    # Per-pass before/after cost deltas when a PassPipeline rewrote the
    # plan (core.passes.PassReport); empty without passes.
    pass_reports: list = dataclasses.field(default_factory=list)


def _spgemm_flops(a: CSR, f: int) -> float:
    return 2.0 * a.nnz * f


class _BaseScheduler:
    """Shared accounting + `run()`: build, rewrite, interpret.

    Feasibility calibration (`oom_fraction`): Table III shows each baseline's
    minimum viable budget as a fraction of Table II's memory requirement —
    MaxMemory/UCG need ≳85 % of (A+B+C), ETC ≳72 % (output allocated at the
    larger input's size), AIRES is bounded only by Eq. 7's p>0. We encode
    those observed thresholds as policy constants; the *latency* model below
    them is mechanistic (transfers, merges, overlap), not curve-fit.
    """

    name = "base"
    oom_fraction = 0.0  # min budget / required_bytes; 0 → model-driven only
    segment_cache: Optional[TieredSegmentCache] = None

    def __init__(
        self,
        spec: TierSpec,
        device_budget: Optional[int] = None,
        peak_flops: float = 82.6e12,       # RTX4090-class fp32 (cost model)
        compute_efficiency: float = 0.20,  # share of memory bw sparse kernels reach
        passes=None,                       # Optional[core.passes.PassPipeline]
        device: "str | torch.device" = "cuda",
    ):
        self.spec = spec
        # Where execute mode computes: the output buffer, the resident H
        # and every kernel launch. Simulate mode touches no device, so the
        # device is resolved (and a missing card raises) only on execute.
        self.device = torch.device(device)
        self.device_budget = device_budget or spec.device_capacity
        self.peak_flops = peak_flops
        self.compute_efficiency = compute_efficiency
        # Plan-rewrite passes applied between build_plan() and the
        # interpreter (run() = build → rewrite → interpret). None — and
        # the empty PassPipeline — are the identity: bit-exact with the
        # pass-free pipeline.
        self.passes = passes

    def _execute_device(self) -> torch.device:
        from repro_torch.core.spgemm import resolve_device
        return resolve_device(self.device)

    def _kernel_seconds(self, flops: float) -> float:
        return flops / (self.peak_flops * self.compute_efficiency)

    def _spgemm_seconds(self, nnz: int, feat: FeatureSpec) -> float:
        return modeled_spgemm_seconds(nnz, feat, self.spec,
                                      self.compute_efficiency)

    def _host_seconds(self, nbytes: float, events: int = 1) -> float:
        """Modeled host staging/merge cost: DRAM memcpy + per-event latency.

        Host costs are modeled (not wall-clock measured) so that scaled-down
        benchmark graphs keep the full-scale cost *ratios*: at 1/1000 scale a
        measured Python-loop overhead would swamp µs-scale modeled
        transfers. Execute mode still runs the real work; tests compare its
        outputs, not its timing.
        """
        return nbytes / self.spec.host_memcpy_bw \
            + events * self.spec.host_op_latency_s

    @staticmethod
    def _feat(h) -> FeatureSpec:
        return FeatureSpec.of(h)

    def _budget_infeasible(self, a: CSR, feat: FeatureSpec) -> bool:
        if self.oom_fraction <= 0.0:
            return False
        return self.device_budget < self.oom_fraction * required_bytes(a, feat)

    def build_plan(self, a: CSR, h,
                   mode: Literal["simulate", "execute"] = "simulate",
                   dataset: str = "") -> PipelinePlan:
        raise NotImplementedError

    def run(self, a: CSR, h,
            mode: Literal["simulate", "execute"] = "simulate",
            dataset: str = "") -> ScheduleResult:
        """Build the plan, rewrite it, interpret it.

        One plan — rewritten once by the optional `passes` PassPipeline
        (validated after every pass, per-pass cost deltas in
        `ScheduleResult.pass_reports`) — then handed to either interpreter.
        """
        plan = self.build_plan(a, h, mode=mode, dataset=dataset)
        pass_reports = []
        if self.passes is not None:
            plan, pass_reports = self.passes.apply(
                plan, spec=self.spec, segment_cache=self.segment_cache)
        cls = ExecuteInterpreter if mode == "execute" else CostInterpreter
        interp = cls(self.spec, segment_cache=self.segment_cache)
        metrics, x = interp.run(plan)
        # The returned plan keeps op metadata (re-estimable) but not the
        # densified bricks / kernel closures it was executed with.
        plan.release_payloads()
        return ScheduleResult(x=x, metrics=metrics, plan=plan.robw,
                              mem=plan.mem, pipeline=plan,
                              pass_reports=pass_reports)


class AiresScheduler(_BaseScheduler):
    """C1+C2+C4+C5 — the paper's contribution.

    Execute mode needs bricks the SpMM kernel's zero-skipping route takes
    (`bm = bk = 8`, the plans' shape); the reference's 128x128 default
    stays the default here, so the modeled plans match its own.
    """

    name = "aires"

    def __init__(self, *args, bm: int = 128, bk: int = 128, align: int = 8,
                 wire_format: Literal["csr", "bricks"] = "csr",
                 segment_cache: Optional[TieredSegmentCache] = None,
                 partition=None, **kw):
        super().__init__(*args, **kw)
        self.bm = bm
        self.bk = bk
        self.align = align
        # Optional sparse.partition.Partition: RoBW tiles over its cluster
        # boundaries, the cache namespace carries a `:p{k}` tag, and the
        # partition-derived owner map is installed on a sharded segment
        # cache before probes are priced. None = unpartitioned.
        self.partition = partition
        # "csr": stream raw compressed segments (paper-faithful wire format,
        #        densification happens device-side); "bricks": stream
        #        densified BlockELL bricks (the port's wire format).
        self.wire_format = wire_format
        # Optional TieredSegmentCache shared across runs: cache-hit segments
        # skip the Phase II DMA transfer (device-tier hit) or pay only the
        # promotion (host-tier hit), both visible in bytes_by_path; skipped
        # wire bytes are reported in metrics.cache_hit_bytes.
        self.segment_cache = segment_cache

    def build_plan(self, a: CSR, h, mode="simulate",
                   dataset="") -> PipelinePlan:
        feat = self._feat(h)
        f = feat.n_cols
        plan = PipelinePlan(scheduler=self.name, dataset=dataset)

        # ---- Phase 0: analytical planning (Eq. 5-7), no data touched.
        mem = plan_memory_unified(a, feat, m_total=self.device_budget)
        plan.mem = mem
        if not mem.feasible:
            plan.oom = True
            return plan
        plan.phases = [PhaseSpec("load"), PhaseSpec("stream"),
                       PhaseSpec("store")]

        # ---- Phase I: dual-way loads. B/H ride the direct storage→device
        # path (GDS analogue) on their own lane; A crosses storage→host and
        # feeds the RoBW pass — the two chains overlap (Fig. 5).
        plan.add(AllocOp(MemoryTier.DEVICE, "H", int(mem.m_b)), "load")
        plan.add(AllocOp(MemoryTier.DEVICE, "C", int(mem.m_c)), "load")
        plan.add(TransferOp(Path.GDS, MemoryTier.STORAGE, MemoryTier.DEVICE,
                            int(mem.m_b), tag="phaseI/H"), "load", LANE_GDS)
        a_bytes = a.nbytes()
        plan.add(AllocOp(MemoryTier.HOST, "A", a_bytes), "load")
        i_load_a = plan.add(
            TransferOp(Path.STORAGE_HOST, MemoryTier.STORAGE, MemoryTier.HOST,
                       a_bytes, tag="phaseI/A"), "load", LANE_SIO)

        # RoBW partitioning on the CPU: executed for real at build time; its
        # makespan contribution is modeled as one indptr scan + per-segment
        # events (see _host_seconds for why).
        part = self.partition
        if part is not None and part.n_rows != a.shape[0]:
            part = None  # built for a different graph: ignore it
        t0 = time.perf_counter()
        robw = robw_partition(
            a, int(mem.m_a), align=self.align,
            boundaries=None if part is None else part.boundaries())
        measured = time.perf_counter() - t0
        plan.robw = robw
        plan.segments = robw.n_segments
        plan.add(HostPreprocessOp(
            self._host_seconds(a.indptr.nbytes, events=robw.n_segments),
            measured_s=measured), "load", LANE_HOST, deps=(i_load_a,))

        # ---- Phase II: double-buffered streaming + per-segment compute.
        # DMA-lane serialization + compute→transfer deps reproduce the
        # double-buffer recurrence (segment k+1's transfer overlaps segment
        # k's compute; each resource is serial).
        execute = mode == "execute"
        ell_iter = (segments_to_block_ell(a, robw, bm=self.bm, bk=self.bk)
                    if execute or self.wire_format == "bricks" else None)
        ells = (list(ell_iter) if ell_iter is not None
                else [None] * robw.n_segments)
        h_dev = None
        if execute:
            plan.out_shape = (a.n_rows, f)
            plan.device = self._execute_device()
            # Phase I's resident B: H reaches the device once, and every
            # segment's kernel reads it there.
            h_dev = torch.as_tensor(h).to(
                device=plan.device, dtype=torch.float32).contiguous()

        cache = self.segment_cache
        # "sim:" prefix keeps simulate-mode token entries from ever aliasing
        # an execute-mode device payload in a shared cache. The graph id is
        # a content fingerprint, never id(a): CPython reuses ids after GC,
        # which could alias two different graphs into one namespace.
        graph_ns = (f"sim:g{csr_fingerprint(a)}:{a.nnz}"
                    f":{a.shape[0]}x{a.shape[1]}:w{f}:b{self.device_budget}"
                    f"{'' if part is None else f':p{part.n_clusters}'}")
        if (cache is not None and part is not None and part.n_shards > 1
                and hasattr(cache, "install_owner_map")
                and part.n_shards == getattr(cache, "n_shards", 1)):
            clusters = part.clusters_for_plan(robw)
            cache.install_owner_map(
                graph_ns,
                [int(part.cluster_to_shard[c]) for c in clusters],
                clusters)
        for i, (seg, ell) in enumerate(zip(robw.segments, ells)):
            if self.wire_format == "bricks" and ell is not None:
                wire_bytes = ell.nbytes()
                wire_shape = tuple(ell.blocks.shape)
            else:
                wire_bytes = seg.nbytes
                wire_shape = (seg.n_rows, seg.nnz)
            miss = TransferOp(Path.DMA, MemoryTier.HOST, MemoryTier.DEVICE,
                              wire_bytes, tag="phaseII/seg")
            if cache is not None:
                key = SegmentKey(graph_ns, i, self.wire_format, wire_shape)
                i_io = plan.add(
                    CacheProbeOp(key, wire_bytes, miss,
                                 value=ell if ell is not None else True,
                                 pin=a), "stream", LANE_DMA)
            else:
                i_io = plan.add(miss, "stream", LANE_DMA)
            kernel = (self._segment_kernel(ell, seg, h_dev)
                      if execute and ell is not None else None)
            plan.add(ComputeOp(self._spgemm_seconds(seg.nnz, feat),
                               kernel=kernel),
                     "stream", LANE_COMPUTE, deps=(i_io,))

        # ---- Phase III: C stays on device for chaining; final store of the
        # compressed output via the direct storage path.
        plan.add(TransferOp(Path.GDS, MemoryTier.DEVICE, MemoryTier.STORAGE,
                            int(mem.m_c), tag="phaseIII/C"), "store", LANE_GDS)
        return plan

    @staticmethod
    def _segment_kernel(ell, seg, h_dev: torch.Tensor):
        """Execute-mode thunk: upload this segment's bricks, run the
        Block-ELL SpMM kernel against the resident H and write the
        segment's row slice of the output buffer."""
        def kernel(out: torch.Tensor) -> None:
            from repro_torch.kernels.ops import bcsr_spmm

            dev = h_dev.device
            bricks = [torch.from_numpy(x).to(dev, non_blocking=True)
                      for x in (ell.blocks, ell.col_tile, ell.n_tiles)]
            x_seg = bcsr_spmm(dataclasses.replace(
                ell, blocks=bricks[0], col_tile=bricks[1],
                n_tiles=bricks[2]), h_dev)
            out[seg.row_start:seg.row_end] = x_seg[: seg.n_rows]
        return kernel


def _reference_kernel(a: CSR, h, device: torch.device):
    """Baseline execute mode: the exact output from one plain sparse
    product on `device` (the baselines' correctness story is not the
    streamed pipeline)."""
    def kernel() -> torch.Tensor:
        rows = np.repeat(np.arange(a.n_rows, dtype=np.int64),
                         np.diff(a.indptr))
        a_dev = torch.sparse_coo_tensor(
            torch.from_numpy(np.stack([rows, a.indices.astype(np.int64)])),
            torch.from_numpy(a.data.astype(np.float32)), a.shape,
            check_invariants=True).to(device)
        h_dev = torch.as_tensor(h).to(device=device, dtype=torch.float32)
        return torch.sparse.mm(a_dev, h_dev)
    return kernel


class MaxMemoryScheduler(_BaseScheduler):
    """Naive static split: maximize rows per segment, merge partial rows.

    Models the paper's MaxMemory baseline: equal static allocation for A and
    B on device; segments cut at byte budget regardless of row boundaries;
    partial rows bounce back to host for merging (measured numpy work) and
    are re-transferred (modeled DMA) — the Fig. 3 overhead. The plan is one
    fully **serial** phase: the baseline has no overlap.
    """

    name = "maxmemory"
    oom_fraction = 0.84  # Table III: dies one notch below Memory Req.

    def build_plan(self, a: CSR, h, mode="simulate",
                   dataset="") -> PipelinePlan:
        feat = self._feat(h)
        f = feat.n_cols
        plan = PipelinePlan(scheduler=self.name, dataset=dataset)
        plan.phases = [PhaseSpec("all", overlap="serial")]
        h_bytes = feat.compressed_bytes
        half = self.device_budget // 2
        if h_bytes > half or self._budget_infeasible(a, feat):
            plan.oom = True  # static split cannot fit B / minimum set absent
            return plan
        plan.add(AllocOp(MemoryTier.DEVICE, "H", h_bytes), "all")
        plan.add(AllocOp(MemoryTier.DEVICE, "A_seg",
                         min(half, self.spec.device_capacity - h_bytes)),
                 "all")

        # B over PCIe through host (no GDS in baseline), serial with A.
        plan.add(TransferOp(Path.STORAGE_HOST, MemoryTier.STORAGE,
                            MemoryTier.HOST, h_bytes, tag="phaseI/H"), "all")
        plan.add(TransferOp(Path.DMA, MemoryTier.HOST, MemoryTier.DEVICE,
                            h_bytes, tag="phaseI/H"), "all")
        plan.add(TransferOp(Path.STORAGE_HOST, MemoryTier.STORAGE,
                            MemoryTier.HOST, a.nbytes(), tag="phaseI/A"),
                 "all")

        cuts = naive_partition(a, half)
        plan.segments = len(cuts)
        value_bytes = a.data.dtype.itemsize
        per_nnz = 4 + value_bytes
        row_of = np.searchsorted(a.indptr, np.arange(a.nnz + 1),
                                 side="right") - 1
        carry_vals = np.empty(0, dtype=a.data.dtype)
        for (lo, hi, first_partial, last_partial) in cuts:
            # Unaligned cut ⇒ every segment must be re-packed ("staged") into
            # a contiguous pinned buffer before HtoD: the stored layout does
            # not match the transfer window. Measured host memcpy — this is
            # the bulk of the Fig. 3 overhead; AIRES's aligned segments skip
            # it entirely (segments ARE the stored layout).
            t0 = time.perf_counter()
            staged_vals = np.ascontiguousarray(a.data[lo:hi])
            staged_idx = np.ascontiguousarray(a.indices[lo:hi])
            measured = time.perf_counter() - t0
            plan.add(HostPreprocessOp(
                self._host_seconds(staged_vals.nbytes + staged_idx.nbytes,
                                   events=1), measured_s=measured), "all")
            if first_partial and carry_vals.size:
                # Merge the previous segment's partial row with its
                # continuation on the host (measured), re-send.
                row = row_of[lo]
                row_end = int(a.indptr[row + 1])
                t0 = time.perf_counter()
                merged = merge_partial_rows(carry_vals,
                                            np.asarray(a.data[lo:row_end]))
                np.ascontiguousarray(merged)  # pinned-buffer re-pack
                measured = time.perf_counter() - t0
                plan.add(HostPreprocessOp(
                    self._host_seconds(2 * merged.nbytes, events=2),
                    measured_s=measured), "all")
                plan.add(TransferOp(Path.DMA, MemoryTier.HOST,
                                    MemoryTier.DEVICE,
                                    merged.size * per_nnz + f * 4,
                                    tag="merge/HtoD", merge=True), "all")
                plan.merge_events += 1
            nbytes = (hi - lo) * per_nnz
            plan.add(TransferOp(Path.DMA, MemoryTier.HOST, MemoryTier.DEVICE,
                                nbytes, tag="seg"), "all")
            plan.add(ComputeOp(self._spgemm_seconds(hi - lo, feat)), "all")
            del staged_vals, staged_idx
            if last_partial:
                # Incomplete row returns to host (values + partial result).
                row = row_of[hi]
                row_lo = int(a.indptr[row])
                carry_vals = np.asarray(a.data[row_lo:hi])
                tail_bytes = carry_vals.size * per_nnz + f * 4
                plan.add(TransferOp(Path.DMA, MemoryTier.DEVICE,
                                    MemoryTier.HOST, tail_bytes,
                                    tag="merge/DtoH", merge=True), "all")
            else:
                carry_vals = np.empty(0, dtype=a.data.dtype)

        # Dynamic-size output vs static allocation (§III-B): C shares the
        # non-A half with B. Every time the C slot fills, the partial output
        # spills DtoH; because a hypersparse A spreads each C row's updates
        # across many segments, spilled C blocks are re-fetched when later
        # segments touch them again (thrash ∝ spill count, capped).
        mem_full = plan_memory_unified(a, feat, m_total=float("inf"))
        c_slot = max(half - h_bytes, 1)
        n_spills = max(1, int(np.ceil(mem_full.m_c / c_slot)))
        thrash = min(n_spills, 3)
        plan.add(TransferOp(Path.DMA, MemoryTier.DEVICE, MemoryTier.HOST,
                            int(mem_full.m_c) * thrash, tag="spill/C"), "all")
        if n_spills > 1:
            # Re-uploaded C partials that later segments accumulate into.
            reup = int(mem_full.m_c * 0.35 * (thrash - 1))
            plan.add(TransferOp(Path.DMA, MemoryTier.HOST, MemoryTier.DEVICE,
                                reup, tag="spill/reup", merge=True), "all")
            # Capacity pressure also evicts resident B pages; they re-read.
            b_evict = int(h_bytes * min(
                1.0, 0.4 * max(0.0, (mem_full.m_c - c_slot)) / max(h_bytes, 1)))
            if b_evict:
                plan.add(TransferOp(Path.STORAGE_HOST, MemoryTier.STORAGE,
                                    MemoryTier.HOST, b_evict, tag="evict/B"),
                         "all")
                plan.add(TransferOp(Path.DMA, MemoryTier.HOST,
                                    MemoryTier.DEVICE, b_evict,
                                    tag="evict/B"), "all")
        if mode == "execute":
            plan.device = self._execute_device()
            plan.reference_kernel = _reference_kernel(a, h, plan.device)
        plan.add(TransferOp(Path.STORAGE_HOST, MemoryTier.HOST,
                            MemoryTier.STORAGE, int(mem_full.m_c),
                            tag="phaseIII/C"), "all")
        return plan


class UCGScheduler(_BaseScheduler):
    """UCG [22] policy model: unified-memory reads + CPU/GPU work split.

    Table I: no alignment, no DMA batching, UM reads, no dual-way. UM
    page-fault traffic re-reads hot pages; a fraction of work runs on CPU
    (dynamic balance) at CPU throughput. Serial plan: UM serializes with
    compute.
    """

    name = "ucg"
    oom_fraction = 0.84  # Table III: same threshold as MaxMemory

    def __init__(self, *args, cpu_flops: float = 1.2e12,
                 cpu_fraction: float = 0.15, um_refetch: float = 1.15, **kw):
        super().__init__(*args, **kw)
        self.cpu_flops = cpu_flops
        self.cpu_fraction = cpu_fraction
        self.um_refetch = um_refetch  # page-granularity over-fetch factor

    def build_plan(self, a: CSR, h, mode="simulate",
                   dataset="") -> PipelinePlan:
        feat = self._feat(h)
        f = feat.n_cols
        plan = PipelinePlan(scheduler=self.name, dataset=dataset)
        plan.phases = [PhaseSpec("all", overlap="serial")]
        h_bytes = feat.compressed_bytes
        if self._budget_infeasible(a, feat):
            # UM spills, but a minimum resident set must fit (Table III '-').
            plan.oom = True
            return plan
        plan.segments = 1

        plan.add(TransferOp(Path.STORAGE_HOST, MemoryTier.STORAGE,
                            MemoryTier.HOST, a.nbytes() + h_bytes,
                            tag="load"), "all")
        # UM moves A, H and C on demand. Page-granularity refetch grows as
        # the resident share shrinks: fewer pages stay cached, so evicted
        # pages refault — refetch ∝ working-set / budget.
        mem_full = plan_memory_unified(a, feat, m_total=float("inf"))
        working_set = a.nbytes() + h_bytes + mem_full.m_c
        refetch = self.um_refetch * max(
            1.0, 0.6 * working_set / max(self.device_budget, 1))
        um_bytes = int((a.nbytes() + h_bytes) * refetch)
        plan.add(TransferOp(Path.UM, MemoryTier.HOST, MemoryTier.DEVICE,
                            um_bytes, tag="um"), "all", LANE_UM)
        dens_b = (100.0 - feat.sparsity_pct) / 100.0
        flops = max(_spgemm_flops(a, f) * dens_b, 2.0 * a.nnz)
        gpu_s = self._kernel_seconds(flops * (1 - self.cpu_fraction))
        cpu_s = flops * self.cpu_fraction / self.cpu_flops
        # CPU/GPU run concurrently: one compute slot at the slower side.
        plan.add(ComputeOp(max(gpu_s, cpu_s), flops=flops), "all")
        plan.add(TransferOp(Path.UM, MemoryTier.DEVICE, MemoryTier.HOST,
                            int(mem_full.m_c * refetch / self.um_refetch),
                            tag="out"), "all", LANE_UM)
        plan.add(TransferOp(Path.STORAGE_HOST, MemoryTier.HOST,
                            MemoryTier.STORAGE, int(mem_full.m_c),
                            tag="out"), "all")
        if mode == "execute":
            plan.device = self._execute_device()
            plan.reference_kernel = _reference_kernel(a, h, plan.device)
        return plan


class ETCScheduler(_BaseScheduler):
    """ETC [16] policy model: batched DMA + dedup + inter-batch pipeline.

    Table I: DMA yes, no UM, no alignment, no dual-way. Output buffer is
    allocated at the larger compressed input's size (paper §III-B), which
    shrinks the effective streaming budget; batch boundaries still split
    rows (merge cost remains, amortized by batching ~4x fewer events).

    Plan shape: a serial "load" phase (Phase I loads, merge bounces, output
    paging — ETC has no dual-way overlap for those) plus a "stream" phase
    whose transfer ops depend on the *previous* compute op — the inter-batch
    pipeline can only prefetch one batch ahead.
    """

    name = "etc"
    oom_fraction = 0.72  # Table III: survives one notch lower than UCG

    def __init__(self, *args, dedup: float = 0.80, batch_amortize: int = 4, **kw):
        super().__init__(*args, **kw)
        self.dedup = dedup              # fraction of redundant transfer removed
        self.batch_amortize = batch_amortize

    def build_plan(self, a: CSR, h, mode="simulate",
                   dataset="") -> PipelinePlan:
        feat = self._feat(h)
        f = feat.n_cols
        plan = PipelinePlan(scheduler=self.name, dataset=dataset)
        plan.phases = [PhaseSpec("load", overlap="serial"),
                       PhaseSpec("stream")]
        h_bytes = feat.compressed_bytes
        out_alloc = max(a.nbytes(), h_bytes)  # sized to larger input (§III-B)
        a_budget = self.device_budget - h_bytes - out_alloc
        if a_budget <= 0:
            # Output under-allocation: C pages through a smaller window
            # (extra spills below) and the stream budget shrinks to a floor.
            a_budget = max(int(0.05 * self.device_budget), 1 << 16)
        if self._budget_infeasible(a, feat):
            plan.oom = True
            return plan
        plan.add(TransferOp(Path.STORAGE_HOST, MemoryTier.STORAGE,
                            MemoryTier.HOST, a.nbytes() + h_bytes,
                            tag="load"), "load")
        plan.add(TransferOp(Path.DMA, MemoryTier.HOST, MemoryTier.DEVICE,
                            h_bytes, tag="phaseI/H"), "load")

        cuts = naive_partition(a, int(a_budget))
        plan.segments = len(cuts)
        value_bytes = a.data.dtype.itemsize
        per_nnz = 4 + value_bytes
        prev_cmp: Optional[int] = None
        for idx, (lo, hi, first_partial, last_partial) in enumerate(cuts):
            if idx % self.batch_amortize == 0:
                # Batching amortizes the re-staging memcpy across
                # `batch_amortize` segments (ETC's 3-step access policy), but
                # cannot remove it: batch boundaries are still unaligned.
                t0 = time.perf_counter()
                sv = np.ascontiguousarray(a.data[lo:hi])
                si = np.ascontiguousarray(a.indices[lo:hi])
                measured = time.perf_counter() - t0
                plan.add(HostPreprocessOp(
                    self._host_seconds(sv.nbytes + si.nbytes, events=1),
                    measured_s=measured), "load")
            nbytes = int((hi - lo) * per_nnz * (1 - self.dedup * 0.25))
            i_io = plan.add(
                TransferOp(Path.DMA, MemoryTier.HOST, MemoryTier.DEVICE,
                           nbytes, tag="seg"), "stream", LANE_DMA,
                deps=(() if prev_cmp is None else (prev_cmp,)))
            prev_cmp = plan.add(
                ComputeOp(self._spgemm_seconds(hi - lo, feat)),
                "stream", LANE_COMPUTE, deps=(i_io,))
            if last_partial and idx % self.batch_amortize == 0:
                plan.add(TransferOp(Path.DMA, MemoryTier.DEVICE,
                                    MemoryTier.HOST, f * 4 + 64 * per_nnz,
                                    tag="merge/DtoH", merge=True), "load")
                plan.merge_events += 1

        # Output paging: C exits via DMA; if the reserved out_alloc is under
        # M_C, the overflow pages out mid-stream as well (no GDS in ETC).
        mem_full = plan_memory_unified(a, feat, m_total=float("inf"))
        plan.add(TransferOp(Path.DMA, MemoryTier.DEVICE, MemoryTier.HOST,
                            int(mem_full.m_c), tag="out"), "load")
        plan.add(TransferOp(Path.STORAGE_HOST, MemoryTier.HOST,
                            MemoryTier.STORAGE, int(mem_full.m_c),
                            tag="out"), "load")
        if mode == "execute":
            plan.device = self._execute_device()
            plan.reference_kernel = _reference_kernel(a, h, plan.device)
        return plan


SCHEDULERS = {
    "aires": AiresScheduler,
    "maxmemory": MaxMemoryScheduler,
    "ucg": UCGScheduler,
    "etc": ETCScheduler,
}
