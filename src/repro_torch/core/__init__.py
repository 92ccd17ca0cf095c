"""AIRES core: the Eq. 5-7 memory model, RoBW partitioning, the pipeline
plan IR with its static analyzer and rewrite passes, the paper's schedulers
(AIRES and its three baselines), and the streamed, differentiable
out-of-core SpGEMM with its GCN epoch runner.

  autotune     : schedule knob search over the plan IR
  calibration  : online cost-model calibration (CostCalibrator)
  memory_model : Eq. (5)-(7) analytical planning
  robw         : Algorithm 1 row block-wise alignment
  pipeline     : typed pipeline-plan IR + cost/execute interpreters
  analysis     : static plan analyzer (liveness, races, byte lints)
  passes       : plan-rewrite passes (placement, coalescing, EDF order)
  scheduler    : Algorithm 2 plan builders (AIRES + baselines)
  spgemm       : AiresSpGEMM public API + chained GCN epoch runner
"""
from repro_torch.core.analysis import (
    RULES,
    AnalysisReport,
    Finding,
    PlanAnalysisError,
    analyze_plan,
    default_analyze,
    diff_path_totals,
    path_byte_totals,
    set_default_analyze,
)
from repro_torch.core.autotune import (
    TunedSchedule,
    autotune_schedule,
    bucket_set_bytes,
    candidate_bucket_sets,
)
from repro_torch.core.calibration import CostCalibrator, PathEstimate
from repro_torch.core.memory_model import (
    FeatureSpec,
    MemoryEstimate,
    calc_mem,
    ell_bucket_capacity,
    estimate_output_bytes,
    estimate_resident_bytes,
    plan_memory,
    plan_memory_dense_features,
    plan_memory_spec,
    plan_memory_unified,
    required_bytes,
    segment_budget,
)
from repro_torch.core.passes import (
    CoalescedPayload,
    EDFOrderingPass,
    PassContext,
    PassPipeline,
    PassReport,
    PlanPass,
    ShardPlacementPass,
    TransferCoalescingPass,
    deadline_order,
    edf_sort,
)
from repro_torch.core.pipeline import (
    AllocOp,
    CacheProbeOp,
    ComputeOp,
    CostInterpreter,
    ExecuteInterpreter,
    HostPreprocessOp,
    PhaseSpec,
    PipelinePlan,
    PlanOp,
    PlanValidationError,
    ScheduleMetrics,
    TransferOp,
    modeled_spgemm_seconds,
)
from repro_torch.core.robw import (
    RoBWPlan,
    RoBWSegment,
    densify_segment,
    merge_partial_rows,
    naive_partition,
    robw_delta_partition,
    robw_partition,
    robw_transpose_plan,
    segment_ell_widths,
    segments_to_block_ell,
)
from repro_torch.core.scheduler import (
    SCHEDULERS,
    AiresScheduler,
    ETCScheduler,
    MaxMemoryScheduler,
    ScheduleResult,
    UCGScheduler,
)
from repro_torch.core.spgemm import (
    AiresConfig,
    AiresSpGEMM,
    EpochMetrics,
    UpdateStats,
    gcn_epoch,
    resolve_device,
)

__all__ = [
    "AnalysisReport", "Finding", "PlanAnalysisError", "RULES",
    "analyze_plan", "default_analyze", "diff_path_totals",
    "path_byte_totals", "set_default_analyze",
    "TunedSchedule", "autotune_schedule", "bucket_set_bytes",
    "candidate_bucket_sets",
    "CostCalibrator", "PathEstimate",
    "FeatureSpec", "MemoryEstimate", "calc_mem", "ell_bucket_capacity",
    "estimate_output_bytes", "estimate_resident_bytes", "plan_memory",
    "plan_memory_dense_features", "plan_memory_spec", "plan_memory_unified",
    "required_bytes", "segment_budget",
    "CoalescedPayload", "EDFOrderingPass", "PassContext", "PassPipeline",
    "PassReport", "PlanPass", "ShardPlacementPass", "TransferCoalescingPass",
    "deadline_order", "edf_sort",
    "AllocOp", "CacheProbeOp", "ComputeOp", "CostInterpreter",
    "ExecuteInterpreter", "HostPreprocessOp", "PhaseSpec", "PipelinePlan",
    "PlanOp", "PlanValidationError", "ScheduleMetrics", "TransferOp",
    "modeled_spgemm_seconds",
    "RoBWPlan", "RoBWSegment", "densify_segment", "merge_partial_rows",
    "naive_partition", "robw_delta_partition", "robw_partition",
    "robw_transpose_plan", "segment_ell_widths", "segments_to_block_ell",
    "SCHEDULERS", "AiresScheduler", "ETCScheduler", "MaxMemoryScheduler",
    "ScheduleResult", "UCGScheduler",
    "AiresConfig", "AiresSpGEMM", "EpochMetrics", "UpdateStats", "gcn_epoch",
    "resolve_device",
]
