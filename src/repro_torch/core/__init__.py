"""AIRES core: the Eq. 5-7 memory model, RoBW partitioning, the pipeline
plan IR and the streamed, differentiable out-of-core SpGEMM."""
from repro_torch.core.memory_model import (
    FeatureSpec,
    MemoryEstimate,
    calc_mem,
    ell_bucket_capacity,
    plan_memory_dense_features,
    plan_memory_unified,
)
from repro_torch.core.pipeline import (
    CacheProbeOp,
    ComputeOp,
    CostInterpreter,
    ExecuteInterpreter,
    PhaseSpec,
    PipelinePlan,
    ScheduleMetrics,
    TransferOp,
    modeled_spgemm_seconds,
)
from repro_torch.core.robw import (
    RoBWPlan,
    RoBWSegment,
    densify_segment,
    robw_partition,
    robw_transpose_plan,
    segments_to_block_ell,
)
from repro_torch.core.spgemm import AiresConfig, AiresSpGEMM, resolve_device

__all__ = [
    "FeatureSpec", "MemoryEstimate", "calc_mem", "ell_bucket_capacity",
    "plan_memory_dense_features", "plan_memory_unified",
    "CacheProbeOp", "ComputeOp", "CostInterpreter", "ExecuteInterpreter",
    "PhaseSpec", "PipelinePlan", "ScheduleMetrics", "TransferOp",
    "modeled_spgemm_seconds",
    "RoBWPlan", "RoBWSegment", "densify_segment", "robw_partition",
    "robw_transpose_plan", "segments_to_block_ell",
    "AiresConfig", "AiresSpGEMM", "resolve_device",
]
