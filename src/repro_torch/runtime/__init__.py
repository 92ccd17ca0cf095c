"""The out-of-core GCN serving engine, its continuous-batching loop and the
run supervisor."""
from repro_torch.runtime.supervisor import (
    Supervisor, SupervisorConfig, ElasticMesh, RunState,
)
from repro_torch.runtime.engine import (
    AdmissionError, BatchReport, EngineConfig, GraphUpdateReport, GroupStats,
    InferenceRequest, InferenceResult, RejectedRequest, RequestLatency,
    ServingEngine, SubmitReceipt, WarmStartReport,
)
from repro_torch.runtime.serving_loop import (
    Arrival, ContinuousServer, ServeEvent, ServeReport, StepReport,
    VirtualClock, bursty_trace, poisson_trace, replay_continuous,
    replay_round, summarize,
)

__all__ = [
    "Supervisor", "SupervisorConfig", "ElasticMesh", "RunState",
    "AdmissionError", "BatchReport", "EngineConfig", "GraphUpdateReport",
    "GroupStats", "InferenceRequest", "InferenceResult", "RejectedRequest",
    "RequestLatency", "ServingEngine", "SubmitReceipt", "WarmStartReport",
    "Arrival", "ContinuousServer", "ServeEvent", "ServeReport", "StepReport",
    "VirtualClock", "bursty_trace", "poisson_trace", "replay_continuous",
    "replay_round", "summarize",
]
