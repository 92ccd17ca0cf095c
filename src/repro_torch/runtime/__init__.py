"""The out-of-core GCN serving engine."""
from repro_torch.runtime.engine import (
    AdmissionError,
    BatchReport,
    EngineConfig,
    GraphUpdateReport,
    GroupStats,
    InferenceRequest,
    InferenceResult,
    RejectedRequest,
    RequestLatency,
    ServingEngine,
    SubmitReceipt,
    WarmStartReport,
)

__all__ = [
    "AdmissionError", "BatchReport", "EngineConfig", "GraphUpdateReport",
    "GroupStats",
    "InferenceRequest", "InferenceResult", "RejectedRequest",
    "RequestLatency", "ServingEngine", "SubmitReceipt", "WarmStartReport",
]
