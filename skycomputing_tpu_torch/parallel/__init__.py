"""The MPMD pipeline engine (the port of ``skycomputing_tpu/parallel``:
``PipelineModel`` under GPipe and 1F1B)."""

from .pipeline import (
    PipelineModel,
    PipelineStats,
    StageRuntime,
    build_optimizer,
    device_put_elided,
    sgd,
)

__all__ = ["PipelineModel", "PipelineStats", "StageRuntime",
           "build_optimizer", "device_put_elided", "sgd"]
