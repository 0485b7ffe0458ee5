"""The MPMD pipeline engine (the port of ``skycomputing_tpu/parallel``:
slice 3 ports the GPipe ``PipelineModel``)."""

from .pipeline import PipelineModel, PipelineStats, StageRuntime, sgd

__all__ = ["PipelineModel", "PipelineStats", "StageRuntime", "sgd"]
