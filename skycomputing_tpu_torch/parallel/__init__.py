"""The parallel engines (the port of ``skycomputing_tpu/parallel``): the
MPMD ``PipelineModel`` under GPipe and 1F1B, its data-parallel replicas
(``DataParallelPipeline``), mesh-native stages (``MeshPipelineModel``),
the device ``Mesh`` they share, and sequence-parallel attention (ring
and Ulysses)."""

from .pipeline import (
    PipelineModel,
    PipelineStats,
    StageRuntime,
    build_optimizer,
    device_put_elided,
    sgd,
)
from .data_parallel import DataParallelPipeline
from .mesh import (
    Mesh,
    make_1d_mesh,
    make_dp_pp_mesh,
    make_dp_pp_tp_mesh,
    make_pipeline_mesh,
    stage_submeshes,
)
from .mesh_pipeline import MeshPipelineModel, MeshStageRuntime
from .ring_attention import full_attention_reference, ring_attention
from .ulysses import ulysses_attention

__all__ = ["DataParallelPipeline", "Mesh", "MeshPipelineModel",
           "MeshStageRuntime", "PipelineModel", "PipelineStats",
           "StageRuntime", "build_optimizer", "device_put_elided",
           "full_attention_reference", "make_1d_mesh", "make_dp_pp_mesh",
           "make_dp_pp_tp_mesh", "make_pipeline_mesh", "ring_attention",
           "sgd", "stage_submeshes", "ulysses_attention"]
