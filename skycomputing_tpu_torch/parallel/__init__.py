"""The parallel engines (the port of ``skycomputing_tpu/parallel``): the
MPMD ``PipelineModel`` under GPipe and 1F1B, its data-parallel replicas
(``DataParallelPipeline``), mesh-native stages (``MeshPipelineModel``),
the device ``Mesh`` they share, sequence-parallel attention (ring and
Ulysses), the compiled SPMD BERT and GPT pipelines
(``CompiledBertPipeline``, ``CompiledGptPipeline``: GPipe, interleaving,
tensor parallelism, ZeRO-1/2/3, MoE), tensor parallelism for the
monolithic model and expert parallelism; and the multi-process world
over ``torch.distributed``: ``initialize_from_env``, ``global_mesh``,
``is_coordinator``, the ``PeerHeartbeat`` and elastic re-formation
(``ElasticSupervisor``, ``FileRendezvous``)."""

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
from .multihost import global_mesh, initialize_from_env, is_coordinator
from .heartbeat import PeerHeartbeat
from .elastic import (
    HEARTBEAT_ABORT_RC,
    REALLOC_RC,
    ElasticSupervisor,
    FileRendezvous,
)
from .ring_attention import full_attention_reference, ring_attention
from .ulysses import ulysses_attention
from .expert_parallel import (
    ep_apply,
    ep_shardings,
    make_ep_mesh,
    shard_moe_params,
)
from .sharded import Adam, Sgd, ShardedLeaf
from .spmd import CompiledBertPipeline
from .spmd_gpt import CompiledGptPipeline
from .tensor_parallel import (
    make_tp_mesh,
    shard_params,
    tp_apply,
    tp_shardings,
    tp_train_step_fn,
)

__all__ = ["Adam", "CompiledBertPipeline", "CompiledGptPipeline",
           "DataParallelPipeline", "ElasticSupervisor", "FileRendezvous",
           "HEARTBEAT_ABORT_RC", "Mesh", "MeshPipelineModel",
           "MeshStageRuntime", "PeerHeartbeat", "PipelineModel",
           "PipelineStats", "REALLOC_RC", "Sgd",
           "ShardedLeaf", "StageRuntime", "build_optimizer",
           "device_put_elided", "ep_apply", "ep_shardings",
           "full_attention_reference", "global_mesh", "initialize_from_env",
           "is_coordinator", "make_1d_mesh", "make_dp_pp_mesh",
           "make_dp_pp_tp_mesh", "make_ep_mesh", "make_pipeline_mesh",
           "make_tp_mesh", "ring_attention", "sgd", "shard_moe_params",
           "shard_params", "stage_submeshes", "tp_apply", "tp_shardings",
           "tp_train_step_fn", "ulysses_attention"]
