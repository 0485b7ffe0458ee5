"""skycomputing_tpu_torch: the PyTorch/CUDA port of skycomputing_tpu.

The JAX package ``skycomputing_tpu`` stays the reference; this package
re-implements it slice by slice for an NVIDIA H100, module for module
under the same names.  It imports ``torch`` and ``numpy`` and never
``jax``, ``flax`` or ``skycomputing_tpu``.  Slices 1-2 are paged GPT
serving: :class:`~.serving.ServingEngine` over ``models/gpt.py``, with
the paged-attention kernels written in CUDA (``ops/csrc``).  Slice 3 is
the BERT pipeline trainer: ``models/bert.py`` split into units over a
:class:`~.dynamics.WorkerManager`, weights in a
:class:`~.dynamics.ParameterServer`, an :class:`~.dynamics.Allocator`
(even split), the GPipe :class:`~.parallel.PipelineModel` and the
:class:`~.runner.Runner`, with the flash-attention kernel in CUDA.
Later slices add the paper's main path (profilers, solver, allocation,
1F1B, the launcher), the bench, GLUE data and evaluation, and the
trainer's safety net: the pre-flight plan verifier (:mod:`.analysis`),
the telemetry core (:mod:`.telemetry`), fault injection and self-heal,
the parallel engines on a single-controller device mesh
(:mod:`.parallel`: sequence parallelism, data-parallel replicas,
mesh-native stages, and the compiled SPMD BERT and GPT pipelines with
tensor parallelism, ZeRO-1/2/3 and expert parallelism).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on a CPU tensor each kernel wrapper runs its plain PyTorch version.
"""

from . import models  # noqa: F401 - registers the BERT and GPT layers
from .builder import LayerStack, build_layer, build_layer_stack
from .convert import params_from_jax, spmd_params_from_jax, spmd_params_to_jax
from .registry import LAYER, Registry

__all__ = [
    "LAYER",
    "LayerStack",
    "Registry",
    "build_layer",
    "build_layer_stack",
    "params_from_jax",
    "spmd_params_from_jax",
    "spmd_params_to_jax",
]
