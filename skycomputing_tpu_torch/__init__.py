"""skycomputing_tpu_torch: the PyTorch/CUDA port of skycomputing_tpu.

The JAX package ``skycomputing_tpu`` stays the reference; this package
re-implements it slice by slice for an NVIDIA H100, module for module
under the same names.  It imports ``torch`` and ``numpy`` and never
``jax``, ``flax`` or ``skycomputing_tpu``.  Slice 1 is paged GPT
serving: :class:`~.serving.ServingEngine` over ``models/gpt.py``, with
the paged-attention kernel written in CUDA (``ops/csrc``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on a CPU tensor each kernel wrapper runs its plain PyTorch version.
"""

from . import models  # noqa: F401 - registers the GPT layers in LAYER
from .builder import LayerStack, build_layer, build_layer_stack
from .convert import params_from_jax
from .registry import LAYER, Registry

__all__ = [
    "LAYER",
    "LayerStack",
    "Registry",
    "build_layer",
    "build_layer_stack",
    "params_from_jax",
]
