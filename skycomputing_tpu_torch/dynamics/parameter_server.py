"""Host-resident full-model parameter store (the port of
``skycomputing_tpu/dynamics/parameter_server.py``).

The store is layer-indexed: one CPU float32 state dict per layer of the
model config, so stages slice it by their current layer ranges and a
checkpoint survives re-allocation.  Weights come from one of:

- an explicit ``torch.Generator`` (default: seeded with 0), drawing each
  layer's tensors in module order with the flax initializers'
  distributions — N(0, ``init_std``) for embeddings and for dense
  kernels that carry one, flax ``Dense``'s and ``Conv``'s default
  ``lecun_normal`` (truncated normal, variance 1/fan_in) for the others,
  zero biases, LayerNorm and GroupNorm scales 1 and offsets 0; a module
  with parameters of its own (``GptBlock_MoeMlp``) draws them in its
  ``initial_state(normal)``.  The draws are not JAX's bits;
  weights that must equal the JAX package's come through
- ``state_dicts`` (e.g. :func:`~..convert.params_from_jax`).

Whole-model checkpoints are single files written with ``torch.save``
and published atomically (a temporary file renamed into place); the
write and the read of an existing file retry transient ``OSError``s
with :func:`~..utils.retry_call`, as the JAX store does.  Orbax
directories are not ported.
"""

from __future__ import annotations

import io
import math
import os
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from ..builder import build_layer_stack
from ..utils import retry_call

StateDict = Dict[str, torch.Tensor]

# flax lecun_normal: truncated to two standard deviations, then rescaled
# by this constant so that the variance is 1/fan_in
_TRUNC_STD = 0.87962566103423978


def _lecun_normal(shape, fan_in: int, generator) -> torch.Tensor:
    """flax ``lecun_normal()``: N(0, 1/fan_in) truncated at +-2 standard
    deviations, drawn by inverting the normal CDF on a uniform draw."""
    lo, hi = (0.5 * (1.0 + math.erf(x / math.sqrt(2.0))) for x in (-2.0, 2.0))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)
    return (z * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)).float()


def init_state_dict(module: nn.Module, generator: torch.Generator
                    ) -> StateDict:
    """Initial float32 CPU weights for ``module`` (any device, meta
    included: only shapes are read), drawn from ``generator``."""
    sd: StateDict = {}

    def normal(shape, std):
        return torch.randn(shape, generator=generator) * std

    for name, sub in module.named_modules():
        prefix = f"{name}." if name else ""
        if hasattr(sub, "initial_state"):  # parameters of its own
            for key, value in sub.initial_state(normal).items():
                sd[prefix + key] = value
        if isinstance(sub, nn.LayerNorm):
            sd[prefix + "weight"] = torch.ones(sub.normalized_shape)
            sd[prefix + "bias"] = torch.zeros(sub.normalized_shape)
        elif isinstance(sub, nn.GroupNorm):
            sd[prefix + "weight"] = torch.ones(sub.num_channels)
            sd[prefix + "bias"] = torch.zeros(sub.num_channels)
        elif isinstance(sub, nn.Conv2d):  # flax Conv: lecun_normal
            shape = sub.weight.shape  # [out, in, kh, kw]
            sd[prefix + "weight"] = _lecun_normal(
                shape, shape[1] * shape[2] * shape[3], generator)
            if sub.bias is not None:
                sd[prefix + "bias"] = torch.zeros(sub.out_channels)
        elif isinstance(sub, nn.Embedding):
            sd[prefix + "weight"] = normal(sub.weight.shape, sub.init_std)
        elif isinstance(sub, nn.Linear):
            std = getattr(sub, "init_std", None)
            shape = sub.weight.shape  # [out, in]
            sd[prefix + "weight"] = (
                normal(shape, std) if std is not None
                else _lecun_normal(shape, sub.in_features, generator))
            sd[prefix + "bias"] = torch.zeros(sub.out_features)
    expected = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in sd.items()}
    if got != expected:
        raise ValueError(
            f"{type(module).__name__}: no initializer for "
            f"{sorted(set(expected) - set(got))}"
        )
    return sd


def _host_copy(sd: StateDict) -> StateDict:
    return {k: v.detach().to("cpu", torch.float32, copy=True)
            for k, v in sd.items()}


class ParameterServer:
    def __init__(
        self,
        model_config: List[Dict],
        state_dicts: Optional[Sequence[StateDict]] = None,
        generator: Optional[torch.Generator] = None,
    ):
        self._model_config = list(model_config)
        self.params: List[StateDict] = []
        if state_dicts is not None:
            if len(state_dicts) != len(self._model_config):
                raise ValueError(
                    f"got {len(state_dicts)} state dicts for "
                    f"{len(self._model_config)} layers"
                )
            self.params = [_host_copy(sd) for sd in state_dicts]
        else:
            generator = generator or torch.Generator().manual_seed(0)
            # shapes only: the modules hold no storage
            with torch.device("meta"):
                stack = build_layer_stack(self._model_config)
            self.params = [init_state_dict(m, generator)
                           for m in stack.layers]

    @property
    def num_layers(self) -> int:
        return len(self._model_config)

    # --- whole-model checkpoint io -----------------------------------------
    def save_weights_to_file(self, checkpoint: str) -> None:
        """Write ``checkpoint + ".tmp"`` and rename it into place, so a
        crash at any point leaves the previous checkpoint whole."""
        def write():
            tmp = f"{checkpoint}.tmp"
            torch.save({"layers": self.params}, tmp)
            os.replace(tmp, checkpoint)

        retry_call(write, retry_on=(OSError,),
                   describe=f"checkpoint save {checkpoint}")

    def load_weights_from_file(self, checkpoint: str) -> None:
        if not os.path.exists(checkpoint):
            # a missing file fails fast: only reads of an existing
            # checkpoint get the transient-fault retries
            raise FileNotFoundError(f"no checkpoint at {checkpoint!r}")

        def read():
            with open(checkpoint, "rb") as fh:
                return fh.read()

        raw = retry_call(read, retry_on=(OSError,),
                         describe=f"checkpoint read {checkpoint}")
        try:
            restored = torch.load(io.BytesIO(raw), map_location="cpu",
                                  weights_only=True)
        except Exception as exc:
            # a torn file otherwise surfaces as a deep unpickler
            # traceback with no mention of which file was bad
            raise ValueError(
                f"corrupt or truncated checkpoint {checkpoint!r} "
                f"({len(raw)} bytes): {exc}"
            ) from exc
        if not isinstance(restored, dict) or "layers" not in restored:
            raise ValueError(
                f"corrupt or truncated checkpoint {checkpoint!r}: no "
                f"'layers' entry"
            )
        layers = list(restored["layers"])
        if len(layers) != len(self.params):
            raise ValueError(
                f"checkpoint holds {len(layers)} layers, the model has "
                f"{len(self.params)}"
            )
        for i, (ref, new) in enumerate(zip(self.params, layers)):
            if set(ref) != set(new):
                raise ValueError(
                    f"checkpoint layer {i} holds {sorted(new)}, "
                    f"expected {sorted(ref)}"
                )
        self.params = [_host_copy(sd) for sd in layers]

    # --- per-layer exchange with stages ------------------------------------
    def update_weights(self, state: StateDict, idx: int) -> None:
        self.params[idx] = _host_copy(state)

    def get_state_dict(self, idx: int) -> StateDict:
        return self.params[idx]

    def get_layer_slice(self, start: int, stop: int) -> List[StateDict]:
        return self.params[start:stop]


__all__ = ["ParameterServer", "init_state_dict"]
