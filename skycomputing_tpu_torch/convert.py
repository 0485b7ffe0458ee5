"""JAX per-layer param trees -> the port's per-layer state dicts.

The tests and any user holding weights from the JAX package run both
packages on the same weights through :func:`params_from_jax`.  The
trees come in as nested dicts of numpy arrays (``jax.device_get`` of
``LayerStack.init``'s result, or a checkpoint), so nothing here imports
JAX.  Mappings:

- flax ``Dense`` ``kernel [in, out]`` -> ``weight [out, in]``, plus
  ``bias``;
- ``Embed`` ``embedding`` -> ``weight``;
- ``LayerNorm`` ``scale``/``bias`` -> ``weight``/``bias``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence

import numpy as np
import torch

#: the submodule names each GPT layer's param tree holds
GPT_LAYER_PARAMS = {
    "GptEmbeddings": ("wte", "wpe"),
    "GptBlock_Attn": ("ln_1", "q_proj", "k_proj", "v_proj", "c_proj"),
    "GptBlock_Mlp": ("ln_2", "c_fc", "c_proj"),
    "GptLmHead": ("ln_f", "lm_head"),
}


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _submodule(name: str, tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    keys = set(tree)
    if keys == {"kernel", "bias"}:  # Dense
        return {f"{name}.weight": _tensor(tree["kernel"]).T.contiguous(),
                f"{name}.bias": _tensor(tree["bias"])}
    if keys == {"embedding"}:  # Embed
        return {f"{name}.weight": _tensor(tree["embedding"])}
    if keys == {"scale", "bias"}:  # LayerNorm
        return {f"{name}.weight": _tensor(tree["scale"]),
                f"{name}.bias": _tensor(tree["bias"])}
    raise ValueError(f"{name}: unrecognized flax param leaves {sorted(keys)}")


def params_from_jax(params_list: Sequence[Mapping[str, Any]],
                    layer_cfgs: Sequence[Mapping[str, Any]]
                    ) -> List[Dict[str, torch.Tensor]]:
    """One float32 CPU state dict per layer of ``layer_cfgs``, from the
    JAX package's per-layer param trees (numpy leaves)."""
    if len(params_list) != len(layer_cfgs):
        raise ValueError(
            f"got {len(params_list)} param trees for {len(layer_cfgs)} layers"
        )
    out = []
    for i, (tree, cfg) in enumerate(zip(params_list, layer_cfgs)):
        kind = cfg["layer_type"]
        expected = GPT_LAYER_PARAMS.get(kind)
        if expected is None:
            raise ValueError(f"layer {i}: no conversion for {kind!r}")
        if set(tree) != set(expected):
            raise ValueError(
                f"layer {i} ({kind}): param tree holds {sorted(tree)}, "
                f"expected {sorted(expected)}"
            )
        sd: Dict[str, torch.Tensor] = {}
        for name in expected:
            sd.update(_submodule(name, tree[name]))
        out.append(sd)
    return out


__all__ = ["GPT_LAYER_PARAMS", "params_from_jax"]
