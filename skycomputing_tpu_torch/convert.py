"""JAX per-layer param trees -> the port's per-layer state dicts.

The tests and any user holding weights from the JAX package run both
packages on the same weights through :func:`params_from_jax`.  The
trees come in as nested dicts of numpy arrays (``jax.device_get`` of
``LayerStack.init``'s result, or a checkpoint), so nothing here imports
JAX.  GPT's trees are flat (one level of submodules); BERT's and
ResNet's nest (``BertLayer_Head`` holds ``self.query`` ... and
``output.LayerNorm``, ``ResLayer`` ``block0.conv1`` ...), so the tree is
walked recursively and a nested name becomes a dotted state-dict key.
Leaf mappings:

- flax ``Dense`` ``kernel [in, out]`` -> ``weight [out, in]``, plus
  ``bias``;
- ``Conv`` ``kernel [kh, kw, in, out]`` (HWIO) -> ``weight [out, in,
  kh, kw]`` (OIHW);
- ``Embed`` ``embedding`` -> ``weight``;
- ``LayerNorm`` and ``GroupNorm`` ``scale``/``bias`` ->
  ``weight``/``bias``;
- a parameter declared on the module itself (``GptBlock_MoeMlp``'s
  ``router``, ``w1`` ...) keeps its name and layout.
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
    "GptBlock_MoeMlp": ("ln_2", "router", "w1", "b1", "w2", "b2"),
    "GptLmHead": ("ln_f", "lm_head"),
}

#: the top-level submodule names each BERT layer's param tree holds
BERT_LAYER_PARAMS = {
    "BertEmbeddings": ("word_embeddings", "position_embeddings",
                       "token_type_embeddings", "LayerNorm"),
    "BertLayer_Head": ("self", "output"),
    "LongBertLayer_Head": ("self", "output"),
    "BertLayer_Body": ("dense_act",),
    "BertLayer_BodyShard": ("dense_act",),
    "BertLayer_Tail": ("dense", "LayerNorm"),
    "BertPooler": ("dense_act",),
    "BertTailForClassification": ("classifier",),
}

#: the submodule names of each ResNet unit's param tree, by its config
RESNET_LAYER_PARAMS = {
    "ResHead": lambda cfg: ("conv1", "norm1"),
    "ResLayer": lambda cfg: tuple(f"block{i}"
                                  for i in range(cfg["num_blocks"])),
    "ResTail": lambda cfg: ("fc",),
}

LAYER_PARAMS = {**GPT_LAYER_PARAMS, **BERT_LAYER_PARAMS,
                **RESNET_LAYER_PARAMS}


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _kernel(x) -> torch.Tensor:
    """A Dense kernel [in, out] -> [out, in]; a Conv kernel HWIO ->
    OIHW."""
    k = _tensor(x)
    return (k.T if k.dim() == 2 else k.permute(3, 2, 0, 1)).contiguous()


def _submodule(name: str, tree: Any) -> Dict[str, torch.Tensor]:
    if not isinstance(tree, Mapping):  # a parameter of the module itself
        return {name: _tensor(tree)}
    keys = set(tree)
    if keys == {"kernel", "bias"}:  # Dense (or a Conv with a bias)
        return {f"{name}.weight": _kernel(tree["kernel"]),
                f"{name}.bias": _tensor(tree["bias"])}
    if keys == {"kernel"}:  # Conv without a bias
        return {f"{name}.weight": _kernel(tree["kernel"])}
    if keys == {"embedding"}:  # Embed
        return {f"{name}.weight": _tensor(tree["embedding"])}
    if keys == {"scale", "bias"}:  # LayerNorm, GroupNorm
        return {f"{name}.weight": _tensor(tree["scale"]),
                f"{name}.bias": _tensor(tree["bias"])}
    if all(isinstance(sub, Mapping) for sub in tree.values()):
        out: Dict[str, torch.Tensor] = {}
        for key, sub in tree.items():  # a module of modules
            out.update(_submodule(f"{name}.{key}", sub))
        return out
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
        expected = LAYER_PARAMS.get(kind)
        if expected is None:
            raise ValueError(f"layer {i}: no conversion for {kind!r}")
        if callable(expected):
            expected = expected(cfg)
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


__all__ = ["BERT_LAYER_PARAMS", "GPT_LAYER_PARAMS", "LAYER_PARAMS",
           "RESNET_LAYER_PARAMS", "params_from_jax"]
