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

The compiled SPMD engines' trees (``parallel/spmd.py``) convert with
:func:`spmd_params_from_jax`, which maps every stacked slice of a stage
leaf through the same per-unit mapping, and back into numpy in JAX's
layout with :func:`spmd_params_to_jax` (:func:`state_dict_to_jax`, the
inverse of the per-unit mapping for BERT's and GPT's units).
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


# the unit types of a compiled engine's stage unit and of its ends
_SPMD_UNITS = {
    "bert": {"head": "BertLayer_Head", "body": "BertLayer_Body",
             "tail": "BertLayer_Tail"},
    "gpt": {"attn": "GptBlock_Attn", "mlp": "GptBlock_Mlp"},
}
_SPMD_ENDS = {
    "bert": {"embeddings": "BertEmbeddings", "pooler": "BertPooler",
             "classifier": "BertTailForClassification"},
    "gpt": {"embeddings": "GptEmbeddings", "lm_head": "GptLmHead"},
}
_EMBEDDINGS = {"word_embeddings", "position_embeddings",
               "token_type_embeddings", "wte", "wpe"}
_NORMS = {"LayerNorm", "ln_1", "ln_2", "ln_f"}


def _family(tree: Mapping[str, Any]) -> str:
    stages = tree.get("stages") or {}
    first_unit = next(iter(stages.values()), {})
    return "gpt" if "lm_head" in tree or "attn" in first_unit else "bert"


def _unit_type(family: str, sub: str, tree: Mapping[str, Any]) -> str:
    if family == "gpt" and sub == "mlp" and "router" in tree:
        return "GptBlock_MoeMlp"
    return _SPMD_UNITS[family][sub]


def _lead_indices(leaf, lead: int):
    return list(np.ndindex(*np.shape(leaf)[:lead]))


def _tree_index(tree, idx):
    if isinstance(tree, Mapping):
        return {k: _tree_index(v, idx) for k, v in tree.items()}
    return np.asarray(tree)[idx]


def _first_leaf(tree):
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return tree


def spmd_params_from_jax(params: Mapping[str, Any], tp: int = 1
                         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A compiled engine's params (``CompiledBertPipeline`` or
    ``CompiledGptPipeline`` of the JAX package, numpy leaves) -> the
    port engine's global tree: each end a state dict, ``stages`` a dict
    of port names (``unit_0.head.self.query.weight`` ...) whose leaves
    keep the stacked leading axes ``[S*V]`` (``[S*V, tp]`` for a tp-split
    tree, ``tp > 1``), each slice mapped by :func:`params_from_jax`."""
    family = _family(params)
    lead = 2 if tp > 1 else 1
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for group, tree in params.items():
        if group != "stages":
            kind = _SPMD_ENDS[family][group]
            out[group] = params_from_jax([tree], [dict(layer_type=kind)])[0]
            continue
        indices = _lead_indices(_first_leaf(tree), lead)
        slices = []
        for idx in indices:
            sd: Dict[str, torch.Tensor] = {}
            for unit, subs in _tree_index(tree, idx).items():
                for sub, sub_tree in subs.items():
                    kind = _unit_type(family, sub, sub_tree)
                    part = params_from_jax([sub_tree],
                                           [dict(layer_type=kind)])[0]
                    sd.update({f"{unit}.{sub}.{k}": v
                               for k, v in part.items()})
            slices.append(sd)
        shape = np.shape(_first_leaf(tree))[:lead]
        out["stages"] = {
            name: torch.stack([s[name] for s in slices]).reshape(
                *shape, *slices[0][name].shape)
            for name in slices[0]}
    return out


def state_dict_to_jax(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """A BERT or GPT unit's state dict -> its flax param tree (numpy,
    float32): the inverse of :func:`params_from_jax`'s mapping (dense
    ``weight [out, in]`` -> ``kernel [in, out]``, embeddings ->
    ``embedding``, LayerNorms -> ``scale``/``bias``, a parameter of the
    module itself unchanged)."""
    out: Dict[str, Any] = {}
    for name, value in sd.items():
        arr = value.detach().cpu().float().numpy()
        parts = name.split(".")
        node = out
        for p in parts[:-2]:
            node = node.setdefault(p, {})
        if len(parts) == 1:  # a parameter of the module itself
            out[name] = arr
            continue
        module, leaf = parts[-2], parts[-1]
        sub = node.setdefault(module, {})
        if module in _EMBEDDINGS:
            sub["embedding"] = arr
        elif module in _NORMS:
            sub["scale" if leaf == "weight" else "bias"] = arr
        elif leaf == "weight":
            sub["kernel"] = np.ascontiguousarray(arr.T)
        elif leaf == "bias":
            sub["bias"] = arr
        else:  # a parameter of a submodule itself (the MoE block's)
            sub[leaf] = arr
    return out


def spmd_params_to_jax(params: Mapping[str, Mapping[str, torch.Tensor]],
                       tp: int = 1) -> Dict[str, Any]:
    """The inverse of :func:`spmd_params_from_jax`: the port engine's
    global tree (``CompiledBertPipeline.gather``) -> the JAX engine's
    layout, numpy float32 leaves."""
    lead = 2 if tp > 1 else 1
    out: Dict[str, Any] = {}
    for group, sd in params.items():
        if group != "stages":
            out[group] = state_dict_to_jax(sd)
            continue
        first = next(iter(sd.values()))
        shape = tuple(first.shape[:lead])
        trees = [state_dict_to_jax({n: t[idx] for n, t in sd.items()})
                 for idx in np.ndindex(*shape)]

        def stack(nodes):
            if isinstance(nodes[0], dict):
                return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
            arr = np.stack(nodes)
            return arr.reshape(*shape, *nodes[0].shape)

        out["stages"] = stack(trees)
    return out


__all__ = ["BERT_LAYER_PARAMS", "GPT_LAYER_PARAMS", "LAYER_PARAMS",
           "RESNET_LAYER_PARAMS", "params_from_jax", "spmd_params_from_jax",
           "spmd_params_to_jax", "state_dict_to_jax"]
