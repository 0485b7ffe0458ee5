"""Reference (``scaelum``) checkpoints to the port's per-layer state dicts
and back (the port of ``skycomputing_tpu/utils/torch_convert.py``).

The reference saves a whole model as the ``state_dict`` of an
``nn.ModuleList`` of the decomposed layers
(``scaelum/dynamics/parameter_server.py:29-33``): keys read
``"{layer_idx}.{submodule path}.weight"``.  The port's units are the
same layers in PyTorch: every ``Linear`` holds ``weight [out, in]``,
every ``Embedding`` and ``LayerNorm`` ``weight``/``bias``, as the
reference's do, so the mapping renames submodules and transposes
nothing:

- ``BertLayer_Head``: ``attention.self.{query,key,value}`` ->
  ``self.{query,key,value}``, ``attention.output.{dense,LayerNorm}`` ->
  ``output.{dense,LayerNorm}``;
- ``BertLayer_Body``: ``intermediate.dense_act`` -> ``dense_act``;
- ``BertLayer_Tail``: ``output.{dense,LayerNorm}`` ->
  ``{dense,LayerNorm}``;
- ``BertEmbeddings``, ``BertPooler`` and ``BertTailForClassification``
  keep their names.

Conversion is indexed by layer, so the result loads under any
allocation (``ParameterServer(model_cfg, state_dicts=...)``).
Every tensor comes out as a contiguous float32 CPU copy, the form
``ParameterServer`` keeps.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

#: per layer type, (reference prefix, port prefix) pairs; a key under a
#: reference prefix maps to the same suffix under the port's
_RENAMES: Dict[str, Tuple[Tuple[str, str], ...]] = {
    "BertEmbeddings": (
        ("word_embeddings.", "word_embeddings."),
        ("position_embeddings.", "position_embeddings."),
        ("token_type_embeddings.", "token_type_embeddings."),
        ("LayerNorm.", "LayerNorm."),
    ),
    "BertLayer_Head": (
        ("attention.self.query.", "self.query."),
        ("attention.self.key.", "self.key."),
        ("attention.self.value.", "self.value."),
        ("attention.output.dense.", "output.dense."),
        ("attention.output.LayerNorm.", "output.LayerNorm."),
    ),
    "BertLayer_Body": (("intermediate.dense_act.", "dense_act."),),
    "BertLayer_Tail": (
        ("output.dense.", "dense."),
        ("output.LayerNorm.", "LayerNorm."),
    ),
    "BertPooler": (("dense_act.", "dense_act."),),
    "BertTailForClassification": (("classifier.", "classifier."),),
}


def _rules(layer_type: str) -> Tuple[Tuple[str, str], ...]:
    try:
        return _RENAMES[layer_type]
    except KeyError:
        raise ValueError(
            f"no conversion rule for layer type {layer_type!r}") from None


def _float32(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32).contiguous().clone()
    return torch.from_numpy(np.array(value, dtype=np.float32, copy=True))


def convert_layer(layer_type: str,
                  sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """One reference layer's state dict (keys without the layer index)
    -> the port unit's state dict.  A key no rule maps raises."""
    rules = _rules(layer_type)
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        for ref, port in rules:
            if key.startswith(ref):
                out[port + key[len(ref):]] = _float32(value)
                break
        else:
            raise KeyError(f"{layer_type}: no rule maps key {key!r}")
    return out


def layer_to_torch(layer_type: str,
                   sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`convert_layer`: a port unit's state dict ->
    the reference layer's keys."""
    rules = _rules(layer_type)
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        for ref, port in rules:
            if key.startswith(port):
                out[ref + key[len(port):]] = _float32(value)
                break
        else:
            raise KeyError(f"{layer_type}: no rule maps key {key!r}")
    return out


def split_modulelist_state_dict(
        state: Mapping[str, Any]) -> List[Dict[str, Any]]:
    """``"{idx}.{path}"`` keys -> per-layer dicts, in layer order."""
    layers: Dict[int, Dict[str, Any]] = {}
    for key, value in state.items():
        idx, path = key.split(".", 1)
        layers.setdefault(int(idx), {})[path] = value
    return [layers[i] for i in sorted(layers)]


def convert_state_dict(state: Mapping[str, Any],
                       model_cfg: Sequence[Dict]) -> List[Dict[str, torch.Tensor]]:
    """A reference ``ModuleList`` state dict -> the port's per-layer
    state dicts; ``model_cfg`` is the layer-config list it was trained
    against (layer order defines the mapping)."""
    per_layer = split_modulelist_state_dict(state)
    if len(per_layer) != len(model_cfg):
        raise ValueError(
            f"checkpoint has {len(per_layer)} layers, model config has "
            f"{len(model_cfg)}")
    return [convert_layer(cfg["layer_type"], sd)
            for cfg, sd in zip(model_cfg, per_layer)]


def convert_torch_checkpoint(checkpoint_path: str,
                             model_cfg: Sequence[Dict]) -> List[Dict[str, torch.Tensor]]:
    """A reference ``.pth`` whole-model checkpoint -> the port's
    per-layer state dicts."""
    state = torch.load(checkpoint_path, map_location="cpu",
                       weights_only=True)
    return convert_state_dict(state, model_cfg)


def to_torch_state_dict(state_dicts: Sequence[Mapping[str, torch.Tensor]],
                        model_cfg: Sequence[Dict]) -> Dict[str, torch.Tensor]:
    """The port's per-layer state dicts -> the reference ``ModuleList``
    state dict (float32 CPU tensors, ``"{idx}.{path}"`` keys): the exact
    inverse of :func:`convert_state_dict`, so weights move port ->
    reference -> port bit for bit."""
    if len(state_dicts) != len(model_cfg):
        raise ValueError(
            f"{len(state_dicts)} state dicts for {len(model_cfg)} layers")
    state: Dict[str, torch.Tensor] = {}
    for idx, (cfg, sd) in enumerate(zip(model_cfg, state_dicts)):
        for path, t in layer_to_torch(cfg["layer_type"], sd).items():
            state[f"{idx}.{path}"] = t
    return state


def convert_hf_bert_state_dict(
        state: Mapping[str, Any],
        model_cfg: Sequence[Dict]) -> List[Dict[str, torch.Tensor]]:
    """A HuggingFace ``bert-*`` state dict (``BertModel`` or
    ``BertForSequenceClassification`` naming, with or without the
    ``bert.`` prefix) -> the port's per-layer state dicts.  The encoder
    depth must match ``model_cfg``'s trio count; heads the config does
    not hold (MLM and the like) are ignored, and a config whose last
    unit is the classifier needs the checkpoint's ``classifier``."""
    sd = {(k[5:] if k.startswith("bert.") else k): v
          for k, v in state.items()}

    def sub(prefix: str, into: str) -> Dict[str, Any]:
        hit = {into + k[len(prefix):]: v for k, v in sd.items()
               if k.startswith(prefix)}
        if not hit:
            raise KeyError(f"no checkpoint entries under {prefix!r}")
        return hit

    out: List[Dict[str, torch.Tensor]] = []
    unit = 0
    for cfg in model_cfg:
        lt = cfg["layer_type"]
        enc = f"encoder.layer.{unit}."
        if lt == "BertEmbeddings":
            layer = sub("embeddings.", "")
        elif lt == "BertLayer_Head":
            layer = sub(enc + "attention.", "attention.")
        elif lt == "BertLayer_Body":
            layer = sub(enc + "intermediate.dense.",
                        "intermediate.dense_act.")
        elif lt == "BertLayer_Tail":
            layer = sub(enc + "output.", "output.")
            unit += 1
        elif lt == "BertPooler":
            layer = sub("pooler.dense.", "dense_act.")
        elif lt == "BertTailForClassification":
            if not any(k.startswith("classifier.") for k in sd):
                raise KeyError(
                    "checkpoint has no classifier head; fine-tune configs "
                    "should init it fresh (drop the tail from model_cfg "
                    "and append a fresh-initialized layer)")
            layer = sub("classifier.", "classifier.")
        else:
            raise ValueError(f"no conversion rule for layer type {lt!r}")
        # HF's embeddings also hold index buffers (``position_ids``,
        # ``token_type_ids``); the port derives them
        rules = _rules(lt)
        layer = {k: v for k, v in layer.items()
                 if any(k.startswith(ref) for ref, _ in rules)}
        out.append(convert_layer(lt, layer))
    return out


__all__ = [
    "convert_hf_bert_state_dict",
    "convert_layer",
    "convert_state_dict",
    "convert_torch_checkpoint",
    "layer_to_torch",
    "split_modulelist_state_dict",
    "to_torch_state_dict",
]
