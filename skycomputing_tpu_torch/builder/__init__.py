"""Config-driven factories: layer-config list -> ``build_layer`` each ->
:class:`LayerStack` (the port of ``skycomputing_tpu/builder``)."""

from __future__ import annotations

from typing import Dict, Sequence

from ..registry import LAYER
from .layer_stack import LayerStack, as_tuple


def build_layer(layer_type: str, **kwargs):
    """Instantiate one registered layer module from its config kwargs."""
    cls = LAYER.get_module(layer_type)
    return cls(**kwargs)


def build_layer_stack(model_cfg: Sequence[Dict]) -> LayerStack:
    """Layer-config list -> LayerStack of instantiated modules."""
    modules = []
    for layer_cfg in model_cfg:
        cfg = dict(layer_cfg)
        layer_type = cfg.pop("layer_type")
        modules.append(build_layer(layer_type, **cfg))
    return LayerStack(modules)


__all__ = ["LayerStack", "as_tuple", "build_layer", "build_layer_stack"]
