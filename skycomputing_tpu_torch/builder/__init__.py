"""Config-driven factories (the port of ``skycomputing_tpu/builder``):
layer-config list -> ``build_layer`` each -> :class:`LayerStack`, plus
hooks, data generators and dataloaders from their configs."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from ..registry import DATA_GENERATOR, DATASET, HOOKS, LAYER
from . import proxy_layers  # noqa: F401 - registers Conv2d / MatmulStack
from .layer_stack import LayerStack, as_tuple


def build_layer(layer_type: str, **kwargs):
    """Instantiate one registered layer module from its config kwargs."""
    cls = LAYER.get_module(layer_type)
    return cls(**kwargs)


def build_hook(cfg: Dict):
    from ..runner import hooks_collection  # noqa: F401 - registers hooks

    cfg = dict(cfg)
    hook_type = cfg.pop("type")
    return HOOKS.get_module(hook_type)(**cfg)


def build_data_generator(generator_type: str, generator_cfg: Dict):
    from .. import dataset  # noqa: F401 - registers the generators

    return DATA_GENERATOR.get_module(generator_type)(**generator_cfg)


def build_layer_stack(model_cfg: Sequence[Dict]) -> LayerStack:
    """Layer-config list -> LayerStack of instantiated modules."""
    modules = []
    for layer_cfg in model_cfg:
        cfg = dict(layer_cfg)
        layer_type = cfg.pop("layer_type")
        modules.append(build_layer(layer_type, **cfg))
    return LayerStack(modules)


def build_module_from_cfg(
    model_cfg: Sequence[Dict],
    rank: Optional[int] = None,
    module_wrapper_cfg: Optional[Dict] = None,
) -> LayerStack:
    """The reference's name for :func:`build_layer_stack`; ``rank`` and
    ``module_wrapper_cfg`` are accepted and ignored (device binding,
    slowdown and memory limit belong to the pipeline stage)."""
    return build_layer_stack(model_cfg)


def build_dataloader_from_cfg(data_cfg: Dict):
    """Dataset cfg + dataloader cfg -> DataLoader."""
    from ..dataset import DataLoader  # registers the datasets

    dataset_cfg = dict(data_cfg["dataset_cfg"])
    dataloader_cfg = dict(data_cfg.get("dataloader_cfg", {}))
    ds_type = dataset_cfg.pop("type")
    dataset = DATASET.get_module(ds_type)(**dataset_cfg)
    return DataLoader(dataset, **dataloader_cfg)


__all__ = [
    "LayerStack",
    "as_tuple",
    "build_data_generator",
    "build_dataloader_from_cfg",
    "build_hook",
    "build_layer",
    "build_layer_stack",
    "build_module_from_cfg",
]
