"""LayerStack: the tuple-threading sequential container.

The port of ``skycomputing_tpu/builder/layer_stack.py``: a chain of
layer modules where each layer consumes the *tuple* of outputs of the
previous one.  In PyTorch the modules own their parameters, so the
stack is an ``nn.Module`` over an ``nn.ModuleList`` and no parameter
list is threaded beside the data.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

from torch import nn


def as_tuple(x) -> Tuple:
    return x if isinstance(x, tuple) else (x,)


class LayerStack(nn.Module):
    """An ordered chain of modules with tuple-threading semantics.

    The modules are ``self.layers`` (``nn.Module.modules`` is taken by
    PyTorch's own recursive iterator).
    """

    def __init__(self, modules: Sequence[Any]):
        super().__init__()
        self.layers = nn.ModuleList(modules)

    def __len__(self) -> int:
        return len(self.layers)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerStack(list(self.layers)[idx])
        return self.layers[idx]

    def forward(self, *inputs):
        """Forward the tuple of inputs through every layer; returns the
        final layer's raw output (tensor or tuple)."""
        data = tuple(inputs)
        out = data if len(data) > 1 else data[0]
        for module in self.layers:
            out = module(*data)
            data = as_tuple(out)
        return out


__all__ = ["LayerStack", "as_tuple"]
