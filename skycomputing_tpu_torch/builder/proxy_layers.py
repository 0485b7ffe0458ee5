"""Proxy layers for device benchmarking (the port of
``skycomputing_tpu/builder/proxy_layers.py``).

Both hold float32 parameters and compute in their ``dtype``, as the
port's BERT dense layers do:

- ``MatmulStack``: ``depth`` chained square products — the device
  benchmark's proxy (the experiment config times ``MatmulStack(1024, 4)``
  on a ``(256, 1024)`` input).  Its products are ``F.linear`` (cuBLAS on
  the card): the JAX package computes them outside any Pallas kernel.
- ``Conv2d``: a torch-signature 2D convolution over NCHW inputs, so
  reference-shaped proxy configs keep working.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..registry import LAYER
from ..utils import torch_dtype


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


@LAYER.register_module
class Conv2d(nn.Module):
    """2D convolution over NCHW inputs with a bias (flax ``nn.Conv``'s
    parameters: float32, computed in ``dtype``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Union[int, Tuple[int, int]] = 3,
                 padding: Union[int, Tuple[int, int]] = 0,
                 stride: Union[int, Tuple[int, int]] = 1,
                 dtype: str = "float32"):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.padding = _pair(padding)
        self.stride = _pair(stride)
        self.compute_dtype = torch_dtype(dtype)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kh, kw))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        stride=self.stride, padding=self.padding)


class _Linear(nn.Linear):
    """``nn.Linear`` with float32 parameters computing in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


@LAYER.register_module
class MatmulStack(nn.Module):
    """``depth`` chained products of width ``features`` (the first takes
    ``in_features``, by default ``features``) — a tensor-core-saturating
    speed proxy."""

    def __init__(self, features: int = 1024, depth: int = 4,
                 dtype: str = "bfloat16", in_features: Optional[int] = None):
        super().__init__()
        dt = torch_dtype(dtype)
        widths = [in_features or features] + [features] * depth
        self.mm = nn.ModuleList(_Linear(widths[i], features, dt)
                                for i in range(depth))
        self.compute_dtype = dt

    def forward(self, x):
        x = x.to(self.compute_dtype)
        for layer in self.mm:
            x = layer(x)
        return x


__all__ = ["Conv2d", "MatmulStack"]
