"""ResNet decomposed into pipeline-splittable units (the port of
``skycomputing_tpu/models/resnet.py``).

``ResHead`` (the CIFAR stem), ``ResLayer`` (one stage of residual
blocks) and ``ResTail`` (global average pool + classifier) are the
registered units; ``BasicBlock`` / ``BottleNeck`` the blocks;
:func:`resnet_layer_configs` gives the JAX package's layer-config list
(with the input width of each stage and of the tail, which a PyTorch
layer is built with and flax infers) and ``resnet18`` ... ``resnet152``
the monolithic models.

Images flow NCHW, PyTorch's layout, from unit to unit (the JAX units
pass NHWC); ``ResHead`` also takes NHWC and transposes it once, as the
JAX stem takes both.  Normalization is GroupNorm with ``min(32, C)``
groups and flax's epsilon 1e-6 (the batch statistics of BatchNorm would
be state shared across microbatches).  Convolutions carry no bias; 3x3
convolutions pad 1, and the strided 1x1 downsample pads nothing, which
is what flax's ``'SAME'`` gives a 1x1 kernel.  Everything computes in
float32, as in JAX.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from ..registry import LAYER


def _norm(features: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, features), features, eps=1e-6)


def _conv(n_in: int, n_out: int, kernel: int, stride: int = 1
          ) -> nn.Conv2d:
    return nn.Conv2d(n_in, n_out, kernel, stride=stride,
                     padding=kernel // 2, bias=False)


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (expansion 1)."""

    expansion = 1

    def __init__(self, in_features: int, features: int, strides: int = 1):
        super().__init__()
        self.conv1 = _conv(in_features, features, 3, strides)
        self.norm1 = _norm(features)
        self.conv2 = _conv(features, features, 3)
        self.norm2 = _norm(features)
        if in_features != features or strides != 1:
            self.downsample = _conv(in_features, features, 1, strides)
            self.norm_down = _norm(features)
        else:
            self.downsample = None

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        residual = x
        if self.downsample is not None:
            residual = self.norm_down(self.downsample(x))
        return F.relu(y + residual)


class BottleNeck(nn.Module):
    """1x1 -> 3x3 -> 1x1 residual block (expansion 4)."""

    expansion = 4

    def __init__(self, in_features: int, features: int, strides: int = 1):
        super().__init__()
        out_features = features * self.expansion
        self.conv1 = _conv(in_features, features, 1)
        self.norm1 = _norm(features)
        self.conv2 = _conv(features, features, 3, strides)
        self.norm2 = _norm(features)
        self.conv3 = _conv(features, out_features, 1)
        self.norm3 = _norm(out_features)
        if in_features != out_features or strides != 1:
            self.downsample = _conv(in_features, out_features, 1, strides)
            self.norm_down = _norm(out_features)
        else:
            self.downsample = None

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        residual = x
        if self.downsample is not None:
            residual = self.norm_down(self.downsample(x))
        return F.relu(y + residual)


_BLOCKS = {"BasicBlock": BasicBlock, "BottleNeck": BottleNeck}


@LAYER.register_module
class ResHead(nn.Module):
    """Stem: 3x3 conv + norm + relu (CIFAR-style)."""

    def __init__(self, in_channels: int = 3, features: int = 64):
        super().__init__()
        self.in_channels = in_channels
        self.conv1 = _conv(in_channels, features, 3)
        self.norm1 = _norm(features)

    def forward(self, x):
        if x.shape[1] != self.in_channels and x.shape[-1] == self.in_channels:
            x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW once on entry
        return F.relu(self.norm1(self.conv1(x)))


@LAYER.register_module
class ResLayer(nn.Module):
    """One stage: ``num_blocks`` residual blocks at a feature width.

    ``in_features`` is the width entering the stage, which flax infers
    from the input and a PyTorch convolution needs when it is built
    (:func:`resnet_layer_configs` gives each stage its own)."""

    def __init__(self, block_type: str, num_blocks: int, features: int,
                 strides: int = 1, in_features: int = 64):
        super().__init__()
        block_cls = _BLOCKS[block_type]
        self.num_blocks = num_blocks
        width = in_features
        for i in range(num_blocks):
            self.add_module(f"block{i}", block_cls(
                width, features, strides=strides if i == 0 else 1))
            width = features * block_cls.expansion

    def forward(self, x):
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        return x


@LAYER.register_module
class ResTail(nn.Module):
    """Global average pool + linear classifier over ``in_features``
    channels."""

    def __init__(self, num_classes: int = 10, in_features: int = 512):
        super().__init__()
        self.fc = nn.Linear(in_features, num_classes)

    def forward(self, x):
        return self.fc(x.mean(dim=(2, 3)))


def resnet_layer_configs(block_type: str, blocks_per_stage: Sequence[int],
                         num_classes: int = 10, in_channels: int = 3
                         ) -> list:
    """Full layer-config list: head + one ``ResLayer`` per stage + tail:
    the JAX package's dicts, plus the ``in_features`` each stage and the
    tail are built with."""
    widths = [64, 128, 256, 512]
    expansion = _BLOCKS[block_type].expansion
    cfgs = [dict(layer_type="ResHead", in_channels=in_channels,
                 features=64)]
    width = 64
    for i, (n, w) in enumerate(zip(blocks_per_stage, widths)):
        cfgs.append(dict(layer_type="ResLayer", block_type=block_type,
                         num_blocks=n, features=w,
                         strides=1 if i == 0 else 2, in_features=width))
        width = w * expansion
    cfgs.append(dict(layer_type="ResTail", num_classes=num_classes,
                     in_features=width))
    return cfgs


class ResNet(nn.Module):
    """Monolithic ResNet: the units of :func:`resnet_layer_configs` in
    one module."""

    def __init__(self, block_type: str, blocks_per_stage: Sequence[int],
                 num_classes: int = 10, in_channels: int = 3):
        super().__init__()
        units = []
        for cfg in resnet_layer_configs(block_type, blocks_per_stage,
                                        num_classes, in_channels):
            cfg = dict(cfg)
            units.append(LAYER.get_module(cfg.pop("layer_type"))(**cfg))
        self.units = nn.ModuleList(units)

    def forward(self, x):
        for unit in self.units:
            x = unit(x)
        return x


def resnet18(**kw) -> ResNet:
    return ResNet("BasicBlock", [2, 2, 2, 2], **kw)


def resnet34(**kw) -> ResNet:
    return ResNet("BasicBlock", [3, 4, 6, 3], **kw)


def resnet50(**kw) -> ResNet:
    return ResNet("BottleNeck", [3, 4, 6, 3], **kw)


def resnet101(**kw) -> ResNet:
    return ResNet("BottleNeck", [3, 4, 23, 3], **kw)


def resnet152(**kw) -> ResNet:
    return ResNet("BottleNeck", [3, 8, 36, 3], **kw)


__all__ = ["BasicBlock", "BottleNeck", "ResHead", "ResLayer", "ResNet",
           "ResTail", "resnet101", "resnet152", "resnet18", "resnet34",
           "resnet50", "resnet_layer_configs"]
