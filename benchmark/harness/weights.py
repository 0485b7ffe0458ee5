"""Weights from the run seed, made on the device in one draw.

A layout is a list of units, each a list of ``(key, shape, kind)``:
``"w"`` N(0, std), ``"b"`` N(0, std) (biases and LayerNorm offsets),
``"g"`` 1 + N(0, std) (LayerNorm scales), ``"fan"`` N(0, 1/fan_in) (a
kernel initialised by its fan-in, the last dimension).  One
``torch.randn`` over every leaf, on a generator on ``device`` seeded
with the run seed, so the same seed makes the same tensors on the same
device, and the program and the reference read the same ones.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

Layout = Sequence[Sequence[Tuple[str, Tuple[int, ...], str]]]


def numel(layout: Layout) -> int:
    return sum(math.prod(shape) for unit in layout for _, shape, _ in unit)


def make(layout: Layout, seed: int, device, std: float,
         dtype: torch.dtype = torch.float32) -> List[Dict[str, torch.Tensor]]:
    """Per-unit dicts of views into one ``dtype`` buffer on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(numel(layout), generator=gen, device=device,
                       dtype=dtype)
    units, cursor = [], 0
    for unit in layout:
        out = {}
        for key, shape, kind in unit:
            n = math.prod(shape)
            leaf = flat[cursor:cursor + n].view(shape)
            cursor += n
            if kind == "fan":
                leaf.mul_(1.0 / math.sqrt(shape[-1]))
            else:
                leaf.mul_(std)
                if kind == "g":
                    leaf.add_(1.0)
                elif kind not in ("w", "b"):
                    raise ValueError(f"unknown init kind {kind!r}")
            out[key] = leaf
        units.append(out)
    return units
