"""Device meshes for the port's parallel engines (the port of
``skycomputing_tpu/parallel/mesh.py``).

A :class:`Mesh` is a named grid of ``torch.device`` positions: a numpy
object array of devices, its ``axis_names``, and ``shape[axis]``, as
JAX's ``Mesh`` offers them to callers.  The engines that take one are
single-controller: one Python process drives every position, and data
moves between positions with ``Tensor.to(device)`` (a no-op where two
positions share a device).

A device may appear more than once only where the caller lists it so:
``make_1d_mesh(4, "sp", [torch.device("cuda", 0)] * 4)`` stands one
card for four positions, and ``[torch.device("cpu")] * 4`` does the
same on the CPU.  ``devices=None`` takes every CUDA device and raises
where there is none (:func:`~..utils.resolve_devices`).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import resolve_devices


class Mesh:
    """A named grid of devices: ``devices`` (a numpy object array of
    ``torch.device``), ``axis_names`` (one per array axis), ``shape``
    (axis name -> size) and ``size`` (positions in all)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.array(devices, dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(grid[idx])
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names):
            raise ValueError(
                f"{len(axis_names)} axis names {axis_names} for a "
                f"{grid.ndim}-d device grid")
        self.devices = grid
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, grid.shape))
        self.size = int(grid.size)

    def ring(self, axis_name: str, like: torch.Tensor) -> list:
        """The devices of a 1-d mesh's positions along ``axis_name``, in
        order; for a ``like`` tensor on ``meta``, ``meta`` at every
        position, so a shape-only run moves nothing to the mesh's
        devices."""
        if self.axis_names != (axis_name,):
            raise ValueError(
                f"need a 1-d mesh over {axis_name!r}, got axes "
                f"{self.axis_names}")
        if like.device.type == "meta":
            return [like.device] * self.size
        return list(self.devices.flatten())

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"devices={[str(d) for d in self.devices.flatten()]})")


class _OnePosition(torch.autograd.Function):
    """See :func:`one_position`."""

    @staticmethod
    def forward(ctx, program, S, x, *rest):
        ctx.avals = [(t.shape, t.dtype) for t in (x, *rest)]
        out = program(x[:, :x.shape[1] // S], *rest)
        return out.new_empty((out.shape[0], x.shape[1], *out.shape[2:]))

    @staticmethod
    def backward(ctx, grad_out):
        return (None, None, *(
            grad_out.new_empty(shape, dtype=dtype) if need else None
            for (shape, dtype), need in zip(ctx.avals,
                                            ctx.needs_input_grad[2:])))


def one_position(program, S: int, x: torch.Tensor,
                 *rest: torch.Tensor) -> torch.Tensor:
    """A sequence-parallel unit on ``meta`` (the static profile, the
    pre-flight): ``program(x[:, :L/S], *rest)`` runs position 0's
    program over its L/S rows of ``x`` [B, L, ...], which is what XLA's
    cost analysis charges the JAX unit's sharded program (one device's
    share), and the result has ``x``'s length, with gradients of the
    inputs' shapes.  On a real device the engines run every position
    instead."""
    return _OnePosition.apply(program, S, x, *rest)


def make_1d_mesh(size: int, axis_name: str,
                 devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh of ``size`` devices under ``axis_name``."""
    devs = resolve_devices(devices)
    if len(devs) < size:
        raise ValueError(
            f"need {size} devices for the {axis_name} mesh, have {len(devs)}"
        )
    return Mesh(np.array(devs[:size], dtype=object), (axis_name,))


def make_pipeline_mesh(num_stages: int,
                       devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D ('pp',) mesh over the first ``num_stages`` devices."""
    return make_1d_mesh(num_stages, "pp", devices)


def make_dp_pp_mesh(dp: int, pp: int,
                    devices: Optional[Sequence] = None) -> Mesh:
    """('dp', 'pp') mesh: data-parallel replicas of a pipeline, pp
    innermost."""
    devs = resolve_devices(devices)
    if len(devs) < dp * pp:
        raise ValueError(f"need {dp * pp} devices, have {len(devs)}")
    grid = np.array(devs[: dp * pp], dtype=object).reshape(dp, pp)
    return Mesh(grid, ("dp", "pp"))


def make_dp_pp_tp_mesh(dp: int, pp: int, tp: int,
                       devices: Optional[Sequence] = None) -> Mesh:
    """('dp', 'pp', 'tp') mesh for 3-D parallel pipelines: tp innermost,
    then pp, dp outermost."""
    devs = resolve_devices(devices)
    if len(devs) < dp * pp * tp:
        raise ValueError(f"need {dp * pp * tp} devices, have {len(devs)}")
    grid = np.array(devs[: dp * pp * tp], dtype=object).reshape(dp, pp, tp)
    return Mesh(grid, ("dp", "pp", "tp"))


def stage_submeshes(chips_per_stage: Sequence[int],
                    devices: Optional[Sequence] = None, tp: int = 1,
                    axis_names: Tuple[str, str] = ("dp", "tp")) -> list:
    """Contiguous sub-mesh slices of ONE global device order.

    Stage ``i`` owns ``devices[sum(chips[:i]) : sum(chips[:i+1])]``
    reshaped to ``(chips_i // tp, tp)`` under ``('dp', 'tp')``: the
    mesh-native engine runs each stage on one of these slices, so
    chips-per-stage is an allocator output."""
    devs = resolve_devices(devices)
    chips = [int(k) for k in chips_per_stage]
    if not chips:
        raise ValueError("chips_per_stage is empty")
    if any(k < 1 for k in chips):
        raise ValueError(f"chips_per_stage must be >= 1, got {chips}")
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    need = sum(chips)
    if need > len(devs):
        raise ValueError(
            f"mesh shape {chips} needs {need} devices, have {len(devs)}"
        )
    meshes = []
    offset = 0
    for i, k in enumerate(chips):
        if k % tp:
            raise ValueError(
                f"stage {i}: {k} chips not divisible by tp={tp}"
            )
        block = np.array(devs[offset:offset + k],
                         dtype=object).reshape(k // tp, tp)
        meshes.append(Mesh(block, tuple(axis_names)))
        offset += k
    return meshes


__all__ = [
    "Mesh",
    "make_1d_mesh",
    "make_pipeline_mesh",
    "make_dp_pp_mesh",
    "make_dp_pp_tp_mesh",
    "one_position",
    "stage_submeshes",
]
