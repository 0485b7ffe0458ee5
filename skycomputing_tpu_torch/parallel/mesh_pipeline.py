"""Mesh-native stages (the port of
``skycomputing_tpu/parallel/mesh_pipeline.py``).

The paper's unequal layer->stage allocation, with each stage on a
contiguous sub-mesh of one global device order
(:func:`.mesh.stage_submeshes`): 1..K positions per stage under named
``('dp', 'tp')`` axes.  As in JAX, where a stage's parameters are
``P()`` (replicated over the sub-mesh) and its microbatch rows
``P("dp")``:

- every position of the sub-mesh holds a copy of the stage's
  parameters;
- a microbatch's rows are split into ``dp`` contiguous shards, shard d
  computed on the first position of dp row d (the row's ``tp``
  positions would compute the same rows again, so they compute
  nothing; ``tp`` changes no number);
- splitting rows gives JAX's numbers only where every unit treats rows
  independently.  A stage holding a unit that couples rows (its
  ``couples_rows`` attribute is true: ``GptBlock_MoeMlp``, whose expert
  capacity, routing priority and aux loss are over the call's B*L
  tokens) runs the whole microbatch on its first position, which is
  the function JAX's stage program computes over its sub-mesh;
- dropout draws shard d's masks from a seed derived from the stage's
  (:meth:`MeshStageRuntime._row_seed`): masks of the same law as the
  unsplit stage's, but not its draw, as JAX's threefry mask is not the
  port's either;
- each shard's forward and rematerialized backward run on its own
  position's copy; the copies' gradients are summed into position 0's
  in device order after the schedule's loop, applied once by position
  0's optimizer, and the updated parameters copied to every other
  position, so every copy stays identical.

The schedules (GPipe, 1F1B) are :class:`~.pipeline.PipelineModel`'s,
inherited unchanged: a stage takes its inputs on its first position
(``stage.device``) and gives its outputs back there.  At one position
per stage the stage IS a :class:`~.pipeline.StageRuntime`, so gradients
and parameters equal the MPMD engine's bit for bit.

JAX runs each stage as one compiled program over its sub-mesh, so its
host issues one dispatch per (microbatch, stage).  Eager PyTorch has no
such program: a stage of dp rows issues, per microbatch, dp forwards
and dp rematerialized backwards, each its own string of kernels, plus
the shards' copies; the port keeps no dispatch counter for it.

Chips-per-stage comes from the workers' ``extra_config['mesh_chips']``
(written by ``Allocator.mesh_allocate``), else from ``chips_per_stage``,
else one per stage.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..builder import as_tuple
from .mesh import stage_submeshes
from .pipeline import (
    OptimizerFactory,
    PipelineModel,
    StageRuntime,
    _build_stack,
)


def _row_shards(acts, dp: int, devices) -> List[tuple]:
    """Each tensor of ``acts`` split into ``dp`` contiguous row shards,
    shard d on ``devices[d]``; anything else is passed to every shard."""
    parts = [torch.tensor_split(x, dp) if isinstance(x, torch.Tensor)
             else [x] * dp for x in acts]
    return [tuple(p[d].to(devices[d]) if isinstance(p[d], torch.Tensor)
                  else p[d] for p in parts) for d in range(dp)]


def _join_rows(shards: List[tuple], device: torch.device) -> tuple:
    """The shards' outputs joined row-wise on ``device`` (``None`` where
    a shard has no tensor there)."""
    return tuple(
        torch.cat([s[j].to(device) for s in shards])
        if all(isinstance(s[j], torch.Tensor) for s in shards) else None
        for j in range(len(shards[0])))


class MeshStageRuntime(StageRuntime):
    """One mesh-native stage: a layer slice over a contiguous sub-mesh
    with ``dp`` x ``tp`` positions.  ``device`` is the sub-mesh's first
    position, where the schedule loops hand activations in and out."""

    def __init__(
        self,
        stage_index: int,
        layer_cfgs: Sequence[Dict],
        params: Sequence[Dict[str, torch.Tensor]],
        submesh,
        optimizer: OptimizerFactory,
        slowdown: float = 1.0,
        differentiable_inputs: bool = True,
    ):
        positions = list(submesh.devices.flatten())
        super().__init__(stage_index, layer_cfgs, params, positions[0],
                         optimizer, slowdown, differentiable_inputs)
        self.mesh = submesh
        self.dp = int(submesh.shape["dp"])
        self.tp = int(submesh.shape["tp"])
        # keep the "stage N" prefix: the trace analysis keys on it
        self.lane_name = (f"stage {stage_index} [{positions[0]}x"
                          f"{len(positions)} dp={self.dp} tp={self.tp}]")
        # the replicated copies at every other position, in device order
        self._copies = [_build_stack(layer_cfgs, params, dev)
                        for dev in positions[1:]]
        stacks = [self.stack] + self._copies
        # dp row d computes on its first position
        self._row_stacks = [stacks[d * self.tp] for d in range(self.dp)]
        self._row_devices = [positions[d * self.tp] for d in range(self.dp)]
        # rows are split only where no unit couples them
        self.splits_rows = self.dp > 1 and not any(
            getattr(m, "couples_rows", False) for m in self.stack.layers)

    def _row_seed(self, seed: Optional[int], d: int) -> Optional[int]:
        """Shard d's dropout seed: the stage's own for shard 0, one
        derived from it for the others, so no two shards draw one
        mask."""
        if seed is None or d == 0:
            return seed
        return (seed * 1_000_003 + d) % 2 ** 62

    def _set_mode(self, train: bool) -> None:
        for stack in self._row_stacks:
            if stack.training != train:
                stack.train(train)

    # --- execution ----------------------------------------------------------
    def forward_raw(self, inputs, seed=None, train: bool = True):
        if not self.splits_rows:
            return super().forward_raw(inputs, seed, train)
        self._set_mode(train)
        outs = []
        with torch.no_grad():
            for d, shard in enumerate(_row_shards(inputs, self.dp,
                                                  self._row_devices)):
                with self._dropout_seed(self._row_seed(seed, d),
                                        self._row_devices[d]):
                    outs.append(as_tuple(self._row_stacks[d](*shard)))
        return _join_rows(outs, self.device)

    def backward_raw(self, inputs, dy, seed=None):
        if not self.splits_rows:
            return super().backward_raw(inputs, dy, seed)
        self._set_mode(True)
        x_grads = []
        dy_shards = _row_shards(dy, self.dp, self._row_devices)
        for d, shard in enumerate(_row_shards(inputs, self.dp,
                                              self._row_devices)):
            with torch.enable_grad(), self._dropout_seed(
                    self._row_seed(seed, d), self._row_devices[d]):
                xs = tuple(
                    x.detach().requires_grad_(
                        self._differentiable_inputs
                        and x.is_floating_point())
                    if isinstance(x, torch.Tensor) else x
                    for x in shard)
                outs = as_tuple(self._row_stacks[d](*xs))
                pairs = [(o, g) for o, g in zip(outs, dy_shards[d])
                         if g is not None and isinstance(o, torch.Tensor)
                         and o.requires_grad]
                if pairs:
                    torch.autograd.backward([o for o, _ in pairs],
                                            [g for _, g in pairs])
            x_grads.append(tuple(x.grad if isinstance(x, torch.Tensor)
                                 else None for x in xs))
        if not self._differentiable_inputs:
            return None
        return _join_rows(x_grads, self.device)

    def reduce_gradients(self) -> None:
        """Sum every other row's gradients into position 0's, in device
        order, and clear them there."""
        for stack in self._row_stacks[1:]:
            for p0, p in zip(self.parameters, stack.parameters()):
                if p.grad is None:
                    continue
                g = p.grad.to(self.device)
                p0.grad = g if p0.grad is None else p0.grad + g
                p.grad = None

    def clear_copy_gradients(self) -> None:
        for stack in self._copies:
            stack.zero_grad(set_to_none=True)

    def apply_gradients(self) -> None:
        super().apply_gradients()
        with torch.no_grad():
            for stack in self._copies:
                for p, p0 in zip(stack.parameters(), self.parameters):
                    p.copy_(p0)

    # --- weights exchange ---------------------------------------------------
    def load_weights(self, state_dict_list: Sequence[Dict]) -> None:
        super().load_weights(state_dict_list)
        for stack in self._copies:
            for module, sd in zip(stack.layers, state_dict_list):
                module.load_state_dict(sd, strict=True)


class MeshPipelineModel(PipelineModel):
    """The mesh-native pipeline: stage runtimes on sub-mesh slices.

    :class:`~.pipeline.PipelineModel`'s constructor, plus chips per
    stage: each staged worker's ``extra_config['mesh_chips']`` where
    present (``rebuild()`` re-reads it), else ``chips_per_stage``, else
    one per stage; ``tp`` shapes each sub-mesh ``(chips // tp, tp)``.
    Devices are taken as contiguous blocks of ``devices`` in pipeline
    order, and a device may be listed more than once."""

    def __init__(
        self,
        worker_manager,
        parameter_server,
        optimizer: OptimizerFactory,
        loss_fn,
        devices: Optional[Sequence[Any]] = None,
        num_microbatches: int = 1,
        schedule: str = "gpipe",
        chips_per_stage: Optional[Sequence[int]] = None,
        tp: int = 1,
    ):
        self._chips_override = (
            [int(k) for k in chips_per_stage]
            if chips_per_stage is not None else None
        )
        self._tp = int(tp)
        super().__init__(
            worker_manager, parameter_server, optimizer, loss_fn,
            devices=devices, num_microbatches=num_microbatches,
            schedule=schedule,
        )

    # --- construction -------------------------------------------------------
    def _build_stages(self) -> None:
        self.stages = []
        workers = sorted(self._worker_manager.worker_pool,
                         key=lambda w: w.rank)
        staged = [w for w in workers if w.model_config]
        if any("mesh_chips" in w.extra_config for w in staged):
            # the allocator owns the mesh shape
            chips = [int(w.extra_config.get("mesh_chips", 1))
                     for w in staged]
        elif self._chips_override is not None:
            chips = list(self._chips_override)
            if len(chips) != len(staged):
                raise ValueError(
                    f"chips_per_stage has {len(chips)} entries for "
                    f"{len(staged)} staged workers"
                )
        else:
            chips = [1] * len(staged)
        meshes = stage_submeshes(chips, self._devices, tp=self._tp)
        layer_cursor = 0
        for i, (worker, submesh) in enumerate(zip(staged, meshes)):
            layer_cfgs = worker.model_config
            params = self._parameter_server.get_layer_slice(
                layer_cursor, layer_cursor + len(layer_cfgs))
            self.stages.append(MeshStageRuntime(
                stage_index=i,
                layer_cfgs=layer_cfgs,
                params=params,
                submesh=submesh,
                optimizer=self._optimizer,
                slowdown=float(worker.extra_config.get("slowdown", 1.0)),
                differentiable_inputs=i > 0,
            ))
            layer_cursor += len(layer_cfgs)
        if layer_cursor != self._parameter_server.num_layers:
            raise ValueError(
                f"workers cover {layer_cursor} layers but the model has "
                f"{self._parameter_server.num_layers} — run an allocator "
                f"first"
            )

    @property
    def chips_per_stage(self) -> List[int]:
        """Positions owned by each stage, pipeline order (dp x tp)."""
        return [s.dp * s.tp for s in self.stages]

    @property
    def _stage_devices(self) -> List[torch.device]:
        return [d for s in self.stages for d in s.mesh.devices.flatten()]

    # --- execution ----------------------------------------------------------
    def compute_gradients(self, data, labels,
                          generator: Optional[torch.Generator] = None):
        rows = np.shape(as_tuple(data)[0])[0] // max(self.num_microbatches,
                                                     1)
        bad = [s for s in self.stages if rows % s.dp]
        if bad:
            raise ValueError(
                f"microbatch rows {rows} not divisible by stage "
                f"{bad[0].stage_index}'s dp={bad[0].dp} — pick "
                f"num_microbatches/chips so every stage's dp divides "
                f"the microbatch"
            )
        _, losses, times = super().compute_gradients(data, labels,
                                                     generator)
        for stage in self.stages:
            stage.reduce_gradients()
        grad_totals = [[p.grad for p in stage.parameters]
                       for stage in self.stages]
        return grad_totals, losses, times

    def measure_stage_times(self, data, *args, **kwargs) -> List[float]:
        times = super().measure_stage_times(data, *args, **kwargs)
        for stage in self.stages:
            stage.clear_copy_gradients()
        return times


__all__ = ["MeshPipelineModel", "MeshStageRuntime"]
