"""Data-parallel replicas of the MPMD pipeline (the port of
``skycomputing_tpu/parallel/data_parallel.py``).

R :class:`~.pipeline.PipelineModel` replicas on disjoint slices of one
device list share one :class:`~..dynamics.ParameterServer`.  A step
splits the batch into R contiguous shards, computes each replica's
gradients on its shard (with its own dropout seeds), averages each
stage's gradients on replica 0's stage device, adding in replica order,
and hands the average to every replica, whose own optimizer applies
it.  Identical updates keep the replicas identical, so no parameter is
ever broadcast.

The controller is single, as in JAX: one process issues every
replica's work, and gradients move between replicas with
``Tensor.to``.  A device may be listed more than once
(``[torch.device("cuda", 0)] * 2`` puts both replicas on one card).
"""

from __future__ import annotations

import copy
import time
from typing import Any, Callable, List, Optional, Sequence

import torch

from ..builder import as_tuple
from ..dynamics.parameter_server import ParameterServer
from ..dynamics.worker_manager import WorkerManager
from ..utils import resolve_devices
from .pipeline import (
    OptimizerFactory,
    PipelineModel,
    PipelineStats,
    _split_microbatches,
    _synchronize,
    device_put_elided,
)


class DataParallelPipeline:
    """R pipeline replicas + gradient all-reduce, sharing one
    ParameterServer.

    ``devices`` must hold at least ``num_replicas x devices_per_replica``
    entries; replica r uses the slice ``devices[r * devices_per_replica :
    (r+1) * devices_per_replica]``, with the worker pool's
    ``device_index`` values resolved inside that slice."""

    def __init__(
        self,
        worker_manager: WorkerManager,
        parameter_server: ParameterServer,
        optimizer: OptimizerFactory,
        loss_fn: Callable,
        num_replicas: int,
        devices: Optional[Sequence[Any]] = None,
        devices_per_replica: Optional[int] = None,
        num_microbatches: int = 1,
        schedule: str = "gpipe",
    ):
        devices = resolve_devices(devices)
        if devices_per_replica is None:
            devices_per_replica = max(
                w.device_index for w in worker_manager.worker_pool
            ) + 1
        need = num_replicas * devices_per_replica
        if len(devices) < need:
            raise ValueError(
                f"{num_replicas} replicas x {devices_per_replica} devices "
                f"need {need} devices, have {len(devices)}"
            )
        self.num_replicas = num_replicas
        self.replicas: List[PipelineModel] = [
            PipelineModel(
                worker_manager,
                parameter_server,
                optimizer,
                loss_fn,
                devices=devices[
                    r * devices_per_replica:(r + 1) * devices_per_replica
                ],
                num_microbatches=num_microbatches,
                schedule=schedule,
            )
            for r in range(num_replicas)
        ]
        self.stats = PipelineStats()
        self._step_call_count = 0

    def set_loss_fn(self, loss_fn: Callable) -> None:
        for model in self.replicas:
            model.set_loss_fn(loss_fn)

    def _split_replicas(self, tree):
        return _split_microbatches(tree, self.num_replicas, what="replicas")

    def train_step(self, data, labels,
                   generator: Optional[torch.Generator] = None) -> float:
        """One data-parallel step: shard the batch, compute each replica's
        gradients, average them per stage, update every replica.  Returns
        the mean loss over the replicas."""
        if generator is None:
            # deterministic default: a per-call counter, so identically
            # seeded runs replay identically
            generator = torch.Generator().manual_seed(
                2_000_003 + self._step_call_count)
            self._step_call_count += 1
        R = self.num_replicas
        data_shards = self._split_replicas(as_tuple(data))
        label_shards = self._split_replicas(labels)
        # replica r's dropout seeds come from its own generator, seeded
        # from the step's generator and r (JAX: fold_in(rng, r))
        replica_seeds = torch.randint(0, 2 ** 62, (R,),
                                      generator=generator).tolist()

        t0 = time.perf_counter()
        grads_per_replica = []
        losses: List[torch.Tensor] = []
        for r, model in enumerate(self.replicas):
            grads, replica_losses, _ = model.compute_gradients(
                data_shards[r], label_shards[r],
                torch.Generator().manual_seed(replica_seeds[r]))
            grads_per_replica.append(grads)
            losses.extend(replica_losses)
        t1 = time.perf_counter()

        # all-reduce: sum each stage's gradients on replica 0's stage
        # device in replica order, divide by R, hand the same average to
        # every replica (a copy on each replica's own device)
        averaged = []
        for k, stage0 in enumerate(self.replicas[0].stages):
            stage_avg = []
            for j, total in enumerate(grads_per_replica[0][k]):
                if total is not None:  # a parameter the loss never reached
                    for r in range(1, R):
                        total = total + device_put_elided(
                            grads_per_replica[r][k][j], stage0.device)
                    total = total / R
                stage_avg.append(total)
            averaged.append(stage_avg)
        for r, model in enumerate(self.replicas):
            model.apply_gradients([
                [g if r == 0 or g is None
                 else g.to(stage.device, copy=True) for g in averaged[k]]
                for k, stage in enumerate(model.stages)])
        _synchronize([s.device for m in self.replicas for s in m.stages])
        t2 = time.perf_counter()

        total_loss = float(sum(loss.item() for loss in losses) / R)
        # forward_s: every replica's forward and backward; step_s: the
        # all-reduce and the updates
        self.stats = PipelineStats(
            forward_s=t1 - t0, backward_s=0.0, step_s=t2 - t1,
            loss=total_loss, interleaved=True,
        )
        return total_loss

    def forward(self, data, generator: Optional[torch.Generator] = None):
        return self.replicas[0].forward(data, generator)

    def sync_to_parameter_server(self) -> None:
        self.replicas[0].sync_to_parameter_server()

    def load_from_parameter_server(self) -> None:
        for model in self.replicas:
            model.load_from_parameter_server()

    def train(self, mode: bool = True) -> None:
        for model in self.replicas:
            model.train(mode)

    # --- training state -----------------------------------------------------
    def get_optimizer_state(self):
        """Replica 0's state: the replicas are identical by
        construction."""
        return self.replicas[0].get_optimizer_state()

    def load_optimizer_state(self, state) -> None:
        # into EVERY replica: restoring one would desync their momentum.
        # Each takes its own copy: torch.optim keeps the tensors it is
        # given, and replicas on one device would share their moments
        for model in self.replicas:
            model.load_optimizer_state(copy.deepcopy(state))

    @property
    def _loss_fn(self):
        return self.replicas[0]._loss_fn


__all__ = ["DataParallelPipeline"]
