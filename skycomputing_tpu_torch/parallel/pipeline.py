"""Host-driven MPMD pipeline engine (the port of
``skycomputing_tpu/parallel/pipeline.py``).

- each pipeline **stage** is a contiguous layer slice whose modules,
  parameters and optimizer live on that stage's device;
- **activation handoff** is ``Tensor.to(device)`` between stages (a
  no-op where producer and consumer share a device);
- **backward** rematerializes: a stage stores only its inputs, and its
  backward re-runs the stage forward under ``torch.enable_grad()`` and
  back-propagates the next stage's input cotangent ``dy`` through it,
  returning the cotangents of its own (floating) inputs.  Stage 0 takes
  no input cotangent.  The forward pass itself runs under
  ``torch.no_grad()``, so no activation outlives its stage call;
- **microbatching** is GPipe fill-drain: contiguous leading-axis chunks
  of the batch (labels split the same way), every forward, then every
  backward in reverse microbatch order, each loss scaled by ``1/M``
  with its ``dlogits`` taken from the loss; the gradients accumulate in
  the parameters' ``.grad`` in the JAX engine's summation order; the
  last stage's outputs after the logits get no cotangent;
- each stage's **optimizer** is built by a factory over the stage's
  parameters (:func:`sgd`: ``torch.optim.SGD(lr)``, the update of
  ``optax.sgd``);
- per-worker **slowdown** emulation sleeps ``elapsed x (slowdown - 1)``
  after each stage call, as in the JAX engine.

Dropout masks come from per-(microbatch, stage) seeds drawn from the
step's ``torch.Generator``; a stage with live dropout runs its forward
and its rematerialized forward under the same seed, so both see the
same mask.

Devices default to every CUDA device; with no card and no explicit
``devices=[torch.device("cpu")]`` construction raises.  Not ported yet
(slice 4): the 1F1B schedule and ``measure_stage_times``; optimizers
other than SGD and optimizer-state checkpoints are not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..builder import as_tuple, build_layer_stack
from ..dynamics.parameter_server import ParameterServer
from ..dynamics.worker_manager import WorkerManager
from ..utils import resolve_device

OptimizerFactory = Callable[[List[nn.Parameter]], torch.optim.Optimizer]


def _not_ported(feature: str):
    raise NotImplementedError(
        f"{feature} is not ported to the PyTorch pipeline yet (slice 4)"
    )


def sgd(learning_rate: float) -> OptimizerFactory:
    """``optax.sgd(learning_rate)``'s update as a per-stage factory."""
    return functools.partial(torch.optim.SGD, lr=learning_rate)


def _to_device(acts: Tuple, device: torch.device) -> Tuple:
    """Every tensor (or numpy array) of ``acts`` on ``device``."""
    return tuple(
        torch.as_tensor(x, device=device)
        if isinstance(x, (torch.Tensor, np.ndarray)) else x
        for x in acts
    )


def _split_microbatches(tree, num_microbatches: int):
    """Leading-axis split of every leaf (numpy or tensor) into equal
    contiguous chunks; a tuple comes back as a list of tuples."""
    def split(x):
        x = torch.as_tensor(x)
        if x.shape[0] % num_microbatches != 0:
            raise ValueError(
                f"batch size {x.shape[0]} not divisible by "
                f"{num_microbatches} microbatches"
            )
        return x.reshape(num_microbatches, x.shape[0] // num_microbatches,
                         *x.shape[1:])
    if isinstance(tree, tuple):
        parts = [split(x) for x in tree]
        return [tuple(p[m] for p in parts) for m in range(num_microbatches)]
    whole = split(tree)
    return [whole[m] for m in range(num_microbatches)]


def _synchronize(devices) -> None:
    for device in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(device)


def _build_stack(layer_cfgs, state_dicts, device):
    """The slice's modules on ``device``, holding ``state_dicts``
    (built on the meta device first: no throwaway initialization)."""
    with torch.device("meta"):
        stack = build_layer_stack(layer_cfgs)
    stack = stack.to_empty(device=device)
    for module, sd in zip(stack.layers, state_dicts):
        module.load_state_dict(sd, strict=True)
    return stack


class StageRuntime:
    """One pipeline stage: layer slice + device + optimizer."""

    #: injectable slowdown-emulation hooks (tests substitute fakes)
    _clock = staticmethod(time.perf_counter)
    _sleep = staticmethod(time.sleep)

    def __init__(
        self,
        stage_index: int,
        layer_cfgs: Sequence[Dict],
        params: Sequence[Dict[str, torch.Tensor]],
        device: torch.device,
        optimizer: OptimizerFactory,
        slowdown: float = 1.0,
        differentiable_inputs: bool = True,
    ):
        if len(params) != len(layer_cfgs):
            raise ValueError(
                f"stage {stage_index} holds {len(layer_cfgs)} layers, got "
                f"{len(params)} state dicts"
            )
        self.stage_index = stage_index
        self.device = torch.device(device)
        self.num_layers = len(layer_cfgs)
        self.slowdown = float(slowdown)
        self._differentiable_inputs = differentiable_inputs
        self._optimizer_factory = optimizer
        self.stack = _build_stack(layer_cfgs, params, self.device)
        self.parameters = list(self.stack.parameters())
        self.optimizer = optimizer(self.parameters)
        # seeds matter only where a dropout module can draw a mask
        self.stochastic = any(isinstance(m, nn.Dropout)
                              for m in self.stack.modules())

    # --- execution ----------------------------------------------------------
    @contextlib.contextmanager
    def _dropout_seed(self, seed: Optional[int]):
        """Run under ``seed`` on this stage's device, restoring the
        global generator afterwards (nothing where no mask is drawn)."""
        if seed is None or not self.stochastic or not self.stack.training:
            yield
            return
        cuda = self.device.type == "cuda"
        with torch.random.fork_rng(devices=[self.device] if cuda else []):
            if cuda:
                with torch.cuda.device(self.device):
                    torch.cuda.manual_seed(seed)
            else:
                torch.manual_seed(seed)
            yield

    def _emulated(self, fn):
        """Heterogeneity emulation: ``fn()``, then sleep ``elapsed x
        (slowdown - 1)`` through the injectable hooks."""
        if self.slowdown <= 1.0:
            return fn()
        start = self._clock()
        out = fn()
        _synchronize([self.device])
        self._sleep((self._clock() - start) * (self.slowdown - 1.0))
        return out

    def forward(self, inputs: Tuple, seed: Optional[int] = None,
                train: bool = True) -> Tuple:
        """The stage forward without a graph: only its inputs are kept
        (by the caller) for the rematerializing backward."""
        if self.stack.training != train:
            self.stack.train(train)
        inputs = _to_device(inputs, self.device)

        def run():
            with torch.no_grad(), self._dropout_seed(seed):
                return as_tuple(self.stack(*inputs))

        return self._emulated(run)

    def backward(self, inputs: Tuple, dy: Tuple,
                 seed: Optional[int] = None) -> Optional[Tuple]:
        """Rematerialize the forward on ``inputs`` under autograd and
        back-propagate ``dy`` (one entry per output, ``None`` for no
        cotangent): parameter gradients accumulate into ``.grad``.
        Returns the input cotangents (``None`` for stage 0 and for
        inputs that are not floating point)."""
        self.stack.train(True)
        dy = _to_device(dy, self.device)

        def run():
            with torch.enable_grad(), self._dropout_seed(seed):
                xs = tuple(
                    x.detach().requires_grad_(
                        self._differentiable_inputs
                        and x.is_floating_point())
                    if isinstance(x, torch.Tensor) else x
                    for x in inputs
                )
                outs = as_tuple(self.stack(*xs))
                pairs = [(o, g) for o, g in zip(outs, dy)
                         if g is not None and isinstance(o, torch.Tensor)
                         and o.requires_grad]
                if pairs:
                    torch.autograd.backward([o for o, _ in pairs],
                                            [g for _, g in pairs])
            return xs

        xs = self._emulated(run)
        if not self._differentiable_inputs:
            return None
        return tuple(x.grad if isinstance(x, torch.Tensor) else None
                     for x in xs)

    def apply_gradients(self) -> None:
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    # --- weights exchange ---------------------------------------------------
    def get_state_dict(self) -> List[Dict[str, torch.Tensor]]:
        """Per-layer CPU float32 copies of the stage's weights."""
        return [{k: v.detach().to("cpu", torch.float32, copy=True)
                 for k, v in module.state_dict().items()}
                for module in self.stack.layers]

    def load_weights(self, state_dict_list: Sequence[Dict]) -> None:
        """Copy weights in and start a fresh optimizer state."""
        if len(state_dict_list) != self.num_layers:
            raise ValueError(
                f"stage {self.stage_index} holds {self.num_layers} layers, "
                f"got {len(state_dict_list)} state dicts"
            )
        for module, sd in zip(self.stack.layers, state_dict_list):
            module.load_state_dict(sd, strict=True)
        self.optimizer = self._optimizer_factory(self.parameters)


@dataclass
class PipelineStats:
    """Wall-clock phase accounting for the last step: ``forward_s`` and
    ``backward_s`` end at device barriers, ``step_s`` is the update.
    ``dispatch_s`` is the host's time issuing the loops and the update;
    ``compute_wait_s`` the rest of the step's wall time."""

    forward_s: float = 0.0
    backward_s: float = 0.0
    step_s: float = 0.0
    loss: float = 0.0
    dispatch_s: float = 0.0
    compute_wait_s: float = 0.0

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able field dict."""
        return dataclasses.asdict(self)


class PipelineModel:
    """The assembled pipeline: stage runtimes in worker-rank order, their
    weights taken from the layer-indexed :class:`ParameterServer`."""

    def __init__(
        self,
        worker_manager: WorkerManager,
        parameter_server: ParameterServer,
        optimizer: OptimizerFactory,
        loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
        devices: Optional[Sequence[Any]] = None,
        num_microbatches: int = 1,
        schedule: str = "gpipe",
    ):
        if schedule == "1f1b":
            _not_ported("the 1F1B schedule")
        if schedule != "gpipe":
            raise ValueError(f"unknown schedule {schedule!r}")
        self._worker_manager = worker_manager
        self._parameter_server = parameter_server
        self._optimizer = optimizer
        self._loss_fn = loss_fn
        if devices is None:
            resolve_device(None)  # raises where there is no card
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self._devices = [resolve_device(d) for d in devices]
        self.num_microbatches = num_microbatches
        self.schedule = schedule
        self.stats = PipelineStats()
        self._train = True
        self._fwd_call_count = 0
        self._grad_call_count = 0
        self._last_dispatch_s = 0.0
        self.stages: List[StageRuntime] = []
        self._build_stages()

    def set_loss_fn(self, loss_fn: Callable) -> None:
        self._loss_fn = loss_fn

    # --- construction -------------------------------------------------------
    def _build_stages(self) -> None:
        self.stages = []
        layer_cursor = 0
        workers = sorted(
            self._worker_manager.worker_pool, key=lambda w: w.rank
        )
        for worker in workers:
            layer_cfgs = worker.model_config or []
            if not layer_cfgs:
                continue
            params = self._parameter_server.get_layer_slice(
                layer_cursor, layer_cursor + len(layer_cfgs)
            )
            device = self._devices[worker.device_index % len(self._devices)]
            stage_idx = len(self.stages)
            self.stages.append(
                StageRuntime(
                    stage_index=stage_idx,
                    layer_cfgs=layer_cfgs,
                    params=params,
                    device=device,
                    optimizer=self._optimizer,
                    slowdown=float(worker.extra_config.get("slowdown", 1.0)),
                    differentiable_inputs=stage_idx > 0,
                )
            )
            layer_cursor += len(layer_cfgs)
        if layer_cursor != self._parameter_server.num_layers:
            raise ValueError(
                f"workers cover {layer_cursor} layers but the model has "
                f"{self._parameter_server.num_layers} — run an allocator first"
            )

    def rebuild(self) -> None:
        """Re-slice stages after a re-allocation (gathers weights first)."""
        self.sync_to_parameter_server()
        self._build_stages()

    @property
    def _stage_devices(self) -> List[torch.device]:
        return [stage.device for stage in self.stages]

    def train(self, mode: bool = True) -> None:
        """Train/eval switch for :meth:`forward` (eval: no dropout);
        ``train_step`` always trains."""
        self._train = mode

    def _step_seeds(self, generator: Optional[torch.Generator], M: int,
                    S: int):
        """Per-(microbatch, stage) dropout seeds, or ``None`` where no
        stage draws a mask."""
        if not any(stage.stochastic for stage in self.stages):
            return [[None] * S for _ in range(M)]
        seeds = torch.randint(0, 2 ** 62, (M, S), generator=generator)
        return seeds.tolist()

    # --- execution ----------------------------------------------------------
    def forward(self, data, generator: Optional[torch.Generator] = None):
        """Inference/eval forward of one full batch (no microbatching).

        In train mode with no ``generator``, each call seeds from a
        monotonically increasing counter, so repeated calls draw fresh
        dropout masks.
        """
        seeds = [None] * len(self.stages)
        if self._train:
            if generator is None:
                generator = torch.Generator().manual_seed(
                    self._fwd_call_count)
                self._fwd_call_count += 1
            seeds = self._step_seeds(generator, 1, len(self.stages))[0]
        acts = as_tuple(data)
        for stage, seed in zip(self.stages, seeds):
            acts = stage.forward(acts, seed, train=self._train)
        return acts[0]

    def train_step(self, data, labels,
                   generator: Optional[torch.Generator] = None) -> float:
        """One optimizer step: microbatched fwd -> loss -> bwd -> update.
        Returns the summed (``1/M``-scaled, so mean) loss of the batch."""
        grad_totals, losses, (t0, t1, t2) = self.compute_gradients(
            data, labels, generator
        )
        self.apply_gradients(grad_totals)
        t_upd_issued = time.perf_counter()
        _synchronize(self._stage_devices)
        t3 = time.perf_counter()
        dispatch_s = self._last_dispatch_s + (t_upd_issued - t2)
        total_loss = float(sum(loss.item() for loss in losses))
        self.stats = PipelineStats(
            forward_s=t1 - t0, backward_s=t2 - t1, step_s=t3 - t2,
            loss=total_loss, dispatch_s=dispatch_s,
            compute_wait_s=max((t3 - t0) - dispatch_s, 0.0),
        )
        return total_loss

    def _loss_and_dlogits(self, logits, labels, scale: float):
        with torch.enable_grad():
            lg = logits.detach().requires_grad_(True)
            loss = self._loss_fn(lg, labels) * scale
            (dlogits,) = torch.autograd.grad(loss, lg)
        return loss.detach(), dlogits

    def compute_gradients(self, data, labels,
                          generator: Optional[torch.Generator] = None):
        """GPipe fwd/bwd without the update: (per-stage gradient lists,
        per-microbatch scaled losses, phase timestamps taken after
        device barriers).  The gradients are the stages' ``.grad``
        tensors; :meth:`apply_gradients` applies them."""
        if generator is None:
            # deterministic default: a per-call counter, so identically
            # seeded runs replay identically
            generator = torch.Generator().manual_seed(
                1_000_003 + self._grad_call_count)
            self._grad_call_count += 1
        M = self.num_microbatches
        S = len(self.stages)
        micro_data = _split_microbatches(as_tuple(data), M)
        micro_labels = _split_microbatches(labels, M)
        scale = 1.0 / M
        seeds = self._step_seeds(generator, M, S)
        last_device = self.stages[-1].device

        t0 = time.perf_counter()
        # ---- forward (fill): per microbatch, per stage; keep stage inputs
        stage_inputs: List[List[Optional[Tuple]]] = [[] for _ in self.stages]
        final_acts: List[Tuple] = []
        for m in range(M):
            acts = micro_data[m]
            for k, stage in enumerate(self.stages):
                acts = _to_device(acts, stage.device)
                stage_inputs[k].append(acts)
                acts = stage.forward(acts, seeds[m][k])
            final_acts.append(acts)
        dispatch_s = time.perf_counter() - t0
        _synchronize(self._stage_devices)
        t1 = time.perf_counter()

        # ---- loss + backward (drain), accumulating grads per stage
        losses = []
        for m in reversed(range(M)):
            acts = final_acts[m]
            loss_m, dlogits = self._loss_and_dlogits(
                acts[0], micro_labels[m].to(last_device), scale
            )
            losses.append(loss_m)
            dy: Optional[Tuple] = (dlogits,) + (None,) * (len(acts) - 1)
            for k in reversed(range(S)):
                dy = self.stages[k].backward(stage_inputs[k][m], dy,
                                             seeds[m][k])
                stage_inputs[k][m] = None  # dead once its backward ran
        dispatch_s += time.perf_counter() - t1
        self._last_dispatch_s = dispatch_s
        _synchronize(self._stage_devices)
        t2 = time.perf_counter()
        grad_totals = [[p.grad for p in stage.parameters]
                       for stage in self.stages]
        return grad_totals, losses, (t0, t1, t2)

    def apply_gradients(self, grad_totals) -> None:
        """Apply per-stage gradient lists with each stage's optimizer."""
        for stage, grads in zip(self.stages, grad_totals):
            for p, g in zip(stage.parameters, grads):
                if p.grad is not g:
                    p.grad = g
            stage.apply_gradients()

    def measure_stage_times(self, *args, **kwargs):
        _not_ported("measure_stage_times")

    # --- training state -----------------------------------------------------
    def partition_signature(self) -> List[int]:
        """Layer counts per stage — identifies the current allocation."""
        return [stage.num_layers for stage in self.stages]

    def sync_to_parameter_server(self) -> None:
        """Gather every stage's layer weights back into the host copy."""
        cursor = 0
        for stage in self.stages:
            for layer_params in stage.get_state_dict():
                self._parameter_server.update_weights(layer_params, cursor)
                cursor += 1

    def load_from_parameter_server(self) -> None:
        cursor = 0
        for stage in self.stages:
            stage.load_weights(
                self._parameter_server.get_layer_slice(
                    cursor, cursor + stage.num_layers
                )
            )
            cursor += stage.num_layers


__all__ = [
    "PipelineModel",
    "PipelineStats",
    "StageRuntime",
    "sgd",
]
