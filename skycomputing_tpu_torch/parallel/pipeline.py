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
- **microbatching** splits the batch into contiguous leading-axis
  chunks (labels split the same way), each loss scaled by ``1/M`` with
  its ``dlogits`` taken from the loss; the last stage's outputs after
  the logits get no cotangent.  Two schedules, with the gradients
  accumulating in the parameters' ``.grad`` in the JAX engine's
  summation order for each: **GPipe** fill-drain (every forward, then
  every backward in reverse microbatch order) and **1F1B** (each
  microbatch's backward issued as soon as its forward clears the last
  stage: warm-up forwards, alternating backward/forward, drain; a
  stage's stored input is freed when its backward is issued, so live
  inputs per stage are bounded by the depth, not by M);
- each stage's **optimizer** is built by a factory over the stage's
  parameters (:func:`sgd`, or :func:`build_optimizer` from a config's
  optax name with optax's defaults);
- :meth:`PipelineModel.measure_stage_times` times each stage's forward
  plus rematerialized backward on its device, for the allocator's
  closed loop;
- per-worker **slowdown** emulation sleeps ``elapsed x (slowdown - 1)``
  after each stage call, as in the JAX engine.

Dropout masks come from per-(microbatch, stage) seeds drawn from the
step's ``torch.Generator``; a stage with live dropout runs its forward
and its rematerialized forward under the same seed, so both see the
same mask.

Devices default to every CUDA device; with no card and no explicit
``devices=[torch.device("cpu")]`` construction raises.

Tracing (``telemetry.enable_tracing``, or a ``TraceHook``) records the
reference's timeline: per stage a lane ``stage {k} [{device}]`` with
``fwd``/``bwd`` spans per microbatch (``{"mb": m}``) under both
schedules and an ``update`` span; one ``host_dispatch`` span per step
whose duration is :attr:`PipelineStats.dispatch_s`; and a ``transfer``
or ``transfer_elided`` instant at each placement of stage inputs,
labels and cotangents (:func:`device_put_elided`).  The lanes are looked
up once per call (:meth:`PipelineModel._trace_lanes`), and nothing is
recorded while tracing is off.  The spans time the host issuing work,
as the reference's do: none synchronizes.  The reference's
``xla_compile`` spans have no counterpart: nothing compiles.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..builder import as_tuple, build_layer_stack
from ..dynamics.parameter_server import ParameterServer
from ..dynamics.worker_manager import WorkerManager
from ..telemetry import get_tracer
from ..utils import resolve_devices

OptimizerFactory = Callable[[List[nn.Parameter]], torch.optim.Optimizer]


def sgd(learning_rate: float) -> OptimizerFactory:
    """``optax.sgd(learning_rate)``'s update as a per-stage factory."""
    return functools.partial(torch.optim.SGD, lr=learning_rate)


# optax's factories -> (torch.optim class, optax's defaults, the map from
# optax's argument names to torch's)
_OPTAX = {
    "sgd": (torch.optim.SGD, dict(momentum=None, nesterov=False),
            lambda a: dict(momentum=a["momentum"] or 0.0,
                           nesterov=a["nesterov"])),
    "adam": (torch.optim.Adam, dict(b1=0.9, b2=0.999, eps=1e-8),
             lambda a: dict(betas=(a["b1"], a["b2"]), eps=a["eps"])),
    "adamw": (torch.optim.AdamW,
              dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4),
              lambda a: dict(betas=(a["b1"], a["b2"]), eps=a["eps"],
                             weight_decay=a["weight_decay"])),
}


def build_optimizer(optim_cfg: Dict) -> OptimizerFactory:
    """A per-stage optimizer factory from a config's optax spelling
    (``optim_type`` in ``sgd``/``adam``/``adamw``, ``learning_rate`` and
    optax's keyword names), with optax's defaults — ``adamw`` decays by
    1e-4 as optax does, not by ``torch.optim.AdamW``'s 1e-2.  Anything
    else raises."""
    cfg = dict(optim_cfg)
    name = str(cfg.pop("optim_type")).lower()
    if name not in _OPTAX:
        raise ValueError(
            f"optimizer {name!r} is not ported; use one of {sorted(_OPTAX)}")
    cls, defaults, to_torch = _OPTAX[name]
    lr = cfg.pop("learning_rate")
    unknown = sorted(set(cfg) - set(defaults))
    if unknown:
        raise ValueError(f"{name}: options {unknown} are not ported")
    return functools.partial(cls, lr=lr, **to_torch({**defaults, **cfg}))


def _to_device(acts: Tuple, device: torch.device) -> Tuple:
    """Every tensor (or numpy array) of ``acts`` on ``device``."""
    return tuple(
        torch.as_tensor(x, device=device)
        if isinstance(x, (torch.Tensor, np.ndarray)) else x
        for x in acts
    )


def device_put_elided(tree, device: torch.device):
    """``tree`` (a tuple, or one leaf) on ``device``, as :func:`_to_device`
    places it, counting its leaves the way the reference's
    ``device_put_elided`` does: a tensor already on ``device`` is
    resident, a host array or a tensor elsewhere moves.  With tracing on,
    one ``transfer`` instant (something moved) or ``transfer_elided``
    (nothing did) on lane ``("transfers", str(device))``."""
    single = not isinstance(tree, tuple)
    leaves = (tree,) if single else tree
    tracer = get_tracer()
    if tracer is not None:
        arrays = [x for x in leaves
                  if isinstance(x, (torch.Tensor, np.ndarray))]
        moved = sum(1 for x in arrays
                    if not (isinstance(x, torch.Tensor)
                            and x.device == device))
        lane = tracer.lane("transfers", str(device))
        if moved:
            tracer.instant("transfer", lane, {
                "moved": moved, "elided": len(arrays) - moved})
        else:
            tracer.instant("transfer_elided", lane,
                           {"leaves": len(arrays)})
    placed = _to_device(leaves, device)
    return placed[0] if single else placed


def _split_microbatches(tree, num_microbatches: int,
                        what: str = "microbatches"):
    """Leading-axis split of every leaf (numpy or tensor) into equal
    contiguous chunks (``what`` names them in the error); a tuple comes
    back as a list of tuples.  Host arrays stay host arrays (views)
    until they are placed."""
    def split(x):
        if not isinstance(x, np.ndarray):
            x = torch.as_tensor(x)
        if x.shape[0] % num_microbatches != 0:
            raise ValueError(
                f"batch size {x.shape[0]} not divisible by "
                f"{num_microbatches} {what}"
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
        # trace-lane name: one process row per (stage, device); the trace
        # analysis keys stage utilization on the "stage N" prefix
        self.lane_name = f"stage {stage_index} [{self.device}]"
        # stages sharing this key run the same modules on equal inputs,
        # so their compute profile on one device is the same
        self.config_key = json.dumps(list(layer_cfgs), sort_keys=True,
                                     default=str)
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
    def _dropout_seed(self, seed: Optional[int],
                      device: Optional[torch.device] = None):
        """Run under ``seed`` on ``device`` (this stage's by default),
        restoring the global generator afterwards (nothing where no mask
        is drawn)."""
        if seed is None or not self.stochastic or not self.stack.training:
            yield
            return
        device = self.device if device is None else device
        cuda = device.type == "cuda"
        with torch.random.fork_rng(devices=[device] if cuda else []):
            if cuda:
                with torch.cuda.device(device):
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
        (by the caller) for the rematerializing backward.  The caller
        places ``inputs`` on this stage's device
        (:func:`device_put_elided`)."""
        return self._emulated(lambda: self.forward_raw(inputs, seed, train))

    def forward_raw(self, inputs: Tuple, seed: Optional[int] = None,
                    train: bool = True) -> Tuple:
        """:meth:`forward` without the slowdown emulation."""
        if self.stack.training != train:
            self.stack.train(train)
        with torch.no_grad(), self._dropout_seed(seed):
            return as_tuple(self.stack(*inputs))

    def backward(self, inputs: Tuple, dy: Tuple,
                 seed: Optional[int] = None) -> Optional[Tuple]:
        """Rematerialize the forward on ``inputs`` under autograd and
        back-propagate ``dy`` (one entry per output, ``None`` for no
        cotangent): parameter gradients accumulate into ``.grad``.
        Returns the input cotangents (``None`` for stage 0 and for
        inputs that are not floating point)."""
        dy = device_put_elided(tuple(dy), self.device)
        return self._emulated(lambda: self.backward_raw(inputs, dy, seed))

    def backward_raw(self, inputs: Tuple, dy: Tuple,
                     seed: Optional[int] = None) -> Optional[Tuple]:
        """:meth:`backward` without the slowdown emulation (``dy`` already
        on this stage's device)."""
        self.stack.train(True)
        with torch.enable_grad(), self._dropout_seed(seed):
            xs = tuple(
                x.detach().requires_grad_(
                    self._differentiable_inputs and x.is_floating_point())
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
    Under 1F1B forward and backward interleave: ``forward_s`` holds the
    whole interleaved loop, ``backward_s`` is 0 and ``interleaved`` is
    True.  ``dispatch_s`` is the host's time issuing the loops and the
    update; ``compute_wait_s`` the rest of the step's wall time."""

    forward_s: float = 0.0
    backward_s: float = 0.0
    step_s: float = 0.0
    loss: float = 0.0
    interleaved: bool = False
    dispatch_s: float = 0.0
    compute_wait_s: float = 0.0

    #: metric classification (``telemetry.MetricsRegistry``): the model
    #: rebinds ``stats`` to a fresh object every step, so every field is
    #: a per-step gauge
    FIELD_TYPES = {
        "forward_s": "gauge", "backward_s": "gauge", "step_s": "gauge",
        "loss": "gauge", "interleaved": "gauge", "dispatch_s": "gauge",
        "compute_wait_s": "gauge",
    }

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
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown schedule {schedule!r}")
        self._worker_manager = worker_manager
        self._parameter_server = parameter_server
        self._optimizer = optimizer
        self._loss_fn = loss_fn
        self._devices = resolve_devices(devices)
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
            acts = device_put_elided(acts, stage.device)
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
            loss=total_loss, interleaved=self._interleaved,
            dispatch_s=dispatch_s,
            compute_wait_s=max((t3 - t0) - dispatch_s, 0.0),
        )
        tracer = get_tracer()
        if tracer is not None:
            # one span per step whose duration IS dispatch_s, placed
            # ending now, so the trace carries the engine's dispatch share
            end = tracer.now()
            tracer.complete(
                "host_dispatch", tracer.lane("host", "dispatch"),
                max(end - dispatch_s * 1e6, 0.0), dur_us=dispatch_s * 1e6,
            )
        return total_loss

    def _trace_lanes(self):
        """(tracer, per-stage lane list), or (None, None) when tracing is
        off: one accessor call and S lane lookups per call, none per
        microbatch."""
        tracer = get_tracer()
        if tracer is None:
            return None, None
        return tracer, [tracer.lane(stage.lane_name, "dispatch")
                        for stage in self.stages]

    def _loss_and_dlogits(self, logits, labels, scale: float):
        with torch.enable_grad():
            lg = logits.detach().requires_grad_(True)
            loss = self._loss_fn(lg, labels) * scale
            (dlogits,) = torch.autograd.grad(loss, lg)
        return loss.detach(), dlogits

    @property
    def _interleaved(self) -> bool:
        """True when gradients come from the interleaved 1F1B loop (one
        microbatch has nothing to interleave)."""
        return self.schedule == "1f1b" and self.num_microbatches > 1

    def _step_inputs(self, data, labels, generator):
        """(M, S, microbatch data, microbatch labels, 1/M, seeds)."""
        if generator is None:
            # deterministic default: a per-call counter, so identically
            # seeded runs replay identically
            generator = torch.Generator().manual_seed(
                1_000_003 + self._grad_call_count)
            self._grad_call_count += 1
        M = self.num_microbatches
        S = len(self.stages)
        return (M, S, _split_microbatches(as_tuple(data), M),
                _split_microbatches(labels, M), 1.0 / M,
                self._step_seeds(generator, M, S))

    def compute_gradients(self, data, labels,
                          generator: Optional[torch.Generator] = None):
        """Schedule-dispatched fwd/bwd without the update: (per-stage
        gradient lists, per-microbatch scaled losses, phase timestamps
        taken after device barriers).  The gradients are the stages'
        ``.grad`` tensors; :meth:`apply_gradients` applies them.  Under
        1F1B the middle timestamp equals the last."""
        if self._interleaved:
            return self._compute_gradients_1f1b(data, labels, generator)
        return self._compute_gradients_gpipe(data, labels, generator)

    def _prefetch(self, micro_data, micro_labels):
        """Every microbatch's inputs on the first stage's device and its
        labels on the last's, issued before the first forward."""
        first, last = self.stages[0].device, self.stages[-1].device
        return ([device_put_elided(md, first) for md in micro_data],
                [device_put_elided(ml, last) for ml in micro_labels])

    def _compute_gradients_gpipe(self, data, labels, generator):
        M, S, micro_data, micro_labels, scale, seeds = self._step_inputs(
            data, labels, generator)
        last_device = self.stages[-1].device
        tracer, lanes = self._trace_lanes()

        t0 = time.perf_counter()
        micro_data, micro_labels = self._prefetch(micro_data, micro_labels)
        # ---- forward (fill): per microbatch, per stage; keep stage inputs
        stage_inputs: List[List[Optional[Tuple]]] = [[] for _ in self.stages]
        final_acts: List[Tuple] = []
        for m in range(M):
            acts = micro_data[m]
            for k, stage in enumerate(self.stages):
                acts = device_put_elided(acts, stage.device)
                stage_inputs[k].append(acts)
                if tracer is None:
                    acts = stage.forward(acts, seeds[m][k])
                else:
                    span0 = tracer.now()
                    acts = stage.forward(acts, seeds[m][k])
                    tracer.complete("fwd", lanes[k], span0, {"mb": m})
            final_acts.append(acts)
        dispatch_s = time.perf_counter() - t0
        _synchronize(self._stage_devices)
        t1 = time.perf_counter()

        # ---- loss + backward (drain), accumulating grads per stage
        losses = []
        for m in reversed(range(M)):
            acts = final_acts[m]
            loss_m, dlogits = self._loss_and_dlogits(
                acts[0], device_put_elided(micro_labels[m], last_device),
                scale)
            losses.append(loss_m)
            dy: Optional[Tuple] = (dlogits,) + (None,) * (len(acts) - 1)
            for k in reversed(range(S)):
                if tracer is None:
                    dy = self.stages[k].backward(stage_inputs[k][m], dy,
                                                 seeds[m][k])
                else:
                    span0 = tracer.now()
                    dy = self.stages[k].backward(stage_inputs[k][m], dy,
                                                 seeds[m][k])
                    tracer.complete("bwd", lanes[k], span0, {"mb": m})
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
        tracer, lanes = self._trace_lanes()
        for k, (stage, grads) in enumerate(zip(self.stages, grad_totals)):
            for p, g in zip(stage.parameters, grads):
                if p.grad is not g:
                    p.grad = g
            if tracer is None:
                stage.apply_gradients()
            else:
                span0 = tracer.now()
                stage.apply_gradients()
                tracer.complete("update", lanes[k], span0)

    def _compute_gradients_1f1b(self, data, labels, generator):
        """One-forward-one-backward: a dependency-driven issue loop over
        per-stage queues (warm-up forwards, then alternating
        backward/forward, then drain), the JAX engine's loop.  A stage's
        stored input for microbatch m is freed when its backward is
        issued; gradients accumulate in microbatch order."""
        M, S, micro_data, micro_labels, scale, seeds = self._step_inputs(
            data, labels, generator)
        last_device = self.stages[-1].device
        tracer, lanes = self._trace_lanes()

        t0 = time.perf_counter()
        micro_data, micro_labels = self._prefetch(micro_data, micro_labels)
        stage_inputs: List[Dict[int, Tuple]] = [dict() for _ in range(S)]
        stage_outputs: List[Dict[int, Tuple]] = [dict() for _ in range(S)]
        dys: List[Dict[int, Tuple]] = [dict() for _ in range(S)]
        losses: List[torch.Tensor] = []
        fwd_next = [0] * S  # next microbatch each stage will forward
        bwd_next = [0] * S  # next microbatch each stage will backward

        def can_fwd(k):
            m = fwd_next[k]
            return m < M and (k == 0 or m in stage_outputs[k - 1])

        def can_bwd(k):
            m = bwd_next[k]
            if m >= M or m not in stage_inputs[k]:
                return False
            # the cotangent comes from the loss on the last stage, from
            # the next stage's input cotangent elsewhere
            return m in (dys[k] if k == S - 1 else dys[k + 1])

        def do_fwd(k):
            m = fwd_next[k]
            stage = self.stages[k]
            acts = micro_data[m] if k == 0 else stage_outputs[k - 1].pop(m)
            acts = device_put_elided(acts, stage.device)
            stage_inputs[k][m] = acts
            if tracer is None:
                out = stage.forward(acts, seeds[m][k])
            else:
                span0 = tracer.now()
                out = stage.forward(acts, seeds[m][k])
                tracer.complete("fwd", lanes[k], span0, {"mb": m})
            if k < S - 1:
                stage_outputs[k][m] = out
            else:
                loss_m, dlogits = self._loss_and_dlogits(
                    out[0], device_put_elided(micro_labels[m], last_device),
                    scale)
                losses.append(loss_m)
                dys[k][m] = (dlogits,) + (None,) * (len(out) - 1)
            fwd_next[k] += 1

        def do_bwd(k):
            m = bwd_next[k]
            dy = dys[k].pop(m) if k == S - 1 else dys[k + 1].pop(m)
            if tracer is None:
                dx = self.stages[k].backward(stage_inputs[k].pop(m), dy,
                                             seeds[m][k])
            else:
                span0 = tracer.now()
                dx = self.stages[k].backward(stage_inputs[k].pop(m), dy,
                                             seeds[m][k])
                tracer.complete("bwd", lanes[k], span0, {"mb": m})
            if k > 0:
                dys[k][m] = dx
            bwd_next[k] += 1

        # walk the stages last to first issuing backwards (they free
        # memory), then first to last issuing forwards
        while any(b < M for b in bwd_next):
            progressed = False
            for k in reversed(range(S)):
                # stage k holds its first backward until S - k forwards
                # are in flight or its forwards are done
                if can_bwd(k) and (
                        fwd_next[k] - bwd_next[k] >= min(S - k,
                                                         M - bwd_next[k])
                        or fwd_next[k] >= M):
                    do_bwd(k)
                    progressed = True
            for k in range(S):
                if can_fwd(k):
                    do_fwd(k)
                    progressed = True
            if not progressed:  # pragma: no cover - deadlock guard
                raise RuntimeError("1F1B schedule made no progress")

        self._last_dispatch_s = time.perf_counter() - t0
        _synchronize(self._stage_devices)
        t2 = time.perf_counter()
        grad_totals = [[p.grad for p in stage.parameters]
                       for stage in self.stages]
        # interleaved: forward_s carries the whole loop, backward_s is 0
        return grad_totals, losses, (t0, t2, t2)

    # --- profiling ----------------------------------------------------------
    def measure_stage_times(
        self,
        data,
        generator: Optional[torch.Generator] = None,
        repeats: int = 3,
        inner_iters=3,
        dedup: bool = True,
        auto_window_s: float = 0.5,
        seed_times: Optional[Dict] = None,
    ) -> List[float]:
        """Per-stage seconds of one iteration — the stage's forward plus
        its rematerialized backward against a zero cotangent, what a
        train step issues per microbatch — on the stage's device.

        After one warm iteration per stage, the median of ``repeats``
        samples, each timing ``inner_iters`` chained iterations closed by
        one synchronize.  The samples are taken round-robin over the
        stages being timed, so a drift of the host's speed during the
        pass lands on every stage alike.  ``inner_iters="auto"`` sizes
        the chain per stage from one post-warm probe: ``clamp(round(
        auto_window_s / t1), 1, 3)``.  ``dedup`` times a stage once per
        (layer structure, input shapes and dtypes, device) and reuses the
        time for its twins; the untimed forward still runs per stage to
        feed the next.  ``seed_times`` is a (key -> raw seconds) map
        carried across calls: keys present are trusted, new measurements
        are written back.  Each reported time is the raw time multiplied
        by the stage's ``slowdown`` (the timed calls bypass the slowdown
        emulation); the map stores raw times."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        seeds = self._step_seeds(generator, 1, len(self.stages))[0]
        acts = as_tuple(data)
        seen: Dict = seed_times if seed_times is not None else {}
        keys: List = []
        samplers: Dict[int, Callable[[], float]] = {}  # by stage index
        timing: set = set()  # keys a sampler of this call times
        for k, (stage, seed) in enumerate(zip(self.stages, seeds)):
            inputs = device_put_elided(acts, stage.device)
            out = stage.forward_raw(inputs, seed)
            key = (
                stage.config_key,
                tuple((tuple(x.shape), str(x.dtype)) for x in inputs),
                str(stage.device),
            )
            keys.append(key)
            if not (dedup and (key in seen or key in timing)):
                samplers[k] = self._stage_sampler(stage, inputs, out, seed,
                                                  inner_iters, auto_window_s)
                timing.add(key)
            acts = out
        samples: Dict[int, List[float]] = {k: [] for k in samplers}
        for _ in range(repeats):
            for k, sample in samplers.items():
                samples[k].append(sample())
        raw = {k: float(np.median(v)) for k, v in samples.items()}
        for k, t in raw.items():
            seen[keys[k]] = t
        for stage in self.stages:
            stage.optimizer.zero_grad(set_to_none=True)
        return [raw.get(k, seen[key]) * max(stage.slowdown, 1.0)
                for k, (stage, key) in enumerate(zip(self.stages, keys))]

    @staticmethod
    def _stage_sampler(stage: StageRuntime, inputs, out, seed, inner_iters,
                       auto_window_s: float) -> Callable[[], float]:
        """Warm ``stage`` on ``inputs``; returns a callable that takes one
        sample: seconds per iteration over a chain closed by a
        synchronize."""
        dy = tuple(torch.zeros_like(o) if o.is_floating_point() else None
                   for o in out)

        def one_iter():
            stage.forward_raw(inputs, seed)
            stage.backward_raw(inputs, dy, seed)

        one_iter()  # warm
        _synchronize([stage.device])
        if inner_iters == "auto":
            t0 = time.perf_counter()
            one_iter()
            _synchronize([stage.device])
            t1 = time.perf_counter() - t0
            inner = max(1, min(3, round(auto_window_s / max(t1, 1e-9))))
        else:
            inner = max(int(inner_iters), 1)

        def sample() -> float:
            t0 = time.perf_counter()
            for _ in range(inner):
                one_iter()
            _synchronize([stage.device])
            return (time.perf_counter() - t0) / inner

        return sample

    # --- training state -----------------------------------------------------
    def partition_signature(self) -> List[int]:
        """Layer counts per stage — identifies the current allocation."""
        return [stage.num_layers for stage in self.stages]

    def get_optimizer_state(self) -> Dict:
        """Host copies of every stage's optimizer state, tagged with the
        partition they belong to: unlike the layer-indexed parameters,
        optimizer state is shaped per stage, so it restores only under
        the same allocation."""
        def host(x):
            if isinstance(x, torch.Tensor):
                return x.detach().to("cpu", copy=True)
            if isinstance(x, dict):
                return {k: host(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(host(v) for v in x)
            return x

        return {"partition": self.partition_signature(),
                "stages": [host(stage.optimizer.state_dict())
                           for stage in self.stages]}

    def load_optimizer_state(self, state: Dict) -> None:
        saved = list(state["partition"])
        if saved != self.partition_signature():
            raise ValueError(
                f"optimizer state was saved under partition {saved}, "
                f"current partition is {self.partition_signature()}; "
                "re-allocate to match or restore parameters only"
            )
        for stage, stage_state in zip(self.stages, state["stages"]):
            stage.optimizer.load_state_dict(stage_state)

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
    "build_optimizer",
    "device_put_elided",
    "sgd",
]
