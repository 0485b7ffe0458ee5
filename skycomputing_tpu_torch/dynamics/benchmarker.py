"""Device and model benchmarkers (the port of
``skycomputing_tpu/dynamics/benchmarker.py``).

- :class:`DeviceBenchmarker` times the proxy model (``MatmulStack`` in
  the experiment config) on each worker's device and reads its free
  memory (``torch.cuda.mem_get_info`` on a card, ``psutil`` on the CPU)
  unless the worker's ``mem_limit`` sets it.  Measurements are cached
  per worker and, for the time, per physical device: four workers on
  one card are timed once, then each is skewed by the stimulator
  (compute time multiplied, memory divided), keyed by the worker's
  stable ``stim_index``.  ``STIMULATE`` in the environment turns the
  seeded :class:`~..stimulator.Stimulator` on.
- :class:`ModelBenchmarker` profiles every unit of the model config:
  static (FLOPs and memory from one forward on the ``meta`` device) or
  ``timed`` (measured forward + backward seconds with real weights on
  ``device``, each unit fed the real outputs of the one before).  Both
  modes time or count each distinct (unit config, input shapes) once,
  so BERT-large's 75 units profile as 6.
"""

from __future__ import annotations

import abc
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from ..builder import build_layer, build_layer_stack
from ..dataset import BaseGenerator, RandomTensorGenerator
from ..stimulator import Stimulator
from ..telemetry import trace_span
from ..utils import resolve_device, resolve_devices
from .estimator import Estimator, memory_mb, meta_like
from .worker_manager import WorkerManager

#: the experiment config's device benchmark: a product chain that keeps
#: the tensor cores busy, timed on a (256, 1024) probe
PROXY_MODEL_CONFIG = [dict(layer_type="MatmulStack", features=1024, depth=4)]
PROXY_INPUT_SIZE = (256, 1024)


def generate_worker_name(rank: int) -> str:
    return f"worker{rank}"


class BaseBenchmarker(abc.ABC):
    @abc.abstractmethod
    def benchmark(self):
        ...


def _device_for(worker, devices):
    return devices[worker.device_index % len(devices)]


def device_available_memory_mb(device, fallback_fraction: float = 0.8
                               ) -> float:
    """Free memory of ``device`` in MB: ``torch.cuda.mem_get_info`` on a
    card; on the CPU, ``fallback_fraction`` of the host's available
    memory (``psutil``)."""
    device = torch.device(device)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return free / 1024.0 ** 2
    try:
        import psutil

        return psutil.virtual_memory().available * fallback_fraction / 1024.0**2
    except ImportError:  # pragma: no cover - psutil is in the image
        return 8 * 1024.0


class DeviceBenchmarker(BaseBenchmarker):
    def __init__(
        self,
        worker_manager: WorkerManager,
        data_generator: BaseGenerator,
        model_config: List[Dict],
        iterations: int = 30,
        dtype: Optional[str] = None,
        devices: Optional[Sequence[Any]] = None,
        stimulator: Optional[Stimulator] = None,
    ):
        self._worker_manager = worker_manager
        self._model_config = model_config
        self._data_generator = data_generator
        self._iterations = iterations
        self._dtype = dtype
        self._devices = resolve_devices(devices)
        if stimulator is None and os.getenv("STIMULATE") is not None:
            stimulator = Stimulator(worker_manager.size)
        self._stimulator = stimulator
        # raw measurements by worker id (allocation re-ranks the pool),
        # and raw times by physical device: workers on one device are the
        # same hardware, and re-timing it per worker would only add noise
        # that fakes heterogeneity
        self._measure_cache: Dict[str, Tuple[float, float]] = {}
        self._device_time_cache: Dict[torch.device, float] = {}

    def local_benchmark(self, worker, data) -> Tuple[float, float]:
        """Time the proxy model on one worker's device; probe free memory."""
        device = _device_for(worker, self._devices)
        if device not in self._device_time_cache:
            with trace_span("bench.device", "dynamics", "benchmark",
                            {"device": str(device)}):
                self._device_time_cache[device] = self._measure_device(
                    device, data)
        elapsed = self._device_time_cache[device]
        mem_limit = worker.extra_config.get("mem_limit", -1)
        if mem_limit and mem_limit > 0:
            avai_mem = float(mem_limit)
        else:
            avai_mem = device_available_memory_mb(device)
        return elapsed, avai_mem

    def _measure_device(self, device, data) -> float:
        """One timed proxy-model run on ``device`` (the cache-miss path)."""
        with torch.device(device):
            stack = build_layer_stack(self._model_config)
        data = data if isinstance(data, tuple) else (data,)
        if self._dtype is not None:
            data = tuple(np.asarray(d).astype(self._dtype) for d in data)
        return Estimator.benchmark_speed(stack, data, device=device,
                                         iterations=self._iterations)

    def benchmark(self) -> Dict[str, Dict[str, float]]:
        results: Dict[str, Dict[str, float]] = {}
        data = None
        for worker in self._worker_manager.worker_pool:
            if worker.id not in self._measure_cache:
                if data is None:
                    data = self._data_generator.generate()
                self._measure_cache[worker.id] = self.local_benchmark(
                    worker, data)
            elapsed, avai_mem = self._measure_cache[worker.id]
            if self._stimulator is not None:
                elapsed *= self._stimulator.compute_slowdown(worker.stim_index)
                avai_mem /= self._stimulator.memory_slowdown(worker.stim_index)
            results[generate_worker_name(worker.rank)] = dict(
                time=elapsed, avai_mem=avai_mem)
        return results


def proxy_device_benchmarker(worker_manager: WorkerManager,
                             iterations: int = 10,
                             devices: Optional[Sequence[Any]] = None,
                             stimulator: Optional[Stimulator] = None
                             ) -> DeviceBenchmarker:
    """A :class:`DeviceBenchmarker` over the experiment's proxy model
    (``PROXY_MODEL_CONFIG`` on a ``PROXY_INPUT_SIZE`` probe)."""
    return DeviceBenchmarker(
        worker_manager, RandomTensorGenerator(size=PROXY_INPUT_SIZE),
        PROXY_MODEL_CONFIG, iterations=iterations, devices=devices,
        stimulator=stimulator)


def _layer_key(layer_cfg: Dict, inputs) -> str:
    shapes = [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
              for x in inputs]
    return json.dumps([layer_cfg, shapes], sort_keys=True, default=str)


def _build_unit(layer_cfg: Dict, device):
    cfg = dict(layer_cfg)
    layer_type = cfg.pop("layer_type")
    with torch.device(device):
        return build_layer(layer_type, **cfg)


def _tensors(out) -> Tuple[torch.Tensor, ...]:
    return tuple(t for t in tree_leaves(out) if isinstance(t, torch.Tensor))


class ModelBenchmarker(BaseBenchmarker):
    """Per-unit (cost, mem_MB) profile over the full model config: cost
    is FLOPs when static, measured forward + backward seconds when
    ``timed`` (the allocator reads relative magnitudes only, so either
    serves).  Memory is the static formula in both modes.  The result is
    computed once and kept."""

    def __init__(
        self,
        model_config: List[Dict],
        data_generator: BaseGenerator,
        param_scale: int = 2,
        device=None,
        timed: bool = False,
        timed_iterations: int = 8,
    ):
        self._model_config = model_config
        self._data_generator = data_generator
        self._param_scale = param_scale
        self._device = device
        self._timed = bool(timed)
        self._timed_iterations = int(timed_iterations)
        self._result: Optional[Tuple[List[float], List[float]]] = None
        #: distinct units counted or timed in the last profile
        self.distinct_units = 0

    @property
    def model_config(self) -> List[Dict]:
        return self._model_config

    def benchmark(self) -> Tuple[List[float], List[float]]:
        if self._result is None:
            with trace_span(
                "bench.model", "dynamics", "benchmark",
                {"layers": len(self._model_config), "timed": self._timed},
            ):
                self._result = self._benchmark()
        return self._result

    def _benchmark(self) -> Tuple[List[float], List[float]]:
        data = self._data_generator.generate()
        data = data if isinstance(data, tuple) else (data,)
        cost_list: List[float] = []
        mem_list: List[float] = []
        cache: Dict[str, Tuple[Any, float, float]] = {}

        if self._timed:
            device = resolve_device(self._device)
            current = tuple(torch.as_tensor(x, device=device) for x in data)
        else:
            current = tuple(meta_like(x) for x in data)
        for layer_cfg in self._model_config:
            key = _layer_key(layer_cfg, current)
            if key not in cache:
                if self._timed:
                    unit = _build_unit(layer_cfg, device)
                    outputs, cost = Estimator.benchmark_train_time(
                        unit, current, device=device,
                        iterations=self._timed_iterations)
                    mem = memory_mb(current, outputs, unit,
                                    self._param_scale)
                else:
                    outputs, cost, mem = Estimator.benchmark_model(
                        _build_unit(layer_cfg, "meta"), current,
                        param_scale=self._param_scale)
                cache[key] = (_tensors(outputs), cost, mem)
            current, cost, mem = cache[key]
            cost_list.append(cost)
            mem_list.append(mem)
        self.distinct_units = len(cache)
        return cost_list, mem_list


__all__ = [
    "BaseBenchmarker",
    "DeviceBenchmarker",
    "ModelBenchmarker",
    "PROXY_INPUT_SIZE",
    "PROXY_MODEL_CONFIG",
    "device_available_memory_mb",
    "generate_worker_name",
    "proxy_device_benchmarker",
]
