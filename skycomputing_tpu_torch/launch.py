"""The experiment launcher (the port of ``experiment/launch.py``).

One process owns every device: load a config -> build the worker pool,
the parameter server and the loader -> profile devices and layers ->
allocate (``optimal``, ``dynamic`` or ``even``) -> build the pipeline
(GPipe or 1F1B) -> train with the config's hooks.  An allocation that
fails ends the run cleanly, without training.  Usage::

    python -m skycomputing_tpu_torch.launch \\
        -c skycomputing_tpu_torch/configs/bert_pipeline.py \\
        [--allocate-type even|optimal|dynamic] [--device cpu]

Without ``--device`` every stage runs on the card, and a box without
one raises instead of falling back to the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

from .builder import (
    build_data_generator,
    build_dataloader_from_cfg,
    build_hook,
)
from .config import load_config
from .dynamics import (
    Allocator,
    DeviceBenchmarker,
    ModelBenchmarker,
    ParameterServer,
    WorkerManager,
)
from .ops import build_loss
from .parallel import PipelineModel, build_optimizer
from .runner import Runner
from .utils import Logger, resolve_devices


class BatchAdapter:
    """The loader's ``((ids, mask, segment_ids), label)`` rows in the
    order ``BertEmbeddings`` takes: ``(ids, token_type_ids, mask)``."""

    def __init__(self, data_loader):
        self._loader = data_loader

    def __len__(self):
        return len(self._loader)

    def __iter__(self):
        for data, labels in self._loader:
            if len(data) == 3:
                ids, mask, segs = data
                yield (ids, segs, mask), labels
            else:
                yield data, labels


@dataclass
class Launch:
    """What a run built, for callers that inspect it afterwards."""

    worker_manager: WorkerManager
    parameter_server: ParameterServer
    allocator: Allocator
    model_benchmarker: ModelBenchmarker
    device_benchmarker: DeviceBenchmarker
    model: PipelineModel
    runner: Runner


def run(cfg, logger: Logger, device=None,
        hooks: Sequence[Any] = ()) -> Optional[Launch]:
    """Profile, allocate, build and train as ``cfg`` says, with
    ``hooks`` registered after the config's own.  Returns what was
    built, or None when the allocation failed (nothing trained)."""
    devices = resolve_devices(None if device is None else [device])
    logger.info(f"devices: {[str(d) for d in devices]}")

    worker_manager = WorkerManager()
    worker_manager.load_worker_pool_from_config(cfg.worker_config)
    data = BatchAdapter(build_dataloader_from_cfg(cfg.data_config))
    parameter_server = ParameterServer(
        cfg.model_config, generator=torch.Generator().manual_seed(0))
    logger.info(f"parameter server: {parameter_server.num_layers} layers")

    bench_cfg = cfg.allocator_config["benchmark_config"]
    model_bench = ModelBenchmarker(
        cfg.model_config,
        build_data_generator(**bench_cfg["model"]["data_generator_cfg"]),
        param_scale=bench_cfg["model"].get("param_scale", 2),
        device=devices[0],
        timed=bench_cfg["model"].get("timed", False),
    )
    # the device benchmarker turns the stimulator on under STIMULATE
    device_bench = DeviceBenchmarker(
        worker_manager,
        build_data_generator(**bench_cfg["device"]["data_generator_cfg"]),
        bench_cfg["device"]["model_config"],
        iterations=bench_cfg["device"].get("iterations", 10),
        devices=devices,
    )
    allocator = Allocator(cfg.model_config, worker_manager, model_bench,
                          device_bench, logger=logger)

    allocate_type = cfg.allocator_config["type"]
    logger.info(f"allocation strategy: {allocate_type}")
    strategies = dict(optimal=allocator.optimal_allocate,
                      dynamic=allocator.dynamic_allocate,
                      even=allocator.even_allocate)
    try:
        if allocate_type not in strategies:
            raise ValueError(f"unknown ALLOCATE_TYPE {allocate_type!r}")
        strategies[allocate_type]()
    except (RuntimeError, ValueError) as exc:
        logger.info(f"allocation failed: {exc!r} — skipping training")
        return None
    for worker in worker_manager.worker_pool:
        logger.info(
            f"  stage rank={worker.rank} name={worker.name} "
            f"device={worker.device_index} "
            f"layers={len(worker.model_config)}"
        )

    model = PipelineModel(
        worker_manager,
        parameter_server,
        build_optimizer(cfg.train_config["optim_cfg"]),
        build_loss(cfg.train_config["loss_cfg"]),
        devices=devices,
        num_microbatches=cfg.get("NUM_MICROBATCHES", 1),
        schedule=cfg.get("SCHEDULE", "gpipe"),
    )
    runner = Runner(
        model,
        parameter_server,
        worker_manager,
        max_epochs=cfg.train_config["runner_cfg"]["max_epochs"],
        max_iters=cfg.train_config["runner_cfg"]["max_iters"],
        timer_cfg=cfg.train_config.get("timer_config"),
        logging_cfg=cfg.get("logging_config"),
    )
    for hook_cfg in cfg.train_config.get("hook_config", []):
        runner.register_hook(build_hook(hook_cfg))
    for hook in hooks:
        runner.register_hook(hook)

    runner.train(data)
    logger.info(f"phase means (s): {runner.phase_timer.summary()}")
    logger.info("training complete")
    return Launch(worker_manager, parameter_server, allocator, model_bench,
                  device_bench, model, runner)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="skycomputing-tpu PyTorch launcher")
    parser.add_argument("-c", "--config", required=True,
                        help="config .py path")
    parser.add_argument("--allocate-type",
                        choices=["even", "optimal", "dynamic"],
                        help="override ALLOCATE_TYPE from the config")
    parser.add_argument("--device",
                        help="run every stage here (e.g. cpu) instead of "
                             "on the cards")
    args = parser.parse_args(argv)
    if args.allocate_type:
        os.environ["SKYTPU_ALLOCATE_TYPE"] = args.allocate_type
    cfg = load_config(args.config)
    if args.allocate_type:
        cfg.allocator_config["type"] = args.allocate_type
    logger = Logger(**cfg.get("logging_config", {}))
    return 0 if run(cfg, logger, device=args.device) is not None else 1


if __name__ == "__main__":
    sys.exit(main())
