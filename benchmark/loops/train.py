"""Loop kind ``train``: the launcher's load-balanced pipeline training.

Set-up builds what ``skycomputing_tpu_torch.launch.run`` builds for the
configuration: the worker pool, the static model profile and the proxy
device profile, the allocation, the parameter server holding the run
seed's weights, ``PipelineModel`` and ``Runner``.  One ``Runner.train``
call then drives every step: the first ``check_steps`` (the steps the
reference follows, on batches that all differ), ``warm_steps`` more,
and the measured window of ``--seconds``, which closes at the first
step boundary past its end.  Batches are made from the seed as the loop
asks for them, padded to the cell's sequence length.

``train_samples_per_s`` counts the rows of the steps that completed in
the window over the window's seconds.  During the checked steps a
:class:`Recorder` keeps what the reference needs from the program's run:
the hidden dropout masks that the program's dropout modules draw (the
reference draws none of its own), and the logits the last stage hands to
the loss; it is removed before the window.  After the window the program
is freed and the reference (``reference/bert.py``, float32) replays the
checked steps from the same weights, batches and masks.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch
from torch import nn

from benchmark.harness import checks, traffic as traffic_mod, weights
from benchmark.harness.devtrace import TraceSlice
from benchmark.reference import bert as ref_bert
from benchmark.reference.precision import float32_exact

MODEL_KEYS = (
    "vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
    "intermediate_size", "hidden_act", "hidden_dropout_prob",
    "attention_probs_dropout_prob", "max_position_embeddings",
    "type_vocab_size", "initializer_range",
)


def model_fields(config: Dict) -> Dict:
    return {k: config[k] for k in MODEL_KEYS}


def make_batch(traffic: Dict, cfg: Dict, num_classes: int, seed: int,
               index: int):
    """Batch ``index`` of the run seed: ``(ids, types, mask, labels,
    lengths)`` as numpy arrays.  Each row is ``[CLS]`` and its real
    tokens (a length drawn from ``traffic["lengths"]``, the first half
    segment A and the rest segment B), zero-padded to the sequence
    length; labels are uniform over the classes."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, int(index)])
    B, L = int(traffic["batch"]), int(traffic["seq"])
    lengths = traffic_mod.draw(traffic["lengths"], B, rng)
    pos = np.arange(L)[None, :]
    real = pos < lengths[:, None]
    ids = rng.integers(int(traffic["vocab_low"]), cfg["vocab_size"],
                       size=(B, L))
    ids = np.where(real, ids, 0)
    ids[:, 0] = 101
    types = (real & (pos >= (lengths[:, None] + 1) // 2)).astype(np.int64)
    labels = rng.integers(0, num_classes, size=B)
    return ids, types, real.astype(np.int64), labels, lengths


class Feed:
    """The loop's batches, made from the seed as they are asked for."""

    def __init__(self, traffic, cfg, num_classes, seed, device):
        self._args = (traffic, cfg, num_classes, seed)
        self._device = device
        self.lengths: List[np.ndarray] = []

    def __iter__(self):
        index = 0
        while True:
            ids, types, mask, labels, lengths = make_batch(*self._args, index)
            self.lengths.append(lengths)
            index += 1
            dev = self._device
            yield ((torch.from_numpy(ids).to(dev),
                    torch.from_numpy(types).to(dev),
                    torch.from_numpy(mask).to(dev)),
                   torch.from_numpy(labels).to(dev))


def _leaf_tensors(model) -> Dict[str, torch.Tensor]:
    """The program's parameters by ``"<unit>:<key>"``."""
    out, unit = {}, 0
    for stage in model.stages:
        for module in stage.stack.layers:
            for key, value in module.state_dict().items():
                out[f"{unit}:{key}"] = value
            unit += 1
    return out


def _delta_norms(model, originals: Dict[str, torch.Tensor], scale: float
                 ) -> Dict[str, float]:
    with torch.no_grad():
        return {name: float((p.float() - originals[name]).norm()) * scale
                for name, p in _leaf_tensors(model).items()}


class Recorder:
    """In the checked steps, the masks each of the program's dropout
    modules draws in its forward (taken where no graph is built: the
    rematerialized forward of the backward draws them again under the
    same seed) and the logits the last stage hands to the loss, both
    moved to the host.  Microbatches come in order, so concatenating
    them gives the batch's rows in order."""

    def __init__(self, model):
        self.model = model
        self.masks: List[Dict[int, List[torch.Tensor]]] = []
        self.logits: List[List[torch.Tensor]] = []
        self._handles = []
        self.armed = False
        unit = 0
        for stage in model.stages:
            for module in stage.stack.layers:
                drops = [m for m in module.modules()
                         if isinstance(m, nn.Dropout)]
                if len(drops) > 1:
                    raise ValueError(f"unit {unit} has {len(drops)} dropout "
                                     "modules; the reference models one")
                for m in drops:
                    self._handles.append(m.register_forward_hook(
                        self._mask_hook(unit)))
                unit += 1
        loss = model._loss_and_dlogits

        def recorded(logits, labels, scale):
            if self.armed:
                self.logits[-1].append(logits.detach().float().cpu())
            return loss(logits, labels, scale)

        model._loss_and_dlogits = recorded

    def _mask_hook(self, unit):
        def hook(module, inputs, output):
            if self.armed and not torch.is_grad_enabled():
                self.masks[-1].setdefault(unit, []).append(output.ne(0).cpu())
        return hook

    def new_step(self):
        self.masks.append({})
        self.logits.append([])
        self.armed = True

    def end_step(self):
        self.armed = False

    def remove(self):
        for h in self._handles:
            h.remove()
        del self.model._loss_and_dlogits

    def steps(self):
        """``(masks, logits)``: per step ``{unit: bool [batch, ...]}``
        (None where no dropout module is live) and float32 logits."""
        masks = [{u: torch.cat(parts) for u, parts in step.items()}
                 for step in self.masks]
        return ((masks if any(masks) else None),
                [torch.cat(parts) for parts in self.logits])


def run(args) -> Dict:
    from skycomputing_tpu_torch.dataset.data_generator import (
        RandomTokenGenerator,
    )
    from skycomputing_tpu_torch.dynamics import (
        Allocator,
        ModelBenchmarker,
        ParameterServer,
        WorkerManager,
        worker_pool_config,
    )
    from skycomputing_tpu_torch.dynamics.benchmarker import (
        proxy_device_benchmarker,
    )
    from skycomputing_tpu_torch.models import BertConfig, bert_layer_configs
    from skycomputing_tpu_torch.ops.losses import cross_entropy_loss
    from skycomputing_tpu_torch.parallel import PipelineModel, sgd
    from skycomputing_tpu_torch.runner import Hook, Runner
    from skycomputing_tpu_torch.utils import Logger

    cfg, run_cfg, traffic = (model_fields(args.config), args.config["run"],
                             args.traffic)
    device, seed = args.device, args.seed
    num_classes = run_cfg["num_classes"]
    batch, seq = int(traffic["batch"]), int(traffic["seq"])
    args.out_dir.mkdir(parents=True, exist_ok=True)
    logger = Logger(filename=str(args.out_dir / "train.log"), mode="w")

    bert_cfg = BertConfig(**cfg, dtype=run_cfg["dtype"],
                          use_flash_attention=run_cfg["use_flash_attention"])
    layer_cfgs = bert_layer_configs(bert_cfg, cfg["num_hidden_layers"],
                                    num_classes=num_classes)
    wm = WorkerManager()
    wm.load_worker_pool_from_config(worker_pool_config(run_cfg["workers"]))

    t_alloc = time.perf_counter()
    allocator = Allocator(
        layer_cfgs, wm,
        ModelBenchmarker(layer_cfgs,
                         RandomTokenGenerator(batch, seq, cfg["vocab_size"]),
                         device=device),
        proxy_device_benchmarker(wm, devices=[device]),
        logger=logger)
    getattr(allocator, f"{run_cfg['allocation']}_allocate")()
    alloc_s = time.perf_counter() - t_alloc

    layout = ref_bert.layout(cfg, num_classes)
    units = weights.make(layout, seed, device, cfg["initializer_range"])
    originals = {f"{i}:{k}": v for i, u in enumerate(units)
                 for k, v in u.items()}
    ps = ParameterServer(layer_cfgs, state_dicts=units)
    del units  # ``originals`` keeps the weights until the checked steps
    model = PipelineModel(
        wm, ps, sgd(run_cfg["lr"]), cross_entropy_loss, devices=[device],
        num_microbatches=run_cfg["microbatches"],
        schedule=run_cfg["schedule"])
    runner = Runner(model, ps, wm, max_epochs=1,
                    max_iters=2 ** 62,
                    logging_cfg=dict(filename=str(args.out_dir / "runner.log"),
                                     mode="w"),
                    seed=int(seed) % 2 ** 63)
    feed = Feed(traffic, cfg, num_classes, seed, device)
    if args.trace:
        TraceSlice.warm(device)

    check_steps = int(traffic["check_steps"])
    open_after = check_steps + int(traffic["warm_steps"])
    slice_s = float(traffic["slice_seconds"])
    tracer = TraceSlice(args.out_dir / "trace.json") if args.trace else None
    lr = run_cfg["lr"]

    class Window(Hook):
        """Records the checked steps, opens the window after the warm
        steps, traces a slice in its middle, and stops the run at the
        first step boundary past its end."""

        def __init__(self):
            self.prog = dict(losses=[], grad_norms={}, update_norms={})
            self.ws = self.we = None
            self.done_in_window = self.failed = 0
            self.slice_steps: List[Dict] = []

        def before_train_iter(self, runner):
            if runner.iter < check_steps:
                recorder.new_step()
            if tracer is not None and tracer.active:
                self._span = torch.profiler.record_function("bench.step")
                self._span.__enter__()

        def after_train_iter(self, runner):
            now = time.perf_counter()
            if tracer is not None and tracer.active:
                self._span.__exit__(None, None, None)
            step, stats = runner.iter, runner.model.stats
            if step <= check_steps:
                recorder.end_step()
                self.prog["losses"].append(stats.loss)
                if step == 1:
                    self.prog["grad_norms"] = _delta_norms(
                        runner.model, originals, 1.0 / lr)
                if step == check_steps:
                    self.prog["update_norms"] = _delta_norms(
                        runner.model, originals, 1.0)
                    originals.clear()
                    recorder.remove()
            if self.ws is None:
                if step == open_after:
                    self.ws, self.we = now, now + args.seconds
                return
            if now <= self.we:
                self.done_in_window += 1
                self.failed += not math.isfinite(stats.loss)
            if tracer is not None:
                if tracer.active:
                    self.slice_steps.append(dict(
                        dispatch_s=stats.dispatch_s,
                        lengths=feed.lengths[step - 1]))
                    if now - tracer.t0 >= slice_s:
                        tracer.stop(device)
                elif tracer.t0 is None and (
                        now >= self.ws + (args.seconds - slice_s) / 2):
                    tracer.start()
            if now >= self.we:
                runner.request_stop()

    recorder = Recorder(model)
    window = Window()
    runner.register_hook(window)
    runner.train(feed)
    if tracer is not None and tracer.active:
        tracer.stop(device)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    end_to_end = dict(
        train_samples_per_s=window.done_in_window * batch / args.seconds,
        setup_s=window.ws - args.t_start,
    )
    trace = tracer.summary() if tracer is not None and tracer.t1 else None
    layer = dict(
        alloc_s=alloc_s, batch=batch, seq=seq,
        num_classes=num_classes, microbatches=run_cfg["microbatches"],
        model=cfg, trace=trace,
        slice_s=tracer.seconds if trace is not None else None,
        slice_steps=window.slice_steps,
    )
    masks, window.prog["logits"] = recorder.steps()
    del runner, model, ps, allocator, feed, recorder
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference replays the checked steps from the same weights and
    # batches, in float32
    with float32_exact():
        ref_units = weights.make(layout, seed, device,
                                 cfg["initializer_range"])
        batches = []
        for index in range(check_steps):
            ids, types, mask, labels, _ = make_batch(
                traffic, cfg, num_classes, seed, index)
            batches.append(tuple(torch.from_numpy(a).to(device)
                                 for a in (ids, types, mask, labels)))
        try:
            ref = ref_bert.train(
                ref_units, cfg, batches, lr,
                block_rows=int(traffic["check"]["block_rows"]), masks=masks)
        except ref_bert.MaskMismatch as exc:
            # the program drew masks for other sites or fewer rows than
            # the batch: it did not run the configured step
            ref = None
            mismatch = str(exc)
    if ref is None:
        found = dict(numbers={k: math.inf for k in
                              traffic["check"]["limits"]},
                     notes=dict(mask_mismatch=mismatch))
    else:
        found = checks.train_numbers(window.prog, ref)
    correct, items = checks.judge(found["numbers"],
                                  traffic["check"]["limits"])
    return dict(
        end_to_end=end_to_end, attempted=window.done_in_window,
        failed=window.failed, correct=correct and window.failed == 0,
        checks=items, notes=found["notes"], memory_peak_bytes=memory_peak,
        trace=trace, layer=layer,
    )
