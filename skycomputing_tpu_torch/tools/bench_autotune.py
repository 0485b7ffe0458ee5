#!/usr/bin/env python
"""Autotuner bench and smoke (the port of ``tools/bench_autotune.py``).

Two modes:

``--smoke`` (pure stdlib, no torch): runs the decide step of the closed
loop on the repository's synthetic straggler trace
(``tools/fixtures/trace_straggler.json``, read as data), with the port's
trace analysis and advisor loaded by file path: the analysis must find
the straggler lane, :class:`TuningAdvisor` must map the signature to an
``allocation`` proposal naming the slow stage's measured seconds, a
clean balanced report must map to no proposal, and a skewed serving
report to a bucket-set proposal.  Structural drift in the analysis
schema or the advisor's signature table fails it.

Default mode: the reference's loop bench.  A BERT pipeline (the
``tiny`` preset, 3 encoder units, 3 workers, worker 0 at ``slowdown``
3) trains with :class:`AutotuneHook` wired to its allocator
(``tune_every=6``), and the bench prints the hook's events, the
partition, and the pre- and post-tune step p50.  It runs on the card
unless ``--device`` names another device (raising on a box without
one); every worker's stage sits on that one device.  ``--out`` writes a
BENCH-style JSON that ``trace_report --baseline`` can gate against,
only where it is asked to.

Usage::

    python -m skycomputing_tpu_torch.tools.bench_autotune --smoke
    python -m skycomputing_tpu_torch.tools.bench_autotune [--device cpu] \\
        [--iters 30] [--out PATH]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from typing import Any, Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
_ROOT = os.path.dirname(_PKG)
_FIXTURE = os.path.join(_ROOT, "tools", "fixtures", "trace_straggler.json")


def _load_by_path(name: str, *parts: str):
    """A pure-stdlib module of the port, loaded from its file (no package
    ``__init__`` runs, so nothing imports torch)."""
    module = sys.modules.get(name)
    if module is not None:
        return module
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_PKG, *parts))
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def run_smoke() -> int:
    analysis = _load_by_path("skytpu_torch_trace_analysis",
                             "telemetry", "analysis.py")
    advisor_mod = _load_by_path("skytpu_torch_tuning_advisor",
                                "tuning", "advisor.py")
    problems = []
    report = analysis.analyze(analysis.load_events(_FIXTURE))
    advisor = advisor_mod.TuningAdvisor()

    proposal = advisor.propose_training(
        report, schedule="gpipe", num_microbatches=2, batch_size=8,
    )
    if proposal is None:
        problems.append("straggler fixture produced no proposal")
    else:
        if proposal.knob != "allocation":
            problems.append(
                f"straggler fixture proposed {proposal.knob!r}, "
                f"expected 'allocation'"
            )
        else:
            measured = list(proposal.value)
            if len(measured) != report["num_stages"]:
                problems.append(
                    f"proposal carries {len(measured)} stage times for "
                    f"{report['num_stages']} stages"
                )
            elif measured.index(max(measured)) != 1:
                problems.append(
                    f"fixture's straggler is stage 1, proposal blames "
                    f"stage {measured.index(max(measured))}"
                )
        print(f"# straggler: {proposal.signature} -> {proposal.knob} "
              f"({proposal.reason})")

    # a balanced, low-bubble report must read as clean (no thrash)
    clean = {
        "stage_busy_ms": {"0": 90.0, "1": 92.0, "2": 91.0},
        "bubble_fraction": 0.08,
        "steps": {"count": 10, "p50_ms": 10.0},
    }
    noop = advisor.propose_training(
        clean, schedule="1f1b", num_microbatches=4, batch_size=8,
    )
    if noop is not None:
        problems.append(f"clean report produced {noop.describe()}")
    else:
        print("# clean report: no-op")

    # skewed serving buckets must map to a bucket-set proposal
    skew = {
        "stage_busy_ms": {"0": 50.0},
        "bubble_fraction": 0.2,
        "serving": {
            "prefill_waves": 20, "decode_ticks": 80, "queue_stalls": 0,
            "padding_fraction": 0.8438,
            "buckets": {"64": {"waves": 20, "requests": 20,
                               "tokens": 200, "padded_fraction": 0.84}},
        },
    }
    bucket_prop = advisor.propose_serving(
        skew, buckets=(64,), num_slots=4, max_len=128,
    )
    if bucket_prop is None or bucket_prop.knob != "buckets":
        problems.append(
            f"skewed-bucket report proposed "
            f"{getattr(bucket_prop, 'knob', None)!r}, expected 'buckets'"
        )
    else:
        print(f"# skewed buckets: -> {list(bucket_prop.value)}")

    if problems:
        for p in problems:
            print(f"bench_autotune --smoke: {p}", file=sys.stderr)
        return 1
    print("# smoke: ok")
    return 0


def run_bench(iters: int, *, device=None, seed: int = 0) -> Dict[str, Any]:
    """The loop bench; returns its result dict (``rc`` 0 when a proposal
    that was applied got committed, or when none was applied)."""
    if _ROOT not in sys.path:
        sys.path.insert(0, _ROOT)
    import numpy as np
    import torch

    from skycomputing_tpu_torch.dynamics import (
        Allocator,
        ParameterServer,
        WorkerManager,
    )
    from skycomputing_tpu_torch.models import bert_config, bert_layer_configs
    from skycomputing_tpu_torch.ops import cross_entropy_loss
    from skycomputing_tpu_torch.parallel import PipelineModel, sgd
    from skycomputing_tpu_torch.runner import AutotuneHook, Runner
    from skycomputing_tpu_torch.tools import device_record
    from skycomputing_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    cfg = bert_config("tiny", dtype="float32", hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    model_cfg = bert_layer_configs(cfg, num_encoder_units=3,
                                   num_classes=3, deterministic=True)
    wm = WorkerManager()
    wm.load_worker_pool_from_config([
        dict(name=f"n{i}", device_config=dict(device_index=0),
             extra_config=dict(slowdown=3.0 if i == 0 else 1.0))
        for i in range(3)
    ])

    class _Dev:
        def benchmark(self):
            return {f"worker{w.rank}": dict(time=1.0, avai_mem=1e6)
                    for w in wm.worker_pool}

    class _Mod:
        def benchmark(self):
            return [1.0] * len(model_cfg), [0.1] * len(model_cfg)

    allocator = Allocator(model_cfg, wm, _Mod(), _Dev())
    allocator.even_allocate()
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, cfg.vocab_size, size=(8, 16)).astype(np.int64)
    types, mask = np.zeros_like(ids), np.ones_like(ids)
    labels = rng.integers(0, 3, size=(8,)).astype(np.int64)
    ps = ParameterServer(model_cfg,
                         generator=torch.Generator().manual_seed(seed))
    model = PipelineModel(wm, ps, sgd(1e-2), cross_entropy_loss,
                          devices=[dev], num_microbatches=2)
    data = tuple(torch.from_numpy(x) for x in (ids, types, mask))
    target = torch.from_numpy(labels)

    class _Loader:
        def __iter__(self):
            while True:
                yield data, target

        def __len__(self):
            return iters

    hook = AutotuneHook(allocator=allocator, tune_every=6,
                        solver_time_s=2.0)
    runner = Runner(model, ps, wm, max_epochs=1, max_iters=iters)
    runner.register_hook(hook)
    partition_before = model.partition_signature()
    runner.train(_Loader())

    applied = [e for e in hook.events if e["outcome"] == "applied"]
    committed = [e for e in hook.events if e["outcome"] == "committed"]
    return dict(
        device=device_record(dev),
        iters=iters,
        partition_before=partition_before,
        partition=model.partition_signature(),
        tunes=hook.tunes,
        events=[{k: v for k, v in e.items() if k != "proposal"}
                for e in hook.events],
        proposals=[e["proposal"] for e in hook.events if "proposal" in e],
        step_ms=dict(
            pre_tune=applied[0]["base_ms"] if applied else None,
            post_tune=committed[-1]["new_ms"] if committed else None,
        ),
        rc=0 if committed or not applied else 1,
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--smoke", action="store_true",
                        help="advisor-on-fixture structural check "
                             "(pure stdlib)")
    parser.add_argument("--iters", type=int, default=30,
                        help="training iterations for the full bench")
    parser.add_argument("--out", help="write a BENCH-style JSON here")
    parser.add_argument("--device", default=None,
                        help="run here (e.g. cpu) instead of on the card; "
                             "without it a box with no card raises")
    args = parser.parse_args(argv)
    if args.smoke:
        return run_smoke()
    if args.device == "cpu":
        import torch

        torch.set_num_threads(1)
    result = run_bench(args.iters, device=args.device)
    print(json.dumps(result, indent=2, default=str))
    if args.out:
        payload = dict(bench="autotune", summary=dict(
            step_ms=result["step_ms"]["post_tune"]
            or result["step_ms"]["pre_tune"] or 0.0,
        ), detail=result)
        parent = os.path.dirname(args.out)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(payload, fh, indent=2, default=str)
        print(f"# wrote {args.out}")
    return result["rc"]


if __name__ == "__main__":
    sys.exit(main())
