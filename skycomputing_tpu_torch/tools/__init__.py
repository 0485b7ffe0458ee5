"""The port's measuring tools (the ports of the repo's ``tools/`` that
drive the JAX package), each a command::

    python -m skycomputing_tpu_torch.tools.<name> [--device cpu] ...

- ``bench_step_overhead``: pipeline step time split into host dispatch
  and device wait, tracing's cost, and (``--mesh``) the per-device
  loop against mesh-native stages;
- ``validate_schedule_model``: the bench's fill-drain schedule model
  against measured pipelined steps;
- ``bench_kv_cache``: cached decoding against full-forward generation;
- ``trace_report``: bubble, dispatch and step analysis of a Chrome
  trace, with a regression gate;
- ``convert_torch_checkpoint``: a reference checkpoint to the port's
  per-layer state dicts;
- ``bench_mfu``: the monolithic BERT train step's time and MFU;
- ``profile_allocation``: the model and device profiles and the
  partition each allocation strategy would choose;
- ``run_ladder``: the experiment config ladder through the launcher;
- ``bench_fleet``: the serving fleet's kill-and-spike scenario (and
  ``--smoke``, the router's and admission's decisions);
- ``skyreport``: an incident postmortem bundle rendered and verified.
- ``bench_disagg``: prefill/decode pools against a monolithic fleet
  over ``disagg_mix``;
- ``bench_chaos``: the fault-plan catalog replayed and audited;
- ``bench_scenarios``: the autoscaler over a named scenario against a
  fixed fleet.

Every tool that runs a model runs on the card unless ``--device`` names
another device, and raises on a box without one.  None writes outside ``build/``,
``chiprun_out/`` or a path its caller gives.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..utils import resolve_device


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default=None,
                        help="run here (e.g. cpu) instead of on the card; "
                             "without it a box with no card raises")


def tool_device(args) -> torch.device:
    """The device ``--device`` names, else the card (raising where there
    is none).  One torch thread on the CPU, so parallel tools do not
    oversubscribe the host."""
    device = resolve_device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(1)
    return device


def device_record(device: torch.device) -> dict:
    """Where a result was measured: the card's name and count, or the
    CPU (whose times are not device times)."""
    if device.type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                    count=torch.cuda.device_count())
    return dict(platform=device.type, kind=device.type, count=1)


def write_json(path: str, obj, indent=1) -> None:
    """``obj`` as JSON at ``path``, its directory made first."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=indent)
        fh.write("\n")
