"""Step time and MFU of the monolithic BERT train step (the port of
``tools/bench_mfu.py``).

Times the whole BERT train step — forward, backward and an SGD update
at 1e-3, one stack on one device — and reports model FLOP utilization
against the card's peak.  The FLOPs per step come from
:func:`~..utils.profiling.compiled_cost` over the whole step (the
port's counter, held to XLA's count of the JAX step within 1% at the
tiny preset in float32); ``6 x parameters x tokens``, the usual
estimate, is printed beside them.  It also times one encoder unit trio
(head, body, tail; forward and backward) alone, the allocator's unit of
time.

    python -m skycomputing_tpu_torch.tools.bench_mfu [--device cpu]
    SKYTPU_MFU_PRESET=base SKYTPU_MFU_BATCH=64 python -m \\
        skycomputing_tpu_torch.tools.bench_mfu

Knobs (JAX's): ``SKYTPU_MFU_PRESET`` (large), ``SKYTPU_MFU_BATCH``
(32), ``SKYTPU_MFU_SEQ`` (128), ``SKYTPU_MFU_UNITS`` (0: the preset's
depth), ``SKYTPU_MFU_ITERS`` (10), ``SKYTPU_MFU_JSON`` (a file for the
figures).  The peak is 989 TFLOP/s (bfloat16, dense) for an H100,
found in ``torch.cuda.get_device_name()``; ``SKYTPU_PEAK_TFLOPS``
overrides it, and a card the table misses needs it.  On the CPU no peak
applies and MFU is not reported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..dynamics.estimator import synchronize
from . import add_device_arg, device_record, tool_device

#: bf16 dense peak TFLOP/s by a substring of the card's name (NVIDIA's
#: data sheet, SXM part, without sparsity)
PEAK_TFLOPS = {"h100": 989.0}


def peak_flops(device) -> Optional[float]:
    override = os.getenv("SKYTPU_PEAK_TFLOPS")
    if override:
        return float(override) * 1e12
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    for key, tflops in PEAK_TFLOPS.items():
        if key in name:
            return tflops * 1e12
    raise SystemExit(f"unknown card {torch.cuda.get_device_name(device)!r};"
                     f" set SKYTPU_PEAK_TFLOPS")


def timed(fn, *args, device, iters: int = 10, warmup: int = 2) -> float:
    """Best of three windows of ``iters`` calls, seconds per call."""
    for _ in range(warmup):
        fn(*args)
    synchronize(device)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        synchronize(device)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def train_step(model, ids, types, mask, labels):
    """Forward, loss, backward and one SGD step of 1e-3 (SGD holds no
    state, so the optimizer is built per step, on whatever weights
    ``model`` holds: real or ``meta``)."""
    from ..ops.losses import cross_entropy_loss
    from ..parallel import sgd

    opt = sgd(1e-3)(list(model.parameters()))
    loss = cross_entropy_loss(model(ids, types, mask), labels)
    loss.backward()
    opt.step()
    opt.zero_grad(set_to_none=True)
    return loss.detach()


def unit_fwd_bwd(trio, hidden, mask4):
    """One encoder trio's forward and backward on a fixed input."""
    from ..builder import as_tuple

    acts = (hidden, mask4)
    for unit in trio:
        acts = as_tuple(unit(*acts))
    loss = (acts[0].float() ** 2).mean()
    loss.backward()
    return loss.detach()


def run(device) -> dict:
    from ..builder import build_layer_stack
    from ..models import bert_config, bert_layer_configs
    from ..utils.profiling import compiled_cost

    preset = os.getenv("SKYTPU_MFU_PRESET", "large")
    batch = int(os.getenv("SKYTPU_MFU_BATCH", "32"))
    seq = int(os.getenv("SKYTPU_MFU_SEQ", "128"))
    units = int(os.getenv("SKYTPU_MFU_UNITS", "0")) or None
    iters = int(os.getenv("SKYTPU_MFU_ITERS", "10"))
    peak = peak_flops(device)

    cfg = bert_config(preset, hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    layer_cfgs = bert_layer_configs(
        cfg, num_encoder_units=units or cfg.num_hidden_layers,
        num_classes=3, deterministic=True)
    # built and initialized on the device from a seed (the weights'
    # values do not move the step's time; a host-side init of
    # BERT-large's 335M parameters would cost seconds)
    cuda = torch.device(device).type == "cuda"
    with torch.random.fork_rng(devices=[device] if cuda else []):
        torch.manual_seed(0)
        with torch.device(device):
            model = build_layer_stack(layer_cfgs)

    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(
        5, cfg.vocab_size, (batch, seq)).astype(np.int64)).to(device)
    types, mask = torch.zeros_like(ids), torch.ones_like(ids)
    labels = torch.from_numpy(
        rng.integers(0, 3, (batch,)).astype(np.int64)).to(device)

    cost = compiled_cost(train_step, model, ids, types, mask, labels)
    flops = cost["flops"]
    n_params = sum(p.numel() for p in model.parameters())
    step_s = timed(train_step, model, ids, types, mask, labels,
                   device=device, iters=iters)

    # one encoder trio alone, on a fixed hidden state
    trio = model.layers[1:4]
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    hidden = torch.from_numpy(rng.standard_normal(
        (batch, seq, cfg.hidden_size)).astype(np.float32)).to(device, dt)
    mask4 = torch.zeros((batch, 1, 1, seq), device=device, dtype=dt)
    unit_flops = compiled_cost(unit_fwd_bwd, trio, hidden, mask4)["flops"]
    unit_s = timed(unit_fwd_bwd, trio, hidden, mask4, device=device,
                   iters=iters)
    for p in model.parameters():
        p.grad = None

    out = dict(
        preset=preset, batch=batch, seq=seq, dtype=cfg.dtype,
        units=len(layer_cfgs),
        step_time_ms=step_s * 1e3,
        flops_per_step=flops,
        six_n_tokens=6.0 * n_params * batch * seq,
        parameters=n_params,
        achieved_tflops_per_s=flops / step_s / 1e12,
        peak_tflops_per_s=None if peak is None else peak / 1e12,
        mfu=None if peak is None else flops / step_s / peak,
        temp_bytes=cost.get("temp_bytes"),
        unit_fwd_bwd_ms=unit_s * 1e3,
        unit_flops=unit_flops,
        unit_mfu=None if peak is None else unit_flops / unit_s / peak,
        device=device_record(device),
    )
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = tool_device(args)
    out = run(device)
    print(json.dumps(out), flush=True)
    mfu = ("not measured" if out["mfu"] is None
           else f"{out['mfu'] * 100:.1f}%")
    print(f"# BERT-{out['preset']} train step (B={out['batch']}, "
          f"L={out['seq']}, {out['dtype']}): {out['step_time_ms']:.2f} ms | "
          f"{out['flops_per_step'] / 1e12:.3f} TFLOPs counted "
          f"(6 x params x tokens {out['six_n_tokens'] / 1e12:.3f}) | "
          f"{out['achieved_tflops_per_s']:.1f} TFLOP/s | MFU {mfu} on "
          f"{out['device']['kind']}", flush=True)
    print(f"# encoder trio fwd+bwd: {out['unit_fwd_bwd_ms']:.2f} ms | "
          f"{out['unit_flops'] / 1e9:.1f} GFLOPs", flush=True)
    path = os.getenv("SKYTPU_MFU_JSON")
    if path:
        with open(path, "w") as fh:
            json.dump(out, fh)
            fh.write("\n")
        print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
