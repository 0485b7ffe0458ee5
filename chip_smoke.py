#!/usr/bin/env python
"""Chip smoke for the PyTorch/CUDA port (``skycomputing_tpu_torch``).

Runs on one NVIDIA GPU (built for an H100, ``sm_90a``) and fails without
one.  Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA source under ``skycomputing_tpu_torch/ops/csrc``
   (one ``nvcc`` per source, started together);
3. each kernel against its plain PyTorch version on the card, in
   bfloat16 and float32, at GPT-2 small's attention shapes (decode,
   prefill and speculative-verify waves), over fp pages (kernel B2) and
   over int8 pages with per-page-per-head scales (kernel B3), with
   kernel / plain / library times and the bound;
4. the main path: GPT-2 small (full width, 12 layers, random weights
   from a seed) served by the paged ``ServingEngine`` — 16 requests,
   four sharing a 64-token prefix — with every kernel's launch count
   read from that run alone;
5. the same workload with ``kv_dtype="int8"`` (kernel B3 in every
   layer of every step, B2 never), beside the fp run's numbers;
6. speculative decoding (``spec_k=4``, ``draft_blocks=2``) over fp
   pages and over int8 pages (B2 / B3 at ``Lq = 5``);
7. chunked prefill (``prefill_chunk=64``), and a swap preemption under
   int8;
8. card against CPU: the same port at full width, depth 2, float32,
   greedy, must give identical token streams on ``cuda`` and ``cpu``;
   over int8 pages, run in lockstep with the CPU's tokens fed to both,
   the card must choose the CPU's token at at least 95% of positions
   (the free-running streams' agreement is reported); speculative
   streams on the card must equal the card's plain streams;
9. a profiler breakdown of a few decode ticks, fp and int8 (device time
   by kernel), and what the KV write (the int8 quantize-on-write, the fp
   scatter) costs per tick.

The line before last is ``{"kernels": [...]}``, one entry per kernel;
the last line is ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Usage::

    python3 chip_smoke.py
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, no sparsity
SEED = 0
LAYERS = 12


def log(msg: str) -> None:
    print(msg, flush=True)


@contextmanager
def phase(name: str):
    log(f"== {name}")
    t0 = time.perf_counter()
    try:
        yield
    except Exception:  # every phase is fatal: report and stop
        traceback.print_exc()
        log(f"FAIL: phase '{name}'")
        sys.exit(1)
    log(f"   {name}: {time.perf_counter() - t0:.3f} s")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)
    log(f"   ok: {msg}")


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------


def time_ms(torch, fn, iters: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms, each launch timed alone with
    CUDA events after a 64 MiB write evicts the 50 MB L2 (a layer's
    pages come from device memory, not from the previous layer's L2)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


# --------------------------------------------------------------------------
# phase 3: paged attention against its plain version
# --------------------------------------------------------------------------


def attention_case(torch, np, name, R, Lq, dtype, seed, int8=False):
    """GPT-2 small heads (H=12, D=64), page_size 16, a 512-page pool.
    Decode and verify waves: 12 live rows at positions 1..300 (every
    fourth row inactive); prefill: 2 live rows (one appending after a
    64-token prefix) and 2 pad rows.  ``int8``: pages are N(0, 32)
    rounded and clipped to int8, scales U(0.02, 0.04) per (page, head),
    so the dequantized pages are of unit size like the fp ones."""
    H, D, PS, P, W = 12, 64, 16, 512, 32
    rng = np.random.default_rng(seed)
    pages = rng.permutation(P - 1)  # page P-1 is only ever a clamp target
    table = np.full((R, W), P, np.int32)
    index = np.zeros(R, np.int32)
    used = 0
    for r in range(R):
        if name in ("decode", "verify"):
            if r % 4 == 3:
                continue  # inactive row: index 0, all sentinels
            index[r] = rng.integers(1, 300)
        elif r >= 2:
            continue  # prefill pad row: index 0, all sentinels
        else:
            index[r] = 64 * r  # row 1 appends after a 64-token prefix
        n = (int(index[r]) + Lq - 1) // PS + 1
        table[r, :n] = pages[used:used + n]
        used += n
    dt = getattr(torch, dtype)
    q = torch.from_numpy(rng.standard_normal((R, Lq, H, D), np.float32))
    case = dict(q=q.to("cuda", dt), table=torch.from_numpy(table).cuda(),
                index=torch.from_numpy(index).cuda(), table_np=table,
                index_np=index, P=P, PS=PS, H=H, D=D, int8=int8)
    if int8:
        for name_ in ("k", "v"):
            vals = np.clip(np.round(32 * rng.standard_normal((P, PS, H, D))),
                           -127, 127).astype(np.int8)
            case[name_] = torch.from_numpy(vals).cuda()
            case[name_ + "_scale"] = torch.from_numpy(
                rng.uniform(0.02, 0.04, (P, H)).astype(np.float32)).cuda()
    else:
        for name_ in ("k", "v"):
            case[name_] = torch.from_numpy(rng.standard_normal(
                (P, PS, H, D), np.float32)).to("cuda", dt)
    return case


def attention_bound(np, case, dtype):
    """The least time for this call: live K/V bytes (each position a
    row can see, read once; int8 pages 1 byte per element plus 4 bytes
    per live (page, head) for each of the k and v scales) + q + out +
    table + index, against visible-pair flops."""
    P, PS, H, D = case["P"], case["PS"], case["H"], case["D"]
    table, index = case["table_np"], case["index_np"]
    R, Lq = case["q"].shape[0], case["q"].shape[1]
    W = table.shape[1]
    live = set()
    pairs = 0
    for r in range(R):
        last = min(int(index[r]) + Lq, W * PS)  # positions 0..last-1
        for pos in range(last):
            phys = min(max(int(table[r, pos // PS]), 0), P - 1)
            live.add((phys, pos % PS))
        for j in range(Lq):
            pairs += min(int(index[r]) + j + 1, W * PS)
    itemsize = 2 if dtype == "bfloat16" else 4
    kv_itemsize = 1 if case["int8"] else itemsize
    nbytes = len(live) * 2 * H * D * kv_itemsize
    if case["int8"]:
        nbytes += len({p for p, _ in live}) * H * 4 * 2
    nbytes += 2 * R * Lq * H * D * itemsize + table.nbytes + index.nbytes
    flops = 4.0 * D * H * pairs
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def kernel_args(case):
    """(positional args, keyword args) of ``paged_attention``."""
    args = (case["q"], case["k"], case["v"], case["table"], case["index"])
    if case["int8"]:
        return args, dict(k_scale=case["k_scale"], v_scale=case["v_scale"])
    return args, {}


def library_call(torch, case):
    """``scaled_dot_product_attention`` over the gathered views (int8
    pages dequantized in the gather) with the causal/staleness mask: the
    yardstick (the port never calls it).  Returns a zero-argument
    callable; the gather and dequant are done once, outside the timed
    call."""
    from skycomputing_tpu_torch.serving.kv_cache import (
        QuantizedPages,
        decode_visibility,
        gather_kv_pages,
    )
    import torch.nn.functional as F

    q = case["q"]
    k, v = case["k"], case["v"]
    if case["int8"]:
        k = QuantizedPages(k, case["k_scale"])
        v = QuantizedPages(v, case["v_scale"])
    k_virt, v_virt = gather_kv_pages(k, v, case["table"])
    mask = decode_visibility(case["index"], q.shape[1], k_virt.shape[1])
    qh = q.transpose(1, 2)
    kh = k_virt.to(q.dtype).transpose(1, 2).contiguous()
    vh = v_virt.to(q.dtype).transpose(1, 2).contiguous()
    m = mask[:, None]
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=m)


def kernel_checks(torch, np):
    from skycomputing_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_reference,
    )

    tol = {"float32": 1e-4, "bfloat16": 2e-2}
    results = []
    for kernel, int8 in (("paged_attention", False),
                         ("paged_attention_int8", True)):
        for name, R, Lq in (("decode", 16, 1), ("prefill", 4, 128),
                            ("verify", 16, 5)):
            for dtype in ("bfloat16", "float32"):
                case = attention_case(torch, np, name, R, Lq, dtype,
                                      seed=len(results), int8=int8)
                args, kw = kernel_args(case)
                out = paged_attention(*args, **kw)
                ref = paged_attention_reference(*args, **kw)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                finite = bool(torch.isfinite(out).all())
                ms = time_ms(torch, lambda: paged_attention(*args, **kw))
                plain_ms = time_ms(
                    torch, lambda: paged_attention_reference(*args, **kw))
                library_ms = time_ms(torch, library_call(torch, case))
                bound_ms, bound_by = attention_bound(np, case, dtype)
                row = dict(kernel=kernel, case=name, R=R, Lq=Lq,
                           dtype=dtype, max_abs_err=err, tol=tol[dtype],
                           ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
                log(f"   {json.dumps(row)}")
                check(finite and err <= tol[dtype],
                      f"{kernel} {name} {dtype}: max |err| {err:.3g} "
                      f"<= {tol[dtype]}")
                results.append(row)
    return results


# --------------------------------------------------------------------------
# phases 4-8: the serving engine
# --------------------------------------------------------------------------


def requests_for(np, Request, n=16, new_tokens=32, seed=SEED):
    """Prompt lengths from default_rng(seed) in 24..250.  Requests 0, 5
    and 12 share a 64-token prefix (page-aligned: a radix hit maps whole
    pages); request 15 repeats request 0's prompt (a hit that ends
    mid-page: a copy-on-write clone)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(24, 251, n)
    prefix = rng.integers(1, 50257, 64).astype(np.int32)
    prompts = []
    for i, length in enumerate(lengths):
        if i in (0, 5, 12):
            tail = rng.integers(1, 50257, max(1, int(length) - 64))
            prompts.append(np.concatenate([prefix, tail.astype(np.int32)]))
        else:
            prompts.append(rng.integers(1, 50257, int(length))
                           .astype(np.int32))
    if n > 15:
        if (prompts[0].size - 1) % 16 == 0:  # keep the repeat mid-page
            prompts[0] = np.append(prompts[0], np.int32(7))
        prompts[15] = prompts[0].copy()
    return [Request(prompt=p, max_new_tokens=new_tokens) for p in prompts]


def build_engine(ServingEngine, cfg_mod, depth, dtype, device, seed=SEED,
                 quiet_after=None, **kw):
    """GPT-2 small's width at ``depth`` blocks, random weights from
    ``seed``.  ``quiet_after=d``: blocks ``d`` and later write 10x less
    into the residual stream (their output projections scaled by 0.1),
    so that a ``d``-block speculative draft agrees with the target often
    enough for acceptance to be exercised — with the plain random
    weights the early-exit draft almost never agrees."""
    cfg = cfg_mod.GptConfig(dropout_prob=0.0, dtype=dtype)
    layer_cfgs = cfg_mod.gpt_layer_configs(cfg, num_blocks=depth)
    params = cfg_mod.random_state_dicts(layer_cfgs, seed)
    if quiet_after is not None:
        for block in range(quiet_after, depth):
            for layer in (1 + 2 * block, 2 + 2 * block):  # attn, mlp
                params[layer]["c_proj.weight"] *= 0.1
    return ServingEngine(
        layer_cfgs, params, page_size=16, buckets=(32, 64, 128, 256),
        max_len=512, max_concurrency=16, prefill_batch=4, num_pages=512,
        device=device, **kw,
    )


def serve(torch, np, gpt_mod, ServingEngine, Request, kernels, preempt=None,
          quiet_after=None, **kw):
    """One full-width (12-layer, bf16) run of the 16-request workload:
    12 requests arrive, one tick later the last 4 (two of them prefix
    sharers, so their radix hits find the first wave's registered
    prompts).  ``preempt`` = (tick, request position, mode) preempts
    that request before that tick's step.  A 4-request warm-up on
    another engine of the same knobs runs first (cuBLAS handles,
    allocator pools) and is not counted.  Every kernel's launch count is
    set to 0 just before the run and read just after it."""
    warm = build_engine(ServingEngine, gpt_mod, LAYERS, "bfloat16", "cuda",
                        quiet_after=quiet_after, **kw)
    warm.run(requests_for(np, Request, n=4, new_tokens=4, seed=99))
    del warm
    gc.collect()
    torch.cuda.empty_cache()
    engine = build_engine(ServingEngine, gpt_mod, LAYERS, "bfloat16", "cuda",
                          quiet_after=quiet_after, **kw)
    reqs = requests_for(np, Request)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k["fn"].launches = 0
    t0 = time.perf_counter()
    for r in reqs[:12]:
        engine.submit(r)
    tick = 0
    while tick == 0 or engine.has_work():
        if tick == 1:
            for r in reqs[12:]:
                engine.submit(r)
        if preempt is not None and tick == preempt[0]:
            engine.preempt(reqs[preempt[1]].request_id, mode=preempt[2])
        engine.step()
        tick += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k["fn"].launches for name, k in kernels.items()}
    snap = engine.stats.snapshot()
    log(f"   stats: {json.dumps(snap)}")
    check(snap["finished"] == 16 and all(
        r.status == "finished" for r in reqs),
          f"{snap['finished']}/16 requests finished")
    check(all(len(r.tokens) == 32 for r in reqs), "32 new tokens each")
    check(all(int(t) < 50257 for r in reqs for t in r.tokens),
          "tokens inside the vocabulary")
    e2e = dict(
        wall_s=wall, generated_tokens=snap["generated_tokens"],
        tokens_per_s=snap["generated_tokens"] / wall,
        engine_tokens_per_s=snap["tokens_per_s"],
        ttft_p50_s=snap["ttft_p50_s"], ttft_p95_s=snap["ttft_p95_s"],
        tpot_p50_s=snap["tpot_p50_s"], tpot_p95_s=snap["tpot_p95_s"],
        prefill_waves=snap["prefill_waves"],
        decode_ticks=snap["decode_ticks"], spec_ticks=snap["spec_ticks"],
        launches=launches,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    log(f"   e2e: {json.dumps(e2e)}")
    return engine, reqs, snap, launches, e2e


def agreement(a, b) -> float:
    """Share of positions where two lists of token streams agree."""
    same = total = 0
    for x, y in zip(a, b):
        total += max(len(x), len(y))
        same += sum(int(s == t) for s, t in zip(x, y))
    return same / total if total else 1.0


def lockstep_int8(torch, np, gpt_mod, ServingEngine, Request):
    """int8 pages at depth 2, float32, greedy, on the card and on the CPU
    in lockstep: after every step each new token the card chose is
    compared with the CPU's and then replaced by it (teacher forcing),
    so every position is judged on the same history.  Returns the
    agreement, the (request, position) pairs that differ, and how the
    two int8 pools differ at the end (entries and int8 steps apart,
    largest relative scale difference)."""
    engines, reqs = {}, {}
    for device in ("cuda", "cpu"):
        engines[device] = build_engine(ServingEngine, gpt_mod, 2, "float32",
                                       device, kv_dtype="int8")
        reqs[device] = requests_for(np, Request, n=6, new_tokens=12, seed=7)
        for r in reqs[device]:
            engines[device].submit(r)
    same = total = 0
    diffs = []
    while engines["cpu"].has_work():
        before = [len(r.tokens) for r in reqs["cpu"]]
        for engine in engines.values():
            engine.step()
        for i, (card, host, n) in enumerate(zip(reqs["cuda"], reqs["cpu"],
                                               before)):
            for j in range(n, len(host.tokens)):
                total += 1
                if card.tokens[j] == host.tokens[j]:
                    same += 1
                else:
                    diffs.append((i, j))
                    card.tokens[j] = host.tokens[j]
    entries = steps = 0
    scale_rel = 0.0
    for card_pair, host_pair in zip(engines["cuda"].stage.slabs,
                                    engines["cpu"].stage.slabs):
        for card, host in zip(card_pair, host_pair):
            d = (card.values.cpu().int() - host.values.int()).abs()
            entries += int((d > 0).sum())
            steps = max(steps, int(d.max()))
            rel = ((card.scale.cpu() - host.scale).abs()
                   / host.scale.abs().clamp_min(1e-30))
            scale_rel = max(scale_rel, float(rel.max()))
    total_entries = sum(2 * k.values.numel()
                        for k, _ in engines["cpu"].stage.slabs)
    return dict(agreement=same / total, positions=total, diffs=diffs,
                int8_entries_differing=entries, pool_entries=total_entries,
                max_int8_steps_apart=steps, max_scale_rel_diff=scale_rel)


def check_launches(launches, expect, what):
    check(launches == expect,
          f"{what}: launches {json.dumps(launches)} == {json.dumps(expect)}")


def kernel_rows(prof):
    """(device us, kernel name, count) per kernel of a profile, largest
    first."""
    rows = []
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue  # kernels only: host ops would count them twice
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, evt.key, evt.count))
    return sorted(rows, reverse=True)


def profile_ticks(torch, engine, ticks=4):
    """``torch.profiler`` over ``ticks`` engine steps; device time by
    kernel, the card's idle share over the window."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            engine.step()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    rows = kernel_rows(prof)
    total_us = sum(r[0] for r in rows)
    out = dict(window_s=window, device_busy_s=total_us / 1e6)
    if total_us > 0:
        out["idle_share"] = max(0.0, 1 - total_us / 1e6 / window)
        out["top"] = [dict(kernel=k[:80], device_ms=us / 1e3, count=n,
                           share=us / total_us) for us, k, n in rows[:12]]
        for row in out["top"]:
            log(f"   {row['share']:6.1%} {row['device_ms']:9.3f} ms "
                f"x{row['count']:<5d} {row['kernel']}")
    else:
        log("   the profiler recorded no device time: not measured")
    return out


def write_cost_per_tick(torch, np, engine, timer=time_ms):
    """What one decode tick's KV write over every layer of ``engine``
    costs (its current rows, random new K/V in the model dtype): the
    int8 pool's quantize-on-write or the fp pool's scatter.  Returns
    (span_ms, device_ms): the write's span on the card's clock by
    ``timer`` — for a sequence of small eager kernels that is the host's
    time to launch them — and the device time of its kernels alone, from
    the profiler.  The write lands in the engine's slabs, so call it
    last."""
    from skycomputing_tpu_torch.serving.kv_cache import (
        scatter_kv,
        slab_device,
        write_plan,
    )

    active = list(engine._running.values())
    _, index, tables = engine._decode_rows(active)
    valid = np.zeros_like(index)
    for r in active:
        valid[r.slot] = r.index + 1
    width = engine._table_width(valid)
    slabs = engine.stage.slabs
    k0 = slabs[0][0]
    device = slab_device(k0)
    plan = write_plan(k0, tables[:, :width], index, valid, 1).to(device)
    spec = engine.stage.specs[0]
    rng = np.random.default_rng(5)
    new = torch.from_numpy(rng.standard_normal(
        (len(index), 1, spec.num_heads, spec.head_dim), np.float32)).to(
        device, getattr(torch, spec.dtype))

    def write():
        for k, v in slabs:
            scatter_kv(k, v, new, new, plan)

    span_ms = timer(torch, write, iters=10)
    if device.type != "cuda":
        return span_ms, None
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        write()
        torch.cuda.synchronize()
    return span_ms, sum(r[0] for r in kernel_rows(prof)) / 1e3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device; this smoke runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import numpy as np
        from skycomputing_tpu_torch.models import gpt as gpt_mod
        from skycomputing_tpu_torch.ops import _build
        from skycomputing_tpu_torch.ops.paged_attention import (
            paged_attention,
            paged_attention_int8,
        )
        from skycomputing_tpu_torch.serving import Request, ServingEngine
    except ImportError as exc:
        print(f"FAIL: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    report = dict(device=kind, torch=torch.__version__,
                  cuda=torch.version.cuda)
    source = "skycomputing_tpu_torch/ops/csrc/paged_attention.cu"
    # every kernel wrapper of the port, by name
    kernels = {
        "paged_attention": dict(
            fn=paged_attention, route="cuda", source=source,
            replaces="skycomputing_tpu/ops/paged_attention.py:73"),
        "paged_attention_int8": dict(
            fn=paged_attention_int8, route="cuda", source=source,
            replaces="skycomputing_tpu/ops/paged_attention.py:108"),
    }
    serve_args = (torch, np, gpt_mod, ServingEngine, Request, kernels)
    B2, B3 = "paged_attention", "paged_attention_int8"

    with phase("card"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.stdout else ""
        log(card)
        report["nvidia_smi"] = card
        log(f"   torch {torch.__version__}, CUDA {torch.version.cuda}")

    with phase("build"):
        sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(sources)) as pool:
            built = list(pool.map(_build.build, sources))
        report["build_s"] = time.perf_counter() - t0
        log(f"   built {sources} in {report['build_s']:.2f} s")
        for path in built:
            ptxas = path.with_suffix(".log")
            if ptxas.exists():
                log(ptxas.read_text().strip())

    with phase("kernels against plain versions"):
        attn = kernel_checks(torch, np)
        report["kernels"] = attn

    with phase("main path: GPT-2 small paged serving"):
        cfg = gpt_mod.GptConfig()
        check(cfg.hidden_size == 768 and cfg.num_hidden_layers == LAYERS
              and cfg.vocab_size == 50257 and cfg.dtype == "bfloat16",
              "GPT-2 small defaults")
        engine, fp_reqs, snap, launches, e2e = serve(*serve_args)
        steps = snap["prefill_waves"] + snap["decode_ticks"]
        check_launches(launches, {B2: LAYERS * steps, B3: 0},
                       f"12 x ({snap['prefill_waves']} prefill waves + "
                       f"{snap['decode_ticks']} decode ticks) of B2")
        check(snap["prefix_hits"] >= 2 and snap["cow_copies"] >= 1,
              f"radix hits {snap['prefix_hits']}, COW clones "
              f"{snap['cow_copies']}")
        report["e2e"] = e2e
        main_launches = launches
        fp_streams = [list(r.tokens) for r in fp_reqs]
        del engine

    with phase("int8 path: GPT-2 small over int8 pages"):
        engine, reqs, snap, launches, e2e = serve(*serve_args,
                                                  kv_dtype="int8")
        steps = snap["prefill_waves"] + snap["decode_ticks"]
        check_launches(launches, {B2: 0, B3: LAYERS * steps},
                       f"12 x ({snap['prefill_waves']} prefill waves + "
                       f"{snap['decode_ticks']} decode ticks) of B3")
        check(snap["quantized_pages"] > 0 and snap["dequant_blocks"] > 0,
              f"quantized pages {snap['quantized_pages']}, dequantized "
              f"blocks {snap['dequant_blocks']}")
        check(snap["prefix_hits"] >= 2 and snap["cow_copies"] >= 1,
              f"radix hits {snap['prefix_hits']}, COW clones "
              f"{snap['cow_copies']}")
        int8_streams = [list(r.tokens) for r in reqs]
        e2e["agreement_with_fp"] = agreement(int8_streams, fp_streams)
        e2e["first_token_agreement_with_fp"] = float(np.mean(
            [a[0] == b[0] for a, b in zip(int8_streams, fp_streams)]))
        fp_e2e = report["e2e"]
        for key in ("tokens_per_s", "ttft_p50_s", "ttft_p95_s", "tpot_p50_s",
                    "tpot_p95_s", "peak_mem_gb"):
            log(f"   {key}: int8 {e2e[key]:.6g}, fp {fp_e2e[key]:.6g}")
        log(f"   positional agreement with the fp run "
            f"{e2e['agreement_with_fp']:.3f} (first tokens "
            f"{e2e['first_token_agreement_with_fp']:.3f}; reported, not "
            f"gated: random weights make near-ties common)")
        report["e2e_int8"] = e2e
        int8_launches = launches
        del engine

    with phase("speculative path: spec_k=4, draft_blocks=2"):
        k, d = 4, 2
        spec = {}
        for kv_dtype, kernel in ((None, B2), ("int8", B3)):
            engine, reqs, snap, launches, e2e = serve(
                *serve_args, spec_k=k, draft_blocks=d, kv_dtype=kv_dtype,
                quiet_after=d)
            expect = {B2: 0, B3: 0}
            expect[kernel] = (
                LAYERS * (snap["prefill_waves"] + snap["decode_ticks"])
                + snap["spec_ticks"] * (k * d + LAYERS))
            check_launches(
                launches, expect,
                f"{kernel}: 12 x {snap['prefill_waves']} prefill waves + "
                f"{snap['spec_ticks']} spec ticks x ({k} x {d} + 12)")
            check(snap["spec_ticks"] > 0
                  and snap["accepted_draft_tokens"] > 0,
                  f"{snap['accepted_draft_tokens']} of "
                  f"{snap['draft_tokens']} draft tokens accepted")
            e2e["accept_rate"] = (snap["accepted_draft_tokens"]
                                  / snap["draft_tokens"])
            e2e["spec_rollbacks"] = snap["spec_rollbacks"]
            log(f"   {kv_dtype or 'fp'} pages: accept rate "
                f"{e2e['accept_rate']:.3f}, tokens/s "
                f"{e2e['tokens_per_s']:.1f}, TPOT p50 "
                f"{e2e['tpot_p50_s'] * 1e3:.2f} ms")
            spec[kv_dtype or "fp"] = e2e
            del engine
        report["e2e_spec"] = spec

    with phase("chunked prefill and swap preemption"):
        engine, reqs, snap, launches, e2e = serve(*serve_args,
                                                  prefill_chunk=64)
        check(snap["prefill_chunks"] > 0,
              f"{snap['prefill_chunks']} prefill chunks in "
              f"{snap['prefill_waves']} chunk waves")
        check_launches(launches, {
            B2: LAYERS * (snap["prefill_waves"] + snap["decode_ticks"]),
            B3: 0}, f"12 x ({snap['prefill_waves']} chunk waves + "
                    f"{snap['decode_ticks']} decode ticks) of B2")
        e2e["agreement_with_fp"] = agreement(
            [list(r.tokens) for r in reqs], fp_streams)
        report["e2e_chunked"] = e2e
        del engine
        victim = 1
        engine, reqs, snap, launches, e2e = serve(
            *serve_args, preempt=(8, victim, "swap"), kv_dtype="int8")
        check(snap["preemptions"] == snap["swap_outs"] == 1
              and snap["swap_ins"] == 1 and snap["swap_corruptions"] == 0,
              f"swap out {snap['swap_outs']}, in {snap['swap_ins']}, "
              f"corrupt {snap['swap_corruptions']}")
        check(reqs[victim].status == "finished"
              and len(reqs[victim].tokens) == 32,
              "the swapped request resumed and finished with 32 tokens")
        check_launches(launches, {
            B2: 0, B3: LAYERS * (snap["prefill_waves"]
                                 + snap["decode_ticks"])},
            "swap run: 12 x (prefill waves + decode ticks) of B3")
        e2e["victim_agreement_with_unpreempted"] = agreement(
            [list(reqs[victim].tokens)], [int8_streams[victim]])
        log(f"   the victim's stream agrees with the un-preempted int8 "
            f"run at {e2e['victim_agreement_with_unpreempted']:.3f} of "
            f"positions (reported: other rows' batch changes)")
        report["e2e_swap"] = e2e
        del engine

    with phase("card against CPU: depth 2, float32, greedy"):
        streams = {}
        for name, device, kw in (
                ("fp", "cuda", {}), ("fp", "cpu", {}),
                ("int8", "cuda", dict(kv_dtype="int8")),
                ("int8", "cpu", dict(kv_dtype="int8")),
                ("spec", "cuda", dict(spec_k=3, draft_blocks=1))):
            eng = build_engine(ServingEngine, gpt_mod, 2, "float32", device,
                               **kw)
            reqs = requests_for(np, Request, n=6, new_tokens=12, seed=7)
            eng.run(reqs)
            streams[name, device] = [list(r.tokens) for r in reqs]
        agree = sum(a == b for a, b in zip(streams["fp", "cuda"],
                                           streams["fp", "cpu"]))
        check(streams["fp", "cuda"] == streams["fp", "cpu"],
              f"card and CPU token streams identical ({agree}/6 requests)")
        free_agree = agreement(streams["int8", "cuda"],
                               streams["int8", "cpu"])
        free_diffs = [(i, j) for i, (a, b) in enumerate(
            zip(streams["int8", "cuda"], streams["int8", "cpu"]))
            for j, (s, t) in enumerate(zip(a, b)) if s != t]
        log(f"   int8 free-running streams agree at {free_agree:.3f} of "
            f"positions; (request, position) that differ: {free_diffs} — "
            f"after a first difference the two histories differ, so the "
            f"rest of that request differs too")
        forced = lockstep_int8(torch, np, gpt_mod, ServingEngine, Request)
        log(f"   int8 lockstep: {json.dumps(forced)}")
        check(forced["agreement"] >= 0.95,
              f"int8 card and CPU choose the same token at "
              f"{forced['agreement']:.3f} of positions given the same "
              f"history (>= 0.95)")
        check(streams["spec", "cuda"] == streams["fp", "cuda"],
              "speculative streams on the card equal plain decoding's")
        report["card_vs_cpu"] = dict(
            fp_identical_requests=agree, int8_free_agreement=free_agree,
            int8_free_diffs=free_diffs, int8_lockstep=forced)

    with phase("profile: device time by kernel over decode ticks"):
        prof_report = {}
        for label, kw, kernel in (("fp", {}, B2),
                                  ("int8", dict(kv_dtype="int8"), B3)):
            engine = build_engine(ServingEngine, gpt_mod, LAYERS, "bfloat16",
                                  "cuda", **kw)
            for r in requests_for(np, Request, n=16, new_tokens=8, seed=3):
                engine.submit(r)
            engine.step()  # admission + prefill waves + a first decode tick
            ticks0 = engine.stats.decode_ticks
            launches0 = kernels[kernel]["fn"].launches
            log(f"   {label} pages:")
            out = profile_ticks(torch, engine)
            ticks = engine.stats.decode_ticks - ticks0
            per_tick = (kernels[kernel]["fn"].launches - launches0) / max(
                ticks, 1)
            check(per_tick == LAYERS, f"{per_tick} {kernel} launches per "
                  f"decode tick (one per layer)")
            out.update(decode_ticks=ticks, launches_per_decode_tick=per_tick)
            span_ms, device_ms = write_cost_per_tick(torch, np, engine)
            out.update(write_span_ms_per_tick=span_ms,
                       write_device_ms_per_tick=device_ms,
                       write_span_share_of_tick=span_ms / 1e3
                       / (out["window_s"] / ticks))
            if out["device_busy_s"] > 0:
                out["write_device_share_of_tick"] = (
                    device_ms / 1e3 / (out["device_busy_s"] / ticks))
            log(f"   profile {label}: "
                f"{json.dumps({k: v for k, v in out.items() if k != 'top'})}")
            prof_report[label] = out
            del engine
        report["profile"] = prof_report

    def entry(name, kernel_launches):
        row = next(r for r in attn if r["kernel"] == name
                   and r["case"] == "decode" and r["dtype"] == "bfloat16")
        k = kernels[name]
        return dict(name=name, route=k["route"], source=k["source"],
                    replaces=k["replaces"], launches=kernel_launches,
                    max_abs_err=row["max_abs_err"], ms=row["ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"], library_ms=row["library_ms"])

    # each kernel's launches from the path that is its own: B2 from the
    # fp main path, B3 from the int8 path
    line = {"kernels": [entry(B2, main_launches[B2]),
                        entry(B3, int8_launches[B3])]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
