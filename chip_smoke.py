#!/usr/bin/env python
"""Chip smoke for the PyTorch/CUDA port (``skycomputing_tpu_torch``).

Runs on one NVIDIA GPU (built for an H100, ``sm_90a``) and fails without
one.  Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA source under ``skycomputing_tpu_torch/ops/csrc``
   (one ``nvcc`` per source, started together);
3. each kernel against its plain PyTorch version on the card, in
   bfloat16 and float32, at GPT-2 small's attention shapes (decode and
   prefill waves), with kernel / plain / library times and the bound;
4. the main path: GPT-2 small (full width, 12 layers, random weights
   from a seed) served by the paged ``ServingEngine`` — 16 requests,
   four sharing a 64-token prefix — with every kernel's launch count
   read from that run alone;
5. card against CPU: the same port at full width, depth 2, float32,
   greedy, must give identical token streams on ``cuda`` and ``cpu``;
6. a profiler breakdown of a few decode ticks (device time by kernel).

The line before last is ``{"kernels": [...]}``, one entry per kernel;
the last line is ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Usage::

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
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


def attention_case(torch, np, name, R, Lq, dtype, seed):
    """GPT-2 small heads (H=12, D=64), page_size 16, a 512-page pool."""
    H, D, PS, P, W = 12, 64, 16, 512, 32
    rng = np.random.default_rng(seed)
    pages = rng.permutation(P - 1)  # page P-1 is only ever a clamp target
    table = np.full((R, W), P, np.int32)
    index = np.zeros(R, np.int32)
    used = 0
    for r in range(R):
        if name == "decode":
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
    k = torch.from_numpy(rng.standard_normal((P, PS, H, D), np.float32))
    v = torch.from_numpy(rng.standard_normal((P, PS, H, D), np.float32))
    return dict(q=q.to("cuda", dt), k=k.to("cuda", dt), v=v.to("cuda", dt),
                table=torch.from_numpy(table).cuda(),
                index=torch.from_numpy(index).cuda(),
                table_np=table, index_np=index, P=P, PS=PS, H=H, D=D)


def attention_bound(np, case, dtype):
    """The least time for this call: live K/V bytes (each position a
    row can see, read once) + q + out, against visible-pair flops."""
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
    nbytes = (len(live) * 2 * H * D + 2 * R * Lq * H * D) * itemsize
    nbytes += table.nbytes + index.nbytes
    flops = 4.0 * D * H * pairs
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def library_call(torch, case):
    """``scaled_dot_product_attention`` over the gathered views with the
    causal/staleness mask: the yardstick (the port never calls it).
    Returns a zero-argument callable; the gather is done once, outside
    the timed call."""
    from skycomputing_tpu_torch.serving.kv_cache import (
        decode_visibility,
        gather_kv_pages,
    )
    import torch.nn.functional as F

    q = case["q"]
    k_virt, v_virt = gather_kv_pages(case["k"], case["v"], case["table"])
    mask = decode_visibility(case["index"], q.shape[1], k_virt.shape[1])
    qh = q.transpose(1, 2)
    kh = k_virt.transpose(1, 2).contiguous()
    vh = v_virt.transpose(1, 2).contiguous()
    m = mask[:, None]
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=m)


def kernel_checks(torch, np):
    from skycomputing_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_reference,
    )

    tol = {"float32": 1e-4, "bfloat16": 2e-2}
    results = []
    for name, R, Lq in (("decode", 16, 1), ("prefill", 4, 128)):
        for dtype in ("bfloat16", "float32"):
            case = attention_case(torch, np, name, R, Lq, dtype,
                                  seed=len(results))
            args = (case["q"], case["k"], case["v"], case["table"],
                    case["index"])
            out = paged_attention(*args)
            ref = paged_attention_reference(*args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            finite = bool(torch.isfinite(out).all())
            ms = time_ms(torch, lambda: paged_attention(*args))
            plain_ms = time_ms(torch,
                               lambda: paged_attention_reference(*args))
            library_ms = time_ms(torch, library_call(torch, case))
            bound_ms, bound_by = attention_bound(np, case, dtype)
            row = dict(case=name, R=R, Lq=Lq, dtype=dtype,
                       max_abs_err=err, tol=tol[dtype], ms=ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
            log(f"   {json.dumps(row)}")
            check(finite and err <= tol[dtype],
                  f"paged_attention {name} {dtype}: max |err| {err:.3g} "
                  f"<= {tol[dtype]}")
            results.append(row)
    return results


# --------------------------------------------------------------------------
# phases 4-5: the serving engine
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


def build_engine(ServingEngine, cfg_mod, depth, dtype, device, seed=SEED):
    cfg = cfg_mod.GptConfig(dropout_prob=0.0, dtype=dtype)
    layer_cfgs = cfg_mod.gpt_layer_configs(cfg, num_blocks=depth)
    params = cfg_mod.random_state_dicts(layer_cfgs, seed)
    return ServingEngine(
        layer_cfgs, params, page_size=16, buckets=(32, 64, 128, 256),
        max_len=512, max_concurrency=16, prefill_batch=4, num_pages=512,
        device=device,
    )


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
    # every kernel wrapper of the port, by name
    kernels = {
        "paged_attention": dict(
            fn=paged_attention, route="cuda",
            source="skycomputing_tpu_torch/ops/csrc/paged_attention.cu",
            replaces="skycomputing_tpu/ops/paged_attention.py:73"),
    }

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
        report["paged_attention"] = attn

    with phase("main path: GPT-2 small paged serving"):
        cfg = gpt_mod.GptConfig()
        check(cfg.hidden_size == 768 and cfg.num_hidden_layers == 12
              and cfg.vocab_size == 50257 and cfg.dtype == "bfloat16",
              "GPT-2 small defaults")
        engine = build_engine(ServingEngine, gpt_mod, 12, "bfloat16", "cuda")
        # warm-up on the same engine's code path (cuBLAS handles,
        # allocator pools); not counted
        engine.run(requests_for(np, Request, n=4, new_tokens=4, seed=99))
        engine = build_engine(ServingEngine, gpt_mod, 12, "bfloat16", "cuda")
        reqs = requests_for(np, Request)
        for k in kernels.values():
            k["fn"].launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # 12 requests arrive, one tick later the last 4 (two of them
        # prefix sharers, so their radix hits find the first wave's
        # registered prompts)
        for r in reqs[:12]:
            engine.submit(r)
        engine.step()
        engine.run(reqs[12:])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: k["fn"].launches for name, k in kernels.items()}
        snap = engine.stats.snapshot()
        steps = snap["prefill_waves"] + snap["decode_ticks"]
        log(f"   stats: {json.dumps(snap)}")
        check(snap["finished"] == 16 and all(
            r.status == "finished" for r in reqs),
              f"{snap['finished']}/16 requests finished")
        check(all(len(r.tokens) == 32 for r in reqs), "32 new tokens each")
        check(all(int(t) < 50257 for r in reqs for t in r.tokens),
              "tokens inside the vocabulary")
        check(launches["paged_attention"] == 12 * steps,
              f"paged_attention launches {launches['paged_attention']} == "
              f"12 x ({snap['prefill_waves']} prefill waves + "
              f"{snap['decode_ticks']} decode ticks)")
        check(snap["prefix_hits"] >= 2 and snap["cow_copies"] >= 1,
              f"radix hits {snap['prefix_hits']}, COW clones "
              f"{snap['cow_copies']}")
        e2e = dict(
            wall_s=wall, generated_tokens=snap["generated_tokens"],
            tokens_per_s=snap["generated_tokens"] / wall,
            engine_tokens_per_s=snap["tokens_per_s"],
            ttft_p50_s=snap["ttft_p50_s"], ttft_p95_s=snap["ttft_p95_s"],
            tpot_p50_s=snap["tpot_p50_s"], tpot_p95_s=snap["tpot_p95_s"],
            prefill_waves=snap["prefill_waves"],
            decode_ticks=snap["decode_ticks"], launches=launches,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        )
        log(f"   e2e: {json.dumps(e2e)}")
        report["e2e"] = e2e

    with phase("card against CPU: depth 2, float32, greedy"):
        streams = {}
        for device in ("cuda", "cpu"):
            eng = build_engine(ServingEngine, gpt_mod, 2, "float32", device)
            reqs = requests_for(np, Request, n=6, new_tokens=12, seed=7)
            eng.run(reqs)
            streams[device] = [list(r.tokens) for r in reqs]
        agree = sum(a == b for a, b in zip(streams["cuda"], streams["cpu"]))
        check(streams["cuda"] == streams["cpu"],
              f"card and CPU token streams identical ({agree}/6 requests)")

    with phase("profile: device time by kernel over decode ticks"):
        from torch.profiler import ProfilerActivity, profile

        engine = build_engine(ServingEngine, gpt_mod, 12, "bfloat16", "cuda")
        for r in requests_for(np, Request, n=16, new_tokens=8, seed=3):
            engine.submit(r)
        engine.step()  # admission + prefill waves + the first decode tick
        ticks0 = engine.stats.decode_ticks
        launches0 = paged_attention.launches
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(4):
                engine.step()
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
        ticks = engine.stats.decode_ticks - ticks0
        per_tick = (paged_attention.launches - launches0) / max(ticks, 1)
        check(per_tick == 12, f"{per_tick} paged_attention launches per "
              f"decode tick (one per layer)")
        rows = []
        for evt in prof.key_averages():
            if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
                continue  # kernels only: host ops would count them twice
            dev_us = getattr(evt, "self_device_time_total",
                             getattr(evt, "self_cuda_time_total", 0))
            if dev_us > 0:
                rows.append((dev_us, evt.key, evt.count))
        rows.sort(reverse=True)
        total_us = sum(r[0] for r in rows)
        prof_report = dict(decode_ticks=ticks, window_s=window,
                           launches_per_decode_tick=per_tick,
                           device_busy_s=total_us / 1e6)
        if total_us > 0:
            prof_report["idle_share"] = max(0.0, 1 - total_us / 1e6 / window)
            prof_report["top"] = [
                dict(kernel=k[:80], device_ms=us / 1e3, count=n,
                     share=us / total_us) for us, k, n in rows[:12]]
            for row in prof_report["top"]:
                log(f"   {row['share']:6.1%} {row['device_ms']:9.3f} ms "
                    f"x{row['count']:<5d} {row['kernel']}")
        else:
            log("   the profiler recorded no device time: not measured")
        log(f"   profile: {json.dumps({k: v for k, v in prof_report.items() if k != 'top'})}")
        report["profile"] = prof_report

    decode_bf16 = next(r for r in attn
                       if r["case"] == "decode" and r["dtype"] == "bfloat16")
    line = {"kernels": [
        dict(name="paged_attention", route=kernels["paged_attention"]["route"],
             source=kernels["paged_attention"]["source"],
             replaces=kernels["paged_attention"]["replaces"],
             launches=launches["paged_attention"],
             max_abs_err=decode_bf16["max_abs_err"], ms=decode_bf16["ms"],
             plain_ms=decode_bf16["plain_ms"],
             bound_ms=decode_bf16["bound_ms"],
             bound_by=decode_bf16["bound_by"],
             library_ms=decode_bf16["library_ms"]),
    ]}
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
