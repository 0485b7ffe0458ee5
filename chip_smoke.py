#!/usr/bin/env python
"""Chip smoke for the PyTorch/CUDA port (``skycomputing_tpu_torch``).

Runs on one NVIDIA GPU (built for an H100, ``sm_90a``) and fails without
one.  Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA source under ``skycomputing_tpu_torch/ops/csrc``
   (one ``nvcc`` per source, started together), one ``ptxas`` line per
   kernel instantiation (registers, spill bytes, static shared memory);
   the tensor-core and decode bodies must not spill;
3. each kernel against its plain PyTorch version on the card, in
   bfloat16 and float32, with kernel / plain / library times and the
   bound: paged attention at GPT-2 small's shapes (decode waves,
   speculative-verify waves, prefill waves at R=4 and Lq 32, 128 and 256,
   a chunked-prefill wave at Lq=64 with every row past index 0) over
   fp pages (kernel B2) and over int8 pages with per-page-per-head
   scales (kernel B3); flash attention (kernel B1) at BERT-large's
   microbatch (B=8, L=128, H=16, D=64, a padded tail of 32 keys), at
   L=512 and at L=100; then, checked but not timed, each kernel body's
   edges (B1 at L=7, 64 and 65, head_dim 32, 40 and 128, B=1, every key
   masked; B2 and B3 with a row at index 0, a row filling its whole
   table and an all-sentinel pad row, head_dim 64 and 128, Lq 1, 5, 16,
   17, 63, 64, 65 and 256).  Every row names the body that served it
   and what ``ptxas -v`` reported for that body (registers, spills,
   shared memory) beside its dynamic shared memory;
4. the serving path: GPT-2 small (full width, 12 layers, random weights
   from a seed) served by the paged ``ServingEngine`` — 16 requests,
   four sharing a 64-token prefix — with every kernel's launch count
   read from that run alone, by body too: every prefill wave on the
   tensor-core body, every decode tick on the decode body (likewise
   in phases 5-7);
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
9. a profiler breakdown of one prefill wave and of a few decode ticks,
   fp and int8 (device time by kernel, the card's idle share), and what
   the KV write (the int8 quantize-on-write, the fp scatter) costs per
   tick;
10. bf16 flash on against off: BERT-large's width at depth 2, two
    steps in bfloat16 with ``use_flash_attention`` on (B1's
    tensor-core body inside the model) and off (the einsum path) from
    the same weights: losses within 2e-2 relative;
11. the training path: BERT-large (24 encoder layers as 75 units, seq
    128, batch 32, bf16 compute, flash attention, random weights from a
    seed) over 4 workers on the card, even allocation, GPipe with 4
    microbatches, SGD 1e-3, ``Runner.train`` for 5 steps: finite
    losses, step time, tokens/s, MFU, peak memory, and B1 launched
    exactly 2 x 24 x 4 = 192 times per step (forward and
    rematerialized forward), read from that run alone;
12. trainer card against CPU: the same pipeline at depth 2 in float32,
    two steps on ``cuda`` and on ``cpu`` from the same weights and
    batch: losses within 1e-4 relative, parameters within 1e-5;
13. a profiler breakdown of one train step (device time by kernel, the
    card's idle share, B1's share, the weight casts' launches);
14. the profilers: the static (FLOPs on the ``meta`` device) and the
    timed (forward + backward seconds on the card) ``ModelBenchmarker``
    over BERT-large's 75 units at batch 32, seq 128 — six distinct
    units, none at 0, equal memory estimates, B1 launched while timing —
    and the ``DeviceBenchmarker`` over four workers on the card
    (``MatmulStack`` 1024 x 4 on (256, 1024): timed once, free memory
    from ``mem_get_info``);
15. the launcher's path: ``launch.run`` on
    ``skycomputing_tpu_torch/configs/bert_pipeline.py`` — BERT-large at
    24 layers, seq 128, batch 32, flash on, on the config's GLUE
    dataset (its seeded synthetic MNLI corpus: lengths 8-128, padded
    tails), 4 workers on the card with
    the stimulator, ``optimal`` allocation from the static profile, 1F1B
    with 4 microbatches, 5 steps, with the stop, timer and checkpoint
    hooks: the runner's pre-flight verified the plan once before the
    first step (an ``ok`` report over coverage, shapes, memory and
    donation; its seconds printed), the partition is the solver's,
    contiguous and not the even split, every loss finite, B1 launched
    exactly 192 times per step;
    the checkpoint restores its parameters under ``even_allocate``
    (equal) and its optimizer state is refused there; step time,
    tokens/s, MFU and peak memory beside the GPipe phase's;
16. the headline pass as ``bench.py`` runs it at this scale
    (``dynamics/headline.py:headline_pass``): four workers with the
    paper's slowdowns (3, 5, 3, 6), even allocation and
    ``measure_stage_times``, ``calibrate_costs_by_group`` from the even
    pass (one scale each for the encoder stack, the embeddings and the
    two end units), ``optimal_allocate`` and ``measure_stage_times``
    again; each
    raw stage time times its worker's slowdown gives the emulated step
    time (``schedule_step_time``) at 4 and 16 microbatches; the even
    allocation is measured in the order even, optimal, optimal, even
    and each side's step is the mean of its two; the optimal step must
    be below the even one at both;
17. the GLUE path: a vocabulary and MNLI ``train.tsv`` /
    ``dev_matched.tsv`` written from a seed under ``build/``, then
    ``launch.run`` on the port's config pointed at them
    (``SKYTPU_GLUE_DIR``, ``SKYTPU_VOCAB_FILE``) with ``EvalHook``,
    ``MetricsHook`` and ``NanGuardHook``: 5 steps, one evaluation at the
    epoch's end, a metrics JSONL of a ``run_start`` header and one line
    per step, the pre-flight checked as in phase 15; then ``Runner.evaluate(dev, task="mnli")`` over the 100
    dev rows (3 batches of 32 and one of 4): a finite loss, accuracy in
    [0, 1], every row counted, and B1 launched exactly 24 times per
    batch (an eval-mode forward, no rematerialization), read from that
    window alone; a profile of one eval batch (the card's idle share,
    B1's share); and, at BERT-large's width, depth 2, float32, the same
    evaluation on the card and on the CPU from the same weights: losses
    within 1e-4 relative, equal predictions;
18. the bench: ``python -m skycomputing_tpu_torch.bench`` as a
    subprocess at its defaults (64 workers with the paper's slowdowns,
    BERT-large at 53 encoder layers as 215 units at ffn/2, M=256) under
    a 300 s deadline: exactly one JSON line on stdout, a complete run on
    the card
    (``partial`` null, a finite value) whose even and optimal
    partitions each cover every unit; its fields are printed, and how
    many pre-flight reports (one per allocation built) it wrote to
    stderr, the slowest of them;
19. pre-flight, tracing and self-heal: the trainer's BERT-large (75
    units, flash on, dropouts 0) evenly over 4 workers by an
    ``Allocator`` over the static profile, GPipe M=4.  A plan tampered
    after the build (worker 0's last unit dropped) is refused by
    ``Runner.train`` with ``PlanError`` (coverage) at iteration 0 and
    no B1 launch; then a fresh ``Runner`` trains 20 steps with
    ``TraceHook``, ``FaultInjectionHook`` (worker 0 6x slower from
    iteration 4) and ``SelfHealHook`` on real clocks: pre-flight runs
    before step 1 and again after the heal (both ``ok``), one heal whose
    largest divergence is worker 0's, worker 0 sheds units and the cover
    stays whole, every loss finite, B1 launched 192 times in every step
    on both sides of the heal, the post-heal steps faster than the
    straggler era's; the trace is strict JSON, holds 4 stage lanes
    before the heal, M x stages ``fwd`` and ``bwd`` and one ``update``
    per stage in every ``iter`` span, a ``self_heal`` arc closed as
    ``healed`` and one ``host_dispatch`` span per step.  Printed: step
    medians (baseline, straggler, after the heal), the heal's cost
    (measure, solve, rebuild), the partitions, the pre-flight seconds,
    bubble fraction and dispatch share, peak memory, and the step with
    tracing on against 5 untraced steps.  The trace is written to
    ``chiprun_out/selfheal_trace.json``;
20. serving allocation and multi-stage serving: GPT-2 small (26 units,
    bf16) profiled for decode by ``DecodeModelBenchmarker`` at the
    serving phases' operating point (16 rows, 512-token span, 512 pages
    of 16; fp and int8) and partitioned by ``Allocator.serving_allocate``
    over four workers with the launcher phase's stimulated speeds and
    budgets of 1,000 MB over the stimulator's memory draws (they bind:
    the partition is printed with each stage's charged MB against its
    budget, and the fp and int8 pages must give different partitions);
    ``ServingEngine(worker_manager=wm)`` serves the 16-request workload
    as those stages on the card (the pre-flight passing first), with
    streams, scheduling and each body's launches equal to phases 4 and
    5; speculation (``spec_k=4, draft_blocks=2``) over ``partition=[7, 7,
    6, 6]`` (the draft inside stage 0) equal to phase 6's fp run; a
    ``reconfigure`` to 384 pages at tick 3 (every running request
    re-seated by recomputation, every stage's slabs rebuilt; the card's
    memory before, at its peak during and after) and to buckets up to
    512 at tick 10 (no eviction), at four stages and at one, on equal
    streams and launches; and a worker manager whose stage with the
    most pages gets its units' MB plus half its pages is refused by the
    pre-flight with ``torch.cuda.memory_allocated`` unchanged.  Printed:
    tokens/s, TTFT and TPOT p50/p95 and peak memory, stages against one
    in turns (4, 1, 1, 4 stages, fp and int8; a process's later phases
    run slower than its first, so phases 4-5 are no baseline for these).

The line before last is ``{"kernels": [...]}``, one entry per kernel
(B2's and B3's launches from their serving phases and phase 20);
the last line is ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Usage::

    python3 chip_smoke.py
"""

from __future__ import annotations

import gc
import json
import re
import shutil
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
B1, B2, B3 = "flash_attention", "paged_attention", "paged_attention_int8"


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


# a spinning kernel of ~2 ms at the H100's clock, queued ahead of a timed
# call so that the card is still busy while the host enqueues it
SPIN_CYCLES = 4_000_000


def time_ms(torch, fn, iters: int = 30, warmup: int = 3,
            host_ahead: bool = True) -> float:
    """Median time of ``fn`` on the card's clock in ms, each call timed
    alone with CUDA events after a 64 MiB write evicts the 50 MB L2 (a
    layer's pages come from device memory, not from the previous layer's
    L2).

    ``host_ahead`` (the default) queues the spin kernel before the start
    event, so the host has enqueued the whole call before the card
    reaches it: the span is the call's device time, not the host's time
    to launch it (a short kernel behind a Python wrapper would otherwise
    time the wrapper).  ``host_ahead=False`` times the span as a caller
    meets it, host launch time included."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        if host_ahead:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def host_ms(torch, fn, iters: int = 30) -> float:
    """Median host time to issue ``fn`` in ms (the card kept busy by the
    spin kernel, so no call blocks); where it exceeds the device time,
    a caller issuing one call at a time waits on the host."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    times.sort()
    return times[len(times) // 2]


def spin_ms(torch) -> float:
    """The spin kernel's own time: ``host_ahead`` timing holds while the
    host issues a call in less."""
    return time_ms(torch, lambda: torch.cuda._sleep(SPIN_CYCLES), iters=5,
                   warmup=1, host_ahead=False)


# --------------------------------------------------------------------------
# kernel bodies and what ptxas said about them
# --------------------------------------------------------------------------

# template arguments as the compiler mangles them
_MANGLED_ARGS = (("13__nv_bfloat16", "bf16"), ("f", "f32"), ("a", "int8"))


def kernel_label(mangled: str) -> str:
    """``paged_attention_kernel_decode<bf16, int8, 1>`` for a mangled
    kernel name of the port (the mangled name where it is not one)."""
    found = re.search(r"\d+((?:flash|paged)_attention_kernel\w*?)I(.+?)EEv",
                      mangled)
    if not found:
        return mangled
    name, args = found.groups()
    out, i = [], 0
    while i < len(args):
        if args.startswith("S1_", i):  # the first type argument again
            out.append(out[0])
            i += 3
        elif args[i] == "L":  # an integer: Li<digits>E
            end = args.index("E", i)
            out.append(args[i + 2:end])
            i = end + 1
        else:
            for code, label in _MANGLED_ARGS:
                if args.startswith(code, i):
                    out.append(label)
                    i += len(code)
                    break
            else:
                return mangled
    return f"{name}<{', '.join(out)}>"


def ptxas_by_label(_build):
    """Every kernel instantiation's ``ptxas -v`` figures, by label."""
    return {kernel_label(fn): info
            for stem in sorted(p.stem for p in _build.CSRC.glob("*.cu"))
            for fn, info in _build.ptxas_report(stem).items()}


_SHORT = {"float32": "f32", "bfloat16": "bf16", "int8": "int8"}


def body_fields(ptxas, body, label, smem_bytes):
    """A kernel row's body: its name, the instantiation that ran, what
    ptxas reported for it and its dynamic shared memory per block."""
    info = ptxas.get(label, {})
    return dict(body=body, kernel_function=label,
                registers=info.get("registers"),
                spill_store_bytes=info.get("spill_store_bytes"),
                spill_load_bytes=info.get("spill_load_bytes"),
                static_smem_bytes=info.get("static_smem_bytes", 0),
                dynamic_smem_bytes=smem_bytes)


def paged_body(ptxas, q, page_dtype, table, page_size=16):
    """Which body of B2/B3 serves ``q`` over pages of ``page_dtype``."""
    from skycomputing_tpu_torch.ops.paged_attention import (
        kernel_plan,
        kernel_smem_bytes,
    )

    R, Lq, H, D = q.shape
    body = kernel_plan(q.dtype, page_dtype, Lq, D, page_size)
    kv = _SHORT[str(page_dtype).replace("torch.", "")]
    t = _SHORT[str(q.dtype).replace("torch.", "")]
    if body == "decode":
        max_q = 1 if Lq == 1 else (8 if Lq <= 8 else 16)
        label = f"paged_attention_kernel_decode<{t}, {kv}, {max_q}>"
    elif body == "tensor_core":
        label = f"paged_attention_kernel_mma<{kv}, {D}>"
    else:
        label = f"paged_attention_kernel<{t}, {kv}>"
    return body_fields(ptxas, body, label, kernel_smem_bytes(
        body, page_dtype, Lq, D, page_size, table.shape[1]))


def flash_body(torch, ptxas, q):
    """Which body of B1 serves ``q``."""
    from skycomputing_tpu_torch.ops.flash_attention import (
        kernel_plan,
        kernel_smem_bytes,
    )

    B, L, H, D = q.shape
    plan = kernel_plan(q.dtype, B, L, H, D, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    if plan["body"] == "tensor_core":
        label = f"flash_attention_kernel_mma<{D}>"
    else:
        t = _SHORT[str(q.dtype).replace("torch.", "")]
        label = f"flash_attention_kernel<{t}, {4 if D <= 64 else 8}>"
    out = body_fields(ptxas, plan["body"], label, kernel_smem_bytes(plan, D))
    out["warps"] = plan["warps"]
    return out


# --------------------------------------------------------------------------
# phase 3: paged attention against its plain version
# --------------------------------------------------------------------------


# (case, R, Lq): decode and speculative-verify waves (the decode body),
# prefill waves at buckets 128, 256 and 32 and a chunked-prefill wave of
# 64 (bf16: the tensor-core body; float32: the query-tile body)
PAGED_CASES = (("decode", 16, 1), ("prefill", 4, 128), ("verify", 16, 5),
               ("prefill_256", 4, 256), ("chunk", 4, 64),
               ("prefill_32", 4, 32))


def attention_case(torch, np, name, R, Lq, dtype, seed, int8=False):
    """GPT-2 small heads (H=12, D=64), page_size 16, a 512-page pool.
    Decode and verify waves: 12 live rows at positions 1..300 (every
    fourth row inactive); prefill: 2 live rows (one appending after a
    64-token prefix) and 2 pad rows; chunk: 4 live rows, each appending
    a chunk after 64, 128, 192 or 256 positions.  ``int8``: pages are
    N(0, 32) rounded and clipped to int8, scales U(0.02, 0.04) per
    (page, head), so the dequantized pages are of unit size like the fp
    ones."""
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
        elif name == "chunk":
            index[r] = 64 * (r + 1)
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


def kernel_checks(torch, np, ptxas):
    from skycomputing_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_reference,
    )

    tol = {"float32": 1e-4, "bfloat16": 2e-2}
    results = []
    for ki, (kernel, int8) in enumerate((("paged_attention", False),
                                         ("paged_attention_int8", True))):
        for ci, (name, R, Lq) in enumerate(PAGED_CASES):
            for di, dtype in enumerate(("bfloat16", "float32")):
                # the first three cases keep their earlier seeds
                seed = 6 * ki + 2 * ci + di + (0 if ci < 3 else 100)
                case = attention_case(torch, np, name, R, Lq, dtype,
                                      seed=seed, int8=int8)
                args, kw = kernel_args(case)
                out = paged_attention(*args, **kw)
                ref = paged_attention_reference(*args, **kw)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                finite = bool(torch.isfinite(out).all())
                ms = time_ms(torch, lambda: paged_attention(*args, **kw))
                issue_ms = host_ms(torch, lambda: paged_attention(*args,
                                                                  **kw))
                plain_ms = time_ms(
                    torch, lambda: paged_attention_reference(*args, **kw))
                library_ms = time_ms(torch, library_call(torch, case))
                bound_ms, bound_by = attention_bound(np, case, dtype)
                row = dict(kernel=kernel, case=name, R=R, Lq=Lq,
                           dtype=dtype, max_abs_err=err, tol=tol[dtype],
                           ms=ms, host_ms=issue_ms, plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=bound_ms,
                           bound_by=bound_by,
                           **paged_body(ptxas, case["q"], case["k"].dtype,
                                        case["table"]))
                log(f"   {json.dumps(row)}")
                check(finite and err <= tol[dtype],
                      f"{kernel} {name} {dtype}: max |err| {err:.3g} "
                      f"<= {tol[dtype]}")
                results.append(row)
    return results


def paged_edge_case(torch, np, D, Lq, dtype, int8, seed):
    """page_size 16, H=12 at head_dim ``D``, four rows: one at index 0
    (its first query sees one position), one whose last query fills its
    whole table, one at index 20 (mid-page) and one inactive (all
    sentinels).  Up to Lq=17 a 12-page pool and tables of 4 pages; past
    that tables of W = (Lq + 63) // 16 + 1 pages from a pool of 3 W + 2.
    ``int8`` pages as in :func:`attention_case`."""
    H, PS = 12, 16
    if Lq <= 17:
        P, W = 12, 4
        rows = [([3, 4], 0), ([5, 1, 7, 9], W * PS - Lq), ([2, 0, 11], 20),
                ([], 0)]
    else:
        W = (Lq + 63) // PS + 1
        P = 3 * W + 2
        pool = iter(np.random.default_rng(Lq).permutation(P - 1).tolist())

        def take(n):
            return [next(pool) for _ in range(n)]

        rows = [(take((Lq + PS - 1) // PS), 0), (take(W), W * PS - Lq),
                (take((20 + Lq + PS - 1) // PS), 20), ([], 0)]
    rng = np.random.default_rng(seed)
    table = np.full((len(rows), W), P, np.int32)
    index = np.zeros(len(rows), np.int32)
    for r, (pages, idx) in enumerate(rows):
        table[r, :len(pages)] = pages
        index[r] = idx
    dt = getattr(torch, dtype)
    q = torch.from_numpy(rng.standard_normal(
        (len(rows), Lq, H, D), np.float32)).to("cuda", dt)
    args = [q]
    for _ in ("k", "v"):
        if int8:
            args.append(torch.from_numpy(np.clip(np.round(
                32 * rng.standard_normal((P, PS, H, D))), -127, 127).astype(
                    np.int8)).cuda())
        else:
            args.append(torch.from_numpy(rng.standard_normal(
                (P, PS, H, D), np.float32)).to("cuda", dt))
    args += [torch.from_numpy(table).cuda(), torch.from_numpy(index).cuda()]
    kw = {}
    if int8:
        kw = {name: torch.from_numpy(rng.uniform(0.02, 0.04, (P, H)).astype(
            np.float32)).cuda() for name in ("k_scale", "v_scale")}
    return args, kw


def paged_edge_checks(torch, np, ptxas):
    """B2 and B3 at each body's edges, in both dtypes, against the plain
    version (checked, not timed): Lq 1, 5 and 16 (the decode body), 17,
    63, 64, 65 and 256 (bf16: the tensor-core body, one query past one
    warp, around a 64-query block, the largest bucket; float32: the
    query-tile body), head_dim 64 and 128."""
    from skycomputing_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_reference,
    )

    tol = {"float32": 1e-4, "bfloat16": 2e-2}
    results = []
    for kernel, int8 in (("paged_attention", False),
                         ("paged_attention_int8", True)):
        for D in (64, 128):
            for Lq in (1, 5, 16, 17, 63, 64, 65, 256):
                for dtype in ("bfloat16", "float32"):
                    args, kw = paged_edge_case(torch, np, D, Lq, dtype, int8,
                                               seed=500 + len(results))
                    out = paged_attention(*args, **kw)
                    ref = paged_attention_reference(*args, **kw)
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs().max().item()
                    finite = bool(torch.isfinite(out).all())
                    row = dict(kernel=kernel, case=f"edge_d{D}_lq{Lq}", D=D,
                               Lq=Lq, dtype=dtype, max_abs_err=err,
                               tol=tol[dtype],
                               **paged_body(ptxas, args[0], args[1].dtype,
                                            args[3]))
                    log(f"   {json.dumps(row)}")
                    check(finite and err <= tol[dtype],
                          f"{kernel} D={D} Lq={Lq} {dtype} "
                          f"({row['body']}): max |err| {err:.3g} "
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
          quiet_after=None, reconfigure=(), **kw):
    """One full-width (12-layer, bf16) run of the 16-request workload:
    12 requests arrive, one tick later the last 4 (two of them prefix
    sharers, so their radix hits find the first wave's registered
    prompts).  ``preempt`` = (tick, request position, mode) preempts
    that request before that tick's step; ``reconfigure`` = [(tick,
    knobs), ...] calls ``engine.reconfigure(**knobs)`` before that
    tick's step, recording the card's memory before it, its peak during
    it and after it.  A 4-request warm-up on another engine of the same
    knobs runs first (cuBLAS handles, allocator pools) and is not
    counted.  Every kernel's launch count is set to 0 just before the
    run and read just after it."""
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
        for body in getattr(k["fn"], "body_launches", {}):
            k["fn"].body_launches[body] = 0
    changes = dict(reconfigure)
    reconfigured = []
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
        if tick in changes:
            reconfigured.append(reconfigure_on_card(torch, engine, tick,
                                                    changes[tick]))
        engine.step()
        tick += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k["fn"].launches for name, k in kernels.items()}
    bodies = {name: dict(k["fn"].body_launches) for name, k in kernels.items()
              if hasattr(k["fn"], "body_launches")}
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
        launches=launches, body_launches=bodies,
        peak_mem_gb=max([torch.cuda.max_memory_allocated() / 1e9]
                        + [max(r["peak_gb"], r["run_peak_gb"])
                           for r in reconfigured]),
        stages=[len(st.modules) for st in engine.stages],
    )
    if reconfigured:
        e2e["reconfigured"] = reconfigured
    log(f"   e2e: {json.dumps(e2e)}")
    return engine, reqs, snap, launches, e2e


def reconfigure_on_card(torch, engine, tick, knobs):
    """``engine.reconfigure(**knobs)``, with the card's allocated memory
    before, the peak during (a geometry change builds every stage's new
    slabs beside the old ones) and after, in GB, the run's peak until
    then, and the seconds it took (the work queued before it
    included)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    run_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine.reconfigure(**knobs)
    torch.cuda.synchronize()
    row = dict(tick=tick, knobs={k: list(v) if isinstance(v, tuple) else v
                                 for k, v in knobs.items()},
               seconds=time.perf_counter() - t0,
               before_gb=before / 1e9,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               after_gb=torch.cuda.memory_allocated() / 1e9,
               run_peak_gb=run_peak / 1e9,
               preemptions=engine.stats.preemptions)
    torch.cuda.reset_peak_memory_stats()
    log(f"   reconfigure: {json.dumps(row)}")
    return row


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
    for card_pair, host_pair in zip(engines["cuda"].stages[0].slabs,
                                    engines["cpu"].stages[0].slabs):
        for card, host in zip(card_pair, host_pair):
            d = (card.values.cpu().int() - host.values.int()).abs()
            entries += int((d > 0).sum())
            steps = max(steps, int(d.max()))
            rel = ((card.scale.cpu() - host.scale).abs()
                   / host.scale.abs().clamp_min(1e-30))
            scale_rel = max(scale_rel, float(rel.max()))
    total_entries = sum(2 * k.values.numel()
                        for k, _ in engines["cpu"].stages[0].slabs)
    return dict(agreement=same / total, positions=total, diffs=diffs,
                int8_entries_differing=entries, pool_entries=total_entries,
                max_int8_steps_apart=steps, max_scale_rel_diff=scale_rel)


def check_launches(launches, expect, what):
    """Every kernel's launches equal ``expect`` (0 where it names none)."""
    expect = {name: expect.get(name, 0) for name in launches}
    check(launches == expect,
          f"{what}: launches {json.dumps(launches)} == {json.dumps(expect)}")


def check_bodies(e2e, kernel, prefill, decode):
    """``kernel``'s launches by body in a serving run: every prefill (and
    chunk) wave on the tensor-core body, every decode and verify tick on
    the decode body, none on the query-tile body."""
    expect = dict(query_tile=0, decode=decode, tensor_core=prefill)
    got = e2e["body_launches"][kernel]
    check(got == expect, f"{kernel} by body: {json.dumps(got)} == "
          f"{json.dumps(expect)}")


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


def profile_window(torch, run):
    """``torch.profiler`` over ``run()``: (a summary with the window,
    device busy time, kernel launches, the card's idle share and the top
    12 kernels by device time; every kernel row as (device us, name,
    count))."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    rows = kernel_rows(prof)
    total_us = sum(r[0] for r in rows)
    out = dict(window_s=window, device_busy_s=total_us / 1e6,
               kernel_launches=sum(r[2] for r in rows))
    if total_us > 0:
        out["idle_share"] = max(0.0, 1 - total_us / 1e6 / window)
        out["top"] = [dict(kernel=k[:80], device_ms=us / 1e3, count=n,
                           share=us / total_us) for us, k, n in rows[:12]]
        for row in out["top"]:
            log(f"   {row['share']:6.1%} {row['device_ms']:9.3f} ms "
                f"x{row['count']:<5d} {row['kernel']}")
    else:
        log("   the profiler recorded no device time: not measured")
    return out, rows


def profile_prefill_wave(torch, engine, kernel):
    """``torch.profiler`` over the engine's first prefill wave alone
    (the queue head's wave as admission would pick it): device time by
    kernel, the card's idle share, and the paged kernel's launches by
    body, its device time and share of the wave."""
    wave = engine._select_paged_wave()
    bucket = engine.bucketer.bucket_for(
        int(wave[0][0].effective_prompt[wave[0][1].shared_tokens:].size))
    before = dict(kernel.body_launches)
    out, rows = profile_window(
        torch, lambda: engine._prefill_wave_paged(wave))
    kernel_us = sum(us for us, key, _ in rows
                    if "paged_attention_kernel" in key)
    busy_us = sum(us for us, _, _ in rows)
    bodies = {b: n - before[b] for b, n in kernel.body_launches.items()}
    out.update(rows=len(wave), bucket=bucket, body_launches=bodies,
               paged_device_ms=kernel_us / 1e3,
               paged_us_per_launch=kernel_us / max(sum(bodies.values()), 1),
               paged_share=kernel_us / busy_us if busy_us else None,
               paged_kernels=sorted({key[:100] for _, key, _ in rows
                                     if "paged_attention" in key}))
    check(bodies["tensor_core"] == LAYERS and sum(bodies.values()) == LAYERS,
          f"the prefill wave (bucket {bucket}, {len(wave)} requests) ran the "
          f"tensor-core body once per layer: {json.dumps(bodies)}")
    log(f"   profile: "
        f"{json.dumps({k: v for k, v in out.items() if k != 'top'})}")
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
    slabs = engine.stages[0].slabs
    k0 = slabs[0][0]
    device = slab_device(k0)
    plan = write_plan(k0, tables[:, :width], index, valid, 1).to(device)
    spec = engine.stages[0].specs[0]
    rng = np.random.default_rng(5)
    new = torch.from_numpy(rng.standard_normal(
        (len(index), 1, spec.num_heads, spec.head_dim), np.float32)).to(
        device, getattr(torch, spec.dtype))

    def write():
        for k, v in slabs:
            scatter_kv(k, v, new, new, plan)

    span_ms = timer(torch, write, iters=10, host_ahead=False)
    if device.type != "cuda":
        return span_ms, None
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        write()
        torch.cuda.synchronize()
    return span_ms, sum(r[0] for r in kernel_rows(prof)) / 1e3


# --------------------------------------------------------------------------
# phase 3: flash attention (B1) against its plain version
# --------------------------------------------------------------------------

# (case, B, L, padded tail keys) at BERT-large's heads (H=16, D=64)
FLASH_CASES = (("bert_large_L128", 8, 128, 32), ("long_L512", 2, 512, 0),
               ("indivisible_L100", 2, 100, 0))


def flash_case(torch, np, B, L, tail, dtype, seed):
    """q/k/v ~ N(0, 1) [B, L, 16, 64] and a bias row of 0 with -10000
    on the last ``tail`` keys, in ``dtype`` on the card."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, L, 16, 64))
                                .astype(np.float32)).to("cuda", dt)
               for _ in range(3))
    bias = torch.zeros(B, L)
    if tail:
        bias[:, -tail:] = -10000.0
    return q, k, v, bias.to("cuda", dt)


def flash_bound(q, bias, dtype):
    """The least time for one call: q, k, v read and out written once
    (plus the bias row), against 4 * B * H * L * L * D flops (the two
    products; the softmax's exps are not counted)."""
    B, L, H, D = q.shape
    itemsize = q.element_size()
    nbytes = 4 * B * L * H * D * itemsize + bias.numel() * itemsize
    flops = 4.0 * B * H * L * L * D
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def flash_checks(torch, np, ptxas):
    """B1 against its plain version at each case in both dtypes, with
    the kernel's, the plain version's and SDPA's times (SDPA over the
    same inputs transposed to [B, H, L, D] outside the timed call, the
    bias as a broadcast additive mask)."""
    import torch.nn.functional as F
    from skycomputing_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    tol = {"float32": 1e-4, "bfloat16": 2e-2}
    results = []
    for name, B, L, tail in FLASH_CASES:
        for dtype in ("bfloat16", "float32"):
            q, k, v, bias = flash_case(torch, np, B, L, tail, dtype,
                                       seed=300 + len(results))
            scale = q.shape[-1] ** -0.5
            out = flash_attention(q, k, v, bias)
            ref = flash_attention_reference(q, k, v, bias, scale)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            finite = bool(torch.isfinite(out).all())
            qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            mask = bias[:, None, None, :]
            ms = time_ms(torch, lambda: flash_attention(q, k, v, bias))
            issue_ms = host_ms(torch, lambda: flash_attention(q, k, v, bias))
            plain_ms = time_ms(torch, lambda: flash_attention_reference(
                q, k, v, bias, scale))
            library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask))
            bound_ms, bound_by = flash_bound(q, bias, dtype)
            row = dict(kernel="flash_attention", case=name, B=B, L=L,
                       H=16, D=64, padded_keys=tail, dtype=dtype,
                       max_abs_err=err, tol=tol[dtype], ms=ms,
                       host_ms=issue_ms, plain_ms=plain_ms,
                       library_ms=library_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       **flash_body(torch, ptxas, q))
            log(f"   {json.dumps(row)}")
            check(finite and err <= tol[dtype],
                  f"flash_attention {name} {dtype}: max |err| {err:.3g} "
                  f"<= {tol[dtype]}")
            results.append(row)
    return results


# (case, B, L, H, D, masked tail keys) at the tensor-core body's edges;
# head_dim 40 is not a multiple of 16, so bf16 too takes the CUDA-core body
FLASH_EDGE_CASES = (("short_L7", 2, 7, 4, 64, 0), ("one_tile_L64", 2, 64, 4,
                                                    64, 0),
                    ("one_past_L65", 2, 65, 4, 64, 0),
                    ("head_dim_32", 2, 96, 4, 32, 8),
                    ("head_dim_128", 2, 130, 4, 128, 8),
                    ("batch_1", 1, 128, 16, 64, 32),
                    ("all_keys_masked", 2, 64, 4, 64, 64),
                    ("head_dim_40", 2, 100, 4, 40, 8))


def flash_edge_checks(torch, np, ptxas):
    """B1 at its bodies' edges in both dtypes against the plain version
    (checked, not timed).  In ``all_keys_masked`` batch 0's queries are
    zero, so its softmax must come out uniform: its output the mean of v
    over the keys."""
    from skycomputing_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    tol = {"float32": 1e-4, "bfloat16": 2e-2}
    results = []
    for name, B, L, H, D, tail in FLASH_EDGE_CASES:
        for dtype in ("bfloat16", "float32"):
            rng = np.random.default_rng(600 + len(results))
            dt = getattr(torch, dtype)
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (B, L, H, D)).astype(np.float32)).to("cuda", dt)
                for _ in range(3))
            bias = torch.zeros(B, L)
            if tail:
                bias[:, -tail:] = -10000.0
            bias = bias.to("cuda", dt)
            if name == "all_keys_masked":
                q[0] = 0
            out = flash_attention(q, k, v, bias)
            ref = flash_attention_reference(q, k, v, bias, D ** -0.5)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if name == "all_keys_masked":
                mean = v[0].float().mean(dim=0, keepdim=True)
                err = max(err, (out[0].float() - mean).abs().max().item())
            finite = bool(torch.isfinite(out).all())
            row = dict(kernel="flash_attention", case=name, B=B, L=L, H=H,
                       D=D, padded_keys=tail, dtype=dtype, max_abs_err=err,
                       tol=tol[dtype], **flash_body(torch, ptxas, q))
            log(f"   {json.dumps(row)}")
            check(finite and err <= tol[dtype],
                  f"flash_attention {name} {dtype} ({row['body']}): "
                  f"max |err| {err:.3g} <= {tol[dtype]}")
            results.append(row)
    return results


# --------------------------------------------------------------------------
# phases 10-13: the BERT pipeline trainer
# --------------------------------------------------------------------------

BERT_BATCH, BERT_SEQ, BERT_STEPS = 32, 128, 5
BERT_WORKERS, BERT_MICROBATCHES, BERT_LR = 4, 4, 1e-3


def bert_batch(np, vocab_size):
    """The reference benchmark's batch: ids from default_rng(0) in
    [5, vocab), token types 0, no padding, 3-way labels."""
    rng = np.random.default_rng(0)
    ids = rng.integers(5, vocab_size,
                       size=(BERT_BATCH, BERT_SEQ)).astype(np.int32)
    labels = rng.integers(0, 3, size=(BERT_BATCH,)).astype(np.int32)
    return (ids, np.zeros_like(ids), np.ones_like(ids)), labels


def build_trainer(torch, model_cfg, devices=None, state_dicts=None):
    """4 workers (device index i % cards), even allocation, the
    parameter server (weights from seed 0 unless given), GPipe with 4
    microbatches and SGD — through the library's entry points."""
    from skycomputing_tpu_torch.dynamics import (
        Allocator,
        ParameterServer,
        WorkerManager,
    )
    from skycomputing_tpu_torch.ops import cross_entropy_loss
    from skycomputing_tpu_torch.parallel import PipelineModel, sgd

    cards = max(torch.cuda.device_count(), 1)
    wm = WorkerManager()
    wm.load_worker_pool_from_config([
        dict(name=f"node-{i}", device_config=dict(device_index=i % cards))
        for i in range(BERT_WORKERS)
    ])
    Allocator(model_cfg, wm).even_allocate()
    ps = ParameterServer(model_cfg, state_dicts=state_dicts,
                         generator=torch.Generator().manual_seed(SEED))
    model = PipelineModel(wm, ps, sgd(BERT_LR), cross_entropy_loss,
                          devices=devices,
                          num_microbatches=BERT_MICROBATCHES)
    return model, ps, wm


def train_bert(torch, np, kernels):
    """BERT-large trained by ``Runner.train`` for 5 steps; every
    kernel's launches are set to 0 just before and read just after."""
    from skycomputing_tpu_torch.models import bert_config, bert_layer_configs
    from skycomputing_tpu_torch.runner import Hook, Runner

    cfg = bert_config("large", hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0,
                      use_flash_attention=True)
    model_cfg = bert_layer_configs(cfg, num_encoder_units=24, num_classes=3,
                                   deterministic=True)
    check(len(model_cfg) == 75 and cfg.hidden_size == 1024
          and cfg.num_attention_heads == 16 and cfg.dtype == "bfloat16",
          "BERT-large: 75 units, hidden 1024, 16 heads, bf16 compute")
    data, labels = bert_batch(np, cfg.vocab_size)
    t0 = time.perf_counter()
    model, ps, wm = build_trainer(torch, model_cfg)
    setup_s = time.perf_counter() - t0
    partition = model.partition_signature()
    check(partition == [19, 19, 19, 18],
          f"even allocation {partition} over 4 workers")
    params = sum(p.numel() for stage in model.stages
                 for p in stage.parameters)

    class Record(Hook):
        def __init__(self):
            self.steps = []

        def after_train_iter(self, runner):
            self.steps.append(runner.model.stats.snapshot())

    runner = Runner(model, ps, wm, max_epochs=1, max_iters=BERT_STEPS)
    record = Record()
    runner.register_hook(record)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()
    for k in kernels.values():
        k["fn"].launches = 0
    t0 = time.perf_counter()
    runner.train([(data, labels)] * BERT_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k["fn"].launches for name, k in kernels.items()}
    steps = record.steps
    losses = [s["loss"] for s in steps]
    log(f"   losses: {losses}")
    check(len(losses) == BERT_STEPS
          and all(np.isfinite(x) for x in losses),
          f"{len(losses)} finite losses")
    step_s = [s["forward_s"] + s["backward_s"] + s["step_s"] for s in steps]
    median = float(np.median(step_s[1:]))
    tokens = BERT_BATCH * BERT_SEQ
    e2e = dict(
        setup_s=setup_s, wall_s=wall, losses=losses, step_s=step_s,
        step_s_median_2_5=median, tokens_per_step=tokens,
        tokens_per_s=tokens / median, parameters=params,
        mfu=6.0 * params * tokens / median / PEAK_FLOPS["bfloat16"],
        forward_s=[s["forward_s"] for s in steps],
        backward_s=[s["backward_s"] for s in steps],
        update_s=[s["step_s"] for s in steps],
        dispatch_s=[s["dispatch_s"] for s in steps],
        phase_means_s=runner.phase_timer.summary(),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        mem_before_gb=mem_before / 1e9,
        partition=partition, launches=launches,
    )
    log(f"   e2e: {json.dumps(e2e)}")
    return model, data, labels, launches, e2e


def trainer_card_vs_cpu(torch, np):
    """The pipeline at BERT-large's width, depth 2, float32: two steps
    on the card and on the CPU from the same weights and batch."""
    from skycomputing_tpu_torch.models import bert_config, bert_layer_configs

    cfg = bert_config("large", dtype="float32", hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0,
                      use_flash_attention=True)
    model_cfg = bert_layer_configs(cfg, num_encoder_units=2, num_classes=3,
                                   deterministic=True)
    data, labels = bert_batch(np, cfg.vocab_size)
    card, card_ps, _ = build_trainer(torch, model_cfg)
    host, host_ps, _ = build_trainer(torch, model_cfg,
                                     devices=[torch.device("cpu")],
                                     state_dicts=card_ps.params)
    losses = {}
    for name, model in (("cuda", card), ("cpu", host)):
        t0 = time.perf_counter()
        losses[name] = [model.train_step(data, labels) for _ in range(2)]
        log(f"   {name}: losses {losses[name]} in "
            f"{time.perf_counter() - t0:.1f} s")
        model.sync_to_parameter_server()
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(losses["cuda"], losses["cpu"]))
    param_abs = max(
        (a[key] - b[key]).abs().max().item()
        for a, b in zip(card_ps.params, host_ps.params) for key in a
    )
    return dict(losses=losses, max_loss_rel_diff=loss_rel,
                max_param_abs_diff=param_abs)


def flash_on_off_bf16(torch, np, kernels):
    """BERT-large's width at depth 2 in bfloat16: two steps with
    ``use_flash_attention`` on and two with it off, from the same
    weights and batch.  Returns both loss lists, the largest relative
    difference and B1's launches in each run."""
    from skycomputing_tpu_torch.models import bert_config, bert_layer_configs

    models = {}
    params = None
    for flash in (True, False):
        cfg = bert_config("large", hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0,
                          use_flash_attention=flash)
        model_cfg = bert_layer_configs(cfg, num_encoder_units=2,
                                       num_classes=3, deterministic=True)
        model, ps, _ = build_trainer(torch, model_cfg, state_dicts=params)
        params = params or ps.params
        models[flash] = model
    data, labels = bert_batch(np, cfg.vocab_size)
    losses, launches = {}, {}
    for flash, model in models.items():
        before = kernels["flash_attention"]["fn"].launches
        losses[flash] = [model.train_step(data, labels) for _ in range(2)]
        launches[flash] = kernels["flash_attention"]["fn"].launches - before
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses[True],
                                                   losses[False]))
    return dict(losses_flash=losses[True], losses_einsum=losses[False],
                max_loss_rel_diff=rel, flash_launches=launches[True],
                einsum_run_flash_launches=launches[False])


# --------------------------------------------------------------------------
# phases 14-16: the profilers, the launcher and the headline pass
# --------------------------------------------------------------------------

def bert_units(preset="large", layers=24):
    """The trainer's BERT (flash on, both dropouts 0) as unit configs."""
    from skycomputing_tpu_torch.models import bert_config, bert_layer_configs

    cfg = bert_config(preset, hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0,
                      use_flash_attention=True)
    return cfg, bert_layer_configs(cfg, num_encoder_units=layers,
                                   num_classes=3, deterministic=True)


def worker_pool(n):
    """``n`` workers round-robined over the cards (all on one here)."""
    from skycomputing_tpu_torch.dynamics import (
        WorkerManager,
        worker_pool_config,
    )

    wm = WorkerManager()
    wm.load_worker_pool_from_config(worker_pool_config(n, prefix="node"))
    return wm


def profilers(torch, np, kernels, model_cfg, vocab_size, device=None):
    """The static and the timed ``ModelBenchmarker`` over ``model_cfg`` at
    the trainer's batch, and the device benchmarker over four workers.
    Returns (both model benchmarkers, for the headline pass; a report)."""
    from skycomputing_tpu_torch.dataset import RandomTokenGenerator
    from skycomputing_tpu_torch.dynamics import (
        ModelBenchmarker,
        device_available_memory_mb,
        proxy_device_benchmarker,
    )

    def tokens():
        return RandomTokenGenerator(BERT_BATCH, BERT_SEQ, vocab_size)

    static = ModelBenchmarker(model_cfg, tokens())
    t0 = time.perf_counter()
    flops, static_mem = static.benchmark()
    static_s = time.perf_counter() - t0
    timed = ModelBenchmarker(model_cfg, tokens(), device=device, timed=True)
    for k in kernels.values():
        k["fn"].launches = 0
    t0 = time.perf_counter()
    seconds, timed_mem = timed.benchmark()
    timed_s = time.perf_counter() - t0
    launches = {name: k["fn"].launches for name, k in kernels.items()}
    per_type = {}
    for cfg, f, s, m in zip(model_cfg, flops, seconds, static_mem):
        row = per_type.setdefault(cfg["layer_type"], dict(
            units=0, flops=f, ms=s * 1e3, mem_mb=m))
        row["units"] += 1
    for name, row in per_type.items():
        log(f"   {name}: {json.dumps(row)}")
    check(min(flops) > 0 and min(seconds) > 0,
          f"no unit of {len(model_cfg)} profiles at 0 (static FLOPs, timed "
          f"seconds)")
    check(static.distinct_units == timed.distinct_units == len(per_type),
          f"{timed.distinct_units} distinct units timed, "
          f"{static.distinct_units} counted, one per unit type")
    check(static_mem == timed_mem,
          f"static and timed memory estimates equal "
          f"({sum(static_mem) / 1024:.3f} GB in all)")
    b1 = launches["flash_attention"]
    check(b1 > 0 and launches == {**{n: 0 for n in launches},
                                  "flash_attention": b1},
          f"B1 launched {b1} times while profiling, B2/B3 never")

    wm = worker_pool(4)
    device_bench = proxy_device_benchmarker(
        wm, devices=[device] if device is not None else None)
    t0 = time.perf_counter()
    results = device_bench.benchmark()
    device_s = time.perf_counter() - t0
    probe = torch.device(device) if device is not None else torch.device(
        "cuda", 0)
    free_mb = device_available_memory_mb(probe)
    log(f"   device benchmark: {json.dumps(results)}")
    times = {r["time"] for r in results.values()}
    check(len(results) == 4 and len(times) == 1,
          f"4 workers on one device timed once: {times}")
    mems = [r["avai_mem"] for r in results.values()]
    check(all(0 < m and abs(m - free_mb) <= 1024 for m in mems),
          f"free memory {mems[0]:.0f} MB per worker, as read now "
          f"({free_mb:.0f} MB)")
    return static, timed, dict(
        units=len(model_cfg), distinct_units=timed.distinct_units,
        per_type=per_type, static_s=static_s, timed_s=timed_s,
        flops_total=sum(flops), timed_seconds_total=sum(seconds),
        mem_total_gb=sum(static_mem) / 1024, launches=launches,
        device_benchmark=results, device_benchmark_s=device_s,
        free_mb=free_mb)


def launcher_env(workdir, preset="large", layers=24):
    """The knobs of ``configs/bert_pipeline.py`` for the launcher phase."""
    return dict(
        SKYTPU_PRESET=preset, SKYTPU_LAYER_NUM=str(layers),
        SKYTPU_SEQ_LEN=str(BERT_SEQ), SKYTPU_BATCH_SIZE=str(BERT_BATCH),
        SKYTPU_FLASH="1", SKYTPU_CORE_NUM=str(BERT_WORKERS), STIMULATE="1",
        SKYTPU_ALLOCATE_TYPE="optimal", SKYTPU_SCHEDULE="1f1b",
        SKYTPU_MICROBATCHES=str(BERT_MICROBATCHES),
        SKYTPU_MAX_ITERS=str(BERT_STEPS), SKYTPU_PROFILE="static",
        SKYTPU_CKPT_DIR=str(workdir / "ckpt"),
        SKYTPU_LOG_ROOT=str(workdir / "logs"))


def launcher_path(torch, np, kernels, workdir, layers=24, preset="large",
                  device=None):
    """``launch.run`` on the port's config: BERT at ``layers`` encoder
    layers, 4 stimulated workers, ``optimal``, 1F1B with 4 microbatches,
    5 steps, with the stop, timer and checkpoint hooks.  Every kernel's
    launches are set to 0 just before and read just after.  Then the
    checkpoint is restored under ``even_allocate``."""
    import os

    from skycomputing_tpu_torch import launch
    from skycomputing_tpu_torch.config import load_config
    from skycomputing_tpu_torch.dynamics import (
        Allocator,
        ParameterServer,
        WorkerManager,
    )
    from skycomputing_tpu_torch.ops import build_loss
    from skycomputing_tpu_torch.parallel import PipelineModel, build_optimizer
    from skycomputing_tpu_torch.runner import CheckpointHook, Hook
    from skycomputing_tpu_torch.utils import Logger

    env = launcher_env(workdir, preset, layers)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        cfg = load_config(str(
            ROOT / "skycomputing_tpu_torch" / "configs" / "bert_pipeline.py"))
        n_units = len(cfg.model_config)

        class Record(Hook):
            def __init__(self):
                self.steps = []

            def after_train_iter(self, runner):
                self.steps.append(runner.model.stats.snapshot())

        record = Record()
        logger = Logger(**cfg.logging_config)
        if device is None:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k["fn"].launches = 0
        t0 = time.perf_counter()
        run = launch.run(cfg, logger, device=device, hooks=[record])
        if device is None:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: k["fn"].launches for name, k in kernels.items()}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(run is not None, "the launcher allocated and trained")
    preflight = check_preflight(run.runner)
    solved = run.allocator.last_result
    ranges = solved.as_ranges(len(solved.device_order))
    slices = [ranges[d] for d in solved.device_order]
    partition = run.model.partition_signature()
    check(partition == [b - a for a, b in slices]
          and [a for a, _ in slices] == [0] + [b for _, b in slices[:-1]]
          and slices[-1][1] == n_units,
          f"partition {partition} is the solver's ({solved.path}, gap "
          f"{solved.optimality_gap:.3g}): slices {slices} cover the "
          f"{n_units} units contiguously")
    even = [len(w.model_config) for w in Allocator(
        cfg.model_config, worker_pool(BERT_WORKERS)).even_allocate()
        .worker_pool]
    check(partition != even, f"not the even split {even}")
    steps = record.steps
    losses = [s["loss"] for s in steps]
    check(len(losses) == BERT_STEPS and all(np.isfinite(x) for x in losses)
          and all(s["interleaved"] for s in steps),
          f"{len(losses)} finite losses under 1F1B: {losses}")
    per_step = 2 * layers * BERT_MICROBATCHES
    check_launches(launches, {"flash_attention": per_step * BERT_STEPS},
                   f"{per_step} B1 launches per step (2 x {layers} layers "
                   f"x {BERT_MICROBATCHES} microbatches) x {BERT_STEPS} "
                   f"steps, none while profiling")
    step_s = [s["forward_s"] + s["backward_s"] + s["step_s"] for s in steps]
    median = float(np.median(step_s[1:]))
    params = sum(p.numel() for stage in run.model.stages
                 for p in stage.parameters)
    tokens = BERT_BATCH * BERT_SEQ
    e2e = dict(
        wall_s=wall, losses=losses, step_s=step_s,
        step_s_median_2_5=median, tokens_per_s=tokens / median,
        mfu=6.0 * params * tokens / median / PEAK_FLOPS["bfloat16"],
        dispatch_s=[s["dispatch_s"] for s in steps],
        peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                     if device is None else None),
        partition=partition, even_partition=even,
        device_order=solved.device_order, solver_path=solved.path,
        solver_gap=solved.optimality_gap,
        device_time=[r["time"] for r in
                     run.device_benchmarker.benchmark().values()],
        launches=launches, preflight=preflight)

    # the checkpoint restores its parameters under another allocation and
    # refuses its optimizer state there
    hook = next(h for h in run.runner.hooks if isinstance(h, CheckpointHook))
    check(hook.last_saved is not None, f"checkpoint {hook.last_saved}")
    wm = WorkerManager()
    wm.load_worker_pool_from_config(cfg.worker_config)
    Allocator(cfg.model_config, wm).even_allocate()
    ps = ParameterServer(cfg.model_config,
                         generator=torch.Generator().manual_seed(SEED + 1))
    ps.load_weights_from_file(hook.last_saved)
    restored = PipelineModel(
        wm, ps, build_optimizer(cfg.train_config["optim_cfg"]),
        build_loss(cfg.train_config["loss_cfg"]),
        devices=[torch.device(device)] if device is not None else None,
        num_microbatches=BERT_MICROBATCHES, schedule="1f1b")
    restored.sync_to_parameter_server()  # the stages' weights, read back
    diff = max((a[key] - b[key]).abs().max().item()
               for a, b in zip(ps.params, run.parameter_server.params)
               for key in a)
    check(restored.partition_signature() == even and diff == 0.0,
          f"restored under {restored.partition_signature()}: parameters "
          f"equal (max |diff| {diff})")
    try:
        restored.load_optimizer_state(run.model.get_optimizer_state())
        refused = False
    except ValueError:
        refused = True
    check(refused, "its optimizer state is refused under the even split")
    e2e["checkpoint"] = Path(hook.last_saved).name
    log(f"   e2e: {json.dumps(e2e)}")
    del run, restored, ps
    return launches, e2e


def check_preflight(runner):
    """The runner verified its plan once, before its first step: an
    ``ok`` report over coverage, shapes, memory and donation."""
    reports = runner.preflight_reports
    check(len(reports) == 1 and reports[0].ok and reports[0].checks
          == ["coverage", "shapes", "memory", "donation"],
          f"pre-flight: {[r.summary() for r in reports]}")
    log(f"   pre-flight {reports[0].elapsed_s:.3f} s over "
        f"{reports[0].layers} units, {reports[0].stages} stages")
    return dict(seconds=reports[0].elapsed_s, summary=reports[0].summary())


def headline(np, model_cfg, static_bench, model_bench, vocab_size,
             devices=None):
    """The package's headline pass (``dynamics/headline.py``) on the
    trainer's model and batch, under the paper's slowdowns, with the
    static model's prediction beside it.  Optimal must beat even at
    every microbatch count."""
    from skycomputing_tpu_torch.dynamics.headline import (
        HEADLINE_MICROBATCHES,
        headline_pass,
        worker_slowdowns,
    )

    data, _ = bert_batch(np, vocab_size)
    head = headline_pass(
        model_cfg, model_bench, data, worker_slowdowns(BERT_WORKERS, "paper"),
        static_bench.benchmark()[0], devices=devices,
        log=lambda line: log(f"   {line}"))
    for m in HEADLINE_MICROBATCHES:
        even, opt = head["even_step_s"][m], head["optimal_step_s"][m]
        check(opt < even,
              f"M={m}: optimal {opt * 1e3:.1f} ms < even {even * 1e3:.1f} "
              f"ms (means of {head['optimal']['step_s'][m] * 1e3:.1f}, "
              f"{head['optimal_again']['step_s'][m] * 1e3:.1f} and "
              f"{head['even']['step_s'][m] * 1e3:.1f}, "
              f"{head['even_again']['step_s'][m] * 1e3:.1f}; "
              f"{head['speedup'][m]:.1%} faster)")
    return head



# --------------------------------------------------------------------------
# phases 17-18: the GLUE path with evaluation, and the bench
# --------------------------------------------------------------------------

GLUE_VOCAB = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
    "the", "movie", "was", "great", "terrible", "fine",
    "a", "film", "it", "truly", "##ly", "good", "bad",
]
GLUE_TRAIN_ROWS = BERT_BATCH * BERT_STEPS  # one epoch of the run's steps
GLUE_DEV_ROWS = 100  # three full batches and a ragged one of 4
# the bench at its defaults (64 workers, 53 encoder layers at ffn/2:
# about half a minute on an H100), under a deadline well inside the
# smoke's time
BENCH_SMOKE_ENV = dict(SKYTPU_BENCH_DEADLINE_S="300")


def write_glue(np, root):
    """A WordPiece vocabulary and MNLI-format ``train.tsv`` and
    ``dev_matched.tsv`` (text_a in column 8, text_b in 9, the label
    last) written from a seed: the label is set by a keyword, as in
    ``tests/test_glue_real_data.py``.  Returns (data dir, vocab file)."""
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED)
    vocab = root / "vocab.txt"
    vocab.write_text("\n".join(GLUE_VOCAB) + "\n")
    labels = ["contradiction", "entailment", "neutral"]
    keyword = dict(contradiction="terrible", entailment="great",
                   neutral="fine")
    header = "\t".join(f"col{i}" for i in range(12))
    rows = []
    for i in range(GLUE_TRAIN_ROWS + GLUE_DEV_ROWS):
        label = labels[int(rng.integers(0, 3))]
        text_a = f"the movie was {keyword[label]}"
        text_b = "it was a film truly " + " ".join(
            rng.choice(["good", "bad", "fine"], size=int(rng.integers(1, 6))))
        rows.append("\t".join([str(i)] + ["x"] * 7
                              + [text_a, text_b, "x", label]))
    (root / "train.tsv").write_text(
        "\n".join([header] + rows[:GLUE_TRAIN_ROWS]) + "\n")
    (root / "dev_matched.tsv").write_text(
        "\n".join([header] + rows[GLUE_TRAIN_ROWS:]) + "\n")
    return str(root), str(vocab)


def glue_loader(data_cfg, split, batch):
    """The config's GLUE dataset at ``split``, batched in the order the
    model takes, the last batch kept however short."""
    from skycomputing_tpu_torch.builder import build_dataloader_from_cfg
    from skycomputing_tpu_torch.launch import BatchAdapter

    return BatchAdapter(build_dataloader_from_cfg(dict(
        dataset_cfg=dict(data_cfg["dataset_cfg"], split=split),
        dataloader_cfg=dict(batch_size=batch, drop_last=False))))


def glue_path(torch, np, kernels, workdir, layers=24, preset="large",
              device=None, ptxas=None):
    """``launch.run`` on the port's config over MNLI TSVs written from a
    seed (``SKYTPU_GLUE_DIR``, ``SKYTPU_VOCAB_FILE``), with ``EvalHook``,
    ``MetricsHook`` and ``NanGuardHook``; then ``Runner.evaluate`` on the
    dev split with every kernel's launches set to 0 just before and read
    just after: a forward without rematerialization, one B1 launch per
    encoder layer per batch.  On the card, a profile of one eval batch
    and B1 against its plain version at the eval path's own calls."""
    import os

    from skycomputing_tpu_torch import launch
    from skycomputing_tpu_torch.builder import build_hook
    from skycomputing_tpu_torch.config import load_config
    from skycomputing_tpu_torch.runner import EvalHook, NanGuardHook
    from skycomputing_tpu_torch.utils import Logger

    data_dir, vocab_file = write_glue(np, workdir / "mnli")
    env = dict(launcher_env(workdir, preset, layers), SKYTPU_CKPT_DIR="",
               SKYTPU_GLUE_DIR=data_dir, SKYTPU_VOCAB_FILE=vocab_file)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        cfg = load_config(str(
            ROOT / "skycomputing_tpu_torch" / "configs" / "bert_pipeline.py"))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    dev = glue_loader(cfg.data_config, "dev", BERT_BATCH)
    check(not dev._loader.dataset.synthetic
          and len(dev._loader.dataset) == GLUE_DEV_ROWS,
          f"the dev split read from the TSVs: {GLUE_DEV_ROWS} rows, "
          f"{len(dev)} batches")
    metrics_path = workdir / "metrics.jsonl"
    hooks = [EvalHook(dev, interval=1, max_batches=1),
             build_hook(dict(type="MetricsHook", path=str(metrics_path))),
             build_hook(dict(type="NanGuardHook", action="raise"))]
    check(isinstance(hooks[2], NanGuardHook), "the hooks build by name")
    run = launch.run(cfg, Logger(**cfg.logging_config), device=device,
                     hooks=hooks)
    check(run is not None, "the launcher allocated and trained on MNLI")
    train_ds = run.runner.data_loader._loader.dataset
    mask = train_ds.input_mask
    check(not train_ds.synthetic and len(train_ds) == GLUE_TRAIN_ROWS,
          f"trained on the TSVs: {len(train_ds)} rows, real lengths "
          f"{int(mask.sum(1).min())}-{int(mask.sum(1).max())} of "
          f"{mask.shape[1]}")
    preflight = check_preflight(run.runner)
    check(run.runner.iter == BERT_STEPS
          and len(run.runner.eval_history) == 1,
          f"{run.runner.iter} steps, then EvalHook at the epoch's end: "
          f"{json.dumps(run.runner.eval_history)}")
    records = [json.loads(line)
               for line in metrics_path.read_text().splitlines()]
    check(records[0]["event"] == "run_start"
          and len(records) == 1 + BERT_STEPS
          and all(r["run_id"] == records[0]["run_id"]
                  and np.isfinite(r["loss"]) for r in records[1:]),
          f"metrics JSONL: a run_start header (config_hash "
          f"{records[0]['config_hash']}) and {len(records) - 1} finite "
          f"iteration records")

    for k in kernels.values():
        k["fn"].launches = 0
    if device is None:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = run.runner.evaluate(dev, task="mnli")
    if device is None:
        torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = {name: k["fn"].launches for name, k in kernels.items()}
    check(np.isfinite(metrics["loss"]) and 0.0 <= metrics["accuracy"] <= 1.0
          and metrics["num_examples"] == GLUE_DEV_ROWS,
          f"evaluate: {json.dumps(metrics)}")
    check_launches(launches, {"flash_attention": layers * len(dev)},
                   f"B1 {layers} x {len(dev)} eval batches (a forward, no "
                   f"remat)")
    out = dict(eval=metrics, eval_s=eval_s, eval_s_per_batch=eval_s
               / len(dev), launches=launches,
               train_losses=[r["loss"] for r in records[1:]],
               partition=run.model.partition_signature(),
               preflight=preflight)
    if device is None:
        flash = kernels["flash_attention"]["fn"]
        before = flash.launches
        prof, rows = profile_window(
            torch, lambda: run.runner.evaluate(dev, max_batches=1))
        b1_us = sum(us for us, key, _ in rows
                    if "flash_attention_kernel" in key)
        total_us = sum(us for us, _, _ in rows)
        prof.update(flash_launches=flash.launches - before,
                    flash_device_ms=b1_us / 1e3,
                    flash_share=b1_us / total_us if total_us else None)
        out["profile_eval_batch"] = {k: v for k, v in prof.items()
                                     if k != "top"}
        log(f"   profile one eval batch: "
            f"{json.dumps(out['profile_eval_batch'])}")
        out["flash_eval_shapes"] = flash_eval_checks(torch, np, ptxas, run,
                                                     dev)
    log(f"   glue: {json.dumps(out)}")
    del run
    return launches, dev, out


def flash_eval_checks(torch, np, ptxas, run, dev):
    """B1 at the calls the eval path makes: ``Runner.evaluate`` feeds the
    whole dev batch (32 rows, and the ragged last 4) through each layer
    in the model's dtype, with a bias row of -10000 on all but the 13-17
    live keys of 128.  One more evaluation records the first layer's
    (q, k, v, bias) for each batch size; the kernel is then held against
    the plain version on those tensors, and on q/k/v ~ N(0, 1) of the
    same shape and dtype under the same bias, and timed beside the plain
    version and SDPA on the recorded ones."""
    import torch.nn.functional as F
    from skycomputing_tpu_torch.models import bert as bert_mod
    from skycomputing_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    seen = {}
    real = bert_mod.flash_attention

    def record(q, k, v, bias):
        seen.setdefault(q.shape[0], tuple(t.detach().clone()
                                          for t in (q, k, v, bias)))
        return real(q, k, v, bias)

    bert_mod.flash_attention = record
    try:
        run.runner.evaluate(dev)
    finally:
        bert_mod.flash_attention = real
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    rows = []
    for B in sorted(seen, reverse=True):
        q, k, v, bias = seen[B]
        rng = np.random.default_rng(700 + B)
        normal = tuple(torch.from_numpy(rng.standard_normal(tuple(q.shape))
                                        .astype(np.float32)).to(q)
                       for _ in range(3))
        live = (bias == 0).sum(-1)
        for inputs, what in (((q, k, v), "activations"),
                             (normal, "normal")):
            scale = q.shape[-1] ** -0.5
            out = flash_attention(*inputs, bias)
            ref = flash_attention_reference(*inputs, bias, scale)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            finite = bool(torch.isfinite(out).all())
            row = dict(kernel="flash_attention", case=f"eval_B{B}_{what}",
                       B=B, L=q.shape[1], H=q.shape[2], D=q.shape[3],
                       live_keys=[int(live.min()), int(live.max())],
                       dtype=str(q.dtype).replace("torch.", ""),
                       max_abs_err=err, tol=tol[q.dtype],
                       out_abs_max=out.float().abs().max().item(),
                       **flash_body(torch, ptxas, q))
            if what == "activations":
                qh, kh, vh = (t.transpose(1, 2).contiguous()
                              for t in inputs)
                mask = bias[:, None, None, :]
                row.update(
                    ms=time_ms(torch, lambda: flash_attention(*inputs, bias)),
                    plain_ms=time_ms(torch, lambda: flash_attention_reference(
                        *inputs, bias, scale)),
                    library_ms=time_ms(
                        torch, lambda: F.scaled_dot_product_attention(
                            qh, kh, vh, attn_mask=mask)))
                row["bound_ms"], row["bound_by"] = flash_bound(
                    q, bias, row["dtype"])
            log(f"   {json.dumps(row)}")
            check(finite and err <= tol[q.dtype],
                  f"flash_attention eval B={B} {what} {row['dtype']} "
                  f"({row['body']}): max |err| {err:.3g} <= "
                  f"{tol[q.dtype]}")
            rows.append(row)
    check(sorted(seen) == sorted({len(labels) for _, labels in dev}),
          f"B1 checked at every eval batch size: {sorted(seen)}")
    return rows


def eval_card_vs_cpu(torch, np, dev):
    """``Runner.evaluate`` at BERT-large's width, depth 2, float32, flash
    on, on the card and on the CPU from the same weights, over the dev
    loader's first two batches: the losses and every prediction."""
    from skycomputing_tpu_torch.models import bert_config, bert_layer_configs
    from skycomputing_tpu_torch.runner import Runner

    cfg = bert_config("large", dtype="float32", hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0,
                      use_flash_attention=True)
    model_cfg = bert_layer_configs(cfg, num_encoder_units=2, num_classes=3,
                                   deterministic=True)
    card, card_ps, wm = build_trainer(torch, model_cfg)
    host, host_ps, host_wm = build_trainer(
        torch, model_cfg, devices=[torch.device("cpu")],
        state_dicts=card_ps.params)
    batches = [batch for _, batch in zip(range(2), dev)]
    out = {}
    for name, model, ps, pool in (("cuda", card, card_ps, wm),
                                  ("cpu", host, host_ps, host_wm)):
        runner = Runner(model, ps, pool, max_epochs=0, max_iters=0)
        metrics = runner.evaluate(batches, task="mnli")
        model.train(False)
        preds = [model.forward(data).float().argmax(-1).cpu().numpy()
                 for data, _ in batches]
        model.train(True)
        out[name] = dict(metrics=metrics,
                         predictions=np.concatenate(preds).tolist())
    out["loss_rel_diff"] = (abs(out["cuda"]["metrics"]["loss"]
                                - out["cpu"]["metrics"]["loss"])
                            / abs(out["cpu"]["metrics"]["loss"]))
    return out


def bench_run(np, env_extra, timeout_s):
    """``python -m skycomputing_tpu_torch.bench`` in a subprocess; its
    stdout must be exactly one JSON line, a complete run on the card
    whose even and optimal partitions each cover every unit."""
    import os

    env = dict(os.environ, **env_extra)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "skycomputing_tpu_torch.bench"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=timeout_s)
    wall = time.perf_counter() - t0
    for line in proc.stderr.splitlines()[-40:]:
        log(f"   | {line}")
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and len(lines) == 1,
          f"the bench exited {proc.returncode} after {wall:.1f} s with "
          f"{len(lines)} stdout line(s)")
    line = json.loads(lines[0])
    # one "{label}: pre-flight plan-check ..." summary per allocation built
    seconds = [float(m.group(1)) for m in re.finditer(
        r": pre-flight plan-check ok: .*, ([0-9.]+)s$", proc.stderr,
        re.MULTILINE)]
    check(len(seconds) > 0, f"{len(seconds)} pre-flight reports, all ok")
    line["preflight_reports"] = len(seconds)
    line["preflight_slowest_s"] = max(seconds)
    log(f"   bench pre-flight: {len(seconds)} reports, slowest "
        f"{max(seconds):.3f} s, total {sum(seconds):.3f} s")
    for key in ("metric", "value", "vs_baseline", "platform", "device_kind",
                "units", "even_partition", "optimal_partition", "solver_gap",
                "refine_steps", "even_steps", "polish_moves",
                "final_remeasure", "calibration", "value_ffn1_model",
                "phases_skipped", "partial", "pass_s", "elapsed_s"):
        log(f"   bench {key}: {json.dumps(line.get(key))}")
    check(line["platform"] == "gpu" and line["partial"] is None
          and line["value"] is not None and np.isfinite(line["value"]),
          f"a complete run on the card: {line['value']}% "
          f"(vs_baseline {line['vs_baseline']})")
    for side in ("even_partition", "optimal_partition"):
        counts = line[side]
        check(sum(counts) == line["units"] and min(counts) > 0,
              f"{side} {counts} covers the {line['units']} units")
    line["wall_s"] = wall
    return line

# --------------------------------------------------------------------------
# phase 19: pre-flight, tracing and self-heal
# --------------------------------------------------------------------------

# a 6x stage: at 4x a fast host's straggler era can read 1.55x its
# baseline, where SelfHealHook's EWMA and its baseline's upward drift
# (alpha 0.4) meet its 1.35 threshold and no heal fires (selfheal_ab.py)
HEAL_STEPS, HEAL_FAULT_ITER, HEAL_FACTOR, UNTRACED_STEPS = 20, 4, 6.0, 5


def strict_json(text):
    """``json.loads`` that refuses NaN and Infinity."""
    def refuse(token):
        raise ValueError(f"non-standard JSON constant {token}")
    return json.loads(text, parse_constant=refuse)


def selfheal_path(torch, np, kernels, model_cfg, vocab_size, static_bench,
                  workdir, device=None):
    """BERT-large (75 units, flash on) evenly over 4 workers on the card,
    GPipe M=4, from an ``Allocator`` over the static profile.  First a
    tampered plan (worker 0's last unit dropped) must be refused by the
    pre-flight before any step; then ``Runner.train`` for 20 steps with
    ``TraceHook``, a 6x slowdown of worker 0 at iteration 4 and
    ``SelfHealHook`` on real clocks: one heal away from worker 0,
    verified again before the next step; then 5 untraced steps.  Every
    kernel's launches are set to 0 just before the run and read just
    after."""
    from skycomputing_tpu_torch.analysis import PlanError
    from skycomputing_tpu_torch.dynamics import (
        Allocator,
        FaultInjectionHook,
        FaultPlan,
        ParameterServer,
        WorkerManager,
        proxy_device_benchmarker,
    )
    from skycomputing_tpu_torch.ops import cross_entropy_loss
    from skycomputing_tpu_torch.parallel import PipelineModel, sgd
    from skycomputing_tpu_torch.runner import (
        Hook,
        Runner,
        SelfHealHook,
        TraceHook,
    )
    from skycomputing_tpu_torch.telemetry import analysis

    flash = kernels["flash_attention"]["fn"]
    data, labels = bert_batch(np, vocab_size)
    loader = [(data, labels)] * HEAL_STEPS
    wm = WorkerManager()
    wm.load_worker_pool_from_config([
        dict(name=f"node-{i}", device_config=dict(device_index=0))
        for i in range(BERT_WORKERS)])
    devices = [torch.device(device)] if device is not None else None
    on_card = device is None

    def sync():
        if on_card:
            torch.cuda.synchronize()

    allocator = Allocator(model_cfg, wm, static_bench,
                          proxy_device_benchmarker(wm, devices=devices))
    allocator.even_allocate()
    even = [len(w.model_config) for w in wm.worker_pool]
    ps = ParameterServer(model_cfg,
                         generator=torch.Generator().manual_seed(SEED))
    model = PipelineModel(wm, ps, sgd(BERT_LR), cross_entropy_loss,
                          devices=devices,
                          num_microbatches=BERT_MICROBATCHES)
    M, S = BERT_MICROBATCHES, len(model.stages)
    layers = sum(u["layer_type"] == "BertLayer_Head" for u in model_cfg)

    # 1. the tamper: refused before the first step, no B1 launch
    first = wm.get_by_rank(0)
    kept = first.model_config
    first.model_config = kept[:-1]
    tampered = Runner(model, ps, wm, max_epochs=1, max_iters=HEAL_STEPS)
    flash.launches = 0
    try:
        tampered.train(loader)
        refused = None
    except PlanError as exc:
        refused = exc
    check(refused is not None and "coverage" in str(refused)
          and tampered.iter == 0 and flash.launches == 0,
          f"the tampered plan is refused at iteration {tampered.iter} with "
          f"{[i.code for i in getattr(refused, 'issues', [])]}, "
          f"{flash.launches} B1 launches")
    first.model_config = kept

    # 2. the run: trace, fault, heal, and clocks around each step
    class Clock(Hook):
        """Registered last: its before_iter is the last before the step,
        its after_iter the last after it (the heal's cost included)."""

        def __init__(self):
            self.times, self.launches0 = [], 0
            self._t0 = None

        def before_iter(self, runner):
            self.launches0 = flash.launches
            self._t0 = time.perf_counter()

        def after_iter(self, runner):
            sync()
            self.times.append(time.perf_counter() - self._t0)

    class StepLaunches(Hook):
        """Registered first: B1's launches of the step alone."""

        def __init__(self, clock):
            self.clock, self.per_step, self.losses = clock, [], []

        def after_iter(self, runner):
            self.per_step.append(flash.launches - self.clock.launches0)
            self.losses.append(runner.model.stats.loss)

    trace_path = workdir / "selfheal_trace.json"
    clock = Clock()
    steps = StepLaunches(clock)
    heal = SelfHealHook(allocator, window=2, k_windows=2, threshold=1.35,
                        grace_iters=1, baseline_windows=1, max_heals=1,
                        measure_repeats=1, measure_inner=1,
                        solver_time_s=5.0)
    runner = Runner(model, ps, wm, max_epochs=1, max_iters=HEAL_STEPS)
    for hook in (steps, TraceHook(str(trace_path)), FaultInjectionHook(
            FaultPlan([dict(iter=HEAL_FAULT_ITER, kind="slowdown", worker=0,
                            factor=HEAL_FACTOR)])), heal, clock):
        runner.register_hook(hook)
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k["fn"].launches = 0
    t0 = time.perf_counter()
    runner.train(loader)
    sync()
    wall = time.perf_counter() - t0
    launches = {name: k["fn"].launches for name, k in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None

    # 3. the checks
    reports = runner.preflight_reports
    check(len(reports) == 2 and all(r.ok for r in reports),
          f"pre-flight ran {len(reports)} times in the run (before step 1 "
          f"and after the heal): {[r.summary() for r in reports]}")
    heals = [e for e in heal.events if e["kind"] == "heal"]
    check(len(heals) == 1 and heal.heals == 1,
          f"one heal: {[(e['kind'], e['iter']) for e in heal.events]}")
    ev = heals[0]
    div = ev["divergence"]
    worst = max(div, key=div.get)
    check(worst == 0 and div[0] > 1.3,
          f"the largest divergence is worker 0's: "
          f"{ {k: round(v, 3) for k, v in div.items()} }")
    slow = next(w for w in wm.worker_pool if w.stim_index == 0)
    cover = [u for w in sorted(wm.worker_pool, key=lambda w: w.rank)
             for u in (w.model_config or [])]
    check(len(slow.model_config or []) < even[0]
          and [id(u) for u in cover] == [id(u) for u in model_cfg],
          f"worker 0 holds {len(slow.model_config or [])} units (even "
          f"{even[0]}); partition {ev['old_partition']} -> "
          f"{ev['new_partition']}, a contiguous cover of "
          f"{len(model_cfg)} units")
    check(runner.iter == HEAL_STEPS and len(steps.losses) == HEAL_STEPS
          and all(np.isfinite(x) for x in steps.losses),
          f"{runner.iter} steps, every loss finite")
    per_step = 2 * layers * M if on_card else 0
    check(steps.per_step == [per_step] * HEAL_STEPS,
          f"B1 {per_step} launches in each step, before and after the heal: "
          f"{sorted(set(steps.per_step))}")
    heal_at = ev["iter"]
    times = clock.times
    baseline = times[1:HEAL_FAULT_ITER]
    # the slowed steps before the heal's own (whose window holds the
    # heal's cost)
    straggler = times[HEAL_FAULT_ITER:heal_at - 1]
    post = times[heal_at + 2:]
    check(len(straggler) >= 2 and len(post) >= 4
          and np.mean(post) < np.mean(straggler),
          f"post-heal mean step {np.mean(post) * 1e3:.1f} ms below the "
          f"straggler era's {np.mean(straggler) * 1e3:.1f} ms")

    # the trace
    trace = strict_json(trace_path.read_text())
    events = trace["traceEvents"]
    procs = analysis.lane_processes(events)
    stage_pids = {pid for pid, name in procs.items()
                  if analysis.STAGE_RE.match(name)}
    iters = sorted((e for e in events
                    if e["ph"] == "X" and e["name"] == "iter"),
                   key=lambda e: e["ts"])
    arc = [e for e in events if e["name"] == "self_heal"]
    check([e["ph"] for e in arc] == ["b", "e"]
          and arc[1]["args"]["outcome"] == "healed",
          f"the self_heal arc opens and closes: "
          f"{[(e['ph'], e.get('args')) for e in arc]}")
    heal_ts = arc[0]["ts"]
    before = analysis.analyze(
        [e for e in events if e["ph"] == "M" or e["ts"] < heal_ts])
    check(before["num_stages"] == S,
          f"{before['num_stages']} stage lanes before the heal")
    stages_after = len(ev["new_partition"])
    bad = []
    for i, it in enumerate(iters):
        t0_, t1_ = it["ts"], it["ts"] + it["dur"]
        n_stages = S if it["args"]["iter"] < heal_at else stages_after
        got = {name: sum(1 for e in events if e["ph"] == "X"
                         and e["name"] == name and e["pid"] in stage_pids
                         and t0_ <= e["ts"] < t1_)
               for name in ("fwd", "bwd", "update")}
        if got != dict(fwd=M * n_stages, bwd=M * n_stages, update=n_stages):
            bad.append((it["args"]["iter"], got))
    check(len(iters) == HEAL_STEPS and not bad,
          f"{len(iters)} iter spans, each with M x stages fwd and bwd and "
          f"one update per stage (mismatches: {bad})")
    report = analysis.analyze(events)
    check(report["dispatch"]["steps"] == HEAL_STEPS,
          f"{report['dispatch']['steps']} host_dispatch spans")

    def span_s(name):
        return sum(analysis.named_durations(events, name)) / 1e6

    heal_cost = dict(
        measure_s=span_s("selfheal.measure"),
        solve_s=span_s("allocator.solve"),
        profiles_and_calibrate_s=(span_s("allocator.profiles")
                                  + span_s("allocator.calibrate")),
        rebuild_s=span_s("selfheal.rebuild"),
        heal_iteration_s=times[heal_at - 1])

    # tracing off: 5 more steps on the healed partition
    off = Runner(model, ps, wm, max_epochs=1, max_iters=UNTRACED_STEPS)
    off_clock = Clock()
    off.register_hook(off_clock)
    off.train([(data, labels)] * UNTRACED_STEPS)
    out = dict(
        wall_s=wall, even_partition=even,
        partition_before=ev["old_partition"],
        partition_after=ev["new_partition"],
        heal_iter=heal_at, divergence=div, measured_s=ev["measured"],
        step_ms=[t * 1e3 for t in times],
        baseline_median_ms=float(np.median(baseline)) * 1e3,
        straggler_median_ms=float(np.median(straggler)) * 1e3,
        post_heal_median_ms=float(np.median(post)) * 1e3,
        straggler_over_baseline=float(np.median(straggler)
                                      / np.median(baseline)),
        post_over_baseline=float(np.median(post) / np.median(baseline)),
        heal_cost=heal_cost,
        preflight_s=[r.elapsed_s for r in reports],
        bubble_fraction=report["bubble_fraction"],
        dispatch_share=report["dispatch"]["share"],
        stage_utilization=report["stage_utilization"],
        peak_mem_gb=peak_gb, b1_per_step=per_step,
        traced_post_heal_median_ms=float(np.median(post)) * 1e3,
        untraced_median_ms=float(np.median(off_clock.times[1:])) * 1e3,
        trace_events=len(events), launches=launches)
    log(f"   selfheal: {json.dumps(out)}")
    del runner, off, tampered, model, ps
    return launches, out


# --------------------------------------------------------------------------
# phase 20: serving allocation and multi-stage serving
# --------------------------------------------------------------------------

SERVE_MEM_LIMIT_MB = 1000.0  # per worker: GPT-2 small's units need 1,542 MB


def serving_allocation(torch, np, gpt_mod, kv_dtype):
    """``Allocator.serving_allocate`` over GPT-2 small's 26 units (bf16)
    at the serving phases' operating point: ``DecodeModelBenchmarker``
    (16 rows, 512-token span, 512 pages of 16, ``kv_dtype``), four
    workers with the launcher phase's stimulated speeds (the proxy model
    timed on the card, times the stimulator's draws) and memory
    (``mem_limit`` over the stimulator's memory draws: budgets that
    bind, so the pages' size moves the partition).  Returns (the worker
    manager, a report)."""
    from skycomputing_tpu_torch.dynamics import (
        Allocator,
        proxy_device_benchmarker,
    )
    from skycomputing_tpu_torch.serving import (
        DecodeModelBenchmarker,
        paged_kv_mb_per_layer,
    )
    from skycomputing_tpu_torch.stimulator import Stimulator

    layer_cfgs = gpt_mod.gpt_layer_configs(
        gpt_mod.GptConfig(dropout_prob=0.0, dtype="bfloat16"),
        num_blocks=LAYERS)
    wm = worker_pool(4)
    for w in wm.worker_pool:
        w.extra_config["mem_limit"] = SERVE_MEM_LIMIT_MB
    devices = proxy_device_benchmarker(wm, stimulator=Stimulator(4))
    decode = DecodeModelBenchmarker(layer_cfgs, slots=16, max_len=512,
                                    num_pages=512, page_size=16,
                                    kv_dtype=kv_dtype)
    t0 = time.perf_counter()
    flops, mem = decode.benchmark()
    profile_s = time.perf_counter() - t0
    alloc = Allocator(layer_cfgs, wm, None, devices)
    t0 = time.perf_counter()
    alloc.serving_allocate(decode, max_time=5)
    solve_s = time.perf_counter() - t0
    budgets = {name: r["avai_mem"]
               for name, r in devices.benchmark().items()}
    kv_mb = paged_kv_mb_per_layer(layer_cfgs, 512, 16, kv_dtype=kv_dtype)
    stages, cursor = [], 0
    for w in sorted((w for w in wm.worker_pool if w.model_config),
                    key=lambda w: w.rank):
        n = len(w.model_config)
        stages.append(dict(
            worker=w.name, rank=w.rank, units=n,
            charged_mb=float(sum(mem[cursor:cursor + n])),
            kv_mb=float(sum(kv_mb[cursor:cursor + n])),
            solver_budget_mb=budgets[f"worker{w.rank}"],
            verifier_budget_mb=w.extra_config["mem_limit"]))
        cursor += n
    for row in stages:
        log(f"   {kv_dtype or 'fp'} stage {json.dumps(row)}")
    check(cursor == len(layer_cfgs) and len(stages) > 1 and all(
        r["charged_mb"] <= r["solver_budget_mb"] for r in stages),
          f"{kv_dtype or 'fp'} pages: partition "
          f"{[r['units'] for r in stages]} covers the "
          f"{len(layer_cfgs)} units over {len(stages)} stages, each "
          f"stage's charged MB within its budget")
    return wm, dict(partition=[r["units"] for r in stages], stages=stages,
                    profile_s=profile_s, solve_s=solve_s,
                    operating_point=decode.operating_point,
                    bottleneck=alloc.last_result.bottleneck,
                    gap=alloc.last_result.optimality_gap)


def same_run(what, e2e, one, kernel, streams, one_streams):
    """A multi-stage run against its one-stage twin: equal token streams,
    equal scheduling, and ``kernel``'s launches equal by body."""
    check(streams == one_streams,
          f"{what}: greedy streams equal the one-stage engine's "
          f"({len(streams)} requests x {len(streams[0])} tokens)")
    for key in ("prefill_waves", "decode_ticks", "spec_ticks"):
        check(e2e[key] == one[key], f"{what}: {key} {e2e[key]} == "
              f"{one[key]} at one stage")
    check(e2e["body_launches"][kernel] == one["body_launches"][kernel]
          and e2e["launches"] == one["launches"],
          f"{what}: {kernel} launches by body "
          f"{json.dumps(e2e['body_launches'][kernel])} equal the "
          f"one-stage engine's")


def stage_line(stage_runs, one_runs):
    """End-to-end numbers of runs at several stages against runs at one,
    taken in turns in one phase (a process's later phases run slower
    than its earlier ones, so only runs side by side compare): each
    run's value, then each side's mean."""
    keys = ("tokens_per_s", "ttft_p50_s", "ttft_p95_s", "tpot_p50_s",
            "tpot_p95_s", "peak_mem_gb")
    out = {}
    for key in keys:
        a = [e[key] for e in stage_runs]
        b = [e[key] for e in one_runs]
        ratio = (sum(a) * len(b)) / (sum(b) * len(a)) if sum(b) else None
        out[key] = dict(stages=a, one=b, ratio=ratio)
        log(f"   {key}: {len(stage_runs[0]['stages'])} stages "
            f"{', '.join(f'{v:.6g}' for v in a)}; 1 stage "
            f"{', '.join(f'{v:.6g}' for v in b)}; ratio of the means "
            f"{ratio}")
    return out


SPEC_PARTITION = (7, 7, 6, 6)  # stage 0 holds the draft's 5 units


def serving_stages_path(torch, serve_args, one_stage):
    """Phase 20.  ``one_stage``: the one-stage runs to hold the stages
    against, ``{"fp" | "int8" | "spec": (e2e, token streams)}``.  Returns
    (a report, the phase's launches by kernel, its tensor-core prefill
    launches by kernel)."""
    _, np, gpt_mod, ServingEngine, _, _ = serve_args
    from skycomputing_tpu_torch.analysis import PlanError

    stages_report, stage_launches = {}, {B1: 0, B2: 0, B3: 0}
    stage_prefill = {B2: 0, B3: 0}

    def count(e2e):
        for name, n in e2e["launches"].items():
            stage_launches[name] += n
        for name in stage_prefill:
            stage_prefill[name] += e2e["body_launches"][name][
                "tensor_core"]

    # 1-3: a serving allocation over four workers, fp and int8 pages,
    # served as stages of one engine on the card
    for kv_dtype, kernel, (one, one_streams) in (
            (None, B2, one_stage["fp"]), ("int8", B3, one_stage["int8"])):
        label = kv_dtype or "fp"
        wm, alloc = serving_allocation(torch, np, gpt_mod, kv_dtype)
        engine, reqs, snap, launches, e2e = serve(
            *serve_args, worker_manager=wm, kv_dtype=kv_dtype)
        count(e2e)
        check(e2e["stages"] == alloc["partition"],
              f"{label}: the engine's stages {e2e['stages']} are the "
              f"allocation's")
        steps = snap["prefill_waves"] + snap["decode_ticks"]
        check_launches(launches, {kernel: LAYERS * steps},
                       f"{label}, {len(e2e['stages'])} stages: 12 x "
                       f"{steps} steps of {kernel}")
        # 4: the same tokens and the same launches as one stage
        same_run(f"{label}, {len(e2e['stages'])} stages", e2e, one,
                 kernel, [list(r.tokens) for r in reqs], one_streams)
        del engine
        # 8: end-to-end at four stages against one, in turns (4, 1, 1, 4)
        turns = {"stages": [e2e], "one": []}
        for side, kw in (("one", {}), ("one", {}),
                         ("stages", dict(worker_manager=wm))):
            engine, _, _, _, again = serve(*serve_args, kv_dtype=kv_dtype,
                                           **kw)
            count(again)
            turns[side].append(again)
            del engine
        alloc.update(e2e=e2e, in_turns=stage_line(turns["stages"],
                                                  turns["one"]))
        stages_report[label] = alloc
        if kv_dtype is None:
            fp_wm = wm
    check(stages_report["fp"]["partition"]
          != stages_report["int8"]["partition"],
          f"the KV pages' size moves the partition: fp "
          f"{stages_report['fp']['partition']}, int8 "
          f"{stages_report['int8']['partition']}")

    # 5: speculation over an explicit partition whose stage 0 holds
    # the draft (embeddings and 2 blocks: 5 units)
    k, d, partition = 4, 2, list(SPEC_PARTITION)
    engine, reqs, snap, launches, e2e = serve(
        *serve_args, partition=partition, spec_k=k, draft_blocks=d,
        quiet_after=d)
    count(e2e)
    check(e2e["stages"] == partition and engine._draft_mb > 0,
          f"speculation over {partition}, the draft in stage 0, its "
          f"head charged {engine._draft_mb:.3f} MB there")
    one, one_streams = one_stage["spec"]
    same_run(f"speculative, {len(partition)} stages", e2e, one, B2,
             [list(r.tokens) for r in reqs], one_streams)
    stages_report["spec"] = dict(partition=partition, e2e=e2e,
                                 draft_mb=engine._draft_mb)
    del engine

    # 6: reconfigure mid-run (a page-count change, then a larger
    # bucket), at four stages and at one, on the same schedule
    changes = [(3, dict(num_pages=384)),
               (10, dict(buckets=(32, 64, 128, 256, 512)))]
    runs = {}
    for name, kw in (("stages", dict(worker_manager=fp_wm)),
                     ("one", {})):
        engine, reqs, snap, launches, e2e = serve(
            *serve_args, reconfigure=changes, **kw)
        count(e2e)
        check(engine.num_pages == 384
              and engine.bucketer.max_bucket == 512
              and all(len(st.slabs) == 0 or st.slabs[0][0].shape[0]
                      == 384 for st in engine.stages),
              f"{name}: 384 pages in every stage's slabs, buckets to "
              f"512")
        check(snap["preemptions"] == e2e["reconfigured"][0][
            "preemptions"] > 0 and e2e["reconfigured"][1][
            "preemptions"] == snap["preemptions"],
              f"{name}: the page-count change re-seated "
              f"{snap['preemptions']} running requests, the bucket "
              f"change none")
        runs[name] = (e2e, [list(r.tokens) for r in reqs])
        del engine
    same_run("reconfigured, 4 stages", runs["stages"][0], runs["one"][0],
             B2, runs["stages"][1], runs["one"][1])
    stages_report["reconfigure"] = dict(
        changes=[dict(tick=t, knobs={n: list(v) if isinstance(v, tuple)
                                     else v for n, v in c.items()})
                 for t, c in changes],
        stages=runs["stages"][0], one=runs["one"][0],
        in_turns=stage_line([runs["stages"][0]], [runs["one"][0]]),
        agreement_with_unreconfigured=agreement(runs["stages"][1],
                                                one_stage["fp"][1]))
    log(f"   reconfigured streams agree with the unreconfigured fp "
        f"run at {stages_report['reconfigure']['agreement_with_unreconfigured']:.3f}"
        f" of positions (reported: recomputed KV of evicted requests)")

    # 7: a plan over budget is refused before any slab is allocated: the
    # stage with the most KV pages gets a budget that holds its units
    # but not half its pages
    row = max(stages_report["fp"]["stages"], key=lambda r: r["kv_mb"])
    budget = row["charged_mb"] - row["kv_mb"] / 2
    next(w for w in fp_wm.worker_pool
         if w.name == row["worker"]).extra_config["mem_limit"] = budget
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    try:
        build_engine(ServingEngine, gpt_mod, LAYERS, "bfloat16", "cuda",
                     worker_manager=fp_wm)
    except PlanError as exc:
        refused = str(exc)
    else:
        raise AssertionError("an over-budget plan was not refused")
    after = torch.cuda.memory_allocated()
    log(f"   refused: {refused.splitlines()[1].strip()}")
    check(after == before and "KV pages" in refused
          and f"KV slabs are {row['kv_mb']:.6g} MB" in refused,
          f"the pre-flight refused {row['worker']} at {budget:.1f} MB (its "
          f"units and half its {row['kv_mb']:.1f} MB of pages), naming the "
          f"KV pages; card memory {before} B before, {after} B after")
    stages_report["refused"] = refused
    stages_report["launches"] = stage_launches
    return stages_report, stage_launches, stage_prefill



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
        from skycomputing_tpu_torch.ops.flash_attention import flash_attention
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
        "flash_attention": dict(
            fn=flash_attention, route="cuda",
            source="skycomputing_tpu_torch/ops/csrc/flash_attention.cu",
            replaces="skycomputing_tpu/ops/flash_attention.py:26"),
    }
    serve_args = (torch, np, gpt_mod, ServingEngine, Request, kernels)

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
        ptxas = ptxas_by_label(_build)
        report["ptxas"] = ptxas
        for label, info in ptxas.items():
            log(f"   ptxas {label}: {json.dumps(info)}")
        new_bodies = {label: info for label, info in ptxas.items()
                      if "_kernel_mma<" in label or "_kernel_decode<" in label}
        check(len(new_bodies) > 0 and all(
            info.get("spill_store_bytes", 1) == 0
            and info.get("spill_load_bytes", 1) == 0
            for info in new_bodies.values()),
              f"{len(new_bodies)} instantiations of the tensor-core and "
              f"decode bodies, none spilling")

    with phase("kernels against plain versions"):
        report["spin_ms"] = spin_ms(torch)
        log(f"   spin kernel ahead of each timed call: "
            f"{report['spin_ms']:.3f} ms")
        attn = kernel_checks(torch, np, ptxas)
        report["kernels"] = attn
        report["kernel_edges"] = paged_edge_checks(torch, np, ptxas)

    with phase("flash attention (B1) against its plain version"):
        flash = flash_checks(torch, np, ptxas)
        report["flash_kernel"] = flash
        report["flash_edges"] = flash_edge_checks(torch, np, ptxas)

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
        check_bodies(e2e, B2, LAYERS * snap["prefill_waves"],
                     LAYERS * snap["decode_ticks"])
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
        check_bodies(e2e, B3, LAYERS * snap["prefill_waves"],
                     LAYERS * snap["decode_ticks"])
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
        spec, spec_streams = {}, {}
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
            prefill = LAYERS * snap["prefill_waves"]
            check_bodies(e2e, kernel, prefill, expect[kernel] - prefill)
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
            spec_streams[kv_dtype or "fp"] = [list(r.tokens) for r in reqs]
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
        check_bodies(e2e, B2, LAYERS * snap["prefill_waves"],
                     LAYERS * snap["decode_ticks"])
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
        check_bodies(e2e, B3, LAYERS * snap["prefill_waves"],
                     LAYERS * snap["decode_ticks"])
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

    with phase("profile: device time by kernel over a prefill wave and "
               "decode ticks"):
        prof_report = {}
        for label, kw, kernel in (("fp", {}, B2),
                                  ("int8", dict(kv_dtype="int8"), B3)):
            engine = build_engine(ServingEngine, gpt_mod, LAYERS, "bfloat16",
                                  "cuda", **kw)
            for r in requests_for(np, Request, n=16, new_tokens=8, seed=3):
                engine.submit(r)
            log(f"   {label} pages, one prefill wave:")
            prof_report[label + "_prefill"] = profile_prefill_wave(
                torch, engine, kernels[kernel]["fn"])
            engine.step()  # admission + prefill waves + a first decode tick
            ticks0 = engine.stats.decode_ticks
            launches0 = kernels[kernel]["fn"].launches
            log(f"   {label} pages:")
            out, rows = profile_window(
                torch, lambda: [engine.step() for _ in range(4)])
            kernel_us = sum(us for us, key, _ in rows
                            if "paged_attention_kernel" in key)
            busy_us = sum(us for us, _, _ in rows)
            out.update(paged_device_ms=kernel_us / 1e3,
                       paged_share=kernel_us / busy_us if busy_us else None,
                       paged_kernels=sorted({key[:100] for _, key, _ in rows
                                             if "paged_attention" in key}))
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

    with phase("bf16 flash on against off: BERT-large width, depth 2"):
        cmp = flash_on_off_bf16(torch, np, kernels)
        log(f"   {json.dumps(cmp)}")
        check(cmp["flash_launches"] == 2 * 2 * 2 * BERT_MICROBATCHES
              and cmp["einsum_run_flash_launches"] == 0,
              f"B1 launched {cmp['flash_launches']} times with the flag on "
              f"(2 steps x 2 layers x {BERT_MICROBATCHES} microbatches x "
              f"forward and remat), {cmp['einsum_run_flash_launches']} off")
        check(cmp["max_loss_rel_diff"] <= 2e-2,
              f"bf16 losses with flash on and off within "
              f"{cmp['max_loss_rel_diff']:.3g} <= 2e-2 relative")
        report["flash_on_off_bf16"] = cmp
        gc.collect()
        torch.cuda.empty_cache()

    with phase("training path: BERT-large pipeline, 4 stages, GPipe M=4"):
        model, data, labels, launches, e2e = train_bert(torch, np, kernels)
        per_step = 2 * 24 * BERT_MICROBATCHES
        check_launches(launches, {B1: per_step * BERT_STEPS},
                       f"{per_step} B1 launches per step (24 layers x "
                       f"{BERT_MICROBATCHES} microbatches x forward and "
                       f"rematerialized forward) x {BERT_STEPS} steps")
        log(f"   step {e2e['step_s_median_2_5'] * 1e3:.1f} ms (median of "
            f"steps 2-{BERT_STEPS}), {e2e['tokens_per_s']:.0f} tokens/s, "
            f"MFU {e2e['mfu']:.2%}, peak {e2e['peak_mem_gb']:.2f} GB")
        report["e2e_train"] = e2e

    with phase("profile: device time by kernel over one train step"):
        b1_before = flash_attention.launches
        out, rows = profile_window(
            torch, lambda: model.train_step(data, labels))
        b1_us = sum(us for us, key, _ in rows
                    if "flash_attention_kernel" in key)
        total_us = sum(us for us, _, _ in rows)
        b1_launches = flash_attention.launches - b1_before
        out.update(flash_launches=b1_launches,
                   flash_device_ms=b1_us / 1e3,
                   flash_us_per_launch=b1_us / max(b1_launches, 1),
                   flash_share=b1_us / total_us if total_us else None,
                   copy_launches=sum(n for _, key, n in rows
                                     if "copy" in key))
        log(f"   profile train step: "
            f"{json.dumps({k: v for k, v in out.items() if k != 'top'})}")
        report["profile_train"] = out
        del model
        gc.collect()
        torch.cuda.empty_cache()

    with phase("trainer card against CPU: depth 2, float32"):
        cmp = trainer_card_vs_cpu(torch, np)
        log(f"   {json.dumps(cmp)}")
        check(cmp["max_loss_rel_diff"] <= 1e-4,
              f"card and CPU losses within {cmp['max_loss_rel_diff']:.3g} "
              f"<= 1e-4 relative")
        check(cmp["max_param_abs_diff"] <= 1e-5,
              f"card and CPU parameters within "
              f"{cmp['max_param_abs_diff']:.3g} <= 1e-5 after two steps")
        report["trainer_card_vs_cpu"] = cmp
        gc.collect()
        torch.cuda.empty_cache()

    bert_cfg, bert_cfgs = bert_units()
    with phase("profilers: BERT-large's 75 units and 4 workers"):
        static_bench, timed_bench, prof = profilers(
            torch, np, kernels, bert_cfgs, bert_cfg.vocab_size)
        log(f"   {prof['distinct_units']} distinct units timed in "
            f"{prof['timed_s']:.2f} s, counted in {prof['static_s']:.2f} s; "
            f"memory estimate {prof['mem_total_gb']:.3f} GB; B1 launched "
            f"{prof['launches'][B1]} times")
        report["profilers"] = prof
        gc.collect()
        torch.cuda.empty_cache()

    with phase("launcher: optimal allocation, 1F1B M=4, BERT-large"):
        workdir = ROOT / "build" / "chip_smoke"
        shutil.rmtree(workdir, ignore_errors=True)
        try:
            launcher_launches, e2e = launcher_path(torch, np, kernels,
                                                   workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        gpipe = report["e2e_train"]
        for key in ("step_s_median_2_5", "tokens_per_s", "mfu",
                    "peak_mem_gb"):
            log(f"   {key}: 1F1B optimal {e2e[key]:.6g}, GPipe even "
                f"{gpipe[key]:.6g}")
        report["e2e_launcher"] = e2e
        gc.collect()
        torch.cuda.empty_cache()

    with phase("headline pass: even, calibration, optimal (paper slowdowns)"):
        head = headline(np, bert_cfgs, static_bench, timed_bench,
                        bert_cfg.vocab_size)
        log(f"   partitions: even {head['even']['partition']}, optimal "
            f"{head['optimal']['partition']} (solver gap "
            f"{head['solver_gap']:.3g}); speedup "
            f"{json.dumps(head['speedup'])}")
        report["headline"] = head
        gc.collect()
        torch.cuda.empty_cache()

    with phase("GLUE path: MNLI from TSVs, the launcher with eval, metrics "
               "and NaN-guard hooks, then Runner.evaluate"):
        workdir = ROOT / "build" / "chip_smoke_glue"
        shutil.rmtree(workdir, ignore_errors=True)
        try:
            eval_launches, dev, glue = glue_path(torch, np, kernels, workdir,
                                                 ptxas=ptxas)
            cmp = eval_card_vs_cpu(torch, np, dev)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        log(f"   card against CPU: {json.dumps(cmp)}")
        check(cmp["loss_rel_diff"] <= 1e-4,
              f"eval losses on the card and the CPU (depth 2, float32) "
              f"within {cmp['loss_rel_diff']:.3g} <= 1e-4 relative")
        check(cmp["cuda"]["predictions"] == cmp["cpu"]["predictions"],
              f"equal predictions on the card and the CPU "
              f"({len(cmp['cpu']['predictions'])} examples)")
        report["glue"] = glue
        report["eval_card_vs_cpu"] = cmp
        gc.collect()
        torch.cuda.empty_cache()

    with phase("bench: python -m skycomputing_tpu_torch.bench"):
        report["bench"] = bench_run(np, BENCH_SMOKE_ENV, timeout_s=420)

    with phase("pre-flight, tracing and self-heal: BERT-large, 4 workers, "
               "B1 on"):
        workdir = ROOT / "chiprun_out"
        workdir.mkdir(exist_ok=True)
        heal_launches, heal = selfheal_path(
            torch, np, kernels, bert_cfgs, bert_cfg.vocab_size, static_bench,
            workdir)
        log(f"   step medians: baseline {heal['baseline_median_ms']:.1f} "
            f"ms, straggler {heal['straggler_median_ms']:.1f} ms "
            f"({heal['straggler_over_baseline']:.3f}x), after the heal "
            f"{heal['post_heal_median_ms']:.1f} ms "
            f"({heal['post_over_baseline']:.3f}x); partitions "
            f"{heal['partition_before']} -> {heal['partition_after']}")
        log(f"   heal cost: {json.dumps(heal['heal_cost'])}; pre-flight "
            f"{heal['preflight_s']} s; bubble fraction "
            f"{heal['bubble_fraction']}, dispatch share "
            f"{heal['dispatch_share']}; peak {heal['peak_mem_gb']:.2f} GB "
            f"(GPipe phase {report['e2e_train']['peak_mem_gb']:.2f} GB); "
            f"tracing on {heal['traced_post_heal_median_ms']:.1f} ms, off "
            f"{heal['untraced_median_ms']:.1f} ms")
        report["selfheal"] = heal
        gc.collect()
        torch.cuda.empty_cache()

    with phase("serving allocation and multi-stage serving: GPT-2 small, "
               "4 workers"):
        stages_report, stage_launches, stage_prefill = serving_stages_path(
            torch, serve_args, dict(
                fp=(report["e2e"], fp_streams),
                int8=(report["e2e_int8"], int8_streams),
                spec=(report["e2e_spec"]["fp"], spec_streams["fp"])))
        report["serving_stages"] = stages_report
        gc.collect()
        torch.cuda.empty_cache()

    def entry(name, kernel_launches, rows=attn, case="decode", label=None):
        row = next(r for r in rows if r["kernel"] == name
                   and r["case"] == case and r["dtype"] == "bfloat16")
        k = kernels[name]
        return dict(name=label or name, route=k["route"], source=k["source"],
                    replaces=k["replaces"], launches=kernel_launches,
                    max_abs_err=row["max_abs_err"], ms=row["ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"], library_ms=row["library_ms"])

    # each kernel's launches from the paths that are its own: B2 from the
    # fp serving path and the multi-stage phase, B3 from the int8 path and
    # the multi-stage phase, B1 from the launcher's run, the GLUE path's
    # evaluation and the self-heal run;
    # the prefill entries are the tensor-core body's launches in those
    # runs, beside its time at the prefill wave's shape
    fp_bodies = report["e2e"]["body_launches"][B2]
    int8_bodies = report["e2e_int8"]["body_launches"][B3]
    line = {"kernels": [
        entry(B2, main_launches[B2] + stage_launches[B2]),
        entry(B2, fp_bodies["tensor_core"] + stage_prefill[B2],
              case="prefill",
              label=f"{B2}:prefill"),
        entry(B3, int8_launches[B3] + stage_launches[B3]),
        entry(B3, int8_bodies["tensor_core"] + stage_prefill[B3],
              case="prefill",
              label=f"{B3}:prefill"),
        entry(B1, launcher_launches[B1] + eval_launches[B1]
              + heal_launches[B1], flash, "bert_large_L128")]}
    # B1's error: the worst over its main case and the eval path's calls
    line["kernels"][-1]["max_abs_err"] = max(
        [line["kernels"][-1]["max_abs_err"]]
        + [r["max_abs_err"] for r in report["glue"]["flash_eval_shapes"]])
    check(all(k["launches"] > 0 for k in line["kernels"]),
          "every kernel of the line launched on its path")
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
