#!/usr/bin/env python
"""Serving benchmarks for the port (``tools/bench_serving.py`` on the
PyTorch engine), on one GPT instance made from a seed.

Six sections, each a function of ``(layer_cfgs, params, ...)`` that
``chip_smoke.py`` also calls, each holding its engines to the one-shot
reference (``models/gpt.generate`` over the full-sequence forward):

- **continuous vs static batching**: the same slot-layout engine under
  both policies; token-identical, the throughput ratio reported;
- **paged vs slot at equal pool MB** (full run / ``--paged``): the slot
  layout charges one ``max_len`` row per request, the paged layout
  ``ceil(len / page_size)`` pages; the same backlog on both, the gate is
  ``sustained_concurrency`` (mean live requests while a backlog exists)
  above 2x, every paged stream equal to ``generate``'s and the slot
  engine's;
- **shared-prefix TTFT** (with ``--paged``): after one cold request,
  same-prefix requests prefill only their tails (radix hits counted);
- **chunked prefill under backlog** (full run / ``--chunked``): the
  ``interference`` mix (``workload/mixes.py``) on a paged engine with and
  without ``prefill_chunk``; ITL and TPOT tails, token identity;
- **speculative decoding** (full run / ``--spec``): its own model with a
  1,024-token vocabulary whose tail blocks' residual projections are
  zeroed (:func:`zero_tail_residuals`: the draft is exact, accept rate
  1.0, stamped ``draft_exact``), against the plain engine;
- **kernel and int8 pages** (full run / ``--kernel``): the live page-table
  width against ``gather_pages="full"``, int8 pages (pages per MB >=
  1.9x, greedy-stream agreement, quant counters), and the paged-attention
  kernel against its plain version on its own tiny instance — on the
  card only; on the CPU that leg reports ``{"skipped": "no CUDA
  device"}`` and gates nothing.

The JSON schema, gates and exit code are the reference's, with three
changes of substance.  PyTorch compiles no programs: each run's
``steady_state_compiles`` (and the gates named ``zero_steady_state_
recompiles*``) count the kernel libraries loaded or built
(``ops/_build.load.count``) inside the measured window, which must be
0.  The kernel leg's gates are ``kernel_matches_plain`` and
``zero_steady_state_recompiles_kernel`` in place of the Pallas leg's,
and the kernel section's own are ``zero_steady_state_recompiles_live``
and ``_int8``.  The equal-pool-MB stamp counts the model dtype's bytes.
Timing gates (:data:`TIMING_GATES`) join only outside ``--smoke``, as in
the reference.

Usage::

    python -m skycomputing_tpu_torch.bench_serving              # all sections
    python -m skycomputing_tpu_torch.bench_serving --smoke      # seconds-scale
    python -m skycomputing_tpu_torch.bench_serving --paged      # one section
    python -m skycomputing_tpu_torch.bench_serving --chunked
    python -m skycomputing_tpu_torch.bench_serving --spec
    python -m skycomputing_tpu_torch.bench_serving --kernel
    python -m skycomputing_tpu_torch.bench_serving --out path.json --stages 2

It runs on the card unless ``--device cpu`` is given, and writes its
report to ``--out`` (default ``build/BENCH_serving.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

#: gates that judge a performance claim, reported (not asserted) by
#: ``chip_smoke.py``: every one but the concurrency gain judges a time and
#: joins only outside ``--smoke`` (the smoke model's millisecond steps
#: drown in scheduler noise)
TIMING_GATES = frozenset({
    "concurrency_gain_over_2x", "shared_prefix_ttft_drops",
    "tpot_tail_within_3x", "itl_tail_within_3x", "itl_p95_improved_2x",
    "ttft_envelope_1_2x", "speedup_over_1_5x", "decode_tick_improves",
})
#: the int8 pool's fidelity gates (bounded error by design): gated by the
#: bench, reported by ``chip_smoke.py`` beside the timing gates
FIDELITY_GATES = frozenset({
    "int8_agreement_over_0_7", "int8_first_token_over_0_9",
})


def operating_points(smoke: bool) -> Tuple[Dict[str, Any], ...]:
    """(model config kwargs, then the operating points of the sections:
    continuous/static, paged/slot with shared prefix, chunked backlog,
    speculation, kernel/int8), the reference's ``--smoke`` and full-run
    values."""
    if smoke:
        model = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                     num_attention_heads=2, max_position_embeddings=96,
                     dropout_prob=0.0, dtype="float32")
        bench_cfg = dict(slots=3, max_len=96, buckets=(8, 16),
                         prefill_batch=1, n_requests=6,
                         lo_new=2, hi_new=12)
        # paged A/B at equal pool MB: 3 slots x 48 == 18 pages x 8
        paged_cfg = dict(slots=3, max_len=48, buckets=(8, 16),
                         prefill_batch=1, page_size=8,
                         max_pages_per_request=6, num_pages=18,
                         max_concurrency=10, n_requests=12,
                         lo_new=2, hi_new=6,
                         shared_prefix_len=12, shared_tail_len=4,
                         shared_new_tokens=3)
        chunk_cfg = dict(slots=3, max_len=48, buckets=(8, 16, 32),
                         prefill_batch=2, page_size=8,
                         max_pages_per_request=6, num_pages=18,
                         max_concurrency=6,
                         n_churn=4, churn_prompt=(24, 33),
                         churn_new=(2, 4),
                         n_small=6, small_prompt=(4, 9),
                         small_new=(2, 5),
                         prefill_chunk=8, max_chunk_rows=1)
        spec_cfg = dict(slots=3, max_len=48, buckets=(8,),
                        prefill_batch=1, page_size=8,
                        max_pages_per_request=6, num_pages=18,
                        max_concurrency=3, n_requests=4,
                        lo_new=6, hi_new=10,
                        spec_k=2, draft_blocks=1, vocab_size=512)
        # kernel/quant A/B: table width 10 pages, live spans <= 3 pages
        kernel_cfg = dict(slots=3, max_len=80, buckets=(8, 16),
                          prefill_batch=2, page_size=8,
                          max_pages_per_request=10, num_pages=30,
                          max_concurrency=8, n_requests=8,
                          lo_new=2, hi_new=6, span_warm_new=30,
                          workload_span=24)
        return model, bench_cfg, paged_cfg, chunk_cfg, spec_cfg, kernel_cfg
    model = dict(vocab_size=8192, hidden_size=256, num_hidden_layers=8,
                 num_attention_heads=8, max_position_embeddings=320,
                 dropout_prob=0.0, dtype="float32")
    bench_cfg = dict(slots=4, max_len=192, buckets=(16, 32, 64),
                     prefill_batch=2, n_requests=20,
                     lo_new=4, hi_new=96)
    # paged A/B at equal pool MB: 4 slots x 192 == 48 pages x 16
    paged_cfg = dict(slots=4, max_len=192, buckets=(16, 32, 64),
                     prefill_batch=2, page_size=16,
                     max_pages_per_request=12, num_pages=48,
                     max_concurrency=16, n_requests=24,
                     lo_new=6, hi_new=40,
                     shared_prefix_len=48, shared_tail_len=8,
                     shared_new_tokens=8)
    # chunked backlog: long-prompt churners whose 4 x 256 prefill waves
    # starve decode ticks, short requests measuring the per-token damage
    chunk_cfg = dict(slots=4, max_len=288,
                     buckets=(16, 32, 64, 128, 256),
                     prefill_batch=4, page_size=16,
                     max_pages_per_request=18, num_pages=64,
                     max_concurrency=8,
                     n_churn=16, churn_prompt=(200, 257),
                     churn_new=(4, 7),
                     n_small=24, small_prompt=(8, 17),
                     small_new=(4, 9),
                     prefill_chunk=32, max_chunk_rows=2)
    # decode-bound speculation on its own model with a 1,024-token
    # vocabulary: the draft pays the LM head every draft step, and a
    # large head would measure vocabulary size, not speculation
    spec_cfg = dict(slots=12, max_len=96, buckets=(16,),
                    prefill_batch=2, page_size=16,
                    max_pages_per_request=6, num_pages=72,
                    max_concurrency=12, n_requests=16,
                    lo_new=32, hi_new=64,
                    spec_k=10, draft_blocks=1, vocab_size=1024)
    # kernel/quant A/B: an 18-page table serving <= 7-page live spans
    kernel_cfg = dict(slots=4, max_len=288, buckets=(16, 32, 64),
                      prefill_batch=2, page_size=16,
                      max_pages_per_request=18, num_pages=96,
                      max_concurrency=12, n_requests=16,
                      lo_new=6, hi_new=40, span_warm_new=100,
                      workload_span=104)
    return model, bench_cfg, paged_cfg, chunk_cfg, spec_cfg, kernel_cfg


def build_workload(rng, n_requests, buckets, max_len, lo_new, hi_new):
    """Mixed-length request specs: (prompt, max_new_tokens) tuples.

    Prompt lengths spread across every bucket and generation lengths
    across ``lo_new..hi_new`` — the heterogeneity continuous batching
    exploits.  The reference's draw order."""
    specs = []
    for i in range(n_requests):
        bucket = buckets[i % len(buckets)]
        low = 2 if bucket == min(buckets) else buckets[
            buckets.index(bucket) - 1] + 1
        plen = int(rng.integers(low, bucket + 1))
        n_new = int(rng.integers(lo_new, hi_new + 1))
        n_new = min(n_new, max_len - plen)
        prompt = rng.integers(1, 400, (plen,)).astype(np.int32)
        specs.append((prompt, n_new))
    return specs


def build_interference_workload(rng, icfg):
    """The prefill-vs-decode interference mix, by name from
    ``workload/mixes.py``."""
    from .workload.mixes import build_mix

    return build_mix("interference", rng, icfg=icfg)


def _builds() -> int:
    from .ops import _build

    return _build.load.count


def _engine(layer_cfgs, params, cfg, paged=False, **kw):
    """A ``ServingEngine`` at ``cfg``'s operating point (``partition``
    and ``device`` among its keys); ``paged`` adds the page geometry."""
    from .serving import ServingEngine

    if paged:
        kw.update(kv_layout="paged", page_size=cfg["page_size"],
                  num_pages=cfg["num_pages"],
                  max_pages_per_request=cfg["max_pages_per_request"],
                  max_concurrency=cfg["max_concurrency"])
    return ServingEngine(
        layer_cfgs, params, num_slots=cfg["slots"],
        max_len=cfg["max_len"], buckets=cfg["buckets"],
        prefill_batch=cfg["prefill_batch"], partition=cfg.get("partition"),
        device=cfg.get("device"), **kw)


def _bucket_warm(Request, buckets, new_tokens=2):
    # distinct leading tokens per bucket: with the prefix cache live an
    # arange-style warm set would let a larger bucket's prompt hit a
    # smaller one's registered prefix and prefill only a short tail
    return [Request(prompt=np.full((b,), b + 1, np.int32),
                    max_new_tokens=new_tokens) for b in buckets]


def run_mode(layer_cfgs, params, specs, static, smoke_cfg):
    """One slot-layout run of the workload under continuous or static
    batching, after a warm-up of one request per bucket."""
    from .serving import Request

    engine = _engine(layer_cfgs, params, smoke_cfg, static_batching=static)
    engine.run([Request(prompt=np.arange(1, b + 1, dtype=np.int32),
                        max_new_tokens=2) for b in smoke_cfg["buckets"]])
    requests = [Request(prompt=p, max_new_tokens=n) for p, n in specs]
    builds0 = _builds()
    t0 = time.perf_counter()
    outputs = engine.run(requests)
    # run() drains fully and every step ends in a copy of its tokens to
    # the host, so the clock closes over completed device work
    wall_s = time.perf_counter() - t0
    generated = sum(n for _, n in specs)
    return {
        "policy": "static" if static else "continuous",
        "wall_s": wall_s,
        "tokens_per_s": generated / wall_s,
        "generated_tokens": generated,
        "steady_state_compiles": _builds() - builds0,
        "stats": engine.stats.snapshot(),
    }, {r.request_id: outputs[r.request_id] for r in requests}, requests


def run_concurrency_mode(layer_cfgs, params, specs, paged, pcfg):
    """One sustained-concurrency run: submit the whole backlog, step to
    drain, sample live-request counts.  ``sustained_concurrency`` is the
    mean of the samples taken while a backlog still existed."""
    from .serving import Request

    engine = _engine(layer_cfgs, params, pcfg, paged=paged)
    engine.run(_bucket_warm(Request, pcfg["buckets"]))
    if paged:
        # sequentially, so the second request hits the first's prefix
        # and the copy-on-write path runs before the measured window
        warm_sys = np.arange(1, pcfg["page_size"] + 5, dtype=np.int32)
        for tail in (7, 9):
            engine.run([Request(prompt=np.concatenate(
                [warm_sys, np.array([tail], np.int32)]), max_new_tokens=2)])
    requests = [Request(prompt=p, max_new_tokens=n) for p, n in specs]
    builds0 = _builds()
    for r in requests:
        engine.submit(r)
    samples = []
    t0 = time.perf_counter()
    while engine.has_work():
        backlog = len(engine.queued_requests) > 0
        engine.step()
        samples.append((len(engine.running_requests), backlog))
    wall_s = time.perf_counter() - t0
    loaded = [r for r, b in samples if b]
    return {
        "layout": "paged" if paged else "slot",
        "wall_s": wall_s,
        "sustained_concurrency": sum(loaded) / len(loaded) if loaded else 0.0,
        "peak_concurrency": max((r for r, _ in samples), default=0),
        "steady_state_compiles": _builds() - builds0,
        "pool_mb_per_stage_layer": (pcfg["pool_positions"]
                                    * pcfg["kv_mb_per_position"]),
        "stats": engine.stats.snapshot(),
    }, {r.request_id: r.output() for r in requests}, requests


def run_shared_prefix(layer_cfgs, params, pcfg, n_warm=4):
    """Sequential same-system-prompt requests on a fresh paged engine:
    request 0 is the cold prefill, requests 1..n hit the radix cache and
    prefill only their tails."""
    from .serving import Request

    engine = _engine(layer_cfgs, params, pcfg, paged=True)
    rng = np.random.default_rng(17)
    shared_len = pcfg["shared_prefix_len"]
    tail_len = pcfg["shared_tail_len"]
    warm_sys = rng.integers(1, 400, (shared_len,)).astype(np.int32)
    engine.run(_bucket_warm(Request, pcfg["buckets"]))
    for _ in range(2):  # sequential: the second hit runs the COW path
        engine.run([Request(prompt=np.concatenate(
            [warm_sys, rng.integers(1, 400, (tail_len,)).astype(np.int32)]),
            max_new_tokens=2)])
    warm_snap = engine.stats.snapshot()
    system = rng.integers(1, 400, (shared_len,)).astype(np.int32)
    ttfts, requests = [], []
    for _ in range(1 + n_warm):
        tail = rng.integers(1, 400, (tail_len,)).astype(np.int32)
        r = Request(prompt=np.concatenate([system, tail]),
                    max_new_tokens=pcfg["shared_new_tokens"])
        engine.run([r])
        ttfts.append(r.ttft_s())
        requests.append(r)
    snap = engine.stats.snapshot()
    cold, warm_ttfts = ttfts[0], ttfts[1:]
    mean_warm = sum(warm_ttfts) / len(warm_ttfts)
    return {
        "shared_prefix_len": shared_len,
        "tail_len": tail_len,
        "prompt_len": shared_len + tail_len,
        "ttft_cold_s": cold,
        "ttft_warm_s": warm_ttfts,
        "ttft_warm_mean_s": mean_warm,
        "ttft_warm_over_cold": mean_warm / cold if cold else None,
        "prefix_hits": snap["prefix_hits"] - warm_snap["prefix_hits"],
        "prefix_tokens_reused": (snap["prefix_tokens_reused"]
                                 - warm_snap["prefix_tokens_reused"]),
        "cow_copies": snap["cow_copies"] - warm_snap["cow_copies"],
    }, requests


def _pct(xs, q):
    return float(np.percentile(xs, q)) if xs else None


def slo_percentiles(requests):
    """Request-level TTFT/TPOT percentiles (the SLO the chunked gate
    judges: per request, so prefill-wave stalls land in TPOT)."""
    ttft = [r.ttft_s() for r in requests if r.ttft_s() is not None]
    tpot = [r.tpot_s() for r in requests if r.tpot_s() is not None]
    return {
        "ttft_p50_s": _pct(ttft, 50), "ttft_p95_s": _pct(ttft, 95),
        "tpot_p50_s": _pct(tpot, 50), "tpot_p95_s": _pct(tpot, 95),
    }


def _span_warm(engine, Request, cfg):
    """One short-prompt request decoding across the virtual span, so
    every live table width runs before the measured window."""
    span = cfg["max_pages_per_request"] * cfg["page_size"]
    engine.run([Request(prompt=np.full((2,), 401, np.int32),
                        max_new_tokens=span - 4)])


def run_backlog(layer_cfgs, params, specs, pcfg, prefill_chunk):
    """One backlog run on a paged engine (chunked when ``prefill_chunk``
    is set): the whole workload submits at once; per-token inter-token
    latency (ITL) is sampled as the tokens arrive."""
    from .serving import Request

    kw = {}
    if prefill_chunk:
        kw.update(prefill_chunk=prefill_chunk,
                  max_chunk_rows=pcfg.get("max_chunk_rows"))
    engine = _engine(layer_cfgs, params, pcfg, paged=True, **kw)
    engine.run(_bucket_warm(Request, pcfg["buckets"]))
    _span_warm(engine, Request, pcfg)
    requests = [Request(prompt=p, max_new_tokens=n) for p, n in specs]
    builds0 = _builds()
    for r in requests:
        engine.submit(r)
    last_n = {r.request_id: 0 for r in requests}
    last_t: Dict[int, float] = {}
    itl: List[float] = []
    t0 = time.perf_counter()
    while engine.has_work():
        engine.step()
        now = time.perf_counter()
        for r in requests:
            n = len(r.tokens)
            if n > last_n[r.request_id]:
                if r.request_id in last_t:
                    itl.append((now - last_t[r.request_id])
                               / (n - last_n[r.request_id]))
                last_n[r.request_id] = n
                last_t[r.request_id] = now
    wall_s = time.perf_counter() - t0
    snap = engine.stats.snapshot()
    result = {
        "chunked": bool(prefill_chunk),
        "prefill_chunk": prefill_chunk or None,
        "wall_s": wall_s,
        "steady_state_compiles": _builds() - builds0,
        "prefill_chunks": snap["prefill_chunks"],
        "chunk_stalls": snap["chunk_stalls"],
        "itl_p50_s": _pct(itl, 50),
        "itl_p95_s": _pct(itl, 95),
        "stats": snap,
    }
    result.update(slo_percentiles(requests))
    return result, {r.request_id: r.output() for r in requests}, requests


def zero_tail_residuals(layer_cfgs, params_list, draft_blocks):
    """New state dicts with the residual output projections (``c_proj``
    weight and bias) of every block at or past ``draft_blocks`` zeroed,
    making those blocks identities: the prefix-slice draft then agrees
    with the target at every position (accept rate 1.0), so the spec
    section measures the machinery's ceiling.  Zeroed matmuls cost the
    same FLOPs.  ``params_list`` is left as it was."""
    new = list(params_list)
    block = -1
    for i, cfg in enumerate(layer_cfgs):
        lt = cfg.get("layer_type")
        if lt == "GptBlock_Attn":
            block += 1
        if lt in ("GptBlock_Attn", "GptBlock_Mlp") and block >= draft_blocks:
            layer = dict(new[i])
            for key in ("c_proj.weight", "c_proj.bias"):
                layer[key] = torch.zeros_like(layer[key])
            new[i] = layer
    return new


def run_spec_mode(layer_cfgs, params, specs, pcfg, spec_k):
    """One decode-bound run: speculative when ``spec_k`` > 0, plain
    otherwise, on the same params; the median of 3 timed repeats."""
    from .serving import Request

    kw = {}
    if spec_k:
        kw.update(spec_k=spec_k, draft_blocks=pcfg["draft_blocks"])
    engine = _engine(layer_cfgs, params, pcfg, paged=True, **kw)
    engine.run(_bucket_warm(Request, pcfg["buckets"],
                            spec_k + 2 if spec_k else 2))
    _span_warm(engine, Request, pcfg)
    builds0 = _builds()
    generated = sum(n for _, n in specs)
    walls = []
    outputs = requests = None
    for _ in range(3):
        reqs = [Request(prompt=p, max_new_tokens=n) for p, n in specs]
        t0 = time.perf_counter()
        outs = engine.run(reqs)
        walls.append(time.perf_counter() - t0)
        if outputs is None:
            outputs, requests = outs, reqs
    wall_s = sorted(walls)[len(walls) // 2]
    snap = engine.stats.snapshot()
    drafted = snap["draft_tokens"]
    accepted = snap["accepted_draft_tokens"]
    return {
        "speculative": bool(spec_k),
        "spec_k": spec_k or None,
        "wall_s": wall_s,
        "wall_s_repeats": walls,
        "tokens_per_s": generated / wall_s,
        "generated_tokens": generated,
        "steady_state_compiles": _builds() - builds0,
        "draft_tokens": drafted,
        "accepted_draft_tokens": accepted,
        "accept_rate": (accepted / drafted) if drafted else None,
        "spec_rollbacks": snap["spec_rollbacks"],
        "stats": snap,
    }, {r.request_id: outputs[r.request_id] for r in requests}, requests


def _kernel_launches():
    from .ops.paged_attention import paged_attention, paged_attention_int8

    return {fn.__name__: dict(fn.body_launches, total=fn.launches)
            for fn in (paged_attention, paged_attention_int8)}


def run_kernel_engine(layer_cfgs, params, specs, kcfg, *,
                      gather="live", kv_dtype=None, attn_impl=None):
    """One kernel-section run: warm every bucket and every live table
    width (a span-warm request), then drain the workload with the decode
    time, builds, counters and each paged kernel's launches by body
    taken over that window alone."""
    from .serving import Request

    kw = dict(gather_pages=gather)
    if kv_dtype:
        kw["kv_dtype"] = kv_dtype
    if attn_impl:
        kw["attn_impl"] = attn_impl
    engine = _engine(layer_cfgs, params, kcfg, paged=True, **kw)
    engine.run(_bucket_warm(Request, kcfg["buckets"]))
    engine.run([Request(prompt=np.full((2,), 401, np.int32),
                        max_new_tokens=kcfg["span_warm_new"])])
    requests = [Request(prompt=p.copy(), max_new_tokens=n)
                for p, n in specs]
    stats = engine.stats
    builds0, launches0 = _builds(), _kernel_launches()
    decode_s0, decode_tokens0 = stats.decode_s, stats.decode_tokens
    quant0, dequant0 = stats.quantized_pages, stats.dequant_blocks
    t0 = time.perf_counter()
    outputs = engine.run(requests)
    wall_s = time.perf_counter() - t0
    snap = stats.snapshot()
    decode_s = snap["decode_s"] - decode_s0
    decode_tokens = snap["decode_tokens"] - decode_tokens0
    launches = {name: {body: n - launches0[name][body]
                       for body, n in by_body.items()}
                for name, by_body in _kernel_launches().items()}
    model_dtype = str(layer_cfgs[0]["config"]["dtype"])
    return {
        "gather_pages": gather,
        "kv_dtype": kv_dtype or model_dtype,
        "attn_impl": engine.attn_impl,
        "wall_s": wall_s,
        "decode_s": decode_s,
        "decode_tokens": decode_tokens,
        "decode_s_per_token": (decode_s / decode_tokens
                               if decode_tokens else None),
        "steady_state_compiles": _builds() - builds0,
        "quantized_pages": snap["quantized_pages"] - quant0,
        "dequant_blocks": snap["dequant_blocks"] - dequant0,
        "kernel_launches": launches,
        "stats": snap,
    }, {r.request_id: outputs[r.request_id] for r in requests}, requests


# --- the sections -----------------------------------------------------------


def _workload_stamp(specs):
    return {
        "requests": len(specs),
        "prompt_lengths": [int(len(p)) for p, _ in specs],
        "new_tokens": [int(n) for _, n in specs],
    }


def _one_shot(layer_cfgs, params, device, context_length):
    """``r -> generate(...)`` over the full-sequence forward: the
    reference every engine's stream is held to."""
    from .models.gpt import generate, one_shot_forward

    forward = one_shot_forward(layer_cfgs, params, device)

    def one_shot(r):
        return generate(forward, r.prompt[None],
                        max_new_tokens=r.max_new_tokens,
                        context_length=context_length)[0]

    one_shot.forward = forward
    one_shot.context_length = context_length
    return one_shot


def _identical(outs, requests, one_shot, findings: list) -> bool:
    """Every request's stream equal to the one-shot reference's; where
    one is not, its first differing position goes to ``findings`` with
    the reference's logits of both tokens there and their gap."""
    ok = True
    for r in requests:
        got, want = np.asarray(outs[r.request_id]), one_shot(r)
        if np.array_equal(got, want):
            continue
        ok = False
        pos = int(np.argmax(got != want))
        ids = np.zeros((1, one_shot.context_length), np.int64)
        ids[0, :pos] = want[:pos]
        logits = one_shot.forward(torch.from_numpy(ids))[0, pos - 1]
        a, b = float(logits[int(got[pos])]), float(logits[int(want[pos])])
        findings.append(dict(request=r.request_id, position=pos,
                             engine_token=int(got[pos]),
                             reference_token=int(want[pos]),
                             reference_logit_engine_token=a,
                             reference_logit_reference_token=b,
                             gap=b - a))
    return ok


def _pairwise_identical(a_outs, a_reqs, b_outs, b_reqs) -> bool:
    return all(np.array_equal(a_outs[x.request_id], b_outs[y.request_id])
               for x, y in zip(a_reqs, b_reqs))


def continuous_vs_static(layer_cfgs, params, specs, bench_cfg):
    """Section 1: the slot engine under continuous and static batching on
    one workload; token-identical, the throughput ratio reported."""
    results, outputs = {}, {}
    for static in (False, True):
        name = "static" if static else "continuous"
        print(f"running {name} batching...", flush=True)
        result, outs, requests = run_mode(layer_cfgs, params, specs, static,
                                          bench_cfg)
        results[name] = result
        outputs[name] = [outs[r.request_id] for r in requests]
        print(f"  {name}: {result['wall_s']:.2f}s wall, "
              f"{result['tokens_per_s']:.1f} tok/s, "
              f"stalls={result['stats']['queue_stalls']}", flush=True)
    identical = all(np.array_equal(a, b) for a, b in
                    zip(outputs["continuous"], outputs["static"]))
    speedup = (results["continuous"]["tokens_per_s"]
               / results["static"]["tokens_per_s"])
    print(f"continuous/static speedup: {speedup:.2f}x, "
          f"token_identical={identical}", flush=True)
    return dict(continuous=results["continuous"], static=results["static"],
                throughput_speedup=speedup, token_identical=bool(identical),
                gates={"token_identical": bool(identical)})


def paged_vs_slot(layer_cfgs, params, paged_cfg, seed, smoke):
    """Section 2 and 3: paged against slot at equal pool MB on one
    backlog, then shared-prefix TTFT on a fresh paged engine."""
    from .serving.paging import KV_DTYPE_ITEMSIZE

    model = layer_cfgs[0]["config"]
    pcfg = dict(paged_cfg)
    one_shot = _one_shot(layer_cfgs, params, pcfg.get("device"),
                         pcfg["max_len"])
    # one (k, v) pair's MB per cached position in the model dtype, the
    # equal-memory stamp
    kv_mb_per_pos = (2.0 * model["hidden_size"]
                     * KV_DTYPE_ITEMSIZE[str(model["dtype"])] / 1024.0 ** 2)
    pspecs = build_workload(
        np.random.default_rng(seed + 1), pcfg["n_requests"],
        list(pcfg["buckets"]), pcfg["max_len"], pcfg["lo_new"],
        pcfg["hi_new"])
    pcfg["kv_mb_per_position"] = kv_mb_per_pos
    slot_positions = pcfg["slots"] * pcfg["max_len"]
    if slot_positions != pcfg["num_pages"] * pcfg["page_size"]:
        raise ValueError("the A/B holds pool bytes fixed; fix the "
                         "operating point")
    pcfg["pool_positions"] = slot_positions
    ab, ab_outputs = {}, {}
    for paged in (False, True):
        name = "paged" if paged else "slot"
        print(f"running {name} concurrency run...", flush=True)
        result, outs, requests = run_concurrency_mode(
            layer_cfgs, params, pspecs, paged, pcfg)
        ab[name] = result
        ab_outputs[name] = (outs, requests)
        print(f"  {name}: sustained {result['sustained_concurrency']:.2f} "
              f"(peak {result['peak_concurrency']}), "
              f"{result['wall_s']:.2f}s wall, "
              f"builds={result['steady_state_compiles']}", flush=True)
    paged_outs, paged_reqs = ab_outputs["paged"]
    slot_outs, slot_reqs = ab_outputs["slot"]
    findings: List[dict] = []
    paged_identical = _identical(paged_outs, paged_reqs, one_shot, findings)
    slot_vs_paged = _pairwise_identical(paged_outs, paged_reqs, slot_outs,
                                        slot_reqs)
    gain = (ab["paged"]["sustained_concurrency"]
            / max(ab["slot"]["sustained_concurrency"], 1e-9))
    print("running shared-prefix TTFT run...", flush=True)
    shared, shared_reqs = run_shared_prefix(layer_cfgs, params, pcfg)
    shared_identical = _identical({r.request_id: r.output()
                                   for r in shared_reqs}, shared_reqs,
                                  one_shot, findings)
    print(f"  shared prefix {shared['shared_prefix_len']} tokens: "
          f"cold TTFT {shared['ttft_cold_s']:.3f}s, warm mean "
          f"{shared['ttft_warm_mean_s']:.3f}s "
          f"({shared['ttft_warm_over_cold']:.2f}x), "
          f"hits={shared['prefix_hits']}", flush=True)
    gates = {
        "equal_pool_mb": True,  # checked above
        "concurrency_gain_over_2x": bool(gain > 2.0),
        "paged_token_identical": bool(paged_identical),
        "paged_matches_slot": bool(slot_vs_paged),
        "zero_steady_state_recompiles": (
            ab["paged"]["steady_state_compiles"] == 0),
        "prefix_hits_counted": bool(shared["prefix_hits"] >= 1),
        "prefix_tokens_reused": bool(
            shared["prefix_tokens_reused"]
            >= shared["prefix_hits"] * shared["shared_prefix_len"]),
        "shared_token_identical": bool(shared_identical),
    }
    if not smoke:
        gates["shared_prefix_ttft_drops"] = bool(
            shared["ttft_warm_over_cold"] is not None
            and shared["ttft_warm_over_cold"] <= 0.7)
    print(f"paged concurrency gain: {gain:.2f}x at equal pool MB; "
          f"gates: {gates}", flush=True)
    return {
        "operating_point": {
            "page_size": pcfg["page_size"],
            "num_pages": pcfg["num_pages"],
            "max_pages_per_request": pcfg["max_pages_per_request"],
            "max_concurrency": pcfg["max_concurrency"],
            "pool_positions": pcfg["pool_positions"],
            "pool_mb_per_stage_layer": pcfg["pool_positions"] * kv_mb_per_pos,
        },
        "workload": _workload_stamp(pspecs),
        "slot": ab["slot"],
        "paged": ab["paged"],
        "concurrency_gain": gain,
        "shared_prefix": shared,
        "identity_findings": findings,
        "gates": gates,
    }


def chunked_backlog(layer_cfgs, params, chunk_cfg, seed, smoke):
    """Section 4: the interference mix on a paged engine with and
    without chunked prefill."""
    ccfg = dict(chunk_cfg)
    cspecs = build_interference_workload(np.random.default_rng(seed + 2),
                                         ccfg)
    cres, couts = {}, {}
    for chunked in (False, True):
        name = "chunked" if chunked else "unchunked"
        print(f"running {name} backlog run...", flush=True)
        result, outs, requests = run_backlog(
            layer_cfgs, params, cspecs, ccfg,
            ccfg["prefill_chunk"] if chunked else None)
        cres[name] = result
        couts[name] = (outs, requests)
        for kind in ("tpot", "itl"):
            p50, p95 = result[f"{kind}_p50_s"], result[f"{kind}_p95_s"]
            result[f"{kind}_tail_ratio"] = p95 / p50 if p50 and p95 else None
        print(f"  {name}: itl p50 {(result['itl_p50_s'] or 0) * 1e3:.0f}ms "
              f"p95 {(result['itl_p95_s'] or 0) * 1e3:.0f}ms "
              f"(tail {result['itl_tail_ratio'] or 0:.1f}x), tpot tail "
              f"{result['tpot_tail_ratio'] or 0:.1f}x, ttft p95 "
              f"{(result['ttft_p95_s'] or 0):.2f}s, "
              f"builds={result['steady_state_compiles']}", flush=True)
    one_shot = _one_shot(layer_cfgs, params, ccfg.get("device"),
                         ccfg["max_pages_per_request"] * ccfg["page_size"])
    c_outs, c_reqs = couts["chunked"]
    u_outs, u_reqs = couts["unchunked"]
    findings: List[dict] = []
    chunked, unchunked = cres["chunked"], cres["unchunked"]
    gates = {
        "chunk_token_identical": _identical(c_outs, c_reqs, one_shot,
                                            findings),
        "chunk_matches_unchunked": _pairwise_identical(c_outs, c_reqs,
                                                       u_outs, u_reqs),
        "zero_steady_state_recompiles": chunked["steady_state_compiles"] == 0,
        "chunks_counted": bool(chunked["prefill_chunks"] > 0),
    }
    if not smoke:
        def within(a, b, factor):
            return bool(a is not None and b is not None and a <= factor * b)

        gates["tpot_tail_within_3x"] = within(chunked["tpot_tail_ratio"],
                                              1.0, 3.0)
        gates["itl_tail_within_3x"] = within(chunked["itl_tail_ratio"],
                                             1.0, 3.0)
        gates["itl_p95_improved_2x"] = within(chunked["itl_p95_s"],
                                              unchunked["itl_p95_s"], 0.5)
        gates["ttft_envelope_1_2x"] = within(chunked["ttft_p95_s"],
                                             unchunked["ttft_p95_s"], 1.2)
    print(f"chunked ITL tail {chunked['itl_tail_ratio']} vs unchunked "
          f"{unchunked['itl_tail_ratio']}; gates: {gates}", flush=True)
    return {
        "operating_point": {
            k: ccfg[k] for k in ("prefill_chunk", "max_chunk_rows",
                                 "page_size", "num_pages",
                                 "max_pages_per_request", "max_concurrency",
                                 "prefill_batch")},
        "workload": _workload_stamp(cspecs),
        "unchunked": unchunked,
        "chunked": chunked,
        "itl_tail_ratio_unchunked": unchunked["itl_tail_ratio"],
        "itl_tail_ratio_chunked": chunked["itl_tail_ratio"],
        "identity_findings": findings,
        "gates": gates,
    }


def speculative(model: Dict[str, Any], spec_cfg, seed, smoke):
    """Section 5: the section's own model (``model`` with the section's
    vocabulary), tail residuals zeroed, speculative against plain."""
    from .models.gpt import GptConfig, gpt_layer_configs, random_state_dicts

    scfg = dict(spec_cfg)
    s_model = GptConfig(**{**model, "vocab_size": scfg["vocab_size"]})
    s_layer_cfgs = gpt_layer_configs(s_model, deterministic=True)
    print(f"initializing spec-section GPT (vocab={s_model.vocab_size})...",
          flush=True)
    sparams = zero_tail_residuals(
        s_layer_cfgs, random_state_dicts(s_layer_cfgs, seed + 4),
        scfg["draft_blocks"])
    s_virtual = scfg["max_pages_per_request"] * scfg["page_size"]
    sspecs = build_workload(
        np.random.default_rng(seed + 3), scfg["n_requests"],
        list(scfg["buckets"]), s_virtual, scfg["lo_new"], scfg["hi_new"])
    sres, souts = {}, {}
    for spec in (False, True):
        name = "speculative" if spec else "plain"
        print(f"running {name} decode-bound run...", flush=True)
        result, outs, requests = run_spec_mode(
            s_layer_cfgs, sparams, sspecs, scfg,
            scfg["spec_k"] if spec else 0)
        sres[name] = result
        souts[name] = (outs, requests)
        print(f"  {name}: {result['tokens_per_s']:.1f} tok/s "
              f"({result['wall_s']:.2f}s wall), accept_rate="
              f"{result['accept_rate']}, "
              f"builds={result['steady_state_compiles']}", flush=True)
    one_shot = _one_shot(s_layer_cfgs, sparams, scfg.get("device"),
                         s_virtual)
    sp_outs, sp_reqs = souts["speculative"]
    pl_outs, pl_reqs = souts["plain"]
    findings: List[dict] = []
    speedup = (sres["speculative"]["tokens_per_s"]
               / max(sres["plain"]["tokens_per_s"], 1e-9))
    gates = {
        "spec_token_identical": _identical(sp_outs, sp_reqs, one_shot,
                                           findings),
        "spec_matches_plain": _pairwise_identical(sp_outs, sp_reqs, pl_outs,
                                                  pl_reqs),
        "zero_steady_state_recompiles": (
            sres["speculative"]["steady_state_compiles"] == 0),
        "drafts_counted": bool(sres["speculative"]["draft_tokens"] > 0),
    }
    if not smoke:
        gates["speedup_over_1_5x"] = bool(speedup > 1.5)
    print(f"speculative speedup: {speedup:.2f}x at accept_rate="
          f"{sres['speculative']['accept_rate']}; gates: {gates}",
          flush=True)
    return {
        "operating_point": {
            k: scfg[k] for k in ("spec_k", "draft_blocks", "page_size",
                                 "num_pages", "max_pages_per_request",
                                 "max_concurrency", "prefill_batch",
                                 "vocab_size")},
        "draft_exact": True,
        "workload": _workload_stamp(sspecs),
        "plain": sres["plain"],
        "speculative": sres["speculative"],
        "tokens_per_s_speedup": speedup,
        "accept_rate": sres["speculative"]["accept_rate"],
        "identity_findings": findings,
        "gates": gates,
    }


def kernel_quant(layer_cfgs, params, kernel_cfg, seed, smoke):
    """Section 6 without its kernel leg: the live table width against the
    full one, and int8 pages, at the model's dtype."""
    from .serving.paging import paged_pool_mb

    kcfg = dict(kernel_cfg)
    kspecs = build_workload(
        np.random.default_rng(seed + 5), kcfg["n_requests"],
        list(kcfg["buckets"]), kcfg["workload_span"], kcfg["lo_new"],
        kcfg["hi_new"])
    kres, kouts = {}, {}
    for name, kw in (("full_gather", dict(gather="full")),
                     ("live_gather", dict(gather="live")),
                     ("int8", dict(gather="live", kv_dtype="int8"))):
        print(f"running kernel-section {name} run...", flush=True)
        result, outs, requests = run_kernel_engine(
            layer_cfgs, params, kspecs, kcfg, **kw)
        kres[name] = result
        kouts[name] = (outs, requests)
        print(f"  {name}: decode "
              f"{(result['decode_s_per_token'] or 0) * 1e3:.2f}ms/token "
              f"({result['decode_s']:.2f}s total), "
              f"builds={result['steady_state_compiles']}", flush=True)
    one_shot = _one_shot(layer_cfgs, params, kcfg.get("device"),
                         kcfg["max_len"])
    l_outs, l_reqs = kouts["live_gather"]
    f_outs, f_reqs = kouts["full_gather"]
    i_outs, i_reqs = kouts["int8"]
    findings: List[dict] = []
    live_identical = _identical(l_outs, l_reqs, one_shot, findings)
    # int8 is bounded-error by design: the greedy STREAM agreement
    # (generated positions; after one near-tie flip the rest diverges,
    # charged as it falls) and the first generated token
    agree = total = first = 0
    for lr, ir in zip(l_reqs, i_reqs):
        x = l_outs[lr.request_id][len(lr.prompt):]
        y = i_outs[ir.request_id][len(ir.prompt):]
        agree += int((x == y).sum())
        total += int(x.size)
        first += int(x[0] == y[0])
    agreement = agree / total if total else None
    first_frac = first / len(kspecs)
    spec0 = next(c["config"] for c in layer_cfgs
                 if c.get("layer_type") == "GptBlock_Attn")
    heads = int(spec0["num_attention_heads"])
    head_dim = int(spec0["hidden_size"]) // heads
    mb_fp = paged_pool_mb(kcfg["num_pages"], kcfg["page_size"], heads,
                          head_dim, kv_dtype=str(spec0.get("dtype",
                                                           "float32")))
    mb_i8 = paged_pool_mb(kcfg["num_pages"], kcfg["page_size"], heads,
                          head_dim, kv_dtype="int8")
    pages_ratio = mb_fp / mb_i8
    gates = {
        "live_token_identical": bool(live_identical),
        "live_matches_full_gather": _pairwise_identical(l_outs, l_reqs,
                                                        f_outs, f_reqs),
        "zero_steady_state_recompiles_live": (
            kres["live_gather"]["steady_state_compiles"] == 0),
        "zero_steady_state_recompiles_int8": (
            kres["int8"]["steady_state_compiles"] == 0),
        "pages_per_mb_gain_over_1_9x": bool(pages_ratio >= 1.9),
        "int8_agreement_over_0_7": bool(agreement is not None
                                        and agreement >= 0.7),
        "int8_first_token_over_0_9": bool(first_frac >= 0.9),
        "quant_counters_move": bool(kres["int8"]["quantized_pages"] > 0
                                    and kres["int8"]["dequant_blocks"] > 0),
    }
    ful = kres["full_gather"]["decode_s_per_token"]
    liv = kres["live_gather"]["decode_s_per_token"]
    if not smoke:
        gates["decode_tick_improves"] = bool(ful is not None
                                             and liv is not None
                                             and liv < ful)
    decode_speedup = ful / liv if ful and liv else None
    print(f"kernel/quant: decode speedup {decode_speedup} (live vs full), "
          f"pages/MB {pages_ratio:.2f}x, int8 agreement {agreement} "
          f"(first-token {first_frac:.2f}); gates: {gates}", flush=True)
    return {
        "operating_point": {
            k: kcfg[k] for k in ("page_size", "num_pages",
                                 "max_pages_per_request", "max_concurrency",
                                 "prefill_batch", "workload_span")},
        "workload": _workload_stamp(kspecs),
        "full_gather": kres["full_gather"],
        "live_gather": kres["live_gather"],
        "int8": kres["int8"],
        "decode_per_token_speedup": decode_speedup,
        "pool_mb_fp": mb_fp,
        "pool_mb_int8": mb_i8,
        "pages_per_mb_gain": pages_ratio,
        "int8_agreement": agreement,
        "int8_first_token_agreement": first_frac,
        "identity_findings": findings,
        "gates": gates,
    }


def kernel_leg(seed, device):
    """Section 6's kernel leg: the paged-attention kernel against its
    plain version (``attn_impl="kernel"`` / ``"plain"``) on its own tiny
    instance (hidden 64, 2 blocks), token for token, with the kernel's
    launches by body.  Only on a CUDA device; elsewhere it reports
    ``{"skipped": "no CUDA device"}``."""
    from .models.gpt import GptConfig, gpt_layer_configs, random_state_dicts

    if device is None or torch.device(device).type != "cuda":
        return {"skipped": "no CUDA device"}
    print("running kernel-against-plain leg...", flush=True)
    v_model = GptConfig(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=2, max_position_embeddings=64,
                        dropout_prob=0.0, dtype="float32")
    v_layer_cfgs = gpt_layer_configs(v_model, deterministic=True)
    v_params = random_state_dicts(v_layer_cfgs, seed + 6)
    v_kcfg = dict(slots=2, max_len=32, buckets=(8,), prefill_batch=1,
                  partition=None, device=device, page_size=8,
                  max_pages_per_request=4, num_pages=12, max_concurrency=2,
                  span_warm_new=20)
    v_rng = np.random.default_rng(seed + 7)
    v_specs = [(v_rng.integers(1, 512, (n,)).astype(np.int32), m)
               for n, m in ((5, 4), (3, 3))]
    kernel_res, k_outs, k_reqs = run_kernel_engine(
        v_layer_cfgs, v_params, v_specs, v_kcfg, attn_impl="kernel")
    plain_res, p_outs, p_reqs = run_kernel_engine(
        v_layer_cfgs, v_params, v_specs, v_kcfg, attn_impl="plain")
    return {
        "note": ("the kernel against its plain version on its own tiny "
                 "instance; a correctness surface, no timing claim"),
        "model": {"hidden_size": v_model.hidden_size,
                  "num_hidden_layers": v_model.num_hidden_layers,
                  "vocab_size": v_model.vocab_size},
        "kernel": kernel_res,
        "plain": plain_res,
        "gates": {
            "kernel_matches_plain": _pairwise_identical(k_outs, k_reqs,
                                                        p_outs, p_reqs),
            "zero_steady_state_recompiles_kernel": (
                kernel_res["steady_state_compiles"] == 0),
        },
    }


def _device_kind(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--smoke", action="store_true",
                        help="seconds-scale model/workload (CI probe)")
    parser.add_argument("--paged", action="store_true",
                        help="run ONLY the paged-vs-slot + shared-prefix "
                             "sections (the full run includes them)")
    parser.add_argument("--chunked", action="store_true",
                        help="run ONLY the chunked-prefill backlog "
                             "section (the full run includes it)")
    parser.add_argument("--spec", action="store_true",
                        help="run ONLY the speculative-decoding section "
                             "(the full run includes it)")
    parser.add_argument("--kernel", action="store_true",
                        help="run ONLY the kernel/int8 section (the full "
                             "run includes it)")
    parser.add_argument("--out", default=os.path.join("build",
                                                      "BENCH_serving.json"))
    parser.add_argument("--stages", type=int, default=1,
                        help="pipeline stages to split the stack over")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="the device to serve on (default: the card; "
                             "'cpu' runs the kernels' plain versions)")
    args = parser.parse_args(argv)

    from .models.gpt import GptConfig, gpt_layer_configs, random_state_dicts
    from .utils import resolve_device

    device = resolve_device(args.device)
    model, bench_cfg, paged_cfg, chunk_cfg, spec_cfg, kernel_cfg = (
        operating_points(args.smoke))
    cfg = GptConfig(**model)
    layer_cfgs = gpt_layer_configs(cfg, deterministic=True)
    n_layers = len(layer_cfgs)
    partition = None
    if args.stages > 1:
        base = n_layers // args.stages
        partition = [base] * args.stages
        partition[-1] += n_layers - base * args.stages
    for op in (bench_cfg, paged_cfg, chunk_cfg, spec_cfg, kernel_cfg):
        op.update(partition=partition, device=device)
    print(f"initializing {n_layers}-layer GPT (hidden={cfg.hidden_size}) "
          f"on {device}...", flush=True)
    params = random_state_dicts(layer_cfgs, args.seed)
    rng = np.random.default_rng(args.seed)
    specs = build_workload(
        rng, bench_cfg["n_requests"], list(bench_cfg["buckets"]),
        bench_cfg["max_len"], bench_cfg["lo_new"], bench_cfg["hi_new"])
    print(f"workload: {len(specs)} requests, prompts "
          f"{min(len(p) for p, _ in specs)}.."
          f"{max(len(p) for p, _ in specs)} tokens, "
          f"{sum(n for _, n in specs)} tokens to generate", flush=True)
    report: Dict[str, Any] = {
        "bench": "serving",
        "smoke": bool(args.smoke),
        "device_kind": _device_kind(device),
        "steady_state_compiles_counts": (
            "kernel libraries loaded or built (ops/_build.load.count) "
            "inside the measured window; PyTorch compiles no programs"),
        "model": cfg.to_dict(),
        "serving": {
            "slots": bench_cfg["slots"],
            "max_len": bench_cfg["max_len"],
            "buckets": list(bench_cfg["buckets"]),
            "prefill_batch": bench_cfg["prefill_batch"],
            "stages": args.stages,
        },
        "workload": dict(_workload_stamp(specs), seed=args.seed),
    }
    ok = True
    any_flag = args.paged or args.chunked or args.spec or args.kernel
    full = not any_flag and not args.smoke
    if not any_flag:
        report["bench"] = "serving_continuous_vs_static"
        section = continuous_vs_static(layer_cfgs, params, specs, bench_cfg)
        ok = ok and section.pop("gates")["token_identical"]
        report.update(section)
    if args.paged or full:
        report["paged"] = paged_vs_slot(layer_cfgs, params, paged_cfg,
                                        args.seed, args.smoke)
        ok = ok and all(report["paged"]["gates"].values())
    if args.chunked or full:
        report["chunked_prefill"] = chunked_backlog(
            layer_cfgs, params, chunk_cfg, args.seed, args.smoke)
        ok = ok and all(report["chunked_prefill"]["gates"].values())
    if args.spec or full:
        report["speculative"] = speculative(
            dict(model), spec_cfg, args.seed, args.smoke)
        ok = ok and all(report["speculative"]["gates"].values())
    if args.kernel or full:
        kq = kernel_quant(layer_cfgs, params, kernel_cfg, args.seed,
                          args.smoke)
        kq["kernel_leg"] = kernel_leg(args.seed, device)
        kq["gates"].update(kq["kernel_leg"].get("gates", {}))
        report["kernel_quant"] = kq
        ok = ok and all(kq["gates"].values())
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2, default=str)
    print(f"-> {args.out} ({'PASS' if ok else 'FAIL'})", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
