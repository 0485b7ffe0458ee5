"""Loop kind ``serve_closed``: a closed loop of clients over the paged
``ServingEngine``.

Each of ``clients`` clients sends its next request as soon as its last
one finishes; the harness drives ``ServingEngine.submit`` and ``step``
from one thread and reads each request's tokens after every step, so a
token's time is the end of the step that produced it on the host clock,
and a request's times run from its client's send.  Sizes come from the
traffic file's pool (the same multiset for every seed), taken in the run
seed's order; prompt tokens are drawn from the seed.  The clients start
in set-up, and the window opens once ``warm_completions`` requests have
finished, so it opens at steady state.

End to end: ``serve_tokens_per_s`` (tokens delivered in the window over
its seconds), ``ttft_p95_ms`` over every request sent in the window (one
still waiting at the close counts with the wait it has had, one that
failed counts as infinite), ``tpot_p95_ms`` over the requests that
finished in the window with two tokens or more.  After the window the
engine is freed, and the reference (``reference/gpt.py``, float32)
reruns a seeded sample of the requests finished in the window, the
longest among them, over their prompts and served tokens.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import checks, stats, traffic as traffic_mod, weights
from benchmark.harness.devtrace import TraceSlice
from benchmark.reference import gpt as ref_gpt
from benchmark.reference.precision import float32_exact

MODEL_KEYS = (
    "vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
    "intermediate_size", "max_position_embeddings", "hidden_act",
    "dropout_prob", "initializer_range",
)
COUNTERS = ("decode_s", "decode_ticks", "decode_tokens", "prefill_s",
            "prefill_waves")


def model_fields(config: Dict) -> Dict:
    return {k: config[k] for k in MODEL_KEYS}


class Rec:
    """A client's request as the client sees it."""

    __slots__ = ("req", "sent", "first", "last", "n", "done", "failed")

    def __init__(self, req, sent: float):
        self.req, self.sent = req, sent
        self.first: Optional[float] = None
        self.last: Optional[float] = None
        self.done: Optional[float] = None
        self.n = 0
        self.failed = False


def tails(recs: List[Rec], ws: float, we: float) -> Dict[str, float]:
    """TTFT and TPOT 95th percentiles (seconds) of the window's
    requests, and their counts."""
    ttft = []
    for r in recs:
        if not ws <= r.sent <= we:
            continue
        if r.failed:
            ttft.append(math.inf)
        elif r.first is not None and r.first <= we:
            ttft.append(r.first - r.sent)
        else:
            ttft.append(we - r.sent)
    tpot = [(r.last - r.first) / (r.n - 1) for r in recs
            if r.done is not None and ws <= r.done <= we and r.n >= 2]
    return dict(ttft_p95_s=stats.percentile(ttft, 95), ttft_count=len(ttft),
                tpot_p95_s=stats.percentile(tpot, 95), tpot_count=len(tpot))


def run(args) -> Dict:
    from skycomputing_tpu_torch.models import GptConfig, gpt_layer_configs
    from skycomputing_tpu_torch.serving import ServingEngine
    from skycomputing_tpu_torch.serving.batcher import (
        FAILED,
        FINISHED,
        REJECTED,
        Request,
    )

    cfg, run_cfg, tr = (model_fields(args.config), args.config["run"],
                        args.traffic)
    device, seed = args.device, args.seed
    eng = tr["engine"]
    clients = int(tr["clients"])
    layer_cfgs = gpt_layer_configs(GptConfig(**cfg, dtype=run_cfg["dtype"]),
                                   deterministic=True)
    layout = ref_gpt.layout(cfg)
    units = weights.make(layout, seed, device, cfg["initializer_range"])
    engine = ServingEngine(
        layer_cfgs, units, kv_layout="paged",
        page_size=run_cfg["page_size"], num_pages=eng["num_pages"],
        max_concurrency=clients, max_len=cfg["max_position_embeddings"],
        buckets=tuple(eng["buckets"]), prefill_batch=eng["prefill_batch"],
        enable_prefix_cache=eng["prefix_cache"],
        kv_dtype=run_cfg["kv_dtype"],
        device=device)
    del units
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if args.trace:
        TraceSlice.warm(device)
    args.out_dir.mkdir(parents=True, exist_ok=True)
    tracer = TraceSlice(args.out_dir / "trace.json") if args.trace else None
    slice_s = float(tr["slice_seconds"])

    pool = traffic_mod.size_pool(tr["sizes"])
    order = traffic_mod.order(len(pool), seed)
    tokens_rng = np.random.default_rng([int(seed) % 2 ** 64, 1])
    inflight: Dict[int, Rec] = {}
    recs: List[Rec] = []
    sent = [0]

    def send(now: float) -> None:
        prompt_len, out_len = pool[order[sent[0] % len(pool)]]
        sent[0] += 1
        prompt = tokens_rng.integers(0, cfg["vocab_size"], size=prompt_len,
                                     dtype=np.int32)
        req = engine.submit(Request(prompt=prompt,
                                    max_new_tokens=int(out_len)))
        rec = Rec(req, now)
        inflight[req.request_id] = rec
        recs.append(rec)

    def span(name):
        if tracer is not None and tracer.active:
            return torch.profiler.record_function(name)
        return _NULL

    start = time.perf_counter()
    for _ in range(clients):
        send(start)
    completions = 0
    ws = we = None
    window_tokens = 0
    counters0 = counters1 = None
    slice_log: List[Dict] = []
    while True:
        with span("bench.step"):
            engine.step()
        now = time.perf_counter()
        prefill_rows, decode_ctx = [], []
        with span("bench.clients"):
            for rec in list(inflight.values()):
                req = rec.req
                n = len(req.tokens)
                if n > rec.n:
                    plen = int(req.prompt.size)
                    first = rec.n + 1
                    if rec.n == 0:
                        rec.first = now
                        prefill_rows.append((0, plen))
                        first = 2
                    decode_ctx.extend(plen + k - 1
                                      for k in range(first, n + 1))
                    if ws is not None and now <= we:
                        window_tokens += n - rec.n
                    rec.n, rec.last = n, now
                if req.status in (FAILED, REJECTED, FINISHED):
                    rec.failed = req.status != FINISHED
                    rec.done = now
                    del inflight[req.request_id]
                    completions += not rec.failed
                    send(now)
        if tracer is not None and tracer.active:
            slice_log.append(dict(prefill=prefill_rows, decode=decode_ctx))
        if ws is None:
            if completions >= int(tr["warm_completions"]):
                ws, we = now, now + args.seconds
                counters0 = counters1 = _counters(engine)
            continue
        if now <= we:
            counters1 = _counters(engine)
        if tracer is not None:
            if tracer.active and now - tracer.t0 >= slice_s:
                tracer.stop(device)
            elif tracer.t0 is None and now >= ws + (args.seconds
                                                     - slice_s) / 2:
                tracer.start()
        if now >= we:
            break
    if tracer is not None and tracer.active:
        tracer.stop(device)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    tail = tails(recs, ws, we)
    in_window = [r for r in recs if ws <= r.sent <= we]
    end_to_end = dict(
        serve_tokens_per_s=window_tokens / args.seconds,
        ttft_p95_ms=tail["ttft_p95_s"] * 1e3,
        tpot_p95_ms=tail["tpot_p95_s"] * 1e3,
        setup_s=ws - args.t_start,
    )
    trace = tracer.summary() if tracer is not None and tracer.t1 else None
    layer = dict(
        model=cfg, counters=(counters0, counters1), trace=trace,
        slice_s=tracer.seconds if trace is not None else None,
        slice_log=slice_log, tails=tail,
    )
    done = [r for r in recs
            if r.done is not None and not r.failed and ws <= r.done <= we]
    sample = _sample(done, seed, int(tr["check"]["served_tokens"]))
    served = [(r.req.prompt.copy(), np.asarray(r.req.tokens, np.int64))
              for r in sample]
    del engine, inflight, recs, done, sample
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    with float32_exact():
        ref_units = weights.make(layout, seed, device,
                                 cfg["initializer_range"])
        gaps, count = [], 0
        for prompt, tokens in served:
            found = ref_gpt.served_gaps(
                ref_units, cfg, torch.from_numpy(prompt).to(device),
                torch.from_numpy(tokens).to(device))
            gaps.append(found["gap"])
            count += found["tokens"]
    finite = bool(gaps) and all(math.isfinite(g) for g in gaps)
    numbers = dict(logit_gap=max(gaps) if finite else math.inf)
    correct, items = checks.judge(numbers, tr["check"]["limits"])
    failed = sum(r.failed for r in in_window)
    return dict(
        end_to_end=end_to_end, attempted=len(in_window), failed=failed,
        correct=correct and failed == 0, checks=items,
        notes=dict(checked_requests=len(served), checked_tokens=count,
                   window_requests=len(in_window)),
        memory_peak_bytes=memory_peak, trace=trace, layer=layer,
        served=served,
    )


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _counters(engine) -> Dict[str, float]:
    return {k: getattr(engine.stats, k) for k in COUNTERS}


def _sample(done: List[Rec], seed: int, target: int) -> List[Rec]:
    """The request with the most served tokens, then others in the seed's
    order until ``target`` served tokens are covered."""
    if not done:
        return []
    longest = max(done, key=lambda r: r.n)
    rest = [r for r in done if r is not longest]
    picked, total = [longest], longest.n
    rng = np.random.default_rng([int(seed) % 2 ** 64, 2])
    for i in rng.permutation(len(rest)):
        if total >= target:
            break
        picked.append(rest[i])
        total += rest[i].n
    return picked
