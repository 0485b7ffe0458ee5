"""Work counts against hand-worked numbers; the statistics, the trace
reader and the metric readers on synthetic inputs."""

from __future__ import annotations

import json

import pytest

from benchmark.harness import devtrace, spec, stats, workcount
from benchmark.harness.peaks import H100_SXM, least_time

BERT = dict(hidden_size=4, intermediate_size=8, num_hidden_layers=1,
            num_attention_heads=2)
GPT = dict(hidden_size=4, intermediate_size=16, num_hidden_layers=2,
           vocab_size=10, num_attention_heads=2)


def test_bert_step_flops_by_hand():
    # encoder weights 4*16 + 2*32 = 128: 6*128*6 = 4608; pooler and
    # classifier 6*(16 + 8)*2 = 288; attention 12*1*6*3*4 = 864
    assert workcount.bert_step_flops(BERT, batch=2, seq=3,
                                     num_classes=2) == 5760


def test_b1_need_by_hand():
    # flops 4*2*4*(4 + 9); bytes (4*n*2*4*2 + 2n) for n = 2, 3
    assert workcount.b1_call_need([2, 3], heads=2, head_dim=4) == (416, 330)


def test_gpt_flops_by_hand():
    # blocks 2*(4*16 + 2*64) = 384 weights, head 40
    assert workcount.gpt_prefill_flops(GPT, start=1, n=2) == (
        2 * 384 * 2 + 2 * 40 + 4 * 4 * 2 * (2 * 1 + 3))
    assert workcount.gpt_decode_flops(GPT, context=5) == (
        2 * (384 + 40) + 4 * 4 * 2 * 5)


def test_b2_needs_by_hand():
    assert workcount.b2_decode_need([3, 5], hidden=4) == (128, 160)
    assert workcount.b2_prefill_need([(0, 3), (2, 1)], hidden=4) == (
        144, 160)


def test_least_time_takes_the_binding_bound():
    assert least_time(989e12, 0, H100_SXM) == pytest.approx(1.0)
    assert least_time(0, 3.35e12, H100_SXM) == pytest.approx(1.0)


def test_percentile_and_intervals():
    assert stats.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    assert stats.percentile([], 95) != stats.percentile([], 95)  # NaN
    busy, gaps = stats.busy_and_gaps([(1, 3), (2, 4), (6, 7)], 0, 10)
    assert busy == 4
    assert gaps == [(0, 1), (4, 6), (7, 10)]


def _trace(path):
    x = dict(ph="X", pid=1, tid=1)
    events = [
        dict(x, cat="user_annotation", name="bench.slice", ts=0, dur=1000),
        dict(x, cat="user_annotation", name="bench.step", ts=0, dur=1000),
        dict(x, cat="cpu_op", name="aten::mm", ts=350, dur=300),
        dict(x, cat="kernel", pid=0, tid=7, ts=100, dur=200,
             name="void (anonymous namespace)::flash_attention_kernel_mma"
                  "<64>(__nv_bfloat16 const*)"),
        dict(x, cat="kernel", pid=0, tid=7, ts=250, dur=100, name="k2"),
        dict(x, cat="gpu_memcpy", pid=0, tid=7, ts=600, dur=100,
             name="Memcpy HtoD"),
        dict(x, cat="kernel", pid=0, tid=7, ts=1500, dur=100, name="late"),
    ]
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_trace_reader_on_a_synthetic_trace(tmp_path):
    got = devtrace.read_trace(_trace(tmp_path / "t.json"))
    assert got["window_s"] == pytest.approx(1e-3)
    assert got["busy_s"] == pytest.approx(350e-6)
    assert got["kernels"]["flash_attention_kernel_mma<64>"] == [
        1, pytest.approx(200e-6)]
    assert "late" not in got["kernels"]
    idle = dict(got["idle_gaps"])
    assert idle["bench.step / python"] == pytest.approx(400e-6)
    assert idle["bench.step / aten::mm"] == pytest.approx(250e-6)
    assert got["device_ops"][0][0] == "flash_attention_kernel_mma<64>"


def test_idle_share_and_b1_roofline_readers():
    model = dict(BERT, num_attention_heads=2)
    lengths = [2, 3, 2, 3]
    flops, nbytes = workcount.b1_call_need([2, 3], 2, 2)
    need = least_time(flops, nbytes, H100_SXM)
    ctx = dict(
        trace=dict(busy_s=0.25, window_s=1.0,
                   kernels={"flash_attention_kernel_mma<64>": [4, 4 * need],
                            "other": [1, 1.0]}),
        slice_steps=[dict(lengths=lengths, dispatch_s=0.5)],
        slice_s=1.0, microbatches=2, model=model, peaks=H100_SXM,
        batch=4, seq=3, num_classes=3)
    assert spec.load_metric("idle_share.train").read(ctx) == 75.0
    assert spec.load_metric("b1_roofline.train").read(ctx) == (
        pytest.approx(100.0))
    assert spec.load_metric("dispatch_share.train").read(ctx) == 50.0
    mfu = spec.load_metric("mfu.train").read(ctx)
    assert mfu == pytest.approx(100 * workcount.bert_step_flops(
        model, 4, 3, 3) / 989e12)
    assert spec.load_metric("b1_roofline.train").read(
        dict(ctx, trace=None)) is None


def test_serving_readers_on_counters_and_a_log():
    ctx = dict(
        counters=(dict(decode_s=1.0, decode_ticks=10, decode_tokens=100,
                       prefill_s=0.5, prefill_waves=2),
                  dict(decode_s=2.0, decode_ticks=30, decode_tokens=500,
                       prefill_s=1.5, prefill_waves=6)),
        slice_log=[dict(prefill=[(0, 3)], decode=[4, 5])],
        slice_s=2.0, model=GPT, peaks=H100_SXM,
        trace=dict(busy_s=1.0, window_s=2.0, kernels={
            "paged_attention_kernel_decode<bf16>": [2, 1.0],
            "paged_attention_kernel_mma<bf16, 64>": [2, 1.0]}),
        tails=dict(ttft_p95_s=0.2, ttft_count=5, tpot_p95_s=0.05,
                   tpot_count=0))
    read = {n: spec.load_metric(n).read(ctx) for n in (
        "decode_tick_ms.serve", "prefill_wave_ms.serve",
        "decode_rows_mean.serve", "mfu.serve", "b2_decode_roofline.serve",
        "b2_prefill_roofline.serve", "idle_share.serve",
        "ttft_p95_ms.host", "tpot_p95_ms.host")}
    assert read["decode_tick_ms.serve"] == pytest.approx(50.0)
    assert read["prefill_wave_ms.serve"] == pytest.approx(250.0)
    assert read["decode_rows_mean.serve"] == 20.0
    assert read["idle_share.serve"] == 50.0
    assert read["ttft_p95_ms.host"] == pytest.approx(200.0)
    assert read["tpot_p95_ms.host"] is None
    flops = (workcount.gpt_prefill_flops(GPT, 0, 3)
             + workcount.gpt_decode_flops(GPT, 4)
             + workcount.gpt_decode_flops(GPT, 5))
    assert read["mfu.serve"] == pytest.approx(100 * flops / 2.0 / 989e12)
    dec = least_time(*workcount.b2_decode_need([4, 5], 4), H100_SXM)
    assert read["b2_decode_roofline.serve"] == pytest.approx(
        100 * dec * GPT["num_hidden_layers"] / 1.0)
    pre = least_time(*workcount.b2_prefill_need([(0, 3)], 4), H100_SXM)
    assert read["b2_prefill_roofline.serve"] == pytest.approx(
        100 * pre * GPT["num_hidden_layers"] / 1.0)
