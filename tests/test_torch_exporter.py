"""The port's metrics exporter against the JAX package's: the Prometheus
text byte-equal for the same registry (labelled per-reason counters,
strings and ``None`` skipped, source errors, derived rates); the HTTP
endpoints (``/metrics``, ``/metrics.json``, ``/healthz``,
``/incidents``, 404) on ``127.0.0.1``, port 0, with idempotent
start/stop; and the live-metrics mixin on a fleet mid-run (its counters
equal ``fleet.stats``) and on a serving engine (the trainer's
``Runner``: ``tests/test_torch_pipeline.py``)."""

import json
import urllib.error
import urllib.request

import pytest
import torch

from skycomputing_tpu import telemetry as jax_telemetry
from skycomputing_tpu.telemetry import exporter as jax_exporter
from skycomputing_tpu_torch import telemetry
from skycomputing_tpu_torch.telemetry import exporter
from torch_fleet_helpers import sides, tiny_gpt

pytestmark = pytest.mark.torch_port


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as response:
        return response.status, response.read().decode()


def _registry(tel):
    clock = {"t": 0.0}
    state = {"n": 0}
    reg = tel.MetricsRegistry()
    reg.register("fleet", lambda: dict(
        submitted=state["n"], rejected_by_reason={"queue_full": 3,
                                                  "shed": 1.5},
        ttft_p95_s=0.125, note="text", missing=None, healthy=True),
        types={"submitted": "counter", "rejected_by_reason": "counter",
               "ttft_p95_s": "gauge", "healthy": "gauge"})
    reg.register("replica-0.x", lambda: dict(iterations=7,
                                             batch_occupancy=0.5))

    def broken():
        raise RuntimeError('bad "source"\nline')

    reg.register("broken", broken)
    ts = tel.MetricsTimeseries(reg, window=8, clock=lambda: clock["t"])
    for i in range(3):
        clock["t"] = i * 2.0
        state["n"] = 5 * i
        ts.sample()
    return reg, ts


def test_prometheus_text_byte_equal_to_jax():
    ours_reg, ours_ts = _registry(telemetry)
    ref_reg, ref_ts = _registry(jax_telemetry)
    for with_rates in (False, True):
        ours = telemetry.MetricsExporter(
            ours_reg, timeseries=ours_ts if with_rates else None)
        ref = jax_telemetry.MetricsExporter(
            ref_reg, timeseries=ref_ts if with_rates else None)
        text = ours.prometheus_text()
        assert text == ref.prometheus_text()
        assert ours.metrics_json() == ref.metrics_json()
    assert 'skytpu_fleet_rejected_by_reason{key="queue_full"} 3' in text
    assert "skytpu_fleet_submitted_per_s" in text
    assert "skytpu_metric_source_errors 1" in text
    snap = ours_reg.snapshot()
    types = ours_reg.field_types()
    assert exporter.prometheus_text(snap, types, prefix="x") == \
        jax_exporter.prometheus_text(snap, types, prefix="x")
    for name in ("a.b-c", "9lives", "ok_name:x"):
        assert exporter.sanitize_metric_name(name) == \
            jax_exporter.sanitize_metric_name(name)
    assert exporter.escape_label_value('a"b\\c\nd') == \
        jax_exporter.escape_label_value('a"b\\c\nd')


def test_endpoints_and_idempotent_start_stop():
    reg, ts = _registry(telemetry)
    exp = telemetry.MetricsExporter(
        reg, timeseries=ts, health=lambda: {"status": "ok", "tick": 3},
        incidents=lambda: {"open": [], "closed": [], "opened_total": 0,
                           "closed_total": 0},
        host="127.0.0.1", port=0)
    assert not exp.running
    assert exp.start() is exp and exp.start() is exp
    try:
        assert exp.running and exp.port > 0
        status, body = _get(f"{exp.url}/metrics")
        assert status == 200 and body == exp.prometheus_text()
        status, body = _get(f"{exp.url}/metrics.json")
        assert json.loads(body) == json.loads(json.dumps(
            exp.metrics_json()))
        assert json.loads(_get(f"{exp.url}/healthz")[1])["tick"] == 3
        assert json.loads(_get(f"{exp.url}/incidents")[1])[
            "opened_total"] == 0
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(f"{exp.url}/nope")
        assert err.value.code == 404
    finally:
        exp.stop()
        exp.stop()
    assert not exp.running


def test_fleet_and_engine_exporters():
    """The mixin on a fleet mid-run (the fleet's counters on /metrics
    equal ``fleet.stats`` at the scrape) and on a serving engine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    gpt = tiny_gpt()
    side = sides(gpt)[1]
    fleet = side.fleet.ServingFleet(
        gpt[0], side.params, replicas=2,
        engine_kwargs=dict(num_slots=2, max_len=64, buckets=(8, 16)),
        supervisor=side.supervisor(), devices=side.devices(2),
        fault_injector=side.injector(
            [dict(iter=2, kind="replica_crash", replica=0)]))
    fleet.attach_flight()
    exp = fleet.start_exporter()
    try:
        assert fleet.start_exporter() is exp
        for r in side.requests(3, [(5, 8), (3, 6), (7, 7), (6, 5)]):
            fleet.submit(r)
        scraped = None
        while fleet.has_work():
            fleet.step()
            if fleet.tick == 4:
                _, body = _get(f"{exp.url}/metrics")
                scraped = (body, fleet.stats.snapshot())
                health = json.loads(_get(f"{exp.url}/healthz")[1])
                ledger = json.loads(_get(f"{exp.url}/incidents")[1])
        body, stats = scraped
        for field in ("submitted", "dispatched", "migrations", "reforms",
                      "missed_beats", "ticks"):
            assert f"skytpu_fleet_{field} {stats[field]}\n" in body
        assert "# TYPE skytpu_fleet_submitted counter" in body
        assert "skytpu_replica0_finished" in body
        assert set(health["replicas"]) == {"replica0", "replica1"}
        assert ledger["opened_total"] == fleet.incidents.opened_total >= 1
        assert fleet.stats.reforms == 1
    finally:
        fleet.stop_exporter()
        fleet.stop_exporter()
    assert fleet._exporter is None

    engine = side.serving.ServingEngine(
        gpt[0], side.params, device="cpu", kv_layout="paged",
        num_slots=2, max_len=48, buckets=(8, 16), page_size=8)
    engine.enable_timeseries(window=8)
    exp = engine.start_exporter()
    try:
        engine.run(side.requests(4, [(5, 3)]))
        health = json.loads(_get(f"{exp.url}/healthz")[1])
        assert health["kv_layout"] == "paged"
        assert health["attn_impl"] == "plain"
        _, body = _get(f"{exp.url}/metrics")
        assert "# TYPE skytpu_serving_finished counter" in body
        assert "skytpu_serving_finished 1\n" in body
        assert "skytpu_serving_iterations_per_s" in body
    finally:
        engine.stop_exporter()
    assert engine.finished_requests[0].status == "finished"
    torch.set_num_threads(threads)
