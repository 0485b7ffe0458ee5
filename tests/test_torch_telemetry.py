"""The port's telemetry core against the JAX package's: the same calls on
both tracers under one injected counting clock give equal Chrome traces
(lanes, request lanes, the ring bound, async arcs, windowed export, the
disabled no-op); ``MetricsRegistry`` and ``MetricsTimeseries`` give
equal snapshots, rates and percentiles; and a 3-stage ``MatmulStack``
pipeline trained 2 steps under GPipe and under 1F1B records the same
(phase, name, lane) sequence in both packages (less JAX's
``xla_compile`` spans), which the trace analysis counts alike.  A
``Runner`` with ``TraceHook`` writes the same run in both."""

import itertools
import json
import re

import jax
import numpy as np
import optax
import pytest
import torch

from skycomputing_tpu import telemetry as jtel
from skycomputing_tpu.dynamics import ParameterServer as JaxParameterServer
from skycomputing_tpu.dynamics import WorkerManager as JaxWorkerManager
from skycomputing_tpu.ops import cross_entropy_loss as jax_xent
from skycomputing_tpu.parallel import PipelineModel as JaxPipelineModel
from skycomputing_tpu.runner import Runner as JaxRunner
from skycomputing_tpu.runner import TraceHook as JaxTraceHook
from skycomputing_tpu_torch import telemetry as ttel
from skycomputing_tpu_torch.dynamics import ParameterServer, WorkerManager
from skycomputing_tpu_torch.ops import cross_entropy_loss
from skycomputing_tpu_torch.parallel import PipelineModel, sgd
from skycomputing_tpu_torch.runner import Runner, TraceHook

pytestmark = pytest.mark.torch_port

PACKAGES = {"jax": jtel, "torch": ttel}


def _counting_clock():
    counter = itertools.count()
    return lambda: float(next(counter))


def _chrome(trace):
    out = dict(trace)
    out["otherData"] = {k: v for k, v in trace["otherData"].items()
                        if k != "tracer"}
    return out


# --- tracer ------------------------------------------------------------------

def _drive_tracer(tel, capacity):
    """The same calls on either package's Tracer."""
    tr = tel.Tracer(capacity=capacity, clock=_counting_clock(),
                    request_lanes=2)
    stage = tr.lane("stage 0 [dev]", "dispatch")
    with tr.span("fwd", stage, {"mb": 0}):
        tr.instant("transfer", tr.lane("transfers", "dev"), {"moved": 1})
    tr.complete("bwd", stage, tr.now(), {"mb": 0})
    tr.complete("host_dispatch", tr.lane("host", "dispatch"), 5.0,
                dur_us=-3.0)  # clamped to 0
    tr.counter("queue", tr.lane("serving", "engine"), {"depth": 3})
    tr.async_begin("self_heal", tr.lane("selfheal", "arc"), 1, {"iter": 4})
    lanes = [tr.request_lane(rid) for rid in (10, 11, 12)]
    assert lanes[2] is None  # the pool of 2 is exhausted
    assert tr.request_lane(12, lease=False) is None
    tr.release_request_lane(10)
    recycled = tr.request_lane(12)
    assert recycled == lanes[0]
    tr.instant("finish", recycled, {"request": 12})
    mid = tr.now()
    tr.async_end("self_heal", tr.lane("selfheal", "arc"), 1,
                 {"outcome": "healed"})
    tr.async_begin("self_heal", tr.lane("selfheal", "arc"), 2)
    tr.instant("late", stage)
    return tr, mid


@pytest.mark.parametrize("capacity", [1 << 10, 6], ids=["roomy", "ring"])
def test_tracer_exports_the_reference_trace(capacity):
    got = {name: _drive_tracer(tel, capacity)
           for name, tel in PACKAGES.items()}
    (jtr, jmid), (ttr, tmid) = got["jax"], got["torch"]
    assert jmid == tmid
    assert ttr.dropped == jtr.dropped == (4 if capacity == 6 else 0)
    assert _chrome(ttr.to_chrome()) == _chrome(jtr.to_chrome())
    # a window clips the open arc's begin to the window's start
    assert _chrome(ttr.to_chrome(since_us=tmid)) == \
        _chrome(jtr.to_chrome(since_us=jmid))
    assert ttr.to_chrome()["otherData"]["tracer"] == \
        "skycomputing_tpu_torch.telemetry"


def test_disabled_tracing_is_a_shared_no_op(tmp_path):
    for tel in PACKAGES.values():
        tel.disable_tracing()
        assert tel.get_tracer() is None
        assert tel.trace_span("a", "p") is tel.trace_span("b", "q")
        with tel.trace_span("a", "p") as span:
            assert span is None
    tracer = ttel.enable_tracing(capacity=8, clock=_counting_clock())
    try:
        assert ttel.enable_tracing() is tracer  # idempotent
        with ttel.trace_span("solve", "dynamics", "allocator", {"n": 1}):
            pass
        path = tracer.write(str(tmp_path / "sub" / "t.json"))
    finally:
        assert ttel.disable_tracing() is tracer
    assert ttel.get_tracer() is None
    events = ttel.analysis.load_events(path)
    assert [e["name"] for e in events if e["ph"] == "X"] == ["solve"]


# --- metrics registry and time series ---------------------------------------

class _Stats:
    FIELD_TYPES = {"tokens": "counter", "depth": "gauge"}

    def __init__(self):
        self.tokens = 0
        self.depth = 0

    def snapshot(self):
        return {"tokens": self.tokens, "depth": self.depth, "name": "x",
                "by_reason": {"full": self.tokens // 2, "bad": "y"},
                "ok": self.depth > 1}


def _broken():
    raise KeyError("gone")


def _drive_metrics(tel):
    stats = _Stats()
    reg = tel.MetricsRegistry()
    reg.register("engine", stats)
    reg.register("loop", lambda: {"iter": stats.tokens * 3},
                 types={"iter": "counter"})
    reg.register("bad", _broken)
    errors = []
    for name, source in (("engine", stats), ("__errors__", stats),
                         ("num", 3)):
        try:
            reg.register(name, source)
        except (ValueError, TypeError) as exc:
            errors.append(f"{type(exc).__name__}: {exc}")
    clock = iter(float(t) for t in (0, 1, 3, 4, 8, 9, 10))
    series = tel.MetricsTimeseries(reg, window=4, max_keys=4,
                                   clock=lambda: next(clock))
    samples = []
    for tokens, depth in ((0, 1), (10, 4), (30, 2), (5, 7), (25, 3),
                          (45, 3)):
        stats.tokens, stats.depth = tokens, depth
        samples.append(series.sample())
    keys = series.keys()
    return dict(
        snapshot=reg.snapshot(), flat=reg.flat(), types=reg.field_types(),
        names=reg.names(), errors=errors, samples=samples, keys=keys,
        skipped=series.skipped_keys, source_errors=series.source_errors,
        rates=[series.rate(k) for k in keys],
        rates2=[series.rate(k, window=2) for k in keys],
        p50=[series.percentile(k, 50) for k in keys],
        p95=[series.percentile(k, 95, window=3) for k in keys],
        values=[series.values(k, window=2) for k in keys],
        latest=series.latest_sample(), summary=series.summary(points=3),
        ranks=[tel.timeseries.nearest_rank([5.0, 1.0, 3.0, 2.0], q)
               for q in (0, 25, 50, 95, 100)],
    )


def test_metrics_registry_and_timeseries_match_the_reference():
    want, got = (_drive_metrics(tel) for tel in (jtel, ttel))
    assert got == want
    assert got["skipped"] > 0 and got["source_errors"] == 6
    assert any(r is not None for r in got["rates"])


# --- the pipeline's spans ----------------------------------------------------

N_UNITS, FEATURES, BATCH, M = 6, 32, 8, 2


def _model_cfg():
    return [dict(layer_type="MatmulStack", features=FEATURES, depth=1,
                 dtype="float32") for _ in range(N_UNITS)]


def _pool(wm_cls):
    wm = wm_cls()
    wm.load_worker_pool_from_config([
        dict(name=f"n{i}", device_config=dict(device_index=0))
        for i in range(3)])
    cfg = _model_cfg()
    for i, w in enumerate(wm.worker_pool):
        w.model_config = cfg[2 * i:2 * i + 2]
        w.order = w.rank + 1
    return wm


def _batches(n=2):
    rng = np.random.default_rng(0)
    return [(rng.normal(size=(BATCH, FEATURES)).astype(np.float32),
             rng.integers(0, FEATURES, size=(BATCH,)).astype(np.int32))
            for _ in range(n)]


def _jax_model(schedule):
    x = _batches(1)[0][0]
    ps = JaxParameterServer(_model_cfg(), example_inputs=(x,),
                            rng=jax.random.key(0))
    return JaxPipelineModel(_pool(JaxWorkerManager), ps, optax.sgd(1e-2),
                            jax_xent, num_microbatches=M, schedule=schedule)


def _torch_model(schedule):
    ps = ParameterServer(_model_cfg())
    return PipelineModel(_pool(WorkerManager), ps, sgd(1e-2),
                         cross_entropy_loss, devices=[torch.device("cpu")],
                         num_microbatches=M, schedule=schedule)


_DEVICE = re.compile(r"\[.*\]")


def _named_sequence(trace):
    """(ph, name, process, thread) per event, device names blanked and
    JAX's compile spans left out."""
    names, threads = {}, {}
    for ev in trace["traceEvents"]:
        if ev["ph"] == "M" and ev["name"] == "process_name":
            names[ev["pid"]] = _DEVICE.sub("[dev]", ev["args"]["name"])
        elif ev["ph"] == "M" and ev["name"] == "thread_name":
            threads[(ev["pid"], ev["tid"])] = ev["args"]["name"]
    out = []
    for ev in trace["traceEvents"]:
        if ev["ph"] == "M" or ev["name"] == "xla_compile":
            continue
        process = names[ev["pid"]]
        thread = threads[(ev["pid"], ev["tid"])]
        if process == "transfers":
            thread = "dev"
        out.append((ev["ph"], ev["name"], process, thread))
    return out


def _traced_steps(tel, model, step):
    step(model, _batches(1)[0])  # warm: JAX compiles outside the trace
    tracer = tel.enable_tracing(clock=_counting_clock())
    try:
        for batch in _batches(2):
            step(model, batch)
    finally:
        tel.disable_tracing()
    return tracer.to_chrome()


def _span_counts(report_events, analysis):
    report = analysis.analyze(report_events)
    stage_names = {}
    procs = analysis.lane_processes(report_events)
    for ev in report_events:
        if ev.get("ph") == "X" and analysis.STAGE_RE.match(
                procs.get(ev["pid"], "")):
            stage_names[ev["name"]] = stage_names.get(ev["name"], 0) + 1
    return dict(num_stages=report["num_stages"],
                transfers=report["transfers"],
                dispatch_steps=report["dispatch"]["steps"],
                stage_spans=stage_names)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_trace_matches_the_reference(schedule):
    jtrace = _traced_steps(
        jtel, _jax_model(schedule),
        lambda m, b: m.train_step(*b, rng=jax.random.key(1)))
    ttrace = _traced_steps(
        ttel, _torch_model(schedule),
        lambda m, b: m.train_step(*b, generator=torch.Generator()))
    got, want = _named_sequence(ttrace), _named_sequence(jtrace)
    assert got == want
    counts = _span_counts(ttrace["traceEvents"], ttel.analysis)
    assert counts == _span_counts(jtrace["traceEvents"], jtel.analysis)
    assert counts["stage_spans"] == {"fwd": 2 * M * 3, "bwd": 2 * M * 3,
                                     "update": 2 * 3}
    mbs = [ev["args"]["mb"] for ev in ttrace["traceEvents"]
           if ev["ph"] == "X" and ev["name"] == "fwd"]
    assert sorted(mbs) == sorted(list(range(M)) * 3 * 2)


def test_host_dispatch_span_is_the_steps_dispatch_time():
    model = _torch_model("gpipe")
    tracer = ttel.enable_tracing()
    try:
        model.train_step(*_batches(1)[0])
    finally:
        ttel.disable_tracing()
    (span,) = [e for e in tracer.to_chrome()["traceEvents"]
               if e["name"] == "host_dispatch"]
    assert span["dur"] == pytest.approx(model.stats.dispatch_s * 1e6)
    assert model.stats.FIELD_TYPES.keys() == model.stats.snapshot().keys()


def test_trace_hook_writes_the_reference_run(tmp_path):
    def run(model, ps, wm, runner_cls, hook_cls, tel, path):
        runner = runner_cls(model, ps, wm, max_epochs=1, max_iters=2)
        runner.register_hook(hook_cls(str(path)))
        tel.disable_tracing()
        runner.train(_batches(2))
        assert tel.get_tracer() is None  # the hook owned and closed it
        with open(path) as fh:
            return json.load(fh), runner

    x = _batches(1)[0][0]
    jps = JaxParameterServer(_model_cfg(), example_inputs=(x,),
                             rng=jax.random.key(0))
    jwm = _pool(JaxWorkerManager)
    jtrace, _ = run(JaxPipelineModel(jwm, jps, optax.sgd(1e-2), jax_xent),
                    jps, jwm, JaxRunner, JaxTraceHook, jtel,
                    tmp_path / "jax.json")
    ps = ParameterServer(_model_cfg())
    wm = _pool(WorkerManager)
    model = PipelineModel(wm, ps, sgd(1e-2), cross_entropy_loss,
                          devices=[torch.device("cpu")])
    ttrace, runner = run(model, ps, wm, Runner, TraceHook, ttel,
                         tmp_path / "torch.json")
    assert _named_sequence(ttrace) == _named_sequence(jtrace)
    names = [e[1] for e in _named_sequence(ttrace)]
    assert names[:2] == ["run_start", "preflight"]
    assert names.count("iter") == 2 and names[-1] == "run_end"
    report = ttel.analysis.analyze(ttrace["traceEvents"])
    assert report["steps"]["count"] == 2 and report["num_stages"] == 3
    assert len(ttel.analysis.measured_stage_seconds(report)) == 3
    assert runner.metrics.snapshot()["pipeline"]["loss"] == \
        runner.model.stats.loss
    series = runner.enable_timeseries(window=4)
    assert runner.enable_timeseries() is series
    assert series.type_of("pipeline.loss") == "gauge"
