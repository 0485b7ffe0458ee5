"""``python -m skycomputing_tpu_torch.tools.trace_report`` and the port's
trace analysis against the JAX package's ``tools/trace_report.py`` and
``skycomputing_tpu/telemetry/analysis.py`` on the repository's fixture
traces: every key both reports produce equal to 1e-9, the baseline
targets equal, and the same exit code for the same trace and baseline
(0 within tolerance, 2 on a regression, 1 on a baseline with no
recognized keys); the serving breakdown, the padding waste, the request
ids and every request's waterfall equal, exactly, on the fixtures and on
a trace the port's serving engine wrote; ``--request`` with the
reference's exit codes."""

import importlib.util
import json
from pathlib import Path

import pytest

from skycomputing_tpu.telemetry import analysis as jax_analysis
from skycomputing_tpu_torch.telemetry import analysis
from skycomputing_tpu_torch.tools import trace_report

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tools" / "fixtures"
TRACES = ["trace_smoke.json", "trace_straggler.json"]


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_trace_report", REPO / "tools" / "trace_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _common_equal(got, want, path=""):
    """Every key present in both, recursively; numbers to 1e-9.
    Returns the number of leaves compared."""
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        shared = set(got) & set(want)
        return sum(_common_equal(got[k], want[k], f"{path}.{k}")
                   for k in shared)
    if isinstance(want, (int, float)) and not isinstance(want, bool):
        assert got == pytest.approx(want, abs=1e-9), path
        return 1
    assert got == want, path
    return 1


@pytest.mark.parametrize("name", TRACES)
def test_analyze_equals_jax_on_the_fixtures(name):
    events = analysis.load_events(str(FIXTURES / name))
    got = analysis.analyze(events)
    want = jax_analysis.analyze(jax_analysis.load_events(str(FIXTURES / name)))
    leaves = _common_equal(got, want)
    assert leaves >= 12
    # the key the port leaves out is XLA's compile count
    assert set(want) - set(got) <= {"xla_compiles"}
    assert got.get("serving") == want.get("serving")
    assert analysis.measured_stage_seconds(got) == pytest.approx(
        jax_analysis.measured_stage_seconds(want), abs=1e-12)


def test_request_only_trace_refused_by_both():
    path = str(FIXTURES / "trace_request.json")
    with pytest.raises(analysis.TraceError):
        analysis.analyze(analysis.load_events(path))
    with pytest.raises(jax_analysis.TraceError):
        jax_analysis.analyze(jax_analysis.load_events(path))


@pytest.mark.parametrize("bench", sorted(
    p.name for p in REPO.glob("BENCH_*.json")))
def test_baseline_targets_equal_jax(bench):
    path = str(REPO / bench)
    assert analysis.baseline_targets(path) == jax_analysis.baseline_targets(
        path)


BASELINES = {
    "within": {"step_ms": 100.0},
    "step_regressed": {"step_ms": 1.0},
    "bubble_regressed": {"bubble_fraction": 0.1},
    "nested_seconds": {"runs": [{"step_wall_s": 0.02}, {"step_s": 0.5}]},
    "unrecognized": {"tokens_per_s": 3.0},
}


@pytest.mark.parametrize("baseline", sorted(BASELINES))
@pytest.mark.parametrize("name", TRACES)
def test_baseline_exit_code_equals_jax(tmp_path, capsys, name, baseline):
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps(BASELINES[baseline]))
    argv = [str(FIXTURES / name), "--baseline", str(path), "--json"]
    got = trace_report.main(argv)
    got_out = json.loads(capsys.readouterr().out.splitlines()[0]) \
        if got != 1 else None
    want = _jax_tool().main(argv)
    want_out = json.loads(capsys.readouterr().out.splitlines()[0]) \
        if want != 1 else None
    assert got == want
    assert got in (0, 1, 2)
    if got != 1:
        gate, jax_gate = got_out["baseline_gate"], want_out["baseline_gate"]
        assert gate["failures"] == jax_gate["failures"]
        assert gate["targets"] == jax_gate["targets"]
    if baseline == "within":
        assert got == 0
    if baseline.endswith("regressed"):
        assert got == 2


def test_smoke_and_human_report(capsys):
    assert trace_report.main(["--smoke"]) == 0
    out = capsys.readouterr().out
    assert "bubble fraction" in out and "# smoke: ok" in out
    assert trace_report.main([str(FIXTURES / "trace_request.json")]) == 1


# --- the serving breakdown and request timelines -----------------------------

def _serving_trace():
    """Events a traced paged engine of the port wrote on the CPU: waves
    over two buckets, a swap preemption and a reconfigure mid-run."""
    import numpy as np

    from skycomputing_tpu_torch import telemetry
    from skycomputing_tpu_torch.models.gpt import (
        GptConfig,
        gpt_layer_configs,
        random_state_dicts,
    )
    from skycomputing_tpu_torch.serving import Request, ServingEngine

    cfg = GptConfig(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=2, max_position_embeddings=64,
                    dropout_prob=0.0, dtype="float32")
    layer_cfgs = gpt_layer_configs(cfg, deterministic=True)
    engine = ServingEngine(layer_cfgs, random_state_dicts(layer_cfgs, 0),
                           device="cpu", num_slots=2, max_len=48,
                           buckets=(8, 32), kv_layout="paged", page_size=8)
    rng = np.random.default_rng(5)
    reqs = [Request(prompt=rng.integers(1, 128, (n,)).astype(np.int32),
                    max_new_tokens=5) for n in (5, 20, 7, 3, 12)]
    tracer = telemetry.enable_tracing()
    try:
        for r in reqs:
            engine.submit(r)
        for _ in range(3):
            engine.step()
        engine.preempt(reqs[0].request_id, mode="swap")
        engine.reconfigure(buckets=(8, 16, 32))
        engine.run()
    finally:
        telemetry.disable_tracing()
    return tracer.to_chrome()["traceEvents"], reqs


@pytest.fixture(scope="module")
def engine_trace():
    return _serving_trace()


def test_serving_section_equals_jax(engine_trace):
    events, _ = engine_trace
    got, want = analysis.analyze(events), jax_analysis.analyze(events)
    assert got["serving"] == want["serving"]
    assert got["serving"]["prefill_waves"] >= 3
    assert set(got["serving"]["buckets"]) >= {"8", "32"}
    assert got["serving"]["preemptions"] == 1
    assert analysis.serving_padding_fraction(got["serving"]) == \
        jax_analysis.serving_padding_fraction(want["serving"])
    # the stage lanes carry each stage's share of every wave and tick
    assert got["num_stages"] == want["num_stages"] == 1


@pytest.mark.parametrize("source", ["fixture", "engine"])
def test_request_timelines_equal_jax(engine_trace, source):
    if source == "fixture":
        events = analysis.load_events(str(FIXTURES / "trace_request.json"))
    else:
        events = engine_trace[0]
    ids = analysis.request_ids(events)
    assert ids == jax_analysis.request_ids(events)
    assert ids
    for rid in ids:
        got = analysis.request_timeline(events, rid)
        assert got == jax_analysis.request_timeline(events, rid)
        assert got["orphan_spans"] == 0
    with pytest.raises(analysis.TraceError):
        analysis.request_timeline(events, max(ids) + 1000)
    if source == "engine":
        swapped = analysis.request_timeline(events, engine_trace[1][0]
                                            .request_id)
        assert swapped["complete"] and swapped["preemptions"] == 1
        assert {s["name"] for s in swapped["segments"]} == {
            "queue_wait", "prefill", "decode"}


REQUEST_ARGS = {
    "fixture_request": [str(FIXTURES / "trace_request.json"), "--request",
                        "7"],
    "fixture_request_json": [str(FIXTURES / "trace_request.json"),
                             "--request", "7", "--json"],
    "unknown_request": [str(FIXTURES / "trace_request.json"), "--request",
                        "0"],
    "smoke_request": ["--smoke", "--request", "7"],
    "smoke_request_unknown": ["--smoke", "--request", "3"],
    "missing_file": [str(FIXTURES / "no_such_trace.json"), "--request",
                     "7"],
}


@pytest.mark.parametrize("case", sorted(REQUEST_ARGS))
def test_request_mode_exit_codes_equal_jax(capsys, case):
    argv = REQUEST_ARGS[case]
    got = trace_report.main(argv)
    got_out = capsys.readouterr().out
    want = _jax_tool().main(argv)
    want_out = capsys.readouterr().out
    assert got == want
    if case.endswith("_json"):
        assert json.loads(got_out) == json.loads(want_out)
    elif got == 0:
        assert got_out == want_out
    if case in ("fixture_request", "smoke_request"):
        assert got == 0 and "migration" in got_out
