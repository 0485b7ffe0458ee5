"""``python -m skycomputing_tpu_torch.tools.trace_report`` and the port's
trace analysis against the JAX package's ``tools/trace_report.py`` and
``skycomputing_tpu/telemetry/analysis.py`` on the repository's fixture
traces: every key both reports produce equal to 1e-9, the baseline
targets equal, and the same exit code for the same trace and baseline
(0 within tolerance, 2 on a regression, 1 on a baseline with no
recognized keys)."""

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
    # the keys the port leaves out are the serving planes' and XLA's
    assert set(want) - set(got) <= {"serving", "xla_compiles"}
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
