"""The port's skylint (``analysis/lint.py``, torch rules) and skyaudit
(``analysis/audit.py``, the port's manifest), and their commands:

- every rule the port has fires on a bad fixture and stays quiet on a
  clean one (SKY001-SKY003, SKY005-SKY008; AUD001-AUD006,
  SKY009-SKY011); SKY004 has a stated reason and no counterpart;
- suppression comments are read from comments only, and a file that
  does not parse is a finding;
- the self-gates are green over the port and ``chip_smoke.py``
  (skylint with a reason beside each suppression, skyaudit with none);
- a lazy ``import jax`` injected anywhere in a copy of the port is
  caught as AUD004 with its import chain;
- each command's exit codes (0 clean, 1 findings, 2 bad invocation)
  and ``--changed-only``, and each loads by file path with torch
  blocked."""

import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from skycomputing_tpu_torch.analysis import audit, lint
from skycomputing_tpu_torch.tools import changed as changed_mod
from skycomputing_tpu_torch.tools import skyaudit, skylint

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "skycomputing_tpu_torch"
GATE = [str(PORT), str(REPO / "chip_smoke.py")]


def _lint(src, path="fixture.py"):
    return [f.rule for f in lint.lint_source(textwrap.dedent(src), path)]


# --- skylint's rules: a bad and a clean fixture each -------------------------

LINT_CASES = {
    "SKY001": (
        """
        import torch
        def train_step(x):
            y = torch.matmul(x, x)
            loss = float(y.sum())
            return y.mean().item() + loss
        """,
        """
        import torch
        def train_step(x, devices, config):
            y = torch.matmul(x, x)
            seeds = torch.randint(0, 9, (3,)).tolist()  # a CPU tensor
            width = int(config["width"])  # a host value
            _synchronize(devices)
            return float(y.sum()), seeds, width
        """),
    "SKY002": (
        """
        from skycomputing_tpu_torch.ops import _build
        def step(self):
            lib = _build.load("paged_attention")
            return lib
        """,
        """
        import torch
        from skycomputing_tpu_torch.ops import _build
        class Engine:
            def __init__(self):
                self.lib = _build.load("paged_attention")
                self.fn = torch.compile(lambda x: x)
            def step(self):
                return self.lib
        """),
    "SKY003": (
        """
        import numpy as np
        import torch
        import torch.nn.functional as F
        def init(x):
            torch.manual_seed(0)
            a = torch.randn(3)
            b = F.dropout(x, 0.1)
            return a, b, np.random.rand(3)
        """,
        """
        import numpy as np
        import torch
        def init(x, g):
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                a = torch.randn(3)
            b = torch.rand(3, generator=g)
            return a, b, np.random.default_rng(0).random(3)
        """),
    "SKY005": (
        """
        import time
        import torch
        import numpy as np
        def timed(a, b, stage, x, loss, opt, scheduler, worker):
            t0 = time.perf_counter()
            y = torch.matmul(a, b)
            dt = time.perf_counter() - t0
            t1 = time.perf_counter()
            stage.forward_raw(x)
            dt1 = time.perf_counter() - t1
            t2 = time.perf_counter()
            loss.backward()
            opt.step()  # an optimizer's step returns before the work
            scheduler.step()
            dt2 = time.perf_counter() - t2
            t3 = time.perf_counter()
            z = torch.matmul(a, b)
            worker.run()  # a thread's run is no sync either
            w = np.asarray(z)  # raises on a CUDA tensor: no sync
            return y, w, dt, dt1, dt2, time.perf_counter() - t3
        """,
        """
        import time
        import torch
        from skycomputing_tpu_torch.serving import ServingEngine
        from skycomputing_tpu_torch.workload import ScenarioPlayer
        def timed(a, b, engine, model, data, labels, devices, self,
                  fleet_a, cfgs, params, scenario, reqs):
            t0 = time.perf_counter()
            y = torch.matmul(a, b)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            t1 = time.perf_counter()
            engine.step()  # the port's tick ends with a host read
            model.train_step(data, labels)  # ends at its barrier
            wall = time.perf_counter() - t1
            t2 = time.perf_counter()
            z = torch.matmul(a, b)
            _synchronize(devices)
            t_dispatch = time.perf_counter() - t2
            srv = ServingEngine(cfgs, params)
            t3 = time.perf_counter()
            torch.matmul(a, b)
            self.warm_engine.step()
            w3 = time.perf_counter() - t3
            t4 = time.perf_counter()
            torch.matmul(a, b)
            fleet_a.step()
            w4 = time.perf_counter() - t4
            t5 = time.perf_counter()
            torch.matmul(a, b)
            srv.run(reqs)  # a name bound to a ServingEngine
            w5 = time.perf_counter() - t5
            t6 = time.perf_counter()
            torch.matmul(a, b)
            ScenarioPlayer(scenario, fleet_a).play()
            w6 = time.perf_counter() - t6
            return y, z, dt, wall, t_dispatch, w3, w4, w5, w6
        """),
    "SKY006": (
        """
        import pdb
        import torch
        def f():
            torch.autograd.set_detect_anomaly(True)
            breakpoint()
        """,
        """
        import torch
        def f():
            torch.autograd.set_detect_anomaly(False)
        """),
    "SKY007": (
        """
        from skycomputing_tpu_torch import build_layer_stack
        stack = build_layer_stack([dict(hidden=4), {"width": 2}])
        """,
        """
        from skycomputing_tpu_torch import build_layer_stack
        base = dict(layer_type="Dense", hidden=4)
        stack = build_layer_stack([dict(layer_type="Dense", hidden=4),
                                   {"layer_type": "Dense"}, dict(**base)])
        """),
    "SKY008": (
        """
        def run(layer, nxt, x):
            out = layer.forward(x)
            return nxt(*out)
        """,
        """
        from skycomputing_tpu_torch.builder.layer_stack import as_tuple
        def run(layer, nxt, x):
            out = layer.forward(x)
            out = as_tuple(out)
            return nxt(*out)
        """),
}


@pytest.mark.parametrize("kind", ["bad", "clean"])
@pytest.mark.parametrize("rule", sorted(LINT_CASES))
def test_lint_rule_fixture(rule, kind):
    bad, clean = LINT_CASES[rule]
    rules = _lint(bad if kind == "bad" else clean)
    if kind == "bad":
        assert rule in rules
    else:
        assert rule not in rules, rules


def test_lint_bad_fixtures_count_each_site():
    assert _lint(LINT_CASES["SKY001"][0]).count("SKY001") == 2
    assert _lint(LINT_CASES["SKY003"][0]).count("SKY003") == 4
    assert _lint(LINT_CASES["SKY005"][0]).count("SKY005") == 4
    assert _lint(LINT_CASES["SKY006"][0]).count("SKY006") == 3


def test_every_reference_rule_has_a_counterpart_or_a_reason():
    reference = {f"SKY00{i}" for i in range(1, 9)}
    assert set(lint.RULES) | set(lint.NO_COUNTERPART) == reference
    assert not set(lint.RULES) & set(lint.NO_COUNTERPART)
    assert "donates no buffer" in lint.NO_COUNTERPART["SKY004"]
    assert "SKY004" in lint.__doc__ and "no counterpart" in lint.__doc__


def test_lint_suppression_reads_comments_only():
    src = """
    import torch
    def f():
        torch.manual_seed(0)  # skylint: disable=SKY003  -- fixture
        torch.manual_seed(1)
        s = "# skylint: disable=SKY003"
        return s
    """
    findings = lint.lint_source(textwrap.dedent(src), "x.py",
                                lint.LintConfig(include_suppressed=True))
    assert [(f.line, f.suppressed) for f in findings] == [(4, True),
                                                           (5, False)]
    assert _lint("# skylint: disable-file=SKY003\nimport torch\n"
                 "torch.manual_seed(0)\n") == []


def test_lint_unparseable_file_is_a_finding():
    assert _lint("def broken(:\n") == ["SKY000"]


# --- skyaudit's rules over a fixture package ---------------------------------

def _tree(root, files):
    for rel, src in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    return root


def _manifest(**over):
    m = {"package": "pkg",
         "layers": {"root": {"modules": ["pkg"], "may_import": ["*"]},
                    "low": {"modules": ["pkg.low"], "may_import": []},
                    "high": {"modules": ["pkg.high"],
                             "may_import": ["low"]}},
         "pure_stdlib": [], "file_path_tools": [], "forbidden_reach": [],
         "counter_bank_sites": [], "snapshot_contracts": {}}
    m.update(over)
    return m


def _audit(tmp_path, files, manifest):
    _tree(tmp_path, files)
    return audit.audit_paths([str(tmp_path / "pkg")],
                             manifest=manifest)


AUDIT_CASES = {
    "AUD001": (
        {"pkg/__init__.py": "", "pkg/low/__init__.py": "",
         "pkg/low/a.py": "from pkg.high import b\n",
         "pkg/high/__init__.py": "", "pkg/high/b.py": "X = 1\n"},
        {"pkg/__init__.py": "", "pkg/low/__init__.py": "",
         "pkg/low/a.py": "X = 1\n", "pkg/high/__init__.py": "",
         "pkg/high/b.py": "from pkg.low import a\n"}, {}),
    "AUD002": (
        {"pkg/__init__.py": "", "pkg/low/__init__.py": "",
         "pkg/low/pure.py": "import numpy\n"},
        {"pkg/__init__.py": "", "pkg/low/__init__.py": "",
         "pkg/low/pure.py": "import json\n\ndef f():\n"
                            "    import numpy\n    return numpy\n"},
        dict(pure_stdlib=["pkg.low.pure"])),
    "AUD003": (
        {"pkg/__init__.py": "", "pkg/low/__init__.py": "",
         "pkg/low/a.py": "from pkg.low import b\n",
         "pkg/low/b.py": "from pkg.low import a\n"},
        {"pkg/__init__.py": "", "pkg/low/__init__.py": "",
         "pkg/low/a.py": "from pkg.low import b\n",
         "pkg/low/b.py": "def f():\n    from pkg.low import a\n"
                         "    return a\n"}, {}),
    "AUD004": (
        {"pkg/__init__.py": "", "pkg/low/__init__.py": "",
         "pkg/low/a.py": "def f():\n    import jax\n    return jax\n"},
        {"pkg/__init__.py": "", "pkg/low/__init__.py": "",
         "pkg/low/a.py": "import torch\n"},
        dict(forbidden_reach=[("pkg", "jax", "fixture", "any")])),
    "AUD005": (
        {"pkg/__init__.py": "", "pkg/low/__init__.py": "",
         "pkg/low/s.py": """
            from dataclasses import dataclass
            @dataclass
            class Stats:
                FIELD_TYPES = {"hits": "counter"}
                hits: int = 0
                misses: int = 0
                def snapshot(self):
                    return dict(hits=self.hits, depth=1)
            """},
        {"pkg/__init__.py": "", "pkg/low/__init__.py": "",
         "pkg/low/s.py": """
            from dataclasses import dataclass
            @dataclass
            class Stats:
                FIELD_TYPES = {"hits": "counter", "misses": "counter"}
                hits: int = 0
                misses: int = 0
                def snapshot(self):
                    return dict(hits=self.hits, misses=self.misses)
            """}, {}),
    "AUD006": (
        {"pkg/__init__.py": "", "pkg/low/__init__.py": "",
         "pkg/low/s.py": """
            class Stats:
                FIELD_TYPES = {"hits": "counter"}
            class Engine:
                def reset(self):
                    self.stats.hits = 0
            """},
        {"pkg/__init__.py": "", "pkg/low/__init__.py": "",
         "pkg/low/s.py": """
            class Stats:
                FIELD_TYPES = {"hits": "counter"}
            class Engine:
                def hit(self):
                    self.stats.hits += 1
            """}, {}),
    "SKY009": (
        {"pkg/__init__.py": "", "pkg/low/__init__.py": "",
         "pkg/low/t.py": """
            import threading
            class Server:
                def __init__(self):
                    self.count = 0
                    self._thread = threading.Thread(target=self._loop)
                def _loop(self):
                    self.count = 1
                def reset(self):
                    self.count = 0
            """},
        {"pkg/__init__.py": "", "pkg/low/__init__.py": "",
         "pkg/low/t.py": """
            import threading
            class Server:
                def __init__(self):
                    self.count = 0
                    self._lock = threading.Lock()
                    self._thread = threading.Thread(target=self._loop)
                def _loop(self):
                    with self._lock:
                        self.count = 1
                def reset(self):
                    with self._lock:
                        self.count = 0
            """}, {}),
    "SKY010": (
        {"pkg/__init__.py": "", "pkg/low/__init__.py": "",
         "pkg/low/t.py": """
            import threading
            class Box:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.items = []
                def add(self, x):
                    with self._lock:
                        self.items.append(x)
                def drop(self):
                    self.items.clear()
            """},
        {"pkg/__init__.py": "", "pkg/low/__init__.py": "",
         "pkg/low/t.py": """
            import threading
            class Box:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.items = []
                def add(self, x):
                    with self._lock:
                        self.items.append(x)
                def drop(self):
                    with self._lock:
                        self.items.clear()
            """}, {}),
    "SKY011": (
        {"pkg/__init__.py": "", "pkg/low/__init__.py": "",
         "pkg/low/t.py": """
            import threading
            class Server:
                def __init__(self):
                    self.series = {}
                    self._lock = threading.Lock()
                    self._t = threading.Thread(target=self._serve)
                def _serve(self):
                    return [k for k in self.series]
            """},
        {"pkg/__init__.py": "", "pkg/low/__init__.py": "",
         "pkg/low/t.py": """
            import threading
            class Server:
                def __init__(self):
                    self.series = {}
                    self._lock = threading.Lock()
                    self._t = threading.Thread(target=self._serve)
                def _serve(self):
                    with self._lock:
                        return [k for k in self.series]
            """}, {}),
}


@pytest.mark.parametrize("kind", ["bad", "clean"])
@pytest.mark.parametrize("rule", sorted(AUDIT_CASES))
def test_audit_rule_fixture(tmp_path, rule, kind):
    bad, clean, over = AUDIT_CASES[rule]
    found = _audit(tmp_path, bad if kind == "bad" else clean,
                   _manifest(**over))
    rules = [f.rule for f in found]
    if kind == "bad":
        assert rule in rules, [f.format() for f in found]
    else:
        assert rule not in rules, [f.format() for f in found]


def test_port_manifest_declares_the_port():
    m = audit.MANIFEST
    assert m["package"] == "skycomputing_tpu_torch"
    layers = {spec["modules"][0].split(".")[-1]
              for spec in m["layers"].values()}
    assert {"ops", "models", "serving", "fleet", "disagg", "chaos",
            "workload", "telemetry", "tuning", "analysis", "dynamics",
            "parallel", "runner", "tools"} <= layers
    assert {"skycomputing_tpu_torch.chaos.plan",
            "skycomputing_tpu_torch.disagg.handoff",
            "skycomputing_tpu_torch.workload.scenario",
            "skycomputing_tpu_torch.tuning.advisor",
            "skycomputing_tpu_torch.telemetry.analysis",
            "skycomputing_tpu_torch.analysis.lint",
            "skycomputing_tpu_torch.analysis.audit",
            "skycomputing_tpu_torch.analysis.determinism"} <= set(
        m["pure_stdlib"])
    reach = {(r[0], r[1]) for r in m["forbidden_reach"]}
    for target in ("jax", "flax", "skycomputing_tpu"):
        assert ("skycomputing_tpu_torch", target) in reach
        assert ("chip_smoke", target) in reach
    assert ("skycomputing_tpu_torch.dynamics",
            "skycomputing_tpu_torch.fleet") in reach


def test_injected_jax_import_caught_with_its_chain(tmp_path):
    """A lazy ``import jax`` in one module, a guarded ``import flax`` and
    a guarded import of the JAX package in others: each is AUD004 at its
    own line, with the chain that reaches it from the port."""
    copy = tmp_path / "skycomputing_tpu_torch"
    shutil.copytree(PORT, copy,
                    ignore=shutil.ignore_patterns("__pycache__", "csrc",
                                                  "native"))
    injected = {
        "jax": (copy / "serving" / "paging.py",
                "\n\ndef _probe():\n    import jax\n    return jax\n"),
        "flax": (copy / "tuning" / "advisor.py",
                 "\ntry:\n    import flax\nexcept ImportError:\n"
                 "    pass\n"),
        "skycomputing_tpu": (copy / "fleet" / "router.py",
                             "\ntry:\n    import skycomputing_tpu.tuning\n"
                             "except ImportError:\n    pass\n"),
    }
    for path, text in injected.values():
        path.write_text(path.read_text() + text)
    found = [f for f in audit.audit_paths([str(copy)])
             if f.rule == "AUD004"]
    assert len(found) == 3, [f.format() for f in found]
    for target, (path, _) in injected.items():
        f = next(f for f in found if f.path == str(path))
        chain = re.search(r": (\S.* -> (\S+) \((lazy|guarded)\))",
                          f.message)
        assert chain.group(2).split(".")[0] == target
        assert chain.group(3) == ("lazy" if target == "jax" else "guarded")
        hops = chain.group(1).split(" -> ")
        assert hops[0].startswith("skycomputing_tpu_torch")
        assert hops[-2] == _module(path, copy)


def _module(path, copy):
    rel = path.relative_to(copy.parent).with_suffix("")
    return ".".join(rel.parts)


# --- the self-gates ----------------------------------------------------------

def test_skylint_gate_green_with_reasoned_suppressions(capsys):
    assert skylint.main(GATE + ["--strict", "--show-suppressed",
                                "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] and doc["counts"] == {}
    for f in doc["findings"]:
        assert f["suppressed"]
        line = Path(f["path"]).read_text().splitlines()[f["line"] - 1]
        assert re.search(r"skylint: disable=\S+\s+--\s+\S", line), line


def test_skyaudit_gate_green_with_no_suppression(capsys):
    assert skyaudit.main(GATE + ["--strict", "--show-suppressed",
                                 "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc == {"findings": [], "counts": {}, "ok": True}
    for path in [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]:
        # suppression comments (docstrings that show the syntax are not)
        assert audit._suppressions(path.read_text()) == ({}, set()), path


# --- the commands ------------------------------------------------------------

@pytest.fixture
def fixture_files(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\ntorch.manual_seed(0)\n")
    clean = tmp_path / "clean.py"
    clean.write_text("import json\n")
    return bad, clean


@pytest.mark.parametrize("tool", ["skylint", "skyaudit"])
def test_command_exit_codes(capsys, fixture_files, tool):
    mod = {"skylint": skylint, "skyaudit": skyaudit}[tool]
    bad, clean = fixture_files
    assert mod.main([str(clean), "--strict"]) == 0
    if tool == "skylint":
        assert mod.main([str(bad), "--strict"]) == 1
        assert mod.main([str(bad), "--select", "SKY004"]) == 0
        assert mod.main([str(bad), "--ignore", "SKY003"]) == 0
    assert mod.main([str(clean / "nope"), "--strict"]) == 2
    assert mod.main([str(clean), "--strict", "--select", "XYZ123"]) == 2
    capsys.readouterr()
    assert mod.main([str(clean), "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc == {"findings": [], "counts": {}, "ok": True}


def test_skylint_json_counts(capsys, fixture_files):
    bad, _ = fixture_files
    assert skylint.main([str(bad), "--json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["counts"] == {"SKY003": 1} and doc["ok"] is False
    assert doc["findings"][0]["line"] == 2


def test_changed_only_takes_named_files(capsys, fixture_files):
    bad, clean = fixture_files
    assert skylint.main(["--changed-only", str(bad)]) == 1
    assert skylint.main(["--changed-only", str(clean)]) == 0
    assert skyaudit.main(["--changed-only", str(clean)]) == 0


def _git(cwd, *args):
    subprocess.run(["git", *args], cwd=cwd, check=True,
                   capture_output=True, text=True,
                   env=dict(os.environ, GIT_AUTHOR_NAME="t",
                            GIT_AUTHOR_EMAIL="t@t", GIT_COMMITTER_NAME="t",
                            GIT_COMMITTER_EMAIL="t@t"))


@pytest.mark.skipif(shutil.which("git") is None, reason="needs git")
def test_changed_python_files_from_git(tmp_path):
    repo = tmp_path / "r"
    (repo / "pkg").mkdir(parents=True)
    (repo / "pkg" / "kept.py").write_text("A = 1\n")
    (repo / "pkg" / "edited.py").write_text("B = 1\n")
    (repo / "other.py").write_text("C = 1\n")
    _git(repo, "init", "-q")
    _git(repo, "add", "-A")
    _git(repo, "commit", "-q", "-m", "base")
    (repo / "pkg" / "edited.py").write_text("B = 2\n")
    (repo / "pkg" / "new.py").write_text("D = 1\n")
    (repo / "other.py").write_text("C = 2\n")
    (repo / "pkg" / "notes.txt").write_text("x\n")
    got = changed_mod.changed_python_files([str(repo / "pkg")],
                                           cwd=str(repo))
    assert [Path(p).name for p in got] == ["edited.py", "new.py"]
    assert changed_mod.changed_python_files(
        [str(repo / "other.py")], cwd=str(repo)) == [str(repo / "other.py")]
    assert changed_mod.changed_python_files(
        [str(tmp_path)], cwd=str(tmp_path / "nowhere")) is None


BLOCKER = """
import importlib.abc, runpy, sys
class B(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in {'torch', 'numpy', 'jax', 'flax',
                                  'skycomputing_tpu',
                                  'skycomputing_tpu_torch'}:
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, B())
script = sys.argv[1]
sys.argv = sys.argv[1:]
runpy.run_path(script, run_name='__main__')
"""


@pytest.mark.parametrize("tool", ["skylint", "skyaudit", "skydet"])
def test_command_loads_by_file_path_with_torch_blocked(fixture_files, tool):
    bad, clean = fixture_files
    script = str(PORT / "tools" / f"{tool}.py")
    run = [sys.executable, "-c", BLOCKER, script]
    extra = ["--no-load-check"] if tool == "skydet" else []
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run(run + [str(clean), "--strict"] + extra,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    proc = subprocess.run(run + [str(clean), "--select", "NOPE", "--strict"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120, env=env)
    assert proc.returncode == 2
