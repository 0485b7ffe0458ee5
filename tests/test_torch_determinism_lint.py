"""The port's skydet (``analysis/determinism.py``) over the port's
manifest (``analysis/audit.py``), and its command:

- every rule (DET001-DET006) fires on a bad fixture and stays quiet on
  a clean one, with the manifest's declarations deciding which module
  is deterministic, one-rng, on a digest path or a sanctioned sleeper;
- DET005's port counterpart: every input of the kernel build's compile
  command reaches the library's hashed key (``ops/_build.py``), the
  compiler's path exempt with its reason in the manifest;
- every ``pure_stdlib`` module of the manifest loads by file path;
- the self-gate is green over the port, ``chip_smoke.py`` and
  ``tests/test_torch_*.py`` with no inline suppression;
- the command's exit codes and ``--changed-only``."""

import copy
import json
import textwrap
from pathlib import Path

import pytest

from skycomputing_tpu_torch.analysis import audit, determinism
from skycomputing_tpu_torch.tools import skydet

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "skycomputing_tpu_torch"
BUILD = PORT / "ops" / "_build.py"


def _manifest(**over):
    m = dict(deterministic_modules=["pkg.det"], one_rng_modules=["pkg.det"],
             rng_global_sanctions=[], digest_excluded_fields=["wall_s"],
             digest_path_functions=["Row.key"], program_caches=["_CACHE"],
             program_cache_gates=[], id_key_pins={},
             wallclock_test_sanctions=[], kernel_builds={}, pure_stdlib=[])
    m.update(over)
    return m


def _check(src, module="pkg.det", path="pkg/det.py", manifest=None):
    return [f.rule for f in determinism.check_source(
        textwrap.dedent(src), path, manifest=manifest or _manifest(),
        module=module)]


DET_CASES = {
    "DET001": (
        dict(src="""
            import time
            def schedule(seed):
                return time.time() + seed
            """),
        dict(src="""
            import time
            def schedule(seed, clock=time.monotonic):
                return clock() + seed
            """)),
    "DET002": (
        dict(src="""
            import random
            import numpy as np
            def draw(seed):
                a = random.Random(seed)
                b = random.Random(seed + 1)
                return random.random(), np.random.rand(), a, b
            """),
        dict(src="""
            import random
            import numpy as np
            def draw(seed):
                rng = random.Random(seed)
                return rng.random(), np.random.default_rng(seed).random()
            """)),
    "DET003": (
        dict(src="""
            import hashlib
            def digest(rows):
                h = hashlib.sha256()
                for k, v in rows.items():
                    h.update(repr((k, v.wall_s)).encode())
                return h.hexdigest()
            """),
        dict(src="""
            import hashlib
            def digest(rows):
                h = hashlib.sha256()
                for k, v in sorted(rows.items()):
                    h.update(repr((k, v.tokens)).encode())
                return h.hexdigest()
            """)),
    "DET004": (
        dict(src="""
            _CACHE = {}
            def lookup(obj, n):
                key = (id(obj), n)
                return _CACHE.get(key)
            """),
        dict(src="""
            _CACHE = {}
            def lookup(obj, n):
                key = (obj.name, n)
                return _CACHE.get(key)
            """)),
    "DET005": (
        dict(src=BUILD.read_text().replace(
            'cmd = [nvcc_path(), *NVCC_FLAGS,',
            'cmd = [nvcc_path(), *NVCC_FLAGS, *EXTRA_FLAGS,'),
             module="skycomputing_tpu_torch.ops._build", manifest="port"),
        dict(src=BUILD.read_text(),
             module="skycomputing_tpu_torch.ops._build", manifest="port")),
    "DET006": (
        dict(src="""
            import time
            def test_fast():
                t0 = time.perf_counter()
                time.sleep(0.01)
                assert time.perf_counter() - t0 < 0.5
            """, module="tests.test_x", path="tests/test_x.py"),
        dict(src="""
            import time
            def test_fast():
                t0 = time.perf_counter()
                time.sleep(0.01)
                t1 = time.perf_counter()
                assert (t1 - t0) / (t1 - t0 + 1.0) < 1.0
            """, module="tests.test_x", path="tests/test_x.py",
             manifest=_manifest(wallclock_test_sanctions=[
                 "test_x.py::test_fast"]))),
}


@pytest.mark.parametrize("kind", ["bad", "clean"])
@pytest.mark.parametrize("rule", sorted(DET_CASES))
def test_det_rule_fixture(rule, kind):
    case = dict(DET_CASES[rule][0 if kind == "bad" else 1])
    if case.get("manifest") == "port":
        case["manifest"] = audit.MANIFEST
    rules = _check(**case)
    if kind == "bad":
        assert rule in rules, rules
    else:
        assert rule not in rules, rules


def test_det_rules_follow_the_manifest():
    wall = "import time\ndef f():\n    return time.time()\n"
    assert _check(wall) == ["DET001"]
    assert _check(wall, module="pkg.other") == []
    two = ("import random\ndef f(s):\n    return random.Random(s), "
           "random.Random(s)\n")
    assert _check(two).count("DET002") == 1
    assert _check(two, manifest=_manifest(one_rng_modules=[])) == []
    pinned = ("_CACHE = {}\ndef lookup(obj):\n    key = id(obj)\n"
              "    return _CACHE.get(key)\n")
    assert _check(pinned) == ["DET004"]
    assert _check(pinned, manifest=_manifest(
        id_key_pins={"pkg.det.lookup": "pinned"})) == []
    row = ("class Row:\n    def key(self):\n"
           "        return (self.tokens, self.wall_s)\n")
    assert _check(row) == ["DET003"]


def test_kernel_key_rule_reads_the_port_build():
    """The real ``ops/_build.py`` is clean under the port's manifest; its
    one exempt input is the compiler, and dropping the exemption (or
    hashing one input less) makes the rule name the input."""
    port = audit.MANIFEST
    spec = port["kernel_builds"]["skycomputing_tpu_torch.ops._build"]
    assert set(spec["exempt"]) == {"nvcc_path"}
    assert all(len(why) > 40 for why in spec["exempt"].values())
    src = BUILD.read_text()
    mod = "skycomputing_tpu_torch.ops._build"
    assert _check(src, module=mod, manifest=port) == []
    bare = copy.deepcopy(port)
    bare["kernel_builds"][mod]["exempt"] = {}
    found = determinism.check_source(src, str(BUILD), manifest=bare,
                                     module=mod)
    assert [f.rule for f in found] == ["DET005"]
    assert "`nvcc_path`" in found[0].message
    unhashed = src.replace(' + " ".join(NVCC_FLAGS).encode()', "")
    assert unhashed != src
    found = determinism.check_source(unhashed, str(BUILD), manifest=port,
                                     module=mod)
    assert ["`NVCC_FLAGS`" in f.message for f in found] == [True]
    wrong = copy.deepcopy(port)
    wrong["kernel_builds"][mod]["key"] = "no_such_key"
    assert _check(src, module=mod, manifest=wrong) == ["DET005"]


def test_manifest_declares_the_replay_planes():
    m = audit.MANIFEST
    for name in ("chaos.plan", "workload.scenario", "disagg.handoff",
                 "fleet.router", "tuning.advisor"):
        dotted = f"skycomputing_tpu_torch.{name}"
        assert dotted in m["deterministic_modules"]
        assert dotted in m["one_rng_modules"]
    assert m["program_caches"] == ["_loaded"]
    assert "request_id" in m["digest_excluded_fields"]


def test_pure_stdlib_modules_load_by_file_path():
    assert determinism.check_pure_stdlib_loads(root=str(REPO)) == []
    broken = dict(audit.MANIFEST,
                  pure_stdlib=["skycomputing_tpu_torch.no_such_module"])
    found = determinism.check_pure_stdlib_loads(broken, root=str(REPO))
    assert [f.rule for f in found] == ["DET000"]


def test_skydet_gate_green_with_no_suppression(capsys):
    assert skydet.main(["--strict"]) == 0
    assert "skydet: clean" in capsys.readouterr().err
    paths = [*PORT.rglob("*.py"), REPO / "chip_smoke.py",
             *REPO.glob("tests/test_torch_*.py")]
    assert len(paths) > 150
    for path in paths:
        # suppression comments (docstrings that show the syntax are not)
        assert determinism._suppressions(path.read_text()) == ({}, set()), \
            path


def test_skydet_exit_codes_and_changed_only(tmp_path, capsys):
    clean = tmp_path / "test_clean.py"
    clean.write_text("def test_ok():\n    assert 1\n")
    bad = tmp_path / "test_sleepy.py"
    bad.write_text("import time\ndef test_s():\n    time.sleep(1)\n")
    assert skydet.main([str(clean), "--strict", "--no-load-check"]) == 0
    assert skydet.main([str(bad), "--strict", "--no-load-check"]) == 1
    assert skydet.main([str(bad), "--ignore", "DET006",
                        "--no-load-check"]) == 0
    assert skydet.main([str(tmp_path / "nope.py"), "--strict"]) == 2
    assert skydet.main([str(clean), "--strict", "--select", "DET099"]) == 2
    assert skydet.main(["--changed-only", str(bad), "--no-load-check"]) == 1
    capsys.readouterr()
    assert skydet.main([str(bad), "--json", "--no-load-check"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["counts"] == {"DET006": 1} and doc["ok"] is False
