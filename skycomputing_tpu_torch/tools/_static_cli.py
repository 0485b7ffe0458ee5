"""The command driver shared by the port's static analysers (``skylint``,
``skyaudit``, ``skydet``): argument parsing, ``--changed-only``, the
text and JSON reports and the exit codes.

Pure stdlib, loaded by file path: each analyser's engine
(``analysis/lint.py``, ``audit.py``, ``determinism.py``) is read from
its file, so a gate starts in milliseconds with no torch installed, and
``python skycomputing_tpu_torch/tools/skylint.py ...`` works as well as
``python -m skycomputing_tpu_torch.tools.skylint ...``.

Exit codes: 0 clean, 1 findings (a file that does not parse is always a
finding, rule ``*000``), 2 a bad invocation (a missing path; under
``--strict`` an unknown rule id in ``--select`` / ``--ignore``).
"""

from __future__ import annotations

import argparse
import fnmatch
import importlib.util
import json
import os
import sys
from typing import Callable, Dict, List, Optional, Sequence

TOOLS = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(TOOLS)
ROOT = os.path.dirname(PKG)

#: the gates' scope when no path is given: the port and its chip smoke
#: (skydet adds the port's tests)
PORT_SCOPE = ("skycomputing_tpu_torch", "chip_smoke.py")
TEST_SCOPE = "tests/test_torch_*.py"


def load_by_path(name: str, *parts: str):
    """A module of the port loaded from its file under the package (no
    package ``__init__`` runs)."""
    module = sys.modules.get(name)
    if module is not None:
        return module
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(PKG, *parts))
    module = importlib.util.module_from_spec(spec)
    # dataclasses resolve string annotations through sys.modules
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def default_paths(with_tests: bool) -> List[str]:
    paths = [os.path.join(ROOT, p) for p in PORT_SCOPE]
    if with_tests:
        tests = os.path.join(ROOT, "tests")
        if os.path.isdir(tests):
            paths += sorted(
                os.path.join(tests, n) for n in os.listdir(tests)
                if fnmatch.fnmatch(f"tests/{n}", TEST_SCOPE))
    return [p for p in paths if os.path.exists(p)]


def _in_scope(path: str, scope: Sequence[str]) -> bool:
    path = os.path.abspath(path)
    for p in scope:
        p = os.path.abspath(p)
        if path == p or path.startswith(p + os.sep):
            return True
    return False


def changed_files(prog: str, paths: Sequence[str],
                  explicit: bool) -> Optional[List[str]]:
    """The ``--changed-only`` set: files named on the command line, else
    what git reports changed inside ``paths``; None without git."""
    changed = load_by_path("skytpu_torch_changed", "tools", "changed.py")
    if explicit and any(os.path.isfile(p) for p in paths):
        return changed.changed_python_files(paths, cwd=ROOT)
    # the scope mixes directories and files: ask git about the whole
    # checkout, then keep what lies in the scope
    got = changed.changed_python_files([ROOT], cwd=ROOT)
    if got is None:
        print(f"{prog}: --changed-only: git unavailable, checking "
              f"everything", file=sys.stderr)
        return None
    return [p for p in got if _in_scope(p, paths)]


def parse_rule_set(prog: str, spec: str, known: Sequence[str],
                   strict: bool) -> set:
    ids = {s.strip().upper() for s in spec.split(",") if s.strip()}
    unknown = ids - set(known)
    if unknown:
        msg = f"unknown rule id(s): {', '.join(sorted(unknown))}"
        if strict:
            print(f"{prog}: error: {msg}", file=sys.stderr)
            raise SystemExit(2)
        print(f"{prog}: warning: {msg}", file=sys.stderr)
    return ids


def main(prog: str, doc: str, argv, *, known_rules: Sequence[str],
         make_config: Callable, run: Callable, with_tests: bool = False,
         extra_args: Optional[Callable] = None) -> int:
    """Parse ``argv`` and run one analyser.  ``run(paths, config, args,
    changed)`` returns its findings (``changed`` is the changed-file
    list, or None for a whole run)."""
    ap = argparse.ArgumentParser(
        prog=prog, description=doc,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    scope = " ".join(PORT_SCOPE + ((TEST_SCOPE,) if with_tests else ()))
    ap.add_argument("paths", nargs="*",
                    help=f"files and/or directories (default: {scope})")
    ap.add_argument("--strict", action="store_true",
                    help="fail on unknown rule ids (the gates' mode)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--json", action="store_true",
                    help="the same as --format=json")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--ignore", default="",
                    help="comma-separated rule ids to skip")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also report suppressed findings (marked)")
    ap.add_argument("--changed-only", action="store_true",
                    help="report only files named on the command line or "
                         "that git says changed")
    if extra_args is not None:
        extra_args(ap)
    args = ap.parse_args(argv)
    as_json = args.json or args.format == "json"

    explicit = bool(args.paths)
    paths = list(args.paths) or default_paths(with_tests)
    for p in paths:
        if not os.path.exists(p):
            print(f"{prog}: error: no such path: {p}", file=sys.stderr)
            return 2

    changed = None
    if args.changed_only:
        changed = changed_files(prog, paths, explicit)
        if changed is not None and not changed:
            print(f"{prog}: --changed-only: no python changes, clean",
                  file=sys.stderr)
            if as_json:
                print(json.dumps({"findings": [], "counts": {},
                                  "ok": True}, indent=2))
            return 0

    try:
        config = make_config(
            select=parse_rule_set(prog, args.select, known_rules,
                                  args.strict) if args.select else None,
            ignore=parse_rule_set(prog, args.ignore, known_rules,
                                  args.strict) if args.ignore else set(),
            include_suppressed=args.show_suppressed,
        )
    except SystemExit as exc:  # an unknown rule id under --strict
        return int(exc.code)
    findings = run(paths, config, args, changed)
    active = [f for f in findings if not f.suppressed]

    if as_json:
        counts: Dict[str, int] = {}
        for f in active:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        print(json.dumps({"findings": [f.to_dict() for f in findings],
                          "counts": counts, "ok": not active}, indent=2))
    else:
        for f in findings:
            print(f.format() + (" (suppressed)" if f.suppressed else ""))
        if active:
            print(f"{prog}: {len(active)} finding(s) in "
                  f"{len({f.path for f in active})} file(s)",
                  file=sys.stderr)
        else:
            print(f"{prog}: clean", file=sys.stderr)
    return 1 if active else 0
