"""skydet for the port: determinism and digest-integrity analysis
(``analysis/determinism.py``; the port's counterpart of
``tools/skydet.py``).

Usage::

    python -m skycomputing_tpu_torch.tools.skydet --strict
    python -m skycomputing_tpu_torch.tools.skydet --json
    python -m skycomputing_tpu_torch.tools.skydet --changed-only
    python -m skycomputing_tpu_torch.tools.skydet --select=DET005

With no path it checks ``skycomputing_tpu_torch/``, ``chip_smoke.py``
and ``tests/test_torch_*.py`` against the determinism declarations of
the manifest in ``analysis/audit.py``, and loads every ``pure_stdlib``
module of the manifest by file path (a failure reports as DET000;
``--no-load-check`` skips it).  Exit codes: 0 clean, 1 findings, 2 bad
invocation.  Suppression: ``# skydet: disable=DET00X`` on the finding's
line; the gate runs with none, its exemptions in the manifest with a
reason.  Loadable by file path with no torch installed.
"""

from __future__ import annotations

import importlib.util
import os
import sys


def _driver():
    name = "skytpu_torch_static_cli"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "_static_cli.py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


_cli = _driver()
_engine = _cli.load_by_path("skytpu_torch_skydet", "analysis",
                            "determinism.py")
RULES = _engine.RULES
DetConfig = _engine.DetConfig
check_paths = _engine.check_paths
check_pure_stdlib_loads = _engine.check_pure_stdlib_loads


def main(argv=None) -> int:
    def extra(ap):
        ap.add_argument("--no-load-check", action="store_true",
                        help="skip the pure_stdlib file-path load check")

    def run(paths, config, args, changed):
        findings = check_paths(changed if changed is not None else paths,
                               config)
        if not args.no_load_check:
            findings = check_pure_stdlib_loads(root=_cli.ROOT) + findings
        return findings

    return _cli.main("skydet", __doc__, argv,
                     known_rules=sorted(RULES) + ["DET000"],
                     make_config=DetConfig, run=run, with_tests=True,
                     extra_args=extra)


if __name__ == "__main__":
    sys.exit(main())
