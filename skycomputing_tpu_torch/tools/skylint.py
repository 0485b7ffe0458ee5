"""skylint for the port: the eager PyTorch/CUDA hazard linter
(``analysis/lint.py``; the port's counterpart of ``tools/skylint.py``).

Usage::

    python -m skycomputing_tpu_torch.tools.skylint --strict
    python -m skycomputing_tpu_torch.tools.skylint path/a.py --json
    python -m skycomputing_tpu_torch.tools.skylint --select=SKY003,SKY005
    python -m skycomputing_tpu_torch.tools.skylint --changed-only

With no path it lints ``skycomputing_tpu_torch/`` and ``chip_smoke.py``.
Exit codes: 0 clean, 1 findings, 2 bad invocation.  ``--json`` prints
``{"findings": [...], "counts": {"SKY001": 2, ...}, "ok": false}``.
Suppression: ``# skylint: disable=SKY00X  -- reason`` on the finding's
line.  Loadable by file path with no torch installed.
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
_engine = _cli.load_by_path("skytpu_torch_skylint", "analysis", "lint.py")
RULES = _engine.RULES
LintConfig = _engine.LintConfig
lint_paths = _engine.lint_paths


def main(argv=None) -> int:
    def run(paths, config, args, changed):
        return lint_paths(changed if changed is not None else paths, config)

    return _cli.main(
        "skylint", __doc__, argv,
        known_rules=sorted(RULES) + sorted(_engine.NO_COUNTERPART)
        + ["SKY000"],
        make_config=LintConfig, run=run)


if __name__ == "__main__":
    sys.exit(main())
