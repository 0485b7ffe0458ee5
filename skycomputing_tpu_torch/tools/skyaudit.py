"""skyaudit for the port: whole-program layering, purity, reach, lock
and counter-type audit (``analysis/audit.py``; the port's counterpart of
``tools/skyaudit.py``).

Usage::

    python -m skycomputing_tpu_torch.tools.skyaudit --strict
    python -m skycomputing_tpu_torch.tools.skyaudit --json
    python -m skycomputing_tpu_torch.tools.skyaudit --changed-only
    python -m skycomputing_tpu_torch.tools.skyaudit --select=AUD004

With no path it audits ``skycomputing_tpu_torch/`` and ``chip_smoke.py``
against the manifest in ``analysis/audit.py``.  ``--changed-only``
audits the whole scope (whole-program invariants need the whole graph)
and reports only findings in changed files, plus cycle and reach
findings whose chain names a changed module.  Exit codes: 0 clean, 1
findings, 2 bad invocation.  Suppression: ``# skyaudit:
disable=AUD00X`` on the finding's line; the gate runs with none.
Loadable by file path with no torch installed.
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
_engine = _cli.load_by_path("skytpu_torch_skyaudit", "analysis",
                            "audit.py")
RULES = _engine.RULES
AuditConfig = _engine.AuditConfig
audit_paths = _engine.audit_paths


def main(argv=None) -> int:
    def run(paths, config, args, changed):
        if changed is None:
            return audit_paths(paths, config)
        scope = [p for p in paths if os.path.isdir(p)] or \
            _cli.default_paths(False)
        findings = audit_paths(scope + list(changed), config)
        keep = {os.path.abspath(p) for p in changed}
        changed_mods = {_engine._module_name(p) for p in changed}

        def relevant(f) -> bool:
            if os.path.abspath(f.path) in keep:
                return True
            # a commit that closes a cycle or a forbidden chain by
            # editing its other end must still fail
            return f.rule in ("AUD003", "AUD004") and any(
                m in f.message for m in changed_mods)

        return [f for f in findings if relevant(f)]

    return _cli.main("skyaudit", __doc__, argv,
                     known_rules=sorted(RULES) + ["AUD000"],
                     make_config=AuditConfig, run=run)


if __name__ == "__main__":
    sys.exit(main())
