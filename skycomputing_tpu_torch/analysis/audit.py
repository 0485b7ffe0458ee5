"""skyaudit for the port: whole-program architecture and concurrency
audit of ``skycomputing_tpu_torch`` (the port's own copy of the engine
in ``skycomputing_tpu/analysis/audit.py``, with a manifest written for
the port).

skylint (``analysis/lint.py``) checks one file at a time for eager
PyTorch/CUDA hazards; the invariants that hold the port together are
cross-file:

- **layering and purity** — which subpackage may import which, which
  modules are stdlib-only by contract (loadable by file path with no
  torch installed), and which reaches are forbidden outright: no module
  of the port may reach ``jax``, ``flax`` or the JAX package
  ``skycomputing_tpu`` at any depth, ``dynamics`` never pulls in
  ``fleet``, the telemetry core never imports torch or numpy.  Declared
  once in :data:`MANIFEST`, enforced over the module import graph with
  cycle detection and module -> offending-import diagnostics.
- **lock discipline** — the thread spawners (the metrics exporter's
  handler threads, the heartbeat) and the lock owners: rules
  SKY009-SKY011 below.
- **counter-type drift** — the hand-kept ``FIELD_TYPES`` counter/gauge
  classification that the Prometheus exporter's ``# TYPE`` lines and the
  time series' reset-safe rates trust, cross-checked against the fields
  the stats classes produce.

Rule catalog (stable IDs, one fix-it each):

    AUD001  layering violation (import edge the manifest does not allow,
            or a module no layer claims)
    AUD002  purity violation (a stdlib-only-by-contract module or a
            file-path-loadable tool imports outside the stdlib)
    AUD003  import cycle (module-granular SCC in the top-level graph)
    AUD004  forbidden reach (with the offending import chain); for the
            JAX package and its frameworks every import counts, lazy
            and guarded ones too
    AUD005  unclassified stats field (produced by a class/snapshot bound
            to a FIELD_TYPES contract but absent from it)
    AUD006  plain ``=`` write to a declared counter outside ``__init__``
            / a manifest-documented bank-and-carry site
    SKY009  instance attribute written from a thread/handler context AND
            from normal code without the owning lock
    SKY010  lock-guarded attribute mutated outside any ``with`` on that
            lock
    SKY011  unlocked iteration over a shared dict/deque/list attribute
            of a class that spawns threads

Suppression mirrors skylint: ``# skyaudit: disable=AUD001`` on the
finding's line, ``# skyaudit: disable-file=SKY009`` for a whole file.
The gate (``python -m skycomputing_tpu_torch.tools.skyaudit
skycomputing_tpu_torch/ chip_smoke.py --strict``) ships green with no
suppression.

Scope notes: only TOP-LEVEL UNGUARDED imports feed the layering, cycle
and reach graph (imports inside ``try:`` or a function body are lazy or
optional and cannot break file-path loading or make an import-time
cycle), except for the ``"any"`` reach rules, which read every import.
The lock rules are per-class heuristics with no cross-object aliasing.

PURE STDLIB BY CONTRACT: the CLI loads this module by file path with
no torch installed.  The Finding model is duplicated from ``lint.py``
rather than imported (a package-relative import would break the
file-path load).
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

# --------------------------------------------------------------------------
# model (shape-compatible with analysis.lint.Finding)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Finding:
    """One audit finding, pinned to a file position."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    fixit: str
    suppressed: bool = False

    def format(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: {self.rule} "
            f"{self.message}  [fix: {self.fixit}]"
        )

    def to_dict(self) -> Dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "fixit": self.fixit,
            "suppressed": self.suppressed,
        }


@dataclass
class AuditConfig:
    """Rule selection + suppression handling for one audit run."""

    select: Optional[Set[str]] = None  # None = all rules
    ignore: Set[str] = field(default_factory=set)
    include_suppressed: bool = False


#: rule id -> one-line description (CLI validation + docs generation)
RULES = {
    "AUD001": "layering violation (disallowed inter-layer import edge)",
    "AUD002": "purity violation (stdlib-only contract module imports "
              "outside the stdlib)",
    "AUD003": "import cycle in the top-level module graph",
    "AUD004": "forbidden transitive reach (manifest forbidden_reach)",
    "AUD005": "stats field produced but missing from its FIELD_TYPES "
              "classification",
    "AUD006": "plain = write to a declared counter outside __init__ / "
              "bank-and-carry sites",
    "SKY009": "attribute written from thread/handler context and from "
              "normal code without the owning lock",
    "SKY010": "lock-guarded attribute mutated outside any with on that "
              "lock",
    "SKY011": "unlocked iteration over a shared container attribute of "
              "a thread-spawning class",
}

# --------------------------------------------------------------------------
# the manifest: the repo's layering contract, declared in one place
# --------------------------------------------------------------------------

#: The port's architecture.  One entry per layer: ``modules`` are
#: dotted-name prefixes, ``may_import`` names the layers a DIRECT
#: top-level import edge may target (intra-layer edges are always
#: allowed, stdlib/external imports are the purity pass's business,
#: ``"*"`` = unconstrained).  The matrix encodes the port's graph as it
#: stands, so a NEW edge (serving importing fleet, the telemetry core
#: importing anything) fails with a named diagnostic.  Beyond the JAX
#: package's matrix, ``dynamics`` imports ``models``, ``ops`` and
#: ``parallel`` (the timed profilers run stages and the static one
#: builds units on ``meta``), so ``dynamics <-> parallel`` and
#: ``dynamics <-> runner`` are layer-level warts; module-granular cycle
#: detection (AUD003) is the invariant that keeps them importable.
MANIFEST: Dict[str, Any] = {
    "package": "skycomputing_tpu_torch",
    "layers": {
        "root": {"modules": ["skycomputing_tpu_torch"],
                 "may_import": ["*"]},
        # the commands at the package's root: the launcher and the two
        # benches drive every layer below them
        "entry": {"modules": ["skycomputing_tpu_torch.bench",
                              "skycomputing_tpu_torch.bench_serving",
                              "skycomputing_tpu_torch.launch"],
                  "may_import": ["*"]},
        "convert": {"modules": ["skycomputing_tpu_torch.convert"],
                    "may_import": []},
        "utils": {"modules": ["skycomputing_tpu_torch.utils"],
                  "may_import": []},
        "registry": {"modules": ["skycomputing_tpu_torch.registry"],
                     "may_import": []},
        "config": {"modules": ["skycomputing_tpu_torch.config"],
                   "may_import": []},
        "stimulator": {"modules": ["skycomputing_tpu_torch.stimulator"],
                       "may_import": []},
        "dataset": {"modules": ["skycomputing_tpu_torch.dataset"],
                    "may_import": ["registry", "utils"]},
        "builder": {"modules": ["skycomputing_tpu_torch.builder"],
                    "may_import": ["registry", "utils"]},
        "ops": {"modules": ["skycomputing_tpu_torch.ops"],
                "may_import": ["registry"]},
        "models": {"modules": ["skycomputing_tpu_torch.models"],
                   "may_import": ["ops", "registry", "utils"]},
        "telemetry": {"modules": ["skycomputing_tpu_torch.telemetry"],
                      "may_import": []},
        "analysis": {"modules": ["skycomputing_tpu_torch.analysis"],
                     "may_import": ["builder"]},
        "tuning": {"modules": ["skycomputing_tpu_torch.tuning"],
                   "may_import": ["telemetry", "utils"]},
        "dynamics": {"modules": ["skycomputing_tpu_torch.dynamics"],
                     "may_import": ["builder", "dataset", "models", "ops",
                                    "parallel", "registry", "runner",
                                    "stimulator", "telemetry", "utils"]},
        "parallel": {"modules": ["skycomputing_tpu_torch.parallel"],
                     "may_import": ["builder", "dynamics", "models",
                                    "ops", "telemetry", "utils"]},
        "serving": {"modules": ["skycomputing_tpu_torch.serving"],
                    "may_import": ["analysis", "builder", "dynamics",
                                   "models", "telemetry", "utils"]},
        "runner": {"modules": ["skycomputing_tpu_torch.runner"],
                   "may_import": ["analysis", "dynamics", "ops",
                                  "registry", "telemetry", "tuning",
                                  "utils"]},
        "fleet": {"modules": ["skycomputing_tpu_torch.fleet"],
                  "may_import": ["serving", "telemetry", "utils"]},
        # the workload plane sits BESIDE the fleet: the player drives
        # fleets and engines duck-typed; the scenario core is pure stdlib
        "workload": {"modules": ["skycomputing_tpu_torch.workload"],
                     "may_import": ["serving"]},
        # the chaos and disagg planes sit ABOVE the fleet; their plan
        # and handoff cores are pure stdlib, and their plan_check edges
        # are lazy (in-function)
        "chaos": {"modules": ["skycomputing_tpu_torch.chaos"],
                  "may_import": ["fleet", "serving", "telemetry",
                                 "utils"]},
        "disagg": {"modules": ["skycomputing_tpu_torch.disagg"],
                   "may_import": ["fleet", "serving", "telemetry",
                                  "utils"]},
        "tools": {"modules": ["skycomputing_tpu_torch.tools"],
                  "may_import": ["*"]},
    },
    # stdlib-only by contract: loadable by FILE PATH with no torch, no
    # numpy and no package-relative import (skydet loads each one so)
    "pure_stdlib": [
        "skycomputing_tpu_torch.analysis.audit",
        "skycomputing_tpu_torch.analysis.determinism",
        "skycomputing_tpu_torch.analysis.lint",
        # the fault-plan core and catalog (the injector and the
        # invariants live outside this contract)
        "skycomputing_tpu_torch.chaos.plan",
        # the KV-handoff record and its conservation ledger
        "skycomputing_tpu_torch.disagg.handoff",
        # the partition and mesh-shape solver: pure math
        "skycomputing_tpu_torch.dynamics.solver",
        "skycomputing_tpu_torch.fleet.admission",
        "skycomputing_tpu_torch.fleet.router",
        "skycomputing_tpu_torch.serving.paging",
        "skycomputing_tpu_torch.telemetry.analysis",
        "skycomputing_tpu_torch.telemetry.exporter",
        # the flight-recorder ring and the incident rule engine (skyreport
        # renders postmortems with no torch)
        "skycomputing_tpu_torch.telemetry.flight",
        "skycomputing_tpu_torch.telemetry.incidents",
        "skycomputing_tpu_torch.telemetry.metrics",
        "skycomputing_tpu_torch.telemetry.slo",
        "skycomputing_tpu_torch.telemetry.timeseries",
        "skycomputing_tpu_torch.telemetry.tracer",
        # the decide step: bench_autotune --smoke loads it by file path
        "skycomputing_tpu_torch.tuning.advisor",
        # the scenario core and catalog (the numpy player and mixes live
        # in sibling modules outside this contract)
        "skycomputing_tpu_torch.workload.scenario",
    ],
    # commands that must START with stdlib only: their package imports
    # live inside functions (or are imports of pure_stdlib modules)
    "file_path_tools": [
        # --smoke file-path-loads the analysis and the advisor; the loop
        # bench imports torch inside run_bench
        "skycomputing_tpu_torch.tools.bench_autotune",
        "skycomputing_tpu_torch.tools.bench_flight",
        "skycomputing_tpu_torch.tools.changed",
        # the analysers' shared command driver
        "skycomputing_tpu_torch.tools._static_cli",
        "skycomputing_tpu_torch.tools.skyaudit",
        "skycomputing_tpu_torch.tools.skydet",
        "skycomputing_tpu_torch.tools.skylint",
    ],
    # (source prefix, target prefix, rationale[, "any"]) — checked on
    # the TRANSITIVE closure of top-level imports, chain in the
    # diagnostic; with "any", every import of a source module counts
    # (lazy, guarded and TYPE_CHECKING ones too)
    "forbidden_reach": [
        ("skycomputing_tpu_torch", "jax",
         "the port stands alone: it imports torch, never jax", "any"),
        ("skycomputing_tpu_torch", "flax",
         "the port stands alone: flax is the JAX package's framework",
         "any"),
        ("skycomputing_tpu_torch", "skycomputing_tpu",
         "the port keeps its own copy of what it needs from the JAX "
         "package, even of modules there that import no jax", "any"),
        # the card's smoke script is the port's quickest proof; it runs
        # where no jax is installed
        ("chip_smoke", "jax", "the chip smoke drives the port alone",
         "any"),
        ("chip_smoke", "flax", "the chip smoke drives the port alone",
         "any"),
        ("chip_smoke", "skycomputing_tpu",
         "the chip smoke drives the port alone", "any"),
        ("skycomputing_tpu_torch.dynamics", "skycomputing_tpu_torch.fleet",
         "the trainer-side dynamics plane must stay deployable without "
         "the serving fleet (faults.py talks to it duck-typed)"),
        ("skycomputing_tpu_torch.telemetry", "torch",
         "the telemetry core runs on exporter handler threads and loads "
         "by file path with no torch installed"),
        ("skycomputing_tpu_torch.telemetry", "numpy",
         "telemetry is pure stdlib by contract; numpy breaks the "
         "file-path loads"),
        ("skycomputing_tpu_torch.serving", "skycomputing_tpu_torch.fleet",
         "one engine must not know about the fleet above it (the fleet "
         "drives engines, never the reverse)"),
    ],
    # methods where a plain ``=`` to a declared counter is the
    # SANCTIONED bank-and-carry idiom (the page pool's totals mirrored
    # into ServingStats, the pool being the counters' one owner)
    "counter_bank_sites": [
        "ServingEngine._sync_paged_stats",
    ],
    # snapshot-producing functions bound to a FIELD_TYPES contract they
    # do not own: {Class.method: FIELD_TYPES-declaring class}
    "snapshot_contracts": {
        "EngineReplica.stats_snapshot": "EngineReplica",
        "FlightRecorder.snapshot": "FlightRecorder",
        "IncidentEngine.snapshot": "IncidentEngine",
        "ServingFleet._fleet_snapshot": "FleetStats",
    },
    # ---- determinism declarations (read by analysis/determinism.py) ----
    #
    # modules whose outputs must be a pure function of their seeds and
    # inputs: wall-clock calls flag (DET001) unless injected via a
    # `clock=` parameter, and `random.SystemRandom` is forbidden (DET002)
    "deterministic_modules": [
        "skycomputing_tpu_torch.chaos.invariants",
        "skycomputing_tpu_torch.chaos.plan",
        # the handoff ledger: its event log and audit must replay equal
        "skycomputing_tpu_torch.disagg.handoff",
        "skycomputing_tpu_torch.dynamics.solver",
        # the router ranks replicas from the supervisor's and the
        # engines' counters; a wall read would make placements differ
        # between two same-seed replays
        "skycomputing_tpu_torch.fleet.router",
        "skycomputing_tpu_torch.telemetry.flight",
        "skycomputing_tpu_torch.telemetry.incidents",
        # the decide step: report in, proposal out
        "skycomputing_tpu_torch.tuning.advisor",
        "skycomputing_tpu_torch.workload.scenario",
    ],
    # the replay cores whose contract is at most ONE
    # `random.Random(seed)` in one draw order (DET002)
    "one_rng_modules": [
        "skycomputing_tpu_torch.chaos.plan",
        "skycomputing_tpu_torch.disagg.handoff",
        "skycomputing_tpu_torch.fleet.router",
        "skycomputing_tpu_torch.tuning.advisor",
        "skycomputing_tpu_torch.workload.scenario",
    ],
    # sites sanctioned to touch process-global RNG state, as
    # "file.py::qualname" (none: every draw goes through a seeded
    # generator)
    "rng_global_sanctions": [],
    # field names that must never reach a digest fold (DET003): wall
    # times and request ids differ between two same-seed runs.
    # `resolved` is the injector's load-based selector outcome, `score`
    # the supervisor's EWMA of wall latency, `tick_s` the tick's wall
    # duration
    "digest_excluded_fields": [
        "req_id", "request_id", "resolved", "score", "tick_s",
        "timestamp", "ts", "wall_elapsed_s", "wall_s", "wall_time",
    ],
    # helpers a digest folds whose names do not announce it
    "digest_path_functions": [
        "Arrival.key",
        "AuditCheck.to_dict",
        "AuditReport.to_dict",
        "FaultEvent.key",
        "FlightEvent.det_dict",
        "Incident.det_dict",
        "deterministic_bundle_view",
    ],
    # the port's process-global caches (DET004 watches `id()`/`hash()`
    # in their keys): `_loaded` holds the kernel libraries by source
    # name, each the library `library_path` named
    "program_caches": ["_loaded"],
    "program_cache_gates": [],
    # the kernel library's key (DET005): every input of the build's
    # compile command must reach the hashed key, or an edited input
    # would load a stale library.  `exempt` names inputs left out on
    # purpose, each with its reason.
    "kernel_builds": {
        "skycomputing_tpu_torch.ops._build": {
            "build": "build",
            "key": "library_path",
            "exempt": {
                "nvcc_path": "the compiler is the machine's toolkit, found "
                             "on the PATH or under CUDA_HOME; build/ is "
                             "git-ignored, so a checkout starts with no "
                             "library, and hashing the compiler would run "
                             "it on machines that only read the key",
            },
        },
    },
    # functions where an `id(...)` key operand is sanctioned (none)
    "id_key_pins": {},
    # tests sanctioned to really sleep, as "file.py::test_name" (none:
    # the port's tests inject clocks)
    "wallclock_test_sanctions": [],
}

_SUPPRESS_LINE_RE = re.compile(
    r"#\s*skyaudit:\s*disable(?:=([A-Za-z0-9_,\s]+))?"
)
_SUPPRESS_FILE_RE = re.compile(
    r"#\s*skyaudit:\s*disable-file=([A-Za-z0-9_,\s]+)"
)

#: module names the interpreter ships (py3.10+); the fallback set keeps
#: the audit meaningful on exotic builds
_STDLIB = set(getattr(sys, "stdlib_module_names", ())) or {
    "abc", "argparse", "ast", "bisect", "collections", "contextlib",
    "copy", "dataclasses", "enum", "functools", "hashlib", "heapq",
    "http", "importlib", "io", "itertools", "json", "logging", "math",
    "os", "pathlib", "queue", "random", "re", "shutil", "socket",
    "string", "struct", "subprocess", "sys", "tempfile", "threading",
    "time", "tokenize", "types", "typing", "unittest", "uuid",
    "warnings", "weakref",
}


def _is_stdlib(name: str) -> bool:
    return name.split(".", 1)[0] in _STDLIB or name == "__future__"


def _dotted_prefixes(name: str) -> List[str]:
    """['a', 'a.b', 'a.b.c'] for 'a.b.c'."""
    parts = name.split(".")
    return [".".join(parts[:i + 1]) for i in range(len(parts))]


# --------------------------------------------------------------------------
# module discovery + import extraction
# --------------------------------------------------------------------------


@dataclass
class ImportEdge:
    """One import statement: resolved dotted target + position."""

    target: str
    line: int
    col: int
    guarded: bool  # inside try/except or `if TYPE_CHECKING:`
    lazy: bool     # inside a function/class body (not module level)


@dataclass
class ModuleInfo:
    name: str
    path: str
    tree: Optional[ast.Module]
    lines: List[str]
    imports: List[ImportEdge] = field(default_factory=list)
    parse_error: Optional[str] = None

    def top_level(self) -> List[ImportEdge]:
        """Unguarded module-level imports — the edges that fire at
        import time and therefore feed layering/cycle/reach checks."""
        return [e for e in self.imports if not e.guarded and not e.lazy]


def _module_name(path: str) -> str:
    """Dotted module name for a file, anchored at the outermost
    directory that is still a package (has ``__init__.py``) — so
    ``skycomputing_tpu/fleet/router.py`` names itself identically no
    matter which directory the CLI was launched from."""
    path = os.path.abspath(path)
    parts = [os.path.splitext(os.path.basename(path))[0]]
    parent = os.path.dirname(path)
    while parent and os.path.exists(os.path.join(parent, "__init__.py")):
        parts.insert(0, os.path.basename(parent))
        parent = os.path.dirname(parent)
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts) if parts else os.path.basename(path)


def _extract_imports(info: ModuleInfo) -> None:
    """Fill ``info.imports``, classifying guarded/lazy context."""
    assert info.tree is not None
    is_pkg = info.path.endswith("__init__.py")

    def resolve_from(node: ast.ImportFrom) -> str:
        if not node.level:
            return node.module or ""
        parts = info.name.split(".")
        # for a package __init__, level 1 is the package itself
        keep = len(parts) - node.level + (1 if is_pkg else 0)
        base = parts[:max(keep, 0)]
        return ".".join(base + ([node.module] if node.module else []))

    def visit(nodes: Iterable[ast.stmt], guarded: bool,
              lazy: bool) -> None:
        for node in nodes:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    info.imports.append(ImportEdge(
                        alias.name, node.lineno, node.col_offset,
                        guarded, lazy))
            elif isinstance(node, ast.ImportFrom):
                base = resolve_from(node)
                if not base:
                    continue
                info.imports.append(ImportEdge(
                    base, node.lineno, node.col_offset, guarded, lazy))
                # `from pkg import sub` may name a MODULE: record the
                # candidate too; the graph keeps it only if it resolves
                for alias in node.names:
                    if alias.name != "*":
                        info.imports.append(ImportEdge(
                            f"{base}.{alias.name}", node.lineno,
                            node.col_offset, guarded, lazy))
            elif isinstance(node, ast.Try):
                # try body + handlers are the guarded-fallback idiom;
                # `else:` runs whenever the try SUCCEEDED, so imports
                # there fire on plain import — not guarded
                visit(node.body, True, lazy)
                for h in node.handlers:
                    visit(h.body, True, lazy)
                visit(node.orelse, guarded, lazy)
                visit(node.finalbody, guarded, lazy)
            elif isinstance(node, ast.If):
                # ONLY `if TYPE_CHECKING:` is a guard the interpreter
                # never enters; any other conditional import executes
                # at import time and must feed purity/layering/reach
                test_name = _dotted(node.test) or ""
                is_tc = test_name in ("TYPE_CHECKING",
                                      "typing.TYPE_CHECKING")
                visit(node.body, guarded or is_tc, lazy)
                visit(node.orelse, guarded, lazy)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(node.body, guarded, True)
            elif isinstance(node, ast.ClassDef):
                visit(node.body, guarded, lazy)
            elif isinstance(node, (ast.With, ast.For, ast.While)):
                visit(node.body, guarded, lazy)
                visit(getattr(node, "orelse", []), guarded, lazy)

    visit(info.tree.body, False, False)


def load_modules(paths: Sequence[str]) -> List[ModuleInfo]:
    """Parse every ``*.py`` under the given files/directories."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = [d for d in dirs
                           if d not in ("__pycache__", ".git")]
                files += [os.path.join(root, n) for n in sorted(names)
                          if n.endswith(".py")]
        else:
            files.append(p)
    out: List[ModuleInfo] = []
    for path in sorted(set(files)):
        name = _module_name(path)
        try:
            with open(path, encoding="utf-8") as fh:
                source = fh.read()
        except (OSError, UnicodeDecodeError) as exc:
            out.append(ModuleInfo(name, path, None, [],
                                  parse_error=f"unreadable: {exc}"))
            continue
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as exc:
            out.append(ModuleInfo(name, path, None,
                                  source.splitlines(),
                                  parse_error=f"syntax error: {exc.msg} "
                                              f"(line {exc.lineno})"))
            continue
        info = ModuleInfo(name, path, tree, source.splitlines())
        _extract_imports(info)
        out.append(info)
    return out


# --------------------------------------------------------------------------
# analysis 1: layering, purity, cycles, forbidden reach
# --------------------------------------------------------------------------


def _layer_of(module: str, manifest: Dict[str, Any]) -> Optional[str]:
    """Longest-prefix layer match for a dotted module name."""
    best, best_len = None, -1
    for layer, spec in manifest["layers"].items():
        for prefix in spec["modules"]:
            if module == prefix or module.startswith(prefix + "."):
                if len(prefix) > best_len:
                    best, best_len = layer, len(prefix)
    return best


def _resolve_internal(target: str,
                      known: Dict[str, ModuleInfo]) -> Optional[str]:
    """Map an import target onto a module in the audited set: the
    longest known prefix (importing ``pkg.mod.attr`` touches
    ``pkg.mod``; importing a package touches its ``__init__``)."""
    name = target
    while name:
        if name in known:
            return name
        if "." not in name:
            return None
        name = name.rsplit(".", 1)[0]
    return None


def _graph(modules: List[ModuleInfo]) -> Dict[str, List[Tuple[str, ImportEdge]]]:
    """module -> [(imported module, edge)] over top-level imports."""
    known = {m.name: m for m in modules}
    out: Dict[str, List[Tuple[str, ImportEdge]]] = {}
    for m in modules:
        seen: Set[str] = set()
        edges: List[Tuple[str, ImportEdge]] = []
        for e in m.top_level():
            tgt = _resolve_internal(e.target, known)
            if tgt is None or tgt == m.name or tgt in seen:
                continue
            seen.add(tgt)
            edges.append((tgt, e))
        out[m.name] = edges
    return out


def _check_layering(modules: List[ModuleInfo],
                    manifest: Dict[str, Any]) -> List[Finding]:
    out: List[Finding] = []
    known = {m.name: m for m in modules}
    pkg = manifest.get("package", "")
    for m in modules:
        if m.tree is None:
            continue
        layer = _layer_of(m.name, manifest)
        if layer is None:
            continue  # outside the manifest's world entirely
        spec = manifest["layers"][layer]
        # a module the bare package prefix is the only match for is a
        # NEW subpackage no layer claims — make it declare itself
        if layer == "root" and m.name != pkg and pkg and \
                m.name.startswith(pkg + "."):
            out.append(Finding(
                "AUD001", m.path, 1, 0,
                f"module `{m.name}` belongs to no declared layer",
                "add its subpackage to the MANIFEST layer table "
                "(analysis/audit.py) with an explicit may_import list",
            ))
            continue
        allowed = spec["may_import"]
        if "*" in allowed:
            continue
        seen_edges: Set[Tuple[str, int]] = set()
        for e in m.top_level():
            tgt = _resolve_internal(e.target, known)
            tgt_layer = _layer_of(tgt if tgt else e.target, manifest)
            if tgt_layer is None or tgt_layer == layer:
                continue
            # one finding per (layer edge, line): an ImportFrom
            # contributes the base module plus per-alias candidates
            key = (tgt_layer, e.line)
            if key in seen_edges:
                continue
            seen_edges.add(key)
            if tgt_layer not in allowed:
                out.append(Finding(
                    "AUD001", m.path, e.line, e.col,
                    f"`{m.name}` (layer {layer}) imports "
                    f"`{tgt or e.target}` (layer {tgt_layer}) — edge "
                    f"{layer} -> {tgt_layer} is not in the manifest",
                    f"drop the import, invert the dependency, or (if "
                    f"the architecture really changed) add "
                    f"{tgt_layer!r} to {layer!r}.may_import in "
                    f"analysis/audit.py MANIFEST",
                ))
    return out


def _check_purity(modules: List[ModuleInfo],
                  manifest: Dict[str, Any]) -> List[Finding]:
    pure = set(manifest.get("pure_stdlib", ()))
    tools = set(manifest.get("file_path_tools", ()))
    out: List[Finding] = []
    for m in modules:
        if m.tree is None or (m.name not in pure and m.name not in tools):
            continue
        contract = ("stdlib-only by contract" if m.name in pure
                    else "a file-path-loadable tool")
        for e in m.top_level():
            if _is_stdlib(e.target):
                continue
            # an import of a module that is ITSELF pure-stdlib by
            # contract preserves bare-runner loadability (the importer
            # puts the repo root on sys.path first);
            # `from tools._loader import x` also records the candidate
            # edge `tools._loader.x`, so match dotted prefixes too
            if any(t in pure for t in _dotted_prefixes(e.target)):
                continue
            out.append(Finding(
                "AUD002", m.path, e.line, e.col,
                f"`{m.name}` is {contract} but imports "
                f"`{e.target}` at module level — this breaks "
                f"file-path loading on a bare runner",
                "move the import behind a guarded try/except fallback "
                "or into the function that needs it; duplicate small "
                "constants instead of importing them (the _ERRORS_KEY "
                "idiom)",
            ))
    return out


def _check_cycles(modules: List[ModuleInfo],
                  manifest: Dict[str, Any]) -> List[Finding]:
    """Tarjan SCC over the top-level import graph; any component with
    more than one module is an import-time cycle."""
    graph = _graph(modules)
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    def strongconnect(v: str) -> None:
        # iterative Tarjan: a deep package chain must not hit the
        # recursion limit inside a lint gate
        work = [(v, 0)]
        while work:
            node, pi = work.pop()
            if pi == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack.add(node)
            recurse = False
            targets = [t for t, _ in graph.get(node, ())]
            for i in range(pi, len(targets)):
                t = targets[i]
                if t not in index:
                    work.append((node, i + 1))
                    work.append((t, 0))
                    recurse = True
                    break
                elif t in on_stack:
                    low[node] = min(low[node], index[t])
            if recurse:
                continue
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                sccs.append(comp)
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])

    for m in sorted(graph):
        if m not in index:
            strongconnect(m)

    paths = {m.name: m.path for m in modules}
    out: List[Finding] = []
    for comp in sccs:
        if len(comp) < 2:
            continue
        comp = sorted(comp)
        first = comp[0]
        # name the edge that closes the cycle for the diagnostic
        edge_line = 1
        for tgt, e in graph.get(first, ()):
            if tgt in comp:
                edge_line = e.line
                break
        out.append(Finding(
            "AUD003", paths.get(first, first), edge_line, 0,
            f"import cycle: {' -> '.join(comp + [first])} — these "
            f"modules cannot be file-path loaded or reasoned about "
            f"independently",
            "break the cycle with a lazy (function-scope) import on "
            "the weakest edge, or move the shared piece down a layer",
        ))
    return out


def _check_forbidden_reach(modules: List[ModuleInfo],
                           manifest: Dict[str, Any]) -> List[Finding]:
    """BFS the transitive closure from each forbidden-rule source; a
    module whose DIRECT import hits the target prefix is reported with
    one example chain from the rule's source.  A rule whose fourth
    element is ``"any"`` reads every import of a module (lazy, guarded
    and TYPE_CHECKING ones too), not only its top-level ones."""
    graph = _graph(modules)
    known = {m.name: m for m in modules}
    out: List[Finding] = []
    for rule in manifest.get("forbidden_reach", ()):
        src_prefix, tgt_prefix, why = rule[:3]
        every_import = len(rule) > 3 and rule[3] == "any"

        def hits(name: str) -> bool:
            return name == tgt_prefix or \
                name.startswith(tgt_prefix + ".")

        starts = [m.name for m in modules
                  if m.tree is not None and
                  (m.name == src_prefix or
                   m.name.startswith(src_prefix + "."))]
        reported: Set[str] = set()
        for start in sorted(starts):
            # BFS with parent pointers for chain reconstruction
            parent: Dict[str, Optional[str]] = {start: None}
            queue = [start]
            while queue:
                node = queue.pop(0)
                info = known.get(node)
                if info is None:
                    continue
                if hits(node):
                    # already inside the forbidden subtree: its own
                    # internal edges are not new crossings — only the
                    # edge that ENTERED it is the violation
                    continue
                edges = info.imports if every_import else info.top_level()
                for e in edges:
                    if hits(e.target):
                        if node in reported:
                            continue
                        reported.add(node)
                        chain: List[str] = []
                        cur: Optional[str] = node
                        while cur is not None:
                            chain.append(cur)
                            cur = parent[cur]
                        chain.reverse()
                        kind = ("" if not (e.lazy or e.guarded) else
                                " (lazy)" if e.lazy else " (guarded)")
                        arrow = " -> ".join(chain + [e.target + kind])
                        out.append(Finding(
                            "AUD004", info.path, e.line, e.col,
                            f"forbidden reach {src_prefix} -/-> "
                            f"{tgt_prefix}: {arrow} ({why})",
                            "cut the dependency (every import counts "
                            "for this rule)" if every_import else
                            "make the import lazy/guarded if it is "
                            "optional, or cut the dependency — this "
                            "reach is forbidden by the manifest",
                        ))
                for tgt, _e in graph.get(node, ()):
                    if tgt not in parent:
                        parent[tgt] = node
                        queue.append(tgt)
    # one finding per offending module per rule
    seen: Set[Tuple[str, str, int]] = set()
    unique = []
    for f in out:
        key = (f.rule, f.path, f.line)
        if key not in seen:
            seen.add(key)
            unique.append(f)
    return unique


# --------------------------------------------------------------------------
# analysis 2: lock discipline (SKY009-SKY011)
# --------------------------------------------------------------------------

_LOCK_CTORS = {"threading.Lock", "threading.RLock", "Lock", "RLock",
               "threading.Condition", "Condition"}
_HANDLER_BASES = {"BaseHTTPRequestHandler", "BaseRequestHandler",
                  "StreamRequestHandler", "DatagramRequestHandler"}
_MUTATING_METHODS = {"append", "appendleft", "add", "insert", "extend",
                     "extendleft", "update", "pop", "popleft", "popitem",
                     "remove", "discard", "clear", "setdefault",
                     "__setitem__", "rotate", "sort", "reverse"}
_CONTAINER_CTORS = {"dict", "list", "set", "deque", "defaultdict",
                    "OrderedDict", "collections.deque",
                    "collections.defaultdict", "collections.OrderedDict"}
_ITER_WRAPPERS = {"list", "sorted", "tuple", "set", "dict", "sum",
                  "max", "min", "len", "frozenset", "any", "all"}


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _self_attr(node: ast.AST, selves: Set[str]) -> Optional[str]:
    """``X`` when node is ``<self-or-alias>.X``, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and \
            node.value.id in selves:
        return node.attr
    return None


@dataclass
class _AttrEvent:
    attr: str
    node: ast.AST
    kind: str        # "write" | "mutate" | "iterate"
    locked: bool     # under `with <self>.<lock>` for an owned lock
    fn_name: str     # enclosing method name
    threaded: bool   # thread/handler execution context


class _ClassAudit:
    """Per-class lock-discipline facts, AST-only (no aliasing beyond
    the ``alias = self`` closure idiom)."""

    def __init__(self, cls: ast.ClassDef, path: str):
        self.cls = cls
        self.path = path
        self.locks: Set[str] = set()
        self.containers: Set[str] = set()
        self.spawns_threads = False
        self.thread_targets: Set[str] = set()  # method names run on threads
        self.handler_classes: List[ast.ClassDef] = []
        self.events: List[_AttrEvent] = []
        self._scan_structure()
        self._scan_events()

    # -- pass 1: locks, containers, thread spawn points ---------------------
    def _scan_structure(self) -> None:
        for fn in self._methods(self.cls):
            in_init = fn.name == "__init__"
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and \
                        isinstance(node.value, ast.Call):
                    ctor = _dotted(node.value.func) or ""
                    for t in node.targets:
                        attr = _self_attr(t, {"self"})
                        if attr is None:
                            continue
                        if ctor in _LOCK_CTORS:
                            self.locks.add(attr)
                        elif in_init and (ctor in _CONTAINER_CTORS or
                                          ctor.split(".")[-1] in
                                          ("deque", "defaultdict")):
                            self.containers.add(attr)
                if isinstance(node, ast.Assign) and in_init and \
                        isinstance(node.value, (ast.Dict, ast.List,
                                                ast.Set)):
                    for t in node.targets:
                        attr = _self_attr(t, {"self"})
                        if attr is not None:
                            self.containers.add(attr)
                if isinstance(node, ast.Call):
                    callee = _dotted(node.func) or ""
                    if callee.endswith("Thread") and (
                            callee in ("threading.Thread", "Thread")):
                        self.spawns_threads = True
                        for kw in node.keywords:
                            if kw.arg == "target":
                                tgt = _self_attr(kw.value, {"self"})
                                if tgt:
                                    self.thread_targets.add(tgt)
                                elif isinstance(kw.value, ast.Name):
                                    self.thread_targets.add(kw.value.id)
            # nested handler classes (http.server idiom): their methods
            # run on server threads
            for node in ast.walk(fn):
                if isinstance(node, ast.ClassDef):
                    bases = {b.attr if isinstance(b, ast.Attribute)
                             else getattr(b, "id", "")
                             for b in node.bases}
                    if bases & _HANDLER_BASES:
                        self.spawns_threads = True
                        self.handler_classes.append(node)

    @staticmethod
    def _methods(cls: ast.ClassDef) -> List[ast.FunctionDef]:
        return [n for n in cls.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]

    # -- pass 2: attribute events with lock + thread context ----------------
    def _scan_events(self) -> None:
        for fn in self._methods(self.cls):
            threaded = fn.name in self.thread_targets
            selves = self._self_aliases(fn)
            self._walk_fn(fn, fn.name, threaded, selves)
            # nested defs inherit context; a nested def passed to
            # Thread(target=...) inside this method is itself threaded
            for node in ast.walk(fn):
                if isinstance(node, ast.ClassDef) and \
                        node in self.handler_classes:
                    # inside a handler method, `self` is the HANDLER
                    # instance — only the closure aliases (`exp =
                    # self`) reach the outer class's attributes;
                    # keeping bare "self" here misattributed e.g. the
                    # idiomatic `self.close_connection = True` to the
                    # outer class and broke the strict gate on
                    # correct code
                    for sub in self._methods(node):
                        self._walk_fn(sub, f"{fn.name}.{sub.name}",
                                      True, selves - {"self"})

    def _self_aliases(self, fn: ast.AST) -> Set[str]:
        """`exporter = self` closure aliases, plus `self` itself."""
        selves = {"self"}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id in selves:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        selves.add(t.id)
        return selves

    def _walk_fn(self, fn: ast.AST, fn_name: str, threaded: bool,
                 selves: Set[str]) -> None:
        held: List[str] = []

        def locked() -> bool:
            return bool(held)

        def record(attr: str, node: ast.AST, kind: str) -> None:
            self.events.append(_AttrEvent(
                attr, node, kind, locked(), fn_name, threaded))

        def visit(node: ast.AST) -> None:
            if isinstance(node, ast.With):
                lock_names = []
                for item in node.items:
                    la = _self_attr(item.context_expr, selves)
                    if la in self.locks:
                        lock_names.append(la)
                held.extend(lock_names)
                for child in node.body:
                    visit(child)
                for _ in lock_names:
                    held.pop()
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if node is not fn:
                    # nested def: runs later (callback) — same thread
                    # context assumption, separate lock scope
                    self._walk_fn(node, f"{fn_name}.{node.name}",
                                  threaded, selves)
                    return
            if isinstance(node, ast.ClassDef) and node is not fn:
                return  # handler classes handled explicitly
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (node.targets
                           if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    attr = _self_attr(t, selves)
                    if attr is not None:
                        record(attr, node, "write")
                    # self.X[k] = v mutates container X
                    if isinstance(t, ast.Subscript):
                        attr = _self_attr(t.value, selves)
                        if attr is not None:
                            record(attr, node, "mutate")
            if isinstance(node, ast.Delete):
                for t in node.targets:
                    if isinstance(t, ast.Subscript):
                        attr = _self_attr(t.value, selves)
                        if attr is not None:
                            record(attr, node, "mutate")
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _MUTATING_METHODS:
                attr = _self_attr(node.func.value, selves)
                if attr is not None:
                    record(attr, node, "mutate")
            # iteration shapes: for x in self.X / comprehension /
            # list(self.X) / sorted(self.X.items())
            if isinstance(node, (ast.For, ast.comprehension)):
                it = node.iter
                self._record_iteration(it, selves, record)
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id in _ITER_WRAPPERS and node.args:
                self._record_iteration(node.args[0], selves, record)
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.comprehension):
                    self._record_iteration(child.iter, selves, record)
                    continue
                visit(child)

        for child in ast.iter_child_nodes(fn):
            visit(child)

    def _record_iteration(self, it: ast.AST, selves: Set[str],
                          record) -> None:
        attr = _self_attr(it, selves)
        if attr is None and isinstance(it, ast.Call) and \
                isinstance(it.func, ast.Attribute) and \
                it.func.attr in ("items", "keys", "values"):
            attr = _self_attr(it.func.value, selves)
        if attr is not None and attr in self.containers:
            record(attr, it, "iterate")


def _lock_rules(modules: List[ModuleInfo]) -> List[Finding]:
    out: List[Finding] = []
    for m in modules:
        if m.tree is None:
            continue
        for node in ast.walk(m.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            audit = _ClassAudit(node, m.path)
            out += _rule_sky009(audit)
            out += _rule_sky010(audit)
            out += _rule_sky011(audit)
    return out


def _rule_sky009(a: _ClassAudit) -> List[Finding]:
    """Shared write from thread context + normal code, no common lock."""
    if not a.spawns_threads:
        return []
    out: List[Finding] = []
    by_attr: Dict[str, List[_AttrEvent]] = {}
    for e in a.events:
        if e.kind in ("write", "mutate"):
            by_attr.setdefault(e.attr, []).append(e)
    for attr, events in sorted(by_attr.items()):
        threaded = [e for e in events if e.threaded]
        normal = [e for e in events
                  if not e.threaded and e.fn_name != "__init__"]
        if not threaded or not normal:
            continue
        unlocked = [e for e in threaded + normal if not e.locked]
        if not unlocked:
            continue
        first = min(unlocked, key=lambda e: e.node.lineno)
        out.append(Finding(
            "SKY009", a.path, first.node.lineno,
            getattr(first.node, "col_offset", 0),
            f"`{a.cls.name}.{attr}` is written from a thread/handler "
            f"context ({threaded[0].fn_name}) AND from "
            f"{normal[0].fn_name} without a common lock — the "
            f"exporter-race shape",
            "guard both writers with `with self._lock`, or confine "
            "the attribute to one thread and publish via an immutable "
            "snapshot",
        ))
    return out


def _rule_sky010(a: _ClassAudit) -> List[Finding]:
    """A field the class guards SOMEWHERE must be guarded EVERYWHERE."""
    if not a.locks:
        return []
    guarded = {e.attr for e in a.events
               if e.locked and e.kind in ("write", "mutate")}
    guarded -= a.locks
    out: List[Finding] = []
    seen: Set[Tuple[str, int]] = set()
    for e in a.events:
        if e.attr not in guarded or e.locked or \
                e.kind not in ("write", "mutate") or \
                e.fn_name == "__init__":
            continue
        key = (e.attr, e.node.lineno)
        if key in seen:
            continue
        seen.add(key)
        out.append(Finding(
            "SKY010", a.path, e.node.lineno,
            getattr(e.node, "col_offset", 0),
            f"`{a.cls.name}.{e.attr}` is mutated in {e.fn_name} "
            f"outside the lock that guards it elsewhere in the class",
            "wrap the mutation in `with self._lock` (the lock that "
            "already guards this field), or document single-thread "
            "ownership by renaming the unlocked path",
        ))
    return out


def _rule_sky011(a: _ClassAudit) -> List[Finding]:
    """Unlocked iteration over a shared container in a thread-spawner."""
    if not a.spawns_threads:
        return []
    out: List[Finding] = []
    seen: Set[Tuple[str, int]] = set()
    for e in a.events:
        if e.kind != "iterate" or e.locked or e.fn_name == "__init__":
            continue
        key = (e.attr, e.node.lineno)
        if key in seen:
            continue
        seen.add(key)
        out.append(Finding(
            "SKY011", a.path, e.node.lineno,
            getattr(e.node, "col_offset", 0),
            f"`{a.cls.name}` spawns threads but iterates shared "
            f"container `self.{e.attr}` in {e.fn_name} without a lock "
            f"— a concurrent insert raises RuntimeError mid-scrape",
            "take the class lock around the iteration, or snapshot "
            "first (`list(self.X)` under the lock) and iterate the "
            "copy",
        ))
    return out


# --------------------------------------------------------------------------
# analysis 3: counter-type drift
# --------------------------------------------------------------------------


@dataclass
class _StatsClass:
    name: str
    path: str
    node: ast.ClassDef
    field_types: Dict[str, str]
    field_types_line: int
    counter_literal: Optional[List[str]] = None  # literal COUNTER_FIELDS
    counter_literal_line: int = 0


def _literal_str_dict(node: ast.AST,
                      classes: Dict[str, "_StatsClass"]) -> Optional[Dict[str, str]]:
    """Evaluate a dict literal of str->str, following one level of
    ``**Other.FIELD_TYPES`` splats into already-collected classes."""
    if not isinstance(node, ast.Dict):
        return None
    out: Dict[str, str] = {}
    for k, v in zip(node.keys, node.values):
        if k is None:
            dotted = _dotted(v) or ""
            base = dotted.rsplit(".", 1)[0] if "." in dotted else ""
            ref = classes.get(base.split(".")[-1])
            if dotted.endswith(".FIELD_TYPES") and ref is not None:
                out.update(ref.field_types)
                continue
            return None  # unresolvable splat: skip the class entirely
        if isinstance(k, ast.Constant) and isinstance(k.value, str) and \
                isinstance(v, ast.Constant) and isinstance(v.value, str):
            out[k.value] = v.value
        else:
            return None
    return out


def _collect_stats_classes(modules: List[ModuleInfo]) -> Dict[str, _StatsClass]:
    """Every class declaring a FIELD_TYPES literal, by class name.
    Two passes so ``**Other.FIELD_TYPES`` splats resolve regardless of
    file order."""
    classes: Dict[str, _StatsClass] = {}
    pending: List[Tuple[ModuleInfo, ast.ClassDef, ast.Assign]] = []
    for m in modules:
        if m.tree is None:
            continue
        for node in ast.walk(m.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for stmt in node.body:
                if isinstance(stmt, ast.Assign) and any(
                        isinstance(t, ast.Name) and
                        t.id == "FIELD_TYPES"
                        for t in stmt.targets):
                    pending.append((m, node, stmt))
    for _ in range(2):
        for m, cls, stmt in pending:
            if cls.name in classes:
                continue
            types = _literal_str_dict(stmt.value, classes)
            if types is not None:
                classes[cls.name] = _StatsClass(
                    cls.name, m.path, cls, types, stmt.lineno)
    # literal COUNTER_FIELDS tuples (derived comprehensions are exempt)
    for name, sc in classes.items():
        for stmt in sc.node.body:
            if isinstance(stmt, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "COUNTER_FIELDS"
                    for t in stmt.targets):
                if isinstance(stmt.value, (ast.Tuple, ast.List)):
                    vals = [e.value for e in stmt.value.elts
                            if isinstance(e, ast.Constant) and
                            isinstance(e.value, str)]
                    if len(vals) == len(stmt.value.elts):
                        sc.counter_literal = vals
                        sc.counter_literal_line = stmt.lineno
    return classes


_NUMERIC_ANNOTATIONS = {"int", "float", "bool"}


def _produced_keys(fn: ast.AST) -> List[Tuple[str, int]]:
    """Constant TOP-LEVEL keys a snapshot-like function produces.

    Only the returned dict's own keys count — a nested value dict (a
    per-target/per-reason label family, classified by its parent key)
    must not have its inner keys demanded from FIELD_TYPES.  Shapes
    recognized: ``return dict(k=...)`` / ``return {"k": ...}``,
    ``out = dict(...)`` + ``out.update(k=...)`` + ``out["k"] = ...``
    for a local that is later returned.
    """
    returned: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and \
                isinstance(node.value, ast.Name):
            returned.add(node.value.id)

    def top_keys(value: ast.AST) -> List[Tuple[str, int]]:
        got: List[Tuple[str, int]] = []
        if isinstance(value, ast.Call) and \
                (_dotted(value.func) or "").split(".")[-1] == "dict":
            for kw in value.keywords:
                if kw.arg:
                    got.append((kw.arg, value.lineno))
        elif isinstance(value, ast.Dict):
            for k in value.keys:
                if isinstance(k, ast.Constant) and \
                        isinstance(k.value, str):
                    got.append((k.value, value.lineno))
        return got

    keys: List[Tuple[str, int]] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and node.value is not None:
            keys += top_keys(node.value)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id in returned:
                    keys += top_keys(node.value)
                elif isinstance(t, ast.Subscript) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id in returned and \
                        isinstance(t.slice, ast.Constant) and \
                        isinstance(t.slice.value, str):
                    keys.append((t.slice.value, node.lineno))
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "update" and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id in returned:
            for kw in node.keywords:
                if kw.arg:
                    keys.append((kw.arg, node.lineno))
    return keys


def _counter_drift(modules: List[ModuleInfo],
                   manifest: Dict[str, Any]) -> List[Finding]:
    classes = _collect_stats_classes(modules)
    out: List[Finding] = []

    # classes whose registered source is a DIFFERENT method (declared
    # in snapshot_contracts, e.g. EngineReplica.stats_snapshot): their
    # plain `snapshot()` is a non-metrics view and is exempt from the
    # default check — the contract pass below covers the real source
    contracts = manifest.get("snapshot_contracts", {})
    overridden = {
        q.partition(".")[0] for q in contracts
        if q.partition(".")[2] != "snapshot"
    }

    # (a) unclassified numeric dataclass fields + snapshot keys
    for sc in classes.values():
        declared = set(sc.field_types)
        for stmt in sc.node.body:
            if isinstance(stmt, ast.AnnAssign) and \
                    isinstance(stmt.target, ast.Name):
                name = stmt.target.id
                ann = stmt.annotation
                ann_name = (ann.id if isinstance(ann, ast.Name)
                            else _dotted(ann) or "")
                if name.startswith("_") or name in declared:
                    continue
                if ann_name in _NUMERIC_ANNOTATIONS:
                    out.append(Finding(
                        "AUD005", sc.path, stmt.lineno, stmt.col_offset,
                        f"`{sc.name}.{name}` is a numeric stats field "
                        f"but FIELD_TYPES (line {sc.field_types_line}) "
                        f"does not classify it — the exporter emits no "
                        f"# TYPE line and rate math treats it as a "
                        f"gauge silently",
                        f'add "{name}": "counter" or "gauge" to '
                        f"{sc.name}.FIELD_TYPES",
                    ))
        for stmt in sc.node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and stmt.name == "snapshot" and \
                    sc.name not in overridden:
                for key, line in _produced_keys(stmt):
                    if key not in declared and not key.startswith("_"):
                        out.append(Finding(
                            "AUD005", sc.path, line, 0,
                            f"`{sc.name}.snapshot()` produces key "
                            f"`{key}` that FIELD_TYPES does not "
                            f"classify",
                            f'add "{key}" to {sc.name}.FIELD_TYPES '
                            f"(or prefix it with _ if it is not a "
                            f"metric)",
                        ))

        # (b) literal COUNTER_FIELDS must equal the counter subset
        if sc.counter_literal is not None:
            expect = sorted(k for k, v in sc.field_types.items()
                            if v == "counter")
            got = sorted(sc.counter_literal)
            if got != expect:
                missing = sorted(set(expect) - set(got))
                extra = sorted(set(got) - set(expect))
                out.append(Finding(
                    "AUD005", sc.path, sc.counter_literal_line, 0,
                    f"`{sc.name}.COUNTER_FIELDS` drifted from "
                    f"FIELD_TYPES (missing: {missing or '-'}, "
                    f"extra: {extra or '-'})",
                    "derive COUNTER_FIELDS from FIELD_TYPES instead "
                    "of listing it by hand",
                ))

    # (c) snapshot contracts declared in the manifest
    for qualname, types_cls in contracts.items():
        cls_name, _, meth_name = qualname.partition(".")
        bound = classes.get(types_cls)
        fn_node = None
        fn_path = None
        for m in modules:
            if m.tree is None:
                continue
            for node in ast.walk(m.tree):
                if isinstance(node, ast.ClassDef) and \
                        node.name == cls_name:
                    for stmt in node.body:
                        if isinstance(stmt, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)) and \
                                stmt.name == meth_name:
                            fn_node, fn_path = stmt, m.path
        if fn_node is None or fn_path is None:
            continue  # contract names a method outside the audited set
        if bound is None:
            out.append(Finding(
                "AUD005", fn_path, fn_node.lineno, 0,
                f"snapshot contract `{qualname}` is bound to "
                f"`{types_cls}.FIELD_TYPES`, which the audit cannot "
                f"find",
                "fix the snapshot_contracts entry in the MANIFEST or "
                "declare FIELD_TYPES on the named class",
            ))
            continue
        for key, line in _produced_keys(fn_node):
            if key not in bound.field_types and not key.startswith("_"):
                out.append(Finding(
                    "AUD005", fn_path, line, 0,
                    f"`{qualname}` produces key `{key}` that its "
                    f"declared contract `{types_cls}.FIELD_TYPES` "
                    f"does not classify — it reaches the exporter "
                    f"untyped",
                    f'classify "{key}" in {types_cls}.FIELD_TYPES '
                    f"(counter if cumulative, gauge otherwise)",
                ))

    # (d) plain `=` writes to declared counters
    counters: Dict[str, Set[str]] = {}
    for sc in classes.values():
        for fname, kind in sc.field_types.items():
            if kind == "counter":
                counters.setdefault(fname, set()).add(sc.name)
    bank_sites = set(manifest.get("counter_bank_sites", ()))
    for m in modules:
        if m.tree is None:
            continue
        for cls in [n for n in ast.walk(m.tree)
                    if isinstance(n, ast.ClassDef)]:
            own = classes.get(cls.name)
            for fn in [n for n in cls.body
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]:
                if fn.name == "__init__":
                    continue
                if f"{cls.name}.{fn.name}" in bank_sites:
                    continue
                for node in ast.walk(fn):
                    if not isinstance(node, ast.Assign):
                        continue
                    for t in node.targets:
                        if not isinstance(t, ast.Attribute):
                            continue
                        attr = t.attr
                        if attr not in counters:
                            continue
                        base = t.value
                        is_self_field = (
                            own is not None and
                            isinstance(base, ast.Name) and
                            base.id == "self" and
                            attr in own.field_types and
                            own.field_types[attr] == "counter"
                        )
                        base_attr = (
                            base.attr if isinstance(base, ast.Attribute)
                            else base.id if isinstance(base, ast.Name)
                            else ""
                        )
                        is_stats_field = base_attr in ("stats",
                                                       "_stats")
                        if not (is_self_field or is_stats_field):
                            continue
                        owners = ", ".join(sorted(counters[attr]))
                        out.append(Finding(
                            "AUD006", m.path, node.lineno,
                            node.col_offset,
                            f"plain `=` write to declared counter "
                            f"`{attr}` (counter in {owners}) in "
                            f"`{cls.name}.{fn.name}` — counters must "
                            f"only move forward (`+=`); a reset here "
                            f"breaks time-series rate math and "
                            f"Prometheus semantics",
                            "use `+=`, or (for bank-and-carry totals "
                            "across a replaced sub-object) add the "
                            "method to MANIFEST counter_bank_sites "
                            "with a comment explaining the carry",
                        ))
    return out


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------


def _suppressions(source: str):
    """Comment-token suppression maps (same contract as skylint)."""
    import io
    import tokenize

    per_line: Dict[int, Optional[Set[str]]] = {}
    file_level: Set[str] = set()
    try:
        tokens = list(tokenize.generate_tokens(
            io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return per_line, file_level
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_FILE_RE.search(tok.string)
        if m:
            file_level |= {s.strip().upper()
                           for s in m.group(1).split(",") if s.strip()}
            continue
        m = _SUPPRESS_LINE_RE.search(tok.string)
        if m:
            if m.group(1):
                per_line[tok.start[0]] = {
                    s.strip().upper()
                    for s in m.group(1).split(",") if s.strip()}
            else:
                per_line[tok.start[0]] = None
    return per_line, file_level


def audit_modules(modules: List[ModuleInfo],
                  config: Optional[AuditConfig] = None,
                  manifest: Optional[Dict[str, Any]] = None
                  ) -> List[Finding]:
    """Run all three analyses over an already-loaded module set."""
    config = config or AuditConfig()
    manifest = manifest if manifest is not None else MANIFEST
    findings: List[Finding] = []
    for m in modules:
        if m.parse_error:
            findings.append(Finding(
                "AUD000", m.path, 1, 0,
                f"file cannot be audited: {m.parse_error}",
                "fix the file — unauditable files must not pass the "
                "gate",
            ))
    findings += _check_layering(modules, manifest)
    findings += _check_purity(modules, manifest)
    findings += _check_cycles(modules, manifest)
    findings += _check_forbidden_reach(modules, manifest)
    findings += _lock_rules(modules)
    findings += _counter_drift(modules, manifest)

    # rule selection
    selected: List[Finding] = []
    for f in findings:
        if f.rule != "AUD000":
            if config.select is not None and f.rule not in config.select:
                continue
            if f.rule in config.ignore:
                continue
        selected.append(f)

    # suppression handling, per file
    sup_cache: Dict[str, Tuple[Dict[int, Optional[Set[str]]], Set[str]]] = {}
    sources = {m.path: "\n".join(m.lines) for m in modules}
    out: List[Finding] = []
    for f in selected:
        if f.path not in sup_cache:
            sup_cache[f.path] = _suppressions(sources.get(f.path, ""))
        per_line, file_level = sup_cache[f.path]
        sup = f.rule in file_level
        line_sup = per_line.get(f.line, ...)
        if line_sup is None or (line_sup is not ... and
                                f.rule in line_sup):
            sup = True
        if sup:
            if config.include_suppressed:
                out.append(dataclasses.replace(f, suppressed=True))
        else:
            out.append(f)

    # stable order, dedup identical (rule, path, line, message)
    seen = set()
    unique = []
    for f in sorted(out, key=lambda f: (f.path, f.line, f.rule)):
        key = (f.rule, f.path, f.line, f.message)
        if key not in seen:
            seen.add(key)
            unique.append(f)
    return unique


def audit_paths(paths: Sequence[str],
                config: Optional[AuditConfig] = None,
                manifest: Optional[Dict[str, Any]] = None
                ) -> List[Finding]:
    """Audit files and/or directory trees (the CLI entry point)."""
    return audit_modules(load_modules(paths), config, manifest)


__all__ = [
    "AuditConfig", "Finding", "ImportEdge", "MANIFEST", "ModuleInfo",
    "RULES", "audit_modules", "audit_paths", "load_modules",
]
