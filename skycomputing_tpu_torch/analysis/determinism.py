"""skydet for the port: determinism and digest-integrity analysis of
``skycomputing_tpu_torch`` (the port's own copy of the engine in
``skycomputing_tpu/analysis/determinism.py``, reading the port's
manifest in ``analysis/audit.py``).

The port's correctness gates — token identity, workload and chaos
digest equality, byte-identical deterministic logs — rest on
hand-kept determinism contracts: one ``random.Random(seed)`` per plan
in one draw order, digests that exclude wall times and request ids,
clocks injected instead of read, and a kernel library whose file name
hashes every input of its build.  skydet checks them at commit time, as
skylint does for host syncs and skyaudit for layering.

Rules:

    DET001  wall-clock read inside a manifest-declared deterministic
            module (``deterministic_modules``) — inject a ``clock=``
            parameter instead; bare references (defaults, staticmethod
            hooks) never flag, only calls do
    DET002  global-state RNG (``random.seed``/``random.random``/
            ``np.random.*``) anywhere, ``random.SystemRandom`` in a
            deterministic module, and >1 ``random.Random(...)``
            constructed in a declared one-rng module
    DET003  digest-integrity dataflow: manifest-declared
            digest-excluded fields (wall times, request ids) read on a
            digest path, and unsorted ``dict``/``set`` iteration in a
            digest-path function unless wrapped in ``sorted()``
    DET004  ``id()`` / object-``hash()`` feeding a digest or a cache
            key — process-lifetime values in content identities; pins
            with a lifetime guarantee are declared in the manifest's
            ``id_key_pins``, never suppressed inline
    DET005  key completeness.  The port compiles no programs at run
            time; its cache is the kernel library, built by
            ``ops/_build.py:build`` into a file that
            ``library_path`` names by a hash.  Every input of the
            build's compile command must reach that hash
            (``kernel_builds`` in the manifest, with its ``exempt``
            inputs and their reasons), or an edited input would load a
            stale library.  The reference's closure-capture checks of
            program factories stay, for any ``program_cache_gates`` and
            ``program_caches`` the manifest names.
    DET006  test-flakiness gate: tests may not assert a raw wall-clock
            delta against a constant bound, nor call ``time.sleep``
            outside the manifest-sanctioned real-watchdog subjects
            (``wallclock_test_sanctions``)

Exemptions live in the manifest with a rationale; the shipped gate
(``python -m skycomputing_tpu_torch.tools.skydet skycomputing_tpu_torch/
chip_smoke.py tests/test_torch_*.py --strict``) runs with no inline
suppression.

Suppression syntax (same contract as skylint/skyaudit)::

    t = time.time()  # skydet: disable=DET001  -- why this is safe

or ``# skydet: disable`` for every rule on that line; a line containing
``# skydet: disable-file=DET00X`` disables a rule file-wide.  Parse
failures surface as rule ``DET000`` so a broken file cannot slip
through the gate as "no findings".

Pure stdlib by contract: the CLI loads this module by FILE PATH with no
torch installed (the guarded ``.audit`` import below falls back to a
file-path load of the sibling module).
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Finding:
    """One determinism finding, pinned to a file position.

    Shape-compatible with the skylint/skyaudit ``Finding`` (duplicated,
    not imported: a package-relative import would break standalone
    file-path loading on bare runners)."""

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
class DetConfig:
    """Rule selection + suppression handling for one skydet run."""

    select: Optional[Set[str]] = None  # None = all rules
    ignore: Set[str] = field(default_factory=set)
    include_suppressed: bool = False


_SUPPRESS_LINE_RE = re.compile(
    r"#\s*skydet:\s*disable(?:=([A-Za-z0-9_,\s]+))?"
)
_SUPPRESS_FILE_RE = re.compile(
    r"#\s*skydet:\s*disable-file=([A-Za-z0-9_,\s]+)"
)


# --------------------------------------------------------------------------
# manifest plumbing
# --------------------------------------------------------------------------

try:  # package import (the normal in-process path)
    from .audit import MANIFEST as _AUDIT_MANIFEST  # type: ignore
except ImportError:  # pragma: no cover - standalone file-path load
    _AUDIT_MANIFEST = None


def default_manifest() -> Dict[str, Any]:
    """The skyaudit MANIFEST — package import when available, else a
    file-path load of the sibling ``audit.py`` (pure stdlib either
    way), so the CLI works identically on bare runners."""
    global _AUDIT_MANIFEST
    if _AUDIT_MANIFEST is None:
        import importlib.util
        import sys

        name = "_skydet_manifest_source"
        mod = sys.modules.get(name)
        if mod is None:
            spec = importlib.util.spec_from_file_location(
                name,
                os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "audit.py"),
            )
            mod = importlib.util.module_from_spec(spec)
            sys.modules[name] = mod
            spec.loader.exec_module(mod)
        _AUDIT_MANIFEST = mod.MANIFEST
    return _AUDIT_MANIFEST


def _module_name(path: str) -> str:
    """Dotted module name, anchored at the outermost package directory
    (the one whose parent has no ``__init__.py``) — same convention as
    the skyaudit engine."""
    path = os.path.abspath(path)
    parts = [os.path.splitext(os.path.basename(path))[0]]
    d = os.path.dirname(path)
    while os.path.exists(os.path.join(d, "__init__.py")):
        parts.append(os.path.basename(d))
        d = os.path.dirname(d)
    name = ".".join(reversed(parts))
    return name[: -len(".__init__")] if name.endswith(".__init__") else name


def _is_test_path(path: str) -> bool:
    base = os.path.basename(path)
    if base == "conftest.py" or base.startswith("test_"):
        return True
    return "tests" in os.path.normpath(path).split(os.sep)


# --------------------------------------------------------------------------
# AST helpers
# --------------------------------------------------------------------------


def _dotted(node: ast.AST) -> Optional[str]:
    """'time.perf_counter' for an Attribute/Name chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _aliases(tree: ast.Module) -> Tuple[Dict[str, str], Dict[str, str]]:
    """(module aliases, from-import names) — so ``import time as _t``
    and ``from datetime import datetime`` canonicalize the same way."""
    mods: Dict[str, str] = {}
    names: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    mods[a.asname] = a.name
                else:
                    mods[a.name.split(".")[0]] = a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            for a in node.names:
                names[a.asname or a.name] = f"{node.module}.{a.name}"
    return mods, names


_FUNCTION_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def _functions(tree: ast.Module) -> List[Tuple[ast.AST, str]]:
    """Every function/method with its dotted qualname (``Cls.meth``,
    ``outer.inner``)."""
    out: List[Tuple[ast.AST, str]] = []

    def visit(node: ast.AST, qual: List[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FUNCTION_NODES):
                q = qual + [child.name]
                out.append((child, ".".join(q)))
                visit(child, q)
            elif isinstance(child, ast.ClassDef):
                visit(child, qual + [child.name])
            else:
                visit(child, qual)

    visit(tree, [])
    return out


def _own_nodes(fn: ast.AST) -> Iterable[ast.AST]:
    """fn's nodes excluding nested function/class bodies."""

    def visit(node: ast.AST):
        for child in ast.iter_child_nodes(node):
            yield child
            if not isinstance(child, _FUNCTION_NODES + (ast.ClassDef,)):
                yield from visit(child)

    yield from visit(fn)


def _calls_with_scope(tree: ast.Module):
    """Yield (Call node, qualname of the innermost enclosing function
    or '<module>')."""
    out: List[Tuple[ast.Call, str]] = []

    def visit(node: ast.AST, qual: List[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FUNCTION_NODES):
                visit(child, qual + [child.name])
            elif isinstance(child, ast.ClassDef):
                visit(child, qual + [child.name])
            else:
                if isinstance(child, ast.Call):
                    out.append((child, ".".join(qual) or "<module>"))
                visit(child, qual)

    visit(tree, [])
    return out


def _param_names(fn: ast.AST) -> List[str]:
    a = fn.args
    names = [p.arg for p in getattr(a, "posonlyargs", [])]
    names += [p.arg for p in a.args]
    if a.vararg:
        names.append(a.vararg.arg)
    names += [p.arg for p in a.kwonlyargs]
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def _local_env(fn: ast.AST) -> Dict[str, List[ast.AST]]:
    """name -> every expression assigned to it in fn's own body.
    Tuple targets pair element-wise with tuple values when the arity
    matches (the ``a, b = x, y`` idiom)."""
    env: Dict[str, List[ast.AST]] = {}

    def record(target: ast.AST, value: ast.AST) -> None:
        if isinstance(target, ast.Name):
            env.setdefault(target.id, []).append(value)
        elif isinstance(target, (ast.Tuple, ast.List)):
            if isinstance(value, (ast.Tuple, ast.List)) \
                    and len(value.elts) == len(target.elts):
                for t, v in zip(target.elts, value.elts):
                    record(t, v)
            else:
                for t in target.elts:
                    record(t, value)

    for node in _own_nodes(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                record(t, node.value)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) \
                and node.value is not None:
            record(node.target, node.value)
    return env


class _Scope:
    """Root-identifier resolution context: one function's local
    assignments + its class's ``self.X = ...`` map."""

    def __init__(self, fn: Optional[ast.AST],
                 self_map: Optional[Dict[str, "_SelfAttr"]] = None):
        self.params = set(_param_names(fn)) - {"self", "cls"} if fn else set()
        self.env = _local_env(fn) if fn else {}
        self.self_map = self_map or {}


@dataclass
class _SelfAttr:
    """One ``self.X = expr`` assignment with its defining scope."""

    expr: ast.AST
    scope: "_Scope"


def _class_self_map(cls: ast.ClassDef) -> Dict[str, _SelfAttr]:
    """attr -> the expressions every method assigns to ``self.attr``,
    each paired with its defining method's scope (first assignment per
    attr wins; __init__ comes first in source order for every class in
    this tree)."""
    out: Dict[str, _SelfAttr] = {}
    for item in cls.body:
        if not isinstance(item, _FUNCTION_NODES):
            continue
        scope = _Scope(item)
        for node in _own_nodes(item):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]
            else:
                continue
            for t in targets:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                        and t.attr not in out):
                    out[t.attr] = _SelfAttr(node.value, scope)
    # let every method's scope resolve self attrs through the class map
    for attr in out.values():
        attr.scope.self_map = out
    return out


_ROOT_DEPTH = 6


def _expr_roots(expr: ast.AST, scope: _Scope,
                depth: int = _ROOT_DEPTH,
                visiting: Optional[Set[str]] = None) -> Set[str]:
    """Root identifiers an expression's value depends on: parameter
    names (the terminal roots), plus ``self.X`` tokens that resolve no
    further.  Locals expand through their assignments; module globals
    and builtins drop out (they are identical across instances, so they
    cannot make a key incomplete)."""
    visiting = visiting if visiting is not None else set()
    roots: Set[str] = set()
    if depth <= 0:
        return roots
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and node.value.id == "self":
            token = f"self.{node.attr}"
            if token in visiting:
                continue
            attr = scope.self_map.get(node.attr)
            if attr is None:
                roots.add(token)
            else:
                visiting.add(token)
                roots |= _expr_roots(attr.expr, attr.scope, depth - 1,
                                     visiting)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            name = node.id
            if name in visiting or name == "self":
                continue
            if name in scope.params:
                roots.add(name)
            elif name in scope.env:
                visiting.add(name)
                for value in scope.env[name]:
                    roots |= _expr_roots(value, scope, depth - 1, visiting)
            # else: global/builtin — drop
    return roots


def _free_loads(fn: ast.AST) -> Set[str]:
    """Names a closure reads that it does not bind itself (its free
    variables, module globals included — the caller filters)."""
    bound = set(_param_names(fn))
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and \
                isinstance(node.ctx, (ast.Store, ast.Del)):
            bound.add(node.id)
        elif isinstance(node, _FUNCTION_NODES) and node is not fn:
            bound.add(node.name)
        elif isinstance(node, ast.comprehension):
            for t in ast.walk(node.target):
                if isinstance(t, ast.Name):
                    bound.add(t.id)
    loads = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) \
                and node.id not in bound:
            loads.add(node.id)
    return loads


def _self_attr_loads(fn: ast.AST) -> Set[str]:
    """Attrs a closure reads off ``self``."""
    out = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Load) \
                and isinstance(node.value, ast.Name) and node.value.id == "self":
            out.add(node.attr)
    return out


# --------------------------------------------------------------------------
# rule context
# --------------------------------------------------------------------------


class _Ctx:
    def __init__(self, tree: ast.Module, path: str, lines: List[str],
                 module: str, manifest: Dict[str, Any]):
        self.tree = tree
        self.path = path
        self.lines = lines
        self.module = module
        self.manifest = manifest
        self.mods, self.names = _aliases(tree)
        self.is_test = _is_test_path(path)
        self.functions = _functions(tree)

    def canon(self, dotted: Optional[str]) -> Optional[str]:
        """Alias-resolved dotted callee: ``_time.sleep`` -> ``time.sleep``,
        ``datetime.now`` (from-imported class) -> ``datetime.datetime.now``."""
        if dotted is None:
            return None
        head, _, rest = dotted.partition(".")
        if head in self.names:
            base = self.names[head]
        elif head in self.mods:
            base = self.mods[head]
        else:
            return dotted
        return f"{base}.{rest}" if rest else base

    def call_name(self, call: ast.Call) -> Optional[str]:
        return self.canon(_dotted(call.func))

    def finding(self, rule: str, node: ast.AST, message: str,
                fixit: str) -> Finding:
        return Finding(rule=rule, path=self.path,
                       line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0),
                       message=message, fixit=fixit)


# --------------------------------------------------------------------------
# DET001: wall-clock reads in deterministic modules
# --------------------------------------------------------------------------

#: clock reads that differ between two same-seed runs.  Only CALLS flag;
#: a bare reference (an injectable-parameter default ``clock=time.monotonic``,
#: a ``staticmethod(time.perf_counter)`` hook) is the sanctioned idiom.
_WALLCLOCK_CALLS = {
    "time.time", "time.time_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "time.monotonic", "time.monotonic_ns",
    "time.process_time", "time.process_time_ns",
    "time.thread_time", "time.thread_time_ns",
}
_DATETIME_NOW_CALLS = {
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
}


def _is_wallclock_call(ctx: _Ctx, call: ast.Call) -> bool:
    name = ctx.call_name(call)
    if name in _WALLCLOCK_CALLS:
        return True
    return name in _DATETIME_NOW_CALLS and not call.args and not call.keywords


def _rule_det001(ctx: _Ctx) -> List[Finding]:
    det = set(ctx.manifest.get("deterministic_modules", ()))
    if ctx.module not in det:
        return []
    out = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call) and _is_wallclock_call(ctx, node):
            out.append(ctx.finding(
                "DET001", node,
                f"wall-clock read `{_dotted(node.func)}()` inside "
                f"deterministic module `{ctx.module}` — same-seed replays "
                f"will diverge with machine speed",
                "inject the clock: accept a `clock=<real clock>` callable "
                "parameter and call `clock()` (bare references in defaults "
                "never flag), so tests and replays can pin time",
            ))
    return out


# --------------------------------------------------------------------------
# DET002: RNG discipline
# --------------------------------------------------------------------------

#: ``random`` module functions that mutate/read the PROCESS-GLOBAL
#: Mersenne state — any caller anywhere perturbs every other draw order
_GLOBAL_RANDOM_FNS = {
    "seed", "random", "randint", "randrange", "getrandbits", "randbytes",
    "choice", "choices", "shuffle", "sample", "uniform", "triangular",
    "betavariate", "binomialvariate", "expovariate", "gammavariate",
    "gauss", "lognormvariate", "normalvariate", "paretovariate",
    "vonmisesvariate", "weibullvariate",
}
#: ``numpy.random`` attributes that do NOT touch the legacy global state
_NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "BitGenerator",
                 "PCG64", "PCG64DXSM", "Philox", "MT19937", "SFC64"}


def _rule_det002(ctx: _Ctx) -> List[Finding]:
    manifest = ctx.manifest
    sanctions = set(manifest.get("rng_global_sanctions", ()))
    one_rng = set(manifest.get("one_rng_modules", ()))
    det = set(manifest.get("deterministic_modules", ())) | one_rng
    out = []
    rng_ctors: List[ast.Call] = []
    for call, qual in _calls_with_scope(ctx.tree):
        name = ctx.call_name(call)
        if name is None:
            continue
        site = f"{os.path.basename(ctx.path)}::{qual}"
        if name.startswith("random.") and \
                name.split(".")[-1] in _GLOBAL_RANDOM_FNS and \
                name.count(".") == 1:
            if site in sanctions:
                continue
            out.append(ctx.finding(
                "DET002", call,
                f"`{_dotted(call.func)}()` uses the process-global RNG "
                f"state — draw order couples to every other caller in "
                f"the process",
                "construct a local `random.Random(seed)` and draw from "
                "it (or declare the site in MANIFEST "
                "rng_global_sanctions with a rationale)",
            ))
        elif (name.startswith("numpy.random.")
              and name.split(".")[2] not in _NP_RANDOM_OK):
            if site in sanctions:
                continue
            out.append(ctx.finding(
                "DET002", call,
                f"`{_dotted(call.func)}()` uses numpy's legacy global "
                f"RNG state — unseeded and process-coupled",
                "use `np.random.default_rng(seed)` and draw from the "
                "returned Generator",
            ))
        elif name == "random.SystemRandom" and ctx.module in det:
            out.append(ctx.finding(
                "DET002", call,
                f"`random.SystemRandom` in deterministic module "
                f"`{ctx.module}` — OS entropy cannot be seeded, so "
                f"same-seed replay is impossible",
                "use `random.Random(seed)`",
            ))
        elif name == "random.Random":
            rng_ctors.append(call)
    if ctx.module in one_rng and len(rng_ctors) > 1:
        for call in rng_ctors[1:]:
            out.append(ctx.finding(
                "DET002", call,
                f"second `random.Random(...)` in one-rng module "
                f"`{ctx.module}` — the replay contract is ONE rng, one "
                f"draw order ({len(rng_ctors)} constructed)",
                "thread the single seeded rng through instead of "
                "constructing another (splitting draw order silently "
                "changes every committed trace)",
            ))
    return out


# --------------------------------------------------------------------------
# DET003: digest-integrity dataflow
# --------------------------------------------------------------------------

_DIGEST_NAME_RE = re.compile(
    r"(^digest$|_digest$|_checksum$|^deterministic_log$)"
)


def _digest_functions(ctx: _Ctx) -> List[Tuple[ast.AST, str]]:
    """Functions on a digest path: named like one (``digest``,
    ``*_digest``, ``*_checksum``, ``deterministic_log``), constructing
    a ``hashlib`` hasher, or declared in MANIFEST
    ``digest_path_functions`` (the helpers whose output a digest folds:
    ``Arrival.key``, ``AuditReport.to_dict``, ...)."""
    cached = getattr(ctx, "_digest_fns", None)
    if cached is not None:  # DET003 and DET004 both walk this set
        return cached
    declared = set(ctx.manifest.get("digest_path_functions", ()))
    out = []
    for fn, qual in ctx.functions:
        tail2 = ".".join(qual.split(".")[-2:])
        if _DIGEST_NAME_RE.search(fn.name) \
                or qual in declared or tail2 in declared:
            out.append((fn, qual))
            continue
        for node in _own_nodes(fn):
            if isinstance(node, ast.Call):
                name = ctx.call_name(node) or ""
                if name.startswith("hashlib."):
                    out.append((fn, qual))
                    break
    ctx._digest_fns = out
    return out


def _iter_exprs(fn: ast.AST):
    """Every expression a function iterates (for-loops, comprehensions)."""
    for node in ast.walk(fn):
        if isinstance(node, ast.For):
            yield node.iter
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                yield gen.iter


def _rule_det003(ctx: _Ctx) -> List[Finding]:
    excluded = set(ctx.manifest.get("digest_excluded_fields", ()))
    out = []
    for fn, qual in _digest_functions(ctx):
        for node in ast.walk(fn):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.ctx, ast.Load) \
                    and node.attr in excluded:
                out.append(ctx.finding(
                    "DET003", node,
                    f"digest-excluded field `.{node.attr}` read on the "
                    f"digest path `{qual}` — wall times / request ids "
                    f"must never reach a digest fold",
                    "project the field out before hashing (the "
                    "deterministic_log idiom) or drop it from MANIFEST "
                    "digest_excluded_fields if it became replayable",
                ))
            elif isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, ast.Load) \
                    and isinstance(node.slice, ast.Constant) \
                    and node.slice.value in excluded:
                out.append(ctx.finding(
                    "DET003", node,
                    f"digest-excluded key `[{node.slice.value!r}]` read "
                    f"on the digest path `{qual}`",
                    "project the key out before hashing (the "
                    "deterministic_log idiom)",
                ))
        for it in _iter_exprs(fn):
            if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                    and it.func.id in ("sorted", "enumerate", "zip",
                                       "reversed", "list", "tuple", "range"):
                continue  # sorted() sanctions; sequence wrappers are ordered
            unsorted = None
            if isinstance(it, ast.Call) and isinstance(it.func, ast.Attribute) \
                    and it.func.attr in ("items", "keys", "values"):
                unsorted = f".{it.func.attr}()"
            elif isinstance(it, ast.Set) or (
                    isinstance(it, ast.Call)
                    and isinstance(it.func, ast.Name)
                    and it.func.id in ("set", "frozenset")):
                unsorted = "a set"
            if unsorted:
                out.append(ctx.finding(
                    "DET003", it,
                    f"iteration over {unsorted} on the digest path "
                    f"`{qual}` without `sorted(...)` — fold order must "
                    f"not depend on insertion/hash order",
                    "wrap the iterable in `sorted(...)` so the fold "
                    "order is content-determined",
                ))
    return out


# --------------------------------------------------------------------------
# DET004: id()/hash() feeding digests or cache keys
# --------------------------------------------------------------------------


def _id_hash_calls(fn: ast.AST) -> List[ast.Call]:
    return [
        n for n in ast.walk(fn)
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
        and n.func.id in ("id", "hash")
    ]


def _rule_det004(ctx: _Ctx) -> List[Finding]:
    manifest = ctx.manifest
    pins = manifest.get("id_key_pins", {})
    pins = set(pins) if not isinstance(pins, dict) else set(pins.keys())
    caches = set(manifest.get("program_caches", ()))
    gates = set(manifest.get("program_cache_gates", ()))
    digest_fns = {id(fn) for fn, _ in _digest_functions(ctx)}
    out = []
    for fn, qual in ctx.functions:
        if f"{ctx.module}.{qual}" in pins or qual in pins:
            continue  # lifetime-guaranteed pins, declared with rationale
        calls = []
        if id(fn) in digest_fns:
            calls = [(c, "a digest fold") for c in _id_hash_calls(fn)]
        else:
            for node in _own_nodes(fn):
                containers: List[Tuple[ast.AST, str]] = []
                if isinstance(node, ast.Assign) and any(
                        "key" in (t.id if isinstance(t, ast.Name)
                                  else getattr(t, "attr", "")).lower()
                        for t in node.targets
                        if isinstance(t, (ast.Name, ast.Attribute))):
                    containers.append((node.value, "a cache-key value"))
                elif isinstance(node, ast.Call) and node.args:
                    name = (_dotted(node.func) or "").split(".")[-1]
                    if name in gates:
                        containers.append(
                            (node.args[0], f"the `{name}(...)` key"))
                elif isinstance(node, ast.Subscript) \
                        and isinstance(node.value, ast.Name) \
                        and node.value.id in caches:
                    containers.append(
                        (node.slice, f"a `{node.value.id}[...]` key"))
                for container, what in containers:
                    calls += [(c, what)
                              for c in _id_hash_calls_in(container)]
        seen: Set[int] = set()
        for call, what in calls:
            if id(call) in seen:
                continue
            seen.add(id(call))
            out.append(ctx.finding(
                "DET004", call,
                f"`{call.func.id}(...)` feeds {what} in `{qual}` — "
                f"process-lifetime identity in a content identity "
                f"(ids recycle after gc; hashes are salted per process)",
                "key on content (a canonical serialization) — or, if "
                "the object is strong-referenced for the cache entry's "
                "lifetime, declare the function in MANIFEST id_key_pins "
                "with that rationale",
            ))
    return out


def _id_hash_calls_in(expr: ast.AST) -> List[ast.Call]:
    return [
        n for n in ast.walk(expr)
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
        and n.func.id in ("id", "hash")
    ]


# --------------------------------------------------------------------------
# DET005: program-key completeness
# --------------------------------------------------------------------------


def _enclosing_class_and_fn(ctx: _Ctx):
    """[(fn, qual, enclosing ClassDef or None)] for every function."""
    out = []

    def visit(node: ast.AST, qual: List[str], cls: Optional[ast.ClassDef]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FUNCTION_NODES):
                out.append((child, ".".join(qual + [child.name]), cls))
                visit(child, qual + [child.name], None)
            elif isinstance(child, ast.ClassDef):
                visit(child, qual + [child.name], child)
            else:
                visit(child, qual, cls)

    visit(ctx.tree, [], None)
    return out


def _key_roots_at(key_expr: ast.AST, scope: _Scope) -> Set[str]:
    return _expr_roots(key_expr, scope)


def _rule_det005(ctx: _Ctx) -> List[Finding]:
    out = []
    out += _det005_kernel_keys(ctx)
    out += _det005_factory_gates(ctx)
    out += _det005_guarded_constructors(ctx)
    return out


def _names_reaching(expr: ast.AST, env: Dict[str, List[ast.AST]],
                    stop: Set[str], depth: int = _ROOT_DEPTH,
                    visiting: Optional[Set[str]] = None) -> Set[str]:
    """Every name an expression's value reads, locals expanded through
    their assignments (``env``); a local in ``stop`` ends the walk (it
    is derived from the key itself)."""
    visiting = visiting if visiting is not None else set()
    names: Set[str] = set()
    if depth <= 0:
        return names
    for node in ast.walk(expr):
        if not (isinstance(node, ast.Name)
                and isinstance(node.ctx, ast.Load)):
            continue
        name = node.id
        if name in visiting or name in stop:
            continue
        if name in env:
            visiting.add(name)
            for value in env[name]:
                names |= _names_reaching(value, env, stop, depth - 1,
                                         visiting)
        else:
            names.add(name)
    return names


#: callees whose arguments are a compile command
_COMMAND_CALLS = {"subprocess.run", "subprocess.check_call",
                  "subprocess.check_output", "subprocess.Popen",
                  "os.system"}


def _det005_kernel_keys(ctx: _Ctx) -> List[Finding]:
    """A declared kernel build (manifest ``kernel_builds``): every name
    the build's compile command reads — parameters, module globals and
    the functions it calls, locals expanded — must be read by the key
    function too (or be derived from the key function's result, or be
    an ``exempt`` input).  Builtins never count."""
    import builtins

    spec = (ctx.manifest.get("kernel_builds") or {}).get(ctx.module)
    if not spec:
        return []
    fns = {qual: fn for fn, qual in ctx.functions}
    build, key = fns.get(spec["build"]), fns.get(spec["key"])
    if build is None or key is None:
        return [ctx.finding(
            "DET005", ctx.tree,
            f"manifest kernel_builds names `{spec['build']}` and "
            f"`{spec['key']}` in `{ctx.module}`, which defines "
            f"{'neither' if build is None and key is None else 'only one'}",
            "fix the kernel_builds entry in analysis/audit.py's MANIFEST",
        )]
    exempt = set(spec.get("exempt") or ())
    env = _local_env(build)
    # locals assigned from the key function's result are the key's own
    keyed = {name for name, values in env.items()
             if any(isinstance(n, ast.Call)
                    and (_dotted(n.func) or "").split(".")[-1] == key.name
                    for v in values for n in ast.walk(v))}
    key_reads = _names_reaching(key, _local_env(key), set()) \
        | set(_param_names(key))
    # the build's parameters reach the key through the key call's args
    for node in _own_nodes(build):
        if isinstance(node, ast.Call) \
                and (_dotted(node.func) or "").split(".")[-1] == key.name:
            for arg in list(node.args) + [k.value for k in node.keywords]:
                key_reads |= _names_reaching(arg, env, set())
    out = []
    for node in _own_nodes(build):
        if not (isinstance(node, ast.Call)
                and ctx.call_name(node) in _COMMAND_CALLS and node.args):
            continue
        inputs = _names_reaching(node.args[0], env, keyed)
        for name in sorted(inputs - key_reads - exempt - keyed):
            if hasattr(builtins, name) or name in ctx.mods:
                continue
            out.append(ctx.finding(
                "DET005", node,
                f"`{build.name}`'s compile command reads `{name}` but "
                f"the library key `{key.name}` never does — an edited "
                f"`{name}` would load the stale library",
                f"fold `{name}` into `{key.name}`'s hash, or declare it "
                f"with its reason in MANIFEST kernel_builds' `exempt`",
            ))
    return out


def _det005_factory_gates(ctx: _Ctx) -> List[Finding]:
    """``cached_programs(key, factory)`` sites: every local/parameter
    the factory closes over must reach the key expression."""
    gates = set(ctx.manifest.get("program_cache_gates", ()))
    if not gates:
        return []
    out = []
    for fn, qual, _cls in _enclosing_class_and_fn(ctx):
        # cheap pre-scan: root resolution (_Scope) is built only for
        # functions that actually call a gate — the whole-tree run
        # visits thousands of functions and a handful of gate sites
        sites = [n for n in _own_nodes(fn)
                 if isinstance(n, ast.Call)
                 and (_dotted(n.func) or "").split(".")[-1] in gates
                 and len(n.args) >= 2]
        if not sites:
            continue
        scope = _Scope(fn)
        local_defs = {n.name: n for n in _own_nodes(fn)
                      if isinstance(n, _FUNCTION_NODES)}
        for node in sites:
            key_expr, factory = node.args[0], node.args[1]
            if isinstance(factory, ast.Lambda):
                free = _free_loads(factory)
            elif isinstance(factory, ast.Name) \
                    and factory.id in local_defs:
                free = _free_loads(local_defs[factory.id])
            else:
                continue
            key_roots = _key_roots_at(key_expr, scope)
            for name in sorted(free):
                if name not in scope.params and name not in scope.env:
                    continue  # module global — identical across calls
                roots = _expr_roots(ast.Name(id=name, ctx=ast.Load()),
                                    scope)
                if roots and not roots & key_roots:
                    out.append(ctx.finding(
                        "DET005", node,
                        f"program factory at `{qual}` captures `{name}` "
                        f"but the cache key never mentions it — two "
                        f"configs differing only in `{name}` would share "
                        f"one cached program",
                        f"fold `{name}` (or a canonical serialization of "
                        f"it) into the key expression",
                    ))
    return out


def _det005_guarded_constructors(ctx: _Ctx) -> List[Finding]:
    """Cache-guarded constructors (the ``_STAGE_PROGRAMS`` pattern): a
    method that gets/stores a declared cache under a key parameter, and
    stores closures.  Every constructor parameter those closures reach
    must share a root with the key expression at each call site."""
    caches = set(ctx.manifest.get("program_caches", ()))
    if not caches:
        return []
    classes = [n for n in ast.walk(ctx.tree) if isinstance(n, ast.ClassDef)]
    out = []
    for cls in classes:
        self_map = None  # built only once a guarded method is found
        for method in cls.body:
            if not isinstance(method, _FUNCTION_NODES):
                continue
            key_param = _guarded_cache_key_param(method, caches)
            if key_param is None:
                continue
            if self_map is None:
                self_map = _class_self_map(cls)
            reaching = _closure_reaching_params(method, self_map, key_param)
            if not reaching:
                continue
            out += _check_construction_sites(
                ctx, cls, method, key_param, reaching)
    return out


def _guarded_cache_key_param(method: ast.AST,
                             caches: Set[str]) -> Optional[str]:
    """The method's key parameter, iff it both probes and stores a
    declared cache under that parameter."""
    params = set(_param_names(method))
    stored = probed = None
    for node in _own_nodes(method):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id in caches \
                        and isinstance(t.slice, ast.Name) \
                        and t.slice.id in params:
                    stored = t.slice.id
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "get" \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id in caches \
                and node.args and isinstance(node.args[0], ast.Name):
            probed = node.args[0].id
        elif isinstance(node, ast.Compare) \
                and any(isinstance(op, (ast.In, ast.NotIn))
                        for op in node.ops) \
                and isinstance(node.left, ast.Name):
            for cmp in node.comparators:
                if isinstance(cmp, ast.Name) and cmp.id in caches:
                    probed = node.left.id
    if stored is not None and stored == probed:
        return stored
    return None


def _closure_reaching_params(method: ast.AST,
                             self_map: Dict[str, _SelfAttr],
                             key_param: str) -> Set[str]:
    """Constructor parameters the stored closures' state derives from."""
    scope = _Scope(method, self_map)
    reaching: Set[str] = set()
    for node in _own_nodes(method):
        if not isinstance(node, _FUNCTION_NODES):
            continue
        for name in _free_loads(node):
            if name in scope.params:
                reaching.add(name)
            elif name in scope.env:
                roots = _expr_roots(ast.Name(id=name, ctx=ast.Load()),
                                    scope)
                reaching |= roots & scope.params
        for attr in _self_attr_loads(node):
            sa = self_map.get(attr)
            if sa is not None:
                reaching |= _expr_roots(sa.expr, sa.scope) & scope.params
    reaching.discard(key_param)
    return reaching


def _check_construction_sites(ctx: _Ctx, cls: ast.ClassDef,
                              method: ast.AST, key_param: str,
                              reaching: Set[str]) -> List[Finding]:
    sig = [p for p in _param_names(method) if p != "self"]
    out = []
    site_maps: Dict[int, Dict[str, _SelfAttr]] = {}
    for fn, qual, site_cls in _enclosing_class_and_fn(ctx):
        # cheap pre-scan first: scopes and self-maps are expensive
        # (full-class traversals) and construction sites are rare —
        # rebuilding them per visited function made the pass quadratic
        # in class size on the big engine files
        sites = [n for n in _own_nodes(fn)
                 if isinstance(n, ast.Call)
                 and (_dotted(n.func) or "").split(".")[-1] == cls.name]
        if not sites:
            continue
        if site_cls is None:
            site_map = {}
        else:
            if id(site_cls) not in site_maps:
                site_maps[id(site_cls)] = _class_self_map(site_cls)
            site_map = site_maps[id(site_cls)]
        scope = _Scope(fn, site_map)
        for node in sites:
            bound: Dict[str, ast.AST] = {}
            for i, arg in enumerate(node.args):
                if i < len(sig) and not isinstance(arg, ast.Starred):
                    bound[sig[i]] = arg
            for kw in node.keywords:
                if kw.arg:
                    bound[kw.arg] = kw.value
            if key_param not in bound:
                continue
            key_roots = _key_roots_at(bound[key_param], scope)
            if not key_roots:
                continue  # key is a global/constant — nothing derivable
            for p in sorted(reaching):
                if p not in bound:
                    continue
                roots = _expr_roots(bound[p], scope)
                if roots and not roots & key_roots:
                    out.append(ctx.finding(
                        "DET005", node,
                        f"`{cls.name}` caches programs under "
                        f"`{key_param}` but its closures capture "
                        f"`{p}`, and this call's `{p}=` argument shares "
                        f"no root with the key expression — two "
                        f"constructions differing only in `{p}` would "
                        f"reuse one cached program",
                        f"fold the `{p}` operand (or what it derives "
                        f"from) into the `{key_param}` expression at "
                        f"this call site",
                    ))
    return out


# --------------------------------------------------------------------------
# DET006: test-flakiness gate
# --------------------------------------------------------------------------


def _rule_det006(ctx: _Ctx) -> List[Finding]:
    if not ctx.is_test:
        return []
    sanctions = set(ctx.manifest.get("wallclock_test_sanctions", ()))
    base = os.path.basename(ctx.path)
    out = []
    for fn, qual in ctx.functions:
        out += _delta_asserts(ctx, fn, qual)
        # a sanction covers the whole test subtree — the sleep usually
        # lives in a nested stalled/slow_step helper the test installs
        parts = qual.split(".")
        if any(f"{base}::{'.'.join(parts[:i + 1])}" in sanctions
               for i in range(len(parts))):
            continue
        for node in _own_nodes(fn):
            if isinstance(node, ast.Call) \
                    and ctx.call_name(node) == "time.sleep":
                out.append(ctx.finding(
                    "DET006", node,
                    f"`time.sleep` in test `{qual}` — real-time waits "
                    f"flake under load",
                    "drive the subject with an injected clock/sleep "
                    "fake (the StageRuntime._clock idiom) — or, if the "
                    "sleep IS the subject (a real watchdog), declare "
                    "`file::test` in MANIFEST wallclock_test_sanctions "
                    "with the margin rationale",
                ))
    return out


def _delta_asserts(ctx: _Ctx, fn: ast.AST, qual: str) -> List[Finding]:
    """Taint timestamps -> deltas; flag asserts comparing a delta to a
    numeric constant.  Delta/delta ratios untaint (the sanctioned
    robust form: overhead fractions, healed-vs-control comparisons)."""
    ts_vars: Set[str] = set()
    delta_vars: Set[str] = set()

    def classify(expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Call) and _is_wallclock_call(ctx, expr):
            return "ts"
        if isinstance(expr, ast.Name):
            if expr.id in delta_vars:
                return "delta"
            if expr.id in ts_vars:
                return "ts"
            return None
        if isinstance(expr, ast.UnaryOp):
            return classify(expr.operand)
        if isinstance(expr, ast.BinOp):
            left, right = classify(expr.left), classify(expr.right)
            if isinstance(expr.op, ast.Sub) and "ts" in (left, right):
                return "delta"
            if isinstance(expr.op, ast.Div):
                if right == "delta":
                    return None  # delta/delta or x/delta: a ratio
                if left == "delta":
                    return "delta"
                return None
            if isinstance(expr.op, (ast.Add, ast.Sub, ast.Mult)) \
                    and "delta" in (left, right):
                return "delta"
        return None

    out = []
    for node in _own_nodes(fn):
        if isinstance(node, ast.Assign):
            kind = classify(node.value)
            for t in node.targets:
                if isinstance(t, ast.Name):
                    if kind == "ts":
                        ts_vars.add(t.id)
                    elif kind == "delta":
                        delta_vars.add(t.id)
                    else:
                        ts_vars.discard(t.id)
                        delta_vars.discard(t.id)
        elif isinstance(node, ast.Assert) \
                and isinstance(node.test, ast.Compare):
            sides = [node.test.left] + list(node.test.comparators)
            kinds = [classify(s) for s in sides]
            consts = [
                isinstance(s, ast.Constant)
                and isinstance(s.value, (int, float))
                or (isinstance(s, ast.UnaryOp)
                    and isinstance(s.operand, ast.Constant))
                for s in sides
            ]
            if "delta" in kinds and any(
                    c and k != "delta" for c, k in zip(consts, kinds)):
                out.append(ctx.finding(
                    "DET006", node,
                    f"test `{qual}` asserts a raw wall-clock delta "
                    f"against a constant bound — flakes under host "
                    f"load",
                    "assert the behavior instead (an injected-clock "
                    "fake, a cache-state check, or a measured-vs-"
                    "measured ratio) — never a wall-second constant",
                ))
    return out


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------

RULES = {
    "DET001": _rule_det001,
    "DET002": _rule_det002,
    "DET003": _rule_det003,
    "DET004": _rule_det004,
    "DET005": _rule_det005,
    "DET006": _rule_det006,
}


def _suppressions(source: str):
    """(per-line {line: set|None}, file-level set) from real COMMENT
    tokens only — a docstring mentioning the syntax must not disable
    rules (same contract as skylint)."""
    import io
    import tokenize

    per_line: Dict[int, Optional[Set[str]]] = {}
    file_level: Set[str] = set()
    try:
        tokens = list(tokenize.generate_tokens(
            io.StringIO(source).readline
        ))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return per_line, file_level  # unparseable -> DET000 anyway
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_FILE_RE.search(tok.string)
        if m:
            file_level |= {
                s.strip().upper() for s in m.group(1).split(",") if s.strip()
            }
            continue
        m = _SUPPRESS_LINE_RE.search(tok.string)
        if m:
            if m.group(1):
                per_line[tok.start[0]] = {
                    s.strip().upper()
                    for s in m.group(1).split(",") if s.strip()
                }
            else:
                per_line[tok.start[0]] = None  # all rules
    return per_line, file_level


def check_source(source: str, path: str = "<string>",
                 config: Optional[DetConfig] = None,
                 manifest: Optional[Dict[str, Any]] = None,
                 module: Optional[str] = None) -> List[Finding]:
    """Check one source string; returns findings (suppressed ones only
    when the config asks for them).  ``module`` overrides the dotted
    module name derived from ``path`` (fixture convenience)."""
    config = config or DetConfig()
    manifest = manifest if manifest is not None else default_manifest()
    lines = source.splitlines()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [Finding(
            rule="DET000", path=path, line=exc.lineno or 1,
            col=exc.offset or 0,
            message=f"file does not parse: {exc.msg}",
            fixit="fix the syntax error — unparseable files cannot be "
                  "checked and must not pass a lint gate",
        )]
    if module is None:
        module = (_module_name(path) if path != "<string>"
                  else "<string>")
    ctx = _Ctx(tree, path, lines, module, manifest)
    per_line, file_level = _suppressions(source)
    findings: List[Finding] = []
    for rule_id, rule_fn in RULES.items():
        if config.select is not None and rule_id not in config.select:
            continue
        if rule_id in config.ignore:
            continue
        for f in rule_fn(ctx):
            sup = rule_id in file_level
            line_sup = per_line.get(f.line, ...)
            if line_sup is None or (
                    line_sup is not ... and rule_id in line_sup):
                sup = True
            if sup:
                if config.include_suppressed:
                    findings.append(
                        dataclasses.replace(f, suppressed=True)
                    )
            else:
                findings.append(f)
    seen = set()
    unique = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        key = (f.rule, f.line, f.col, f.message)
        if key not in seen:
            seen.add(key)
            unique.append(f)
    return unique


def check_file(path: str,
               config: Optional[DetConfig] = None,
               manifest: Optional[Dict[str, Any]] = None) -> List[Finding]:
    try:
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
    except (OSError, UnicodeDecodeError) as exc:
        return [Finding(
            rule="DET000", path=path, line=1, col=0,
            message=f"file cannot be read: {exc}",
            fixit="fix the encoding or the path — unreadable files "
                  "cannot be checked and must not pass a lint gate",
        )]
    return check_source(source, path, config, manifest)


def check_paths(paths: Sequence[str],
                config: Optional[DetConfig] = None,
                manifest: Optional[Dict[str, Any]] = None) -> List[Finding]:
    """Check files and/or directory trees (the skylint walk contract:
    explicit files always check; caches skipped)."""
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
    out: List[Finding] = []
    for f in sorted(set(files)):
        out += check_file(f, config, manifest)
    return out


def check_pure_stdlib_loads(
        manifest: Optional[Dict[str, Any]] = None,
        root: Optional[str] = None) -> List[Finding]:
    """Load every MANIFEST ``pure_stdlib`` module by FILE PATH, the way
    the smoke gates do on a bare runner — a module that stopped loading
    standalone (a new top-level torch/numpy/package import) fails here at
    lint time instead of in a downstream smoke.  Failures surface as
    DET000 (contract breakage, not a style finding)."""
    import importlib.util
    import sys

    manifest = manifest if manifest is not None else default_manifest()
    if root is None:
        root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
    out: List[Finding] = []
    for dotted in manifest.get("pure_stdlib", ()):
        rel = dotted.split(".")
        path = os.path.join(root, *rel[:-1], rel[-1] + ".py")
        if not os.path.exists(path):
            out.append(Finding(
                rule="DET000", path=path, line=1, col=0,
                message=f"MANIFEST pure_stdlib names `{dotted}` but no "
                        f"such file exists",
                fixit="fix the MANIFEST entry or restore the module",
            ))
            continue
        name = f"_skydet_load_{dotted.replace('.', '_')}"
        if name in sys.modules:
            continue  # already proved loadable this process
        try:
            spec = importlib.util.spec_from_file_location(name, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[name] = mod
            spec.loader.exec_module(mod)
        except Exception as exc:  # noqa: BLE001 - any failure is the finding
            sys.modules.pop(name, None)
            out.append(Finding(
                rule="DET000", path=path, line=1, col=0,
                message=f"`{dotted}` is pure-stdlib by contract but "
                        f"failed to load by file path: "
                        f"{type(exc).__name__}: {exc}",
                fixit="keep the module loadable standalone — guard or "
                      "move the import that broke it (see MANIFEST "
                      "pure_stdlib)",
            ))
    return out


__all__ = [
    "DetConfig", "Finding", "RULES", "check_file", "check_paths",
    "check_pure_stdlib_loads", "check_source", "default_manifest",
]
