"""skylint for the port: an AST linter for the hazards of eager PyTorch
on a card (the port's own counterpart of ``skycomputing_tpu/analysis/
lint.py``, with the rules written for PyTorch and CUDA).

Generic linters cannot see the failure modes that cost a pipelined
eager program its overlap: a stray ``.item()`` inside the pipeline's
issue loop makes the host wait for the whole device queue; a kernel
library built or loaded inside the step puts ``nvcc`` or ``dlopen`` in
a measured window; a draw from the process-global RNG makes dropout
masks depend on who else drew; a timed window that ends with no sync
measures the launch, not the work.  Each rule below encodes one of
those hazards under the reference's stable ID, with a fix-it message
and inline suppression:

    SKY001  host-device sync inside a hot path (``.item()``,
            ``.tolist()``, ``.cpu()``, ``.numpy()``, ``float/int/bool``
            or ``np.asarray`` of a tensor) before the step's barrier
    SKY002  a kernel library built or loaded (``ops/_build.build`` /
            ``load``), ``torch.compile`` or a C++ extension loaded
            inside a hot path: the port's counterpart of a recompile
            inside the step
    SKY003  process-global RNG state: ``torch.manual_seed`` and the
            other global seeders, ``torch.rand*`` / ``randn*`` /
            ``randint`` / ``randperm`` / ``bernoulli`` / ``multinomial``
            / ``normal`` without ``generator=``, functional dropout,
            and numpy's legacy ``np.random.*`` — all outside a
            ``with torch.random.fork_rng(...)`` block
    SKY005  a timed window over device work with no sync before its
            end (``torch.cuda.synchronize``, an event's ``synchronize``
            / ``elapsed_time``, a syncing read, or the port's helpers
            ``synchronize`` / ``_synchronize``)
    SKY006  debug leftovers (``breakpoint()``, ``pdb``/``ipdb``,
            ``torch.autograd.set_detect_anomaly(True)``,
            ``torch.autograd.detect_anomaly()``)
    SKY007  layer-config structure (``layer_type`` missing from a unit
            handed to the builder)
    SKY008  tuple-threading protocol (a raw layer result star-unpacked
            without ``builder.layer_stack.as_tuple``)

The reference's SKY004 (a read of a buffer after ``donate_argnums``
donated it) has no counterpart: eager PyTorch donates no buffer — every
op's inputs stay valid after it returns, and an in-place op (``add_``)
mutates a tensor its caller still owns by design.  ``--select SKY004``
is accepted and finds nothing.

What counts as device work and as a sync follows the port's own
contracts: a ``PipelineModel.train_step`` returns after the pipeline's
device barrier, and a serving engine's or fleet's ``step`` / ``run`` /
a scenario player's ``play`` end each tick with the tokens read to the
host, so all of them are syncing calls — ``step`` / ``run`` / ``play``
only on such a receiver (a name or attribute naming an engine, a fleet
or a player, or a name the function binds to ``ServingEngine``,
``ServingFleet``, ``DisaggFleet`` or ``ScenarioPlayer``), never on an
optimizer, a scheduler or a thread; ``torch.*`` operations, the
kernel wrappers (``flash_attention``, ``paged_attention*``) and a
stage's ``forward`` / ``forward_raw`` / ``backward`` / ``backward_raw``
issue work and return before it is done.

Suppression syntax (same line as the finding)::

    total = float(loss)  # skylint: disable=SKY001  -- once-per-step read

or ``# skylint: disable`` to silence every rule on that line; a line
containing ``# skylint: disable-file=SKY00X`` disables a rule for the
whole file.  Parse failures surface as rule ``SKY000`` so a broken file
cannot slip through a lint gate as "no findings".

The rules are heuristic by design (AST-level, no type inference) and
tuned to the port: the gate (``python -m
skycomputing_tpu_torch.tools.skylint skycomputing_tpu_torch/
chip_smoke.py --strict``) ships green, each inline suppression with its
reason.  Pure stdlib by contract: the CLI loads this module by file path
with no torch installed.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set

# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Finding:
    """One lint finding, pinned to a file position."""

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
class LintConfig:
    """Rule selection + suppression handling for one lint run."""

    select: Optional[Set[str]] = None  # None = all rules
    ignore: Set[str] = field(default_factory=set)
    include_suppressed: bool = False  # report suppressed findings too


# functions whose bodies are "hot": they run once per training step or
# serving tick (or more — per microbatch, per stage), and a host stall in
# them serializes the device queue.  The port's loops: the pipeline's
# train_step and gradient passes, a stage's forward/backward (raw and
# emulated), an engine's or fleet's step, and the paged stage runner.
# Nested functions inherit hotness from the enclosing definition.
HOT_FN_RE = re.compile(
    r"^(train_step|compute_gradients|apply_gradients|forward|forward_raw"
    r"|backward|backward_raw|step|_run_paged_stages)$"
)

# no-argument methods that read a tensor to the host (a sync on CUDA)
_SYNC_ATTR_TAILS = {"item", "tolist", "cpu", "numpy"}
# torch factories: with no ``device=`` they make a CPU tensor, whose
# read is a host copy, not a wait for the card (the port never sets a
# default device)
_CPU_FACTORIES = {"arange", "as_tensor", "empty", "full", "linspace",
                  "ones", "rand", "randint", "randn", "randperm", "tensor",
                  "zeros"}
# builtins that read a tensor to the host when handed one
_SYNC_CALL_NAMES = {"float", "int", "bool"}
_SYNC_NP_FNS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}

# callees that wait for the device (or for the host read that implies
# it): explicit syncs, event timing, syncing reads, and the pipeline's
# ``train_step``, which returns after its barrier (``np.asarray`` is
# none: it raises on a CUDA tensor)
_SYNCING_TAILS = {"synchronize", "_synchronize", "elapsed_time", "item",
                  "tolist", "cpu", "numpy", "train_step"}
# methods that sync only on the port's serving objects, whose tick ends
# with its tokens read to the host (module docstring); an optimizer's or
# a scheduler's ``step`` or a thread's ``run`` does not
_SYNCING_METHODS = {"step", "run", "play"}
# ... such a receiver: a name or attribute naming an engine, a fleet or
# a player (``engine``, ``fleet_a``, ``self.warm_engine``), or a name
# the function binds to one of these classes
_SYNCING_RECEIVER_RE = re.compile(r"(^|_)(engine|fleet|player)(_|\d|$)")
_SYNCING_TYPES = {"ServingEngine", "ServingFleet", "DisaggFleet",
                  "ScenarioPlayer"}

# callees that issue device work and return before it is done
_DISPATCHY_TAIL_RE = re.compile(
    r"^(forward|forward_raw|backward|backward_raw|compute_gradients"
    r"|apply_gradients|flash_attention|paged_attention\w*)$"
)

# torch API that launches no device work (construction, queries, RNG
# objects, device plumbing): a timed window over only these is honest
# host timing
_NON_DISPATCH_TORCH = re.compile(
    r"^torch\.(device|dtype|Generator|Size|get_num_threads|set_num_threads"
    r"|is_tensor|is_floating_point|no_grad|enable_grad|inference_mode"
    r"|set_grad_enabled|get_default_dtype|finfo|iinfo|manual_seed"
    r"|from_numpy|profiler\..*|random\.fork_rng|autograd\.profiler\..*"
    r"|cuda\.(is_available|device_count|get_device_name"
    r"|get_device_properties|current_device|set_device|Event"
    r"|max_memory_allocated|memory_allocated|reset_peak_memory_stats"
    r"|synchronize|Stream|stream|current_stream))$"
)

# the kernel library's build and load (ops/_build.py), torch.compile and
# the C++ extension loaders: each one compiles or dlopens
_BUILD_CALLS = {"_build.build", "_build.load", "torch.compile",
                "torch.jit.script", "torch.jit.trace",
                "torch.utils.cpp_extension.load",
                "torch.utils.cpp_extension.load_inline",
                "cpp_extension.load", "cpp_extension.load_inline"}

# global seeders (never clean outside a fork)
_GLOBAL_SEEDERS = {"torch.manual_seed", "torch.seed",
                   "torch.random.manual_seed", "torch.random.seed",
                   "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                   "torch.cuda.seed", "torch.cuda.seed_all",
                   "torch.set_rng_state", "torch.random.set_rng_state",
                   "torch.cuda.set_rng_state",
                   "torch.cuda.set_rng_state_all"}
# draws that take a generator= (clean with one)
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "rand_like",
                "randn_like", "randint_like", "bernoulli", "multinomial",
                "normal", "poisson"}
# functional dropout draws its mask from the global generator
_DROPOUT_CALLS = {"torch.dropout", "torch.nn.functional.dropout",
                  "F.dropout", "nn.functional.dropout",
                  "torch.nn.functional.dropout1d",
                  "torch.nn.functional.dropout2d",
                  "torch.nn.functional.dropout3d", "F.dropout1d",
                  "F.dropout2d", "F.dropout3d", "torch.alpha_dropout",
                  "F.alpha_dropout", "torch.nn.functional.alpha_dropout"}
# numpy.random attributes that do NOT touch the legacy global state
_NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "BitGenerator",
                 "PCG64", "PCG64DXSM", "Philox", "MT19937", "SFC64",
                 "RandomState"}

_SUPPRESS_LINE_RE = re.compile(
    r"#\s*skylint:\s*disable(?:=([A-Za-z0-9_,\s]+))?"
)
_SUPPRESS_FILE_RE = re.compile(
    r"#\s*skylint:\s*disable-file=([A-Za-z0-9_,\s]+)"
)


# --------------------------------------------------------------------------
# AST helpers
# --------------------------------------------------------------------------


def _dotted(node: ast.AST) -> Optional[str]:
    """'torch.cuda.synchronize' for an Attribute/Name chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _call_tail(call: ast.Call) -> str:
    """Last segment of the callee ('synchronize' for
    torch.cuda.synchronize(...))."""
    fn = call.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


def _walk_functions(tree: ast.Module):
    """Yield (function_node, is_hot) for every def, hotness inherited."""

    def visit(node, hot):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                child_hot = hot or bool(HOT_FN_RE.match(child.name))
                yield child, child_hot
                yield from visit(child, child_hot)
            else:
                yield from visit(child, hot)

    yield from visit(tree, False)


def _own_nodes(fn: ast.AST) -> Iterable[ast.AST]:
    """Walk a function body WITHOUT descending into nested defs."""

    def visit(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                continue
            yield child
            yield from visit(child)

    yield from visit(fn)


def _assign_target_names(node: ast.AST) -> List[str]:
    """Plain-Name targets of an Assign/AugAssign/For/With target tree."""
    out: List[str] = []

    def collect(t):
        if isinstance(t, ast.Name):
            out.append(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                collect(e)
        elif isinstance(t, ast.Starred):
            collect(t.value)

    if isinstance(node, ast.Assign):
        for t in node.targets:
            collect(t)
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.For)):
        collect(node.target)
    return out


# --------------------------------------------------------------------------
# rules
# --------------------------------------------------------------------------


class _Ctx:
    def __init__(self, tree: ast.Module, path: str, lines: List[str]):
        self.tree = tree
        self.path = path
        self.lines = lines

    def finding(self, rule: str, node: ast.AST, message: str,
                fixit: str) -> Finding:
        return Finding(
            rule=rule,
            path=self.path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            message=message,
            fixit=fixit,
        )


def _is_torch_dispatch(dotted: str) -> bool:
    """A ``torch.*`` / ``F.*`` call that launches device work."""
    if dotted.startswith(("torch.", "F.", "nn.functional.")):
        return not _NON_DISPATCH_TORCH.match(dotted)
    return False


def _cpu_factory(expr: ast.AST) -> bool:
    """A ``torch.<factory>(...)`` call with no ``device=``: a CPU
    tensor."""
    return (isinstance(expr, ast.Call)
            and (_dotted(expr.func) or "").startswith("torch.")
            and (_dotted(expr.func) or "").count(".") == 1
            and _call_tail(expr) in _CPU_FACTORIES
            and all(kw.arg != "device" for kw in expr.keywords))


def _first_sync_line(fn: ast.AST) -> Optional[int]:
    """The first line of ``fn``'s own body that waits for the device."""
    lines = [n.lineno for n in _own_nodes(fn)
             if isinstance(n, ast.Call)
             and _call_tail(n) in ("synchronize", "_synchronize")]
    return min(lines) if lines else None


def _rule_sky001(ctx: _Ctx) -> List[Finding]:
    """Host-device sync inside a hot path.

    Inside hot functions a ``.item()`` / ``.tolist()`` / ``.cpu()`` /
    ``.numpy()``, or a ``float()`` / ``int()`` / ``bool()`` /
    ``np.asarray`` of a tensor, blocks the host on the device queue
    mid-issue.  ``float()`` and friends on plain host values are NOT a
    sync, so those flag only when the argument derives from a torch
    call, a kernel wrapper or a stage call, and a read of a tensor that
    a torch factory just made with no ``device=`` (a CPU tensor, e.g. a
    seed drawn from a CPU generator) is a host copy, not a sync.  Reads
    that occur lexically
    at or after a ``synchronize`` / ``_synchronize`` in the same function
    are exempt: the queue is already drained (the once-per-step loss
    read after the pipeline's barrier).
    """
    out: List[Finding] = []
    for fn, hot in _walk_functions(ctx.tree):
        if not hot:
            continue
        first_sync = _first_sync_line(fn)

        def is_device_call(call: ast.Call) -> bool:
            dotted = _dotted(call.func) or ""
            return _is_torch_dispatch(dotted) or \
                bool(_DISPATCHY_TAIL_RE.match(_call_tail(call)))

        tainted: Set[str] = set()
        for _pass in range(2):
            for node in _own_nodes(fn):
                if not isinstance(node, ast.Assign):
                    continue
                v = node.value
                if (isinstance(v, ast.Call) and is_device_call(v)) or any(
                        isinstance(n, ast.Name) and n.id in tainted
                        for n in ast.walk(v)):
                    tainted |= set(_assign_target_names(node))

        def arraylike(expr: ast.AST) -> bool:
            for n in ast.walk(expr):
                if isinstance(n, ast.Name) and n.id in tainted:
                    return True
                if isinstance(n, ast.Call) and is_device_call(n):
                    return True
            return False

        for node in _own_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            if first_sync is not None and node.lineno >= first_sync:
                continue
            dotted = _dotted(node.func)
            tail = _call_tail(node)
            hit = None
            if tail in _SYNC_ATTR_TAILS and \
                    isinstance(node.func, ast.Attribute) and \
                    not node.args and not _cpu_factory(node.func.value):
                hit = f".{tail}()"
            elif dotted in _SYNC_NP_FNS and node.args and \
                    arraylike(node.args[0]):
                hit = dotted
            elif isinstance(node.func, ast.Name) and \
                    node.func.id in _SYNC_CALL_NAMES and node.args and \
                    not isinstance(node.args[0], ast.Constant) and \
                    arraylike(node.args[0]):
                hit = f"{node.func.id}(...)"
            if hit:
                out.append(ctx.finding(
                    "SKY001", node,
                    f"{hit} in hot path `{getattr(fn, 'name', '?')}` "
                    f"makes the host wait for the device mid-issue",
                    "move the read after the step's synchronize, keep "
                    "the value on the device, or read it once per step",
                ))
    return out


def _rule_sky002(ctx: _Ctx) -> List[Finding]:
    """A kernel build or load inside the step.

    The port compiles nothing at run time except its kernel libraries:
    ``ops/_build.build`` runs ``nvcc`` and ``load`` dlopens (and builds
    when the library is missing).  A hot function that reaches either
    (directly, or through ``torch.compile`` / ``torch.jit`` / a C++
    extension loader) puts a compile inside the measured step, the
    port's counterpart of the reference's jit-per-call recompile.
    Kernel wrappers load their library at first use outside the hot
    set; ``ops/_build.load.count`` counts loads so a bench can prove a
    window held none.
    """
    out: List[Finding] = []
    for fn, hot in _walk_functions(ctx.tree):
        if not hot:
            continue
        for node in _own_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func) or ""
            hit = next((c for c in _BUILD_CALLS
                        if dotted == c or dotted.endswith("." + c)), None)
            if hit is None:
                continue
            out.append(ctx.finding(
                "SKY002", node,
                f"`{dotted}(...)` inside hot path `{fn.name}` compiles or "
                f"loads a library inside the step",
                "build and load before the loop (at construction or in a "
                "warm-up call) and keep the handle",
            ))
    return out


def _fork_spans(tree: ast.AST) -> List[tuple]:
    """Line spans of ``with torch.random.fork_rng(...)`` bodies."""
    spans = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call) and (
                        _dotted(expr.func) or "").endswith("fork_rng"):
                    spans.append((node.lineno,
                                  node.end_lineno or node.lineno))
    return spans


def _rule_sky003(ctx: _Ctx) -> List[Finding]:
    """Process-global RNG state.

    Every draw the port makes goes through a seeded ``torch.Generator``
    (the parameter server's initializers, the pipeline's per-microbatch
    dropout seeds, the serving sampler) or happens inside a
    ``torch.random.fork_rng`` block that seeds the fork (the stage's
    dropout fork).  A global seeder, a draw without ``generator=``,
    functional dropout or numpy's legacy ``np.random.*`` outside such a
    block couples its stream to every other caller in the process.
    """
    out: List[Finding] = []
    forks = _fork_spans(ctx.tree)

    def in_fork(line: int) -> bool:
        return any(a <= line <= b for a, b in forks)

    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or in_fork(node.lineno):
            continue
        dotted = _dotted(node.func) or ""
        kws = {kw.arg for kw in node.keywords}
        what = None
        if dotted in _GLOBAL_SEEDERS:
            what = f"`{dotted}(...)` seeds the process-global generator"
        elif dotted.startswith("torch.") and \
                dotted.split(".")[-1] in _TORCH_DRAWS and \
                dotted.count(".") == 1 and "generator" not in kws:
            what = (f"`{dotted}(...)` without generator= draws from the "
                    f"process-global generator")
        elif dotted in _DROPOUT_CALLS:
            what = (f"`{dotted}(...)` draws its mask from the "
                    f"process-global generator")
        elif dotted.startswith(("np.random.", "numpy.random.")) and \
                dotted.split(".")[2] not in _NP_RANDOM_OK:
            what = f"`{dotted}(...)` uses numpy's legacy global RNG state"
        if what:
            out.append(ctx.finding(
                "SKY003", node,
                f"{what} — draw order couples to every other caller in "
                f"the process",
                "pass a seeded torch.Generator (np.random.default_rng for "
                "numpy), or seed inside `with torch.random.fork_rng(...)`",
            ))
    return out


def _rule_sky005(ctx: _Ctx) -> List[Finding]:
    """Timing device work without a sync.

    ``t0 = perf_counter(); <torch work>; dt = perf_counter() - t0`` with
    no sync between measures the LAUNCH, not the work: CUDA returns from
    a launch in microseconds while the card still runs.  A region is
    device work when it calls ``torch.*`` operations, a kernel wrapper
    or a stage's forward/backward; it is synced when it calls
    ``synchronize`` (``torch.cuda.synchronize``, an event's or the
    port's helpers), ``elapsed_time``, a syncing read, or one of the
    port's calls that return after the work (module docstring).
    Regions whose elapsed time lands in a name containing ``dispatch``
    are exempt: host-issue time is the port's one legitimate unsynced
    timing (``PipelineStats.dispatch_s``).
    """
    out: List[Finding] = []
    time_fns = {"time.perf_counter", "time.time", "time.monotonic",
                "time.perf_counter_ns", "time.monotonic_ns",
                "perf_counter", "monotonic"}
    for fn, _hot in _walk_functions(ctx.tree):
        timer_vars: Dict[str, List[int]] = {}
        for node in _own_nodes(fn):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call) and \
                    _dotted(node.value.func) in time_fns:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        timer_vars.setdefault(t.id, []).append(node.lineno)
        if not timer_vars:
            continue
        calls = [n for n in _own_nodes(fn) if isinstance(n, ast.Call)]
        # names this function binds to the port's serving objects
        bound = {t.id for n in _own_nodes(fn) if isinstance(n, ast.Assign)
                 and isinstance(n.value, ast.Call)
                 and _call_tail(n.value) in _SYNCING_TYPES
                 for t in n.targets if isinstance(t, ast.Name)}

        def syncing_receiver(call: ast.Call) -> bool:
            recv = call.func.value if isinstance(call.func,
                                                 ast.Attribute) else None
            if isinstance(recv, ast.Call):  # ScenarioPlayer(...).play()
                return _call_tail(recv) in _SYNCING_TYPES
            if isinstance(recv, ast.Name):
                name = recv.id
            elif isinstance(recv, ast.Attribute):
                name = recv.attr
            else:
                return False
            return name in bound or bool(
                _SYNCING_RECEIVER_RE.search(name.lower()))

        def classify(call: ast.Call) -> str:
            dotted = _dotted(call.func) or ""
            tail = _call_tail(call)
            if tail in _SYNCING_TAILS or (tail in _SYNCING_METHODS
                                          and syncing_receiver(call)):
                return "sync"
            if _is_torch_dispatch(dotted) or _DISPATCHY_TAIL_RE.match(tail):
                return "dispatch"
            return "host"

        for node in _own_nodes(fn):
            if not (isinstance(node, ast.BinOp) and
                    isinstance(node.op, ast.Sub)):
                continue
            right = node.right
            if not (isinstance(right, ast.Name) and
                    right.id in timer_vars):
                continue
            left_ok = (
                isinstance(node.left, ast.Call) and
                _dotted(node.left.func) in time_fns
            ) or (
                isinstance(node.left, ast.Name) and
                node.left.id in timer_vars
            )
            if not left_ok or "dispatch" in right.id:
                continue
            stmts = [
                s for s in _own_nodes(fn)
                if isinstance(s, (ast.Assign, ast.AugAssign,
                                  ast.AnnAssign, ast.Return, ast.Expr))
                and s.lineno <= node.lineno <= (s.end_lineno or s.lineno)
            ]
            if stmts:
                stmt = max(stmts, key=lambda s: s.lineno)  # innermost
                span = ctx.lines[stmt.lineno - 1:stmt.end_lineno or
                                 stmt.lineno]
            else:
                span = ctx.lines[node.lineno - 1:node.lineno]
            if any("dispatch" in ln.split("#")[0] for ln in span):
                continue
            starts = [ln for ln in timer_vars[right.id]
                      if ln < node.lineno]
            if not starts:
                continue
            start = max(starts)
            kinds = {classify(c) for c in calls
                     if start < c.lineno <= node.lineno}
            if "dispatch" in kinds and "sync" not in kinds:
                out.append(ctx.finding(
                    "SKY005", node,
                    f"elapsed time of `{right.id}` (started line {start}) "
                    f"spans device work with no sync — this times the "
                    f"launch, not the work",
                    "torch.cuda.synchronize() (or the port's "
                    "synchronize helper) before reading the clock, or "
                    "time on the card with CUDA events; name the result "
                    "*dispatch* if host-issue time is the point",
                ))
    return out


def _rule_sky006(ctx: _Ctx) -> List[Finding]:
    """Debug leftovers in library code."""
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            dotted = _dotted(node.func) or ""
            hit = None
            if dotted in ("pdb.set_trace", "ipdb.set_trace",
                          "torch.autograd.detect_anomaly") or \
                    (isinstance(node.func, ast.Name) and
                     node.func.id == "breakpoint"):
                hit = dotted or "breakpoint"
            elif dotted in ("torch.autograd.set_detect_anomaly",
                            "torch.autograd.anomaly_mode."
                            "set_detect_anomaly") and not (
                    node.args and isinstance(node.args[0], ast.Constant)
                    and node.args[0].value is False):
                hit = dotted
            if hit:
                out.append(ctx.finding(
                    "SKY006", node,
                    f"debug leftover `{hit}` in library code — it wedges "
                    f"the process or checks every backward op",
                    "delete it, or gate it behind an explicit debug flag",
                ))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = [a.name for a in node.names]
            if isinstance(node, ast.ImportFrom) and node.module:
                mods.append(node.module)
            for m in mods:
                if m in ("pdb", "ipdb"):
                    out.append(ctx.finding(
                        "SKY006", node,
                        f"`import {m}` in library code",
                        "remove the debugger import before shipping",
                    ))
    return out


def _rule_sky007(ctx: _Ctx) -> List[Finding]:
    """Layer-config structure for the builder protocol.

    Every unit config handed to ``build_layer_stack`` / ``build_layer``
    must carry a ``layer_type`` key — the registry dispatches on it, and
    a missing key fails only at build time deep inside a launch path.
    """
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if _call_tail(node) not in ("build_layer_stack", "build_layer",
                                    "build_module_from_cfg"):
            continue
        if not node.args:
            continue
        first = node.args[0]
        elems = first.elts if isinstance(first, ast.List) else [first]
        for elem in elems:
            ok = True
            if isinstance(elem, ast.Dict):
                keys = [k.value for k in elem.keys
                        if isinstance(k, ast.Constant)]
                has_splat = any(k is None for k in elem.keys)
                ok = "layer_type" in keys or has_splat
            elif isinstance(elem, ast.Call) and _call_tail(elem) == "dict":
                kws = [kw.arg for kw in elem.keywords]
                ok = "layer_type" in kws or None in kws
            if not ok:
                out.append(ctx.finding(
                    "SKY007", elem,
                    "layer config without a `layer_type` key — the "
                    "builder registry cannot dispatch it",
                    "add layer_type=<registered layer name> to the "
                    "config dict",
                ))
    return out


def _rule_sky008(ctx: _Ctx) -> List[Finding]:
    """Tuple-threading protocol: a raw layer result must pass through
    ``as_tuple`` before being star-unpacked.

    A layer's output is a tensor OR a tuple (``LayerStack`` threads
    whichever the layer returns); ``*out`` on a bare tensor iterates its
    leading axis — silently feeding batch rows to the next layer.  Raw
    results are those of ``.apply(...)`` / ``.forward(...)`` and of a
    call on a layer or stack the function built (``build_layer`` /
    ``build_layer_stack``).
    """
    out: List[Finding] = []
    for fn, _hot in _walk_functions(ctx.tree):
        built: Set[str] = set()
        raw: Dict[str, int] = {}
        rewrapped: Dict[str, List[int]] = {}
        for node in _own_nodes(fn):
            if not isinstance(node, ast.Assign):
                continue
            v = node.value
            targets = _assign_target_names(node)
            if isinstance(v, ast.Call) and _call_tail(v) in (
                    "build_layer", "build_layer_stack"):
                built |= set(targets)
                continue
            is_raw = isinstance(v, ast.Call) and (
                (isinstance(v.func, ast.Attribute)
                 and v.func.attr in ("apply", "forward"))
                or (isinstance(v.func, ast.Name) and v.func.id in built))
            if is_raw:
                for t in targets:
                    raw[t] = node.lineno
            elif isinstance(v, ast.Call) and _call_tail(v) == "as_tuple":
                for t in targets:
                    rewrapped.setdefault(t, []).append(node.lineno)
            else:
                for t in targets:
                    raw.pop(t, None)
        if not raw:
            continue
        for node in _own_nodes(fn):
            if not isinstance(node, ast.Starred):
                continue
            v = node.value
            if not isinstance(v, ast.Name):
                continue
            if v.id in raw and node.lineno > raw[v.id]:
                wraps = [ln for ln in rewrapped.get(v.id, [])
                         if raw[v.id] < ln <= node.lineno]
                if not wraps:
                    out.append(ctx.finding(
                        "SKY008", node,
                        f"`*{v.id}` star-unpacks a raw layer result "
                        f"(assigned line {raw[v.id]}) — a tensor output "
                        f"would iterate its batch axis",
                        f"thread `{v.id} = as_tuple({v.id})` first "
                        f"(builder.layer_stack.as_tuple)",
                    ))
    return out


RULES = {
    "SKY001": _rule_sky001,
    "SKY002": _rule_sky002,
    "SKY003": _rule_sky003,
    "SKY005": _rule_sky005,
    "SKY006": _rule_sky006,
    "SKY007": _rule_sky007,
    "SKY008": _rule_sky008,
}

#: the reference's rule ids with no counterpart here, and why (the CLI
#: accepts them in --select/--ignore; they find nothing)
NO_COUNTERPART = {
    "SKY004": "eager PyTorch donates no buffer: every op's inputs stay "
              "valid after it returns, so a read after a call is never "
              "a read of a freed buffer",
}


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------


def _suppressions(source: str):
    """(per-line {line: set|None}, file-level set).  None = all rules.

    Directives are read from real COMMENT tokens only (tokenize, not a
    raw line scan): a docstring or string literal that merely *mentions*
    the suppression syntax — documentation, test fixtures, this module's
    own docstring — must not silently disable rules and defeat the
    ``--strict`` gate.
    """
    import io
    import tokenize

    per_line: Dict[int, Optional[Set[str]]] = {}
    file_level: Set[str] = set()
    try:
        tokens = list(tokenize.generate_tokens(
            io.StringIO(source).readline
        ))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return per_line, file_level  # unparseable -> SKY000 anyway
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


def lint_source(source: str, path: str = "<string>",
                config: Optional[LintConfig] = None) -> List[Finding]:
    """Lint one source string; returns findings (suppressed ones only
    when the config asks for them)."""
    config = config or LintConfig()
    lines = source.splitlines()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [Finding(
            rule="SKY000", path=path, line=exc.lineno or 1,
            col=exc.offset or 0,
            message=f"file does not parse: {exc.msg}",
            fixit="fix the syntax error — unparseable files cannot be "
                  "linted and must not pass a lint gate",
        )]
    ctx = _Ctx(tree, path, lines)
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
    # stable order, dedup identical (rule, line, message) repeats
    seen = set()
    unique = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        key = (f.rule, f.line, f.message)
        if key not in seen:
            seen.add(key)
            unique.append(f)
    return unique


def lint_file(path: str,
              config: Optional[LintConfig] = None) -> List[Finding]:
    try:
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
    except (OSError, UnicodeDecodeError) as exc:
        # same contract as a syntax error: a file the gate cannot read
        # (non-UTF8, dangling symlink) must fail as SKY000, not crash
        # the linter mid-run with a raw traceback
        return [Finding(
            rule="SKY000", path=path, line=1, col=0,
            message=f"file cannot be read: {exc}",
            fixit="fix the encoding or the path — unreadable files "
                  "cannot be linted and must not pass a lint gate",
        )]
    return lint_source(source, path, config)


def lint_paths(paths: Sequence[str],
               config: Optional[LintConfig] = None) -> List[Finding]:
    """Lint files and/or directory trees.

    Directories are walked for ``*.py`` (caches skipped); an explicitly
    named FILE is always linted regardless of extension — a mistyped
    gate target must fail loudly (SKY000 on an unparseable file), not
    report clean.
    """
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
        out += lint_file(f, config)
    return out


__all__ = ["Finding", "LintConfig", "NO_COUNTERPART", "RULES", "lint_source",
           "lint_file", "lint_paths"]
