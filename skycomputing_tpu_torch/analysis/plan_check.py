"""Pre-flight plan verifier: reject a bad allocation before the first
step (the port of ``skycomputing_tpu/analysis/plan_check.py``).

The paper's loop — benchmark, solve a layer->device allocation, commit a
long run to it — makes late failure the expensive failure mode: a stage
boundary that does not type-check or an over-budget slice surfaces
minutes into a launch, or hours in, at the first re-allocation.
Everything checked here is checked *abstractly*: each unit is built on
PyTorch's ``meta`` device and run forward on ``meta`` tensors (shapes
and dtypes, no storage, no arithmetic), where the reference runs
``jax.eval_shape``.

Checks (codes, severities and message text as in the reference)
------
- **coverage / contiguity**: the workers' layer slices tile the model
  config exactly — no gaps, overlaps, or shuffled content;
- **stage-boundary agreement** (``shapes``): every layer accepts the
  shapes and dtypes the previous layer produces (per-layer threading,
  deduped by (canonical config, input signature) in
  ``_LAYER_TRACE_CACHE``);
- **memory fit**: per-stage static memory (the estimator's formula:
  inputs + 2x outputs + ``param_scale`` x params at 4 bytes) against
  each worker's configured ``mem_limit`` budget;
- **donation**: in the reference, the stage vjp's input cotangents
  alias the stage inputs (``donate_argnums``).  PyTorch donates no
  buffers; what crosses a stage boundary backwards is the gradient
  ``StageRuntime.backward`` returns for each floating input.  So here
  the check runs ``torch.autograd.grad`` through each stage's first
  unit on ``meta`` and requires a gradient of each floating input's
  shape and dtype (an input the unit does not use gets ``None``, which
  the engine hands across as "no cotangent").  The code stays
  ``donation`` so that both packages' reports compare equal.

A shape diagnostic ends in ``{type}: {text}`` of PyTorch's own
exception, where the reference's ends in JAX's.

Not ported yet: ``verify_plan(serving=...)`` (queue A item 1, serving
allocation); ``verify_allocation_payload`` (item 3, elastic),
``verify_mesh_payload`` (item 3, mesh); ``verify_scale_payload``,
``verify_handoff_payload``, ``verify_fault_plan`` and
``verify_tuning_knobs`` (item 4, the planes that call them).

Wiring: ``Runner`` runs :func:`verify_pipeline` on its first batch before
the first train step and again after a self-heal rebuild; the bench
verifies each allocation before building its pipeline.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..builder import as_tuple, build_layer


# --------------------------------------------------------------------------
# report model
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class PlanIssue:
    """One verifier diagnostic."""

    code: str       # coverage | shape | memory | donation
    severity: str   # error | warning | info
    message: str

    def format(self) -> str:
        return f"[{self.severity}] plan-check/{self.code}: {self.message}"


class PlanError(RuntimeError):
    """Raised when a plan fails verification; carries every diagnostic."""

    def __init__(self, issues: Sequence[PlanIssue]):
        self.issues = list(issues)
        lines = [i.format() for i in self.issues]
        super().__init__(
            "allocation plan failed pre-flight verification:\n  "
            + "\n  ".join(lines)
        )


@dataclass
class PlanReport:
    """Outcome of one verification run."""

    issues: List[PlanIssue] = field(default_factory=list)
    checks: List[str] = field(default_factory=list)
    elapsed_s: float = 0.0
    stages: int = 0
    layers: int = 0

    @property
    def ok(self) -> bool:
        return not self.errors

    @property
    def errors(self) -> List[PlanIssue]:
        return [i for i in self.issues if i.severity == "error"]

    @property
    def warnings(self) -> List[PlanIssue]:
        return [i for i in self.issues if i.severity == "warning"]

    def raise_if_failed(self) -> None:
        if not self.ok:
            raise PlanError(self.errors + self.warnings)

    def summary(self) -> str:
        state = "ok" if self.ok else f"{len(self.errors)} error(s)"
        return (
            f"plan-check {state}: {self.stages} stages / {self.layers} "
            f"layers, checks=[{', '.join(self.checks)}], "
            f"{len(self.warnings)} warning(s), {self.elapsed_s:.3f}s"
        )


# --------------------------------------------------------------------------
# abstract tracing helpers (all on ``meta`` — no storage, no arithmetic)
# --------------------------------------------------------------------------


def _canon(cfg: Dict) -> str:
    return json.dumps(cfg, sort_keys=True, default=str)


def _meta(x) -> torch.Tensor:
    """An empty ``meta`` tensor of ``x``'s shape and dtype."""
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    x = np.asarray(x)
    dtype = torch.from_numpy(np.empty(0, x.dtype)).dtype
    return torch.empty(x.shape, dtype=dtype, device="meta")


def _avals(inputs) -> Tuple[torch.Tensor, ...]:
    """The abstract values of ``inputs``: one ``meta`` tensor per leaf."""
    return tuple(_meta(x) for x in as_tuple(inputs))


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's spelling (``float32``, ``bfloat16``), as the reference
    prints its avals."""
    return str(dtype).replace("torch.", "")


def _fmt(a: torch.Tensor) -> str:
    return f"{tuple(a.shape)}:{_dtype_name(a.dtype)}"


def _sig(avals) -> Tuple:
    return tuple((tuple(a.shape), str(a.dtype)) for a in avals)


def _mb(shapes) -> float:
    total = 0.0
    for shape in shapes:
        n = float(np.prod(shape)) if len(shape) else 1.0
        total += n * 4.0
    return total / 1024.0**2


def _layer_module(cfg: Dict) -> torch.nn.Module:
    c = dict(cfg)
    layer_type = c.pop("layer_type")
    with torch.device("meta"):
        return build_layer(layer_type, **c)


def _exc_line(exc: Exception) -> str:
    """First line of an exception message ('' -> the type alone)."""
    lines = str(exc).splitlines()
    return lines[0] if lines else "(no message)"


def _trace_layer(cfg: Dict, avals):
    """(out_avals, (in_mb, out_mb, params_mb), module), abstractly: the
    unit built on ``meta`` (train mode, as a stage runs it) and run on
    ``meta`` tensors.  Memory is returned as raw components so the
    cached trace stays valid for any ``param_scale`` (the estimator
    formula is applied at lookup)."""
    module = _layer_module(cfg)
    with torch.no_grad():
        out = module(*avals)
    out_avals = tuple(_meta(o) for o in as_tuple(out))
    params = [tuple(p.shape) for p in module.parameters()]
    mem_parts = (_mb([tuple(a.shape) for a in avals]),
                 _mb([tuple(a.shape) for a in out_avals]), _mb(params))
    return out_avals, mem_parts, module


def _layer_mem_mb(mem_parts, param_scale: int) -> float:
    """The estimator formula: inputs + 2x outputs + scale x params."""
    in_mb, out_mb, params_mb = mem_parts
    return in_mb + 2.0 * out_mb + float(param_scale) * params_mb


def _trace_layer_cotangents(module, in_avals) -> List[Optional[Any]]:
    """The input gradients of one unit's backward, on ``meta``: one per
    input, ``None`` for an integer input or one the unit does not use.

    A stage's input-cotangent signature is fixed by its FIRST unit (the
    chain rule only threads cotangents through it), so the check runs
    per distinct (unit, input signature) — a handful of backward passes
    instead of one per stage.
    """
    xs = tuple(
        torch.empty(a.shape, dtype=a.dtype, device="meta").requires_grad_(
            a.dtype.is_floating_point)
        for a in in_avals
    )
    wanted = [x for x in xs if x.requires_grad]
    with torch.enable_grad():
        outs = [o for o in as_tuple(module(*xs))
                if isinstance(o, torch.Tensor) and o.requires_grad]
        grads = iter(
            torch.autograd.grad(outs, wanted,
                                grad_outputs=[torch.ones_like(o)
                                              for o in outs],
                                allow_unused=True)
            if outs and wanted else [None] * len(wanted)
        )
    return [next(grads) if x.requires_grad else None for x in xs]


# trace caches are module-global: meta tensors and meta modules only (no
# storage), keyed by (canonical layer config, input signature).  A bench
# run verifies many allocations of the same model and a healed trainer
# re-verifies the same structures.
_LAYER_TRACE_CACHE: Dict[Tuple, Tuple] = {}
_COTANGENT_CACHE: Dict[Tuple, Any] = {}


# --------------------------------------------------------------------------
# core verification
# --------------------------------------------------------------------------


def _stage_workers(worker_manager) -> List[Any]:
    """Rank-sorted workers with a non-empty layer slice (the stages)."""
    return sorted(
        (w for w in worker_manager.worker_pool if w.model_config),
        key=lambda w: w.rank,
    )


def _worker_slice(worker, start: int, end: int) -> Dict:
    """One slice record for a worker: label + bounds + budget.  The
    single place that maps ``extra_config['mem_limit']`` to a verifier
    budget (<=0 / absent means "no budget configured")."""
    mem_limit = worker.extra_config.get("mem_limit") if \
        hasattr(worker, "extra_config") else None
    return dict(
        label=f"worker rank {worker.rank}",
        start=start,
        end=end,
        mem_budget_mb=(
            float(mem_limit)
            if mem_limit is not None and float(mem_limit) > 0
            else None
        ),
    )


def _verify_slices(
    model_cfg: List[Dict],
    slices: List[Dict],
    example_inputs,
    *,
    layer_mem: Optional[Sequence[float]] = None,
    memory: str = "error",
    check_shapes: bool = True,
    check_donation: bool = True,
    param_scale: int = 2,
) -> PlanReport:
    """Shared engine.  ``slices``: dicts with keys ``label`` (e.g.
    'worker rank 3'), ``start``, ``end``, ``mem_budget_mb`` (None = no
    budget configured)."""
    t0 = time.perf_counter()
    report = PlanReport(stages=len(slices), layers=len(model_cfg))
    issues = report.issues

    # ---- shape threading + per-layer memory, deduped by structure
    if layer_mem is not None and len(layer_mem) != len(model_cfg):
        # a profile at the wrong granularity must not crash the verifier
        # (its whole job is precise rejection): flag it and fall back to
        # the traced per-layer estimate
        issues.append(PlanIssue(
            "memory", "error" if memory == "error" else "warning",
            f"layer_mem holds {len(layer_mem)} entries for "
            f"{len(model_cfg)} layers — the memory profile does not "
            f"match this model config; using traced estimates instead"
        ))
        layer_mem = None
    mem_per_layer: List[Optional[float]] = (
        [float(m) for m in layer_mem]
        if layer_mem is not None else [None] * len(model_cfg)
    )
    stage_in_avals: List[Tuple] = []
    stage_out_avals: List[Tuple] = []
    # the donation check consumes the threaded stage avals, so threading
    # runs whenever EITHER abstract check is requested (or memory needs
    # the per-layer estimate); a plan that fails to thread is broken
    # regardless of which check the caller named, so shape errors are
    # always reported
    if check_shapes or check_donation or \
            (memory != "skip" and layer_mem is None):
        if check_shapes:
            report.checks.append("shapes")
        cache = _LAYER_TRACE_CACHE
        avals = _avals(example_inputs)
        aborted = False
        for s in slices:
            stage_in_avals.append(avals)
            for i in range(s["start"], s["end"]):
                cfg = model_cfg[i]
                key = (_canon(cfg), _sig(avals))
                try:
                    if key in cache:
                        out_avals, mem_parts, _module = cache[key]
                    else:
                        cache[key] = _trace_layer(cfg, avals)
                        out_avals, mem_parts, _module = cache[key]
                except Exception as exc:  # trace-time rejection
                    shapes = [_fmt(a) for a in avals]
                    issues.append(PlanIssue(
                        "shape", "error",
                        f"layer {i} "
                        f"({cfg.get('layer_type', '?')}, {s['label']}) "
                        f"rejects the boundary signature "
                        f"[{', '.join(shapes)}] produced by layer "
                        f"{i - 1 if i else 'input'}: "
                        f"{type(exc).__name__}: {_exc_line(exc)}"
                    ))
                    aborted = True
                    break
                if mem_per_layer[i] is None:
                    mem_per_layer[i] = _layer_mem_mb(mem_parts,
                                                     param_scale)
                avals = out_avals
            stage_out_avals.append(avals)
            if aborted:
                break

    # ---- memory fit
    if memory != "skip" and not any(m is None for m in mem_per_layer):
        report.checks.append("memory")
        for s in slices:
            budget = s.get("mem_budget_mb")
            need = float(sum(mem_per_layer[s["start"]:s["end"]]))
            if budget is None:
                continue
            if need > float(budget):
                issues.append(PlanIssue(
                    "memory", "error" if memory == "error" else "warning",
                    f"{s['label']} (layers {s['start']}..{s['end'] - 1}) "
                    f"needs {need:.6g} MB but its budget is "
                    f"{float(budget):.6g} MB "
                    f"({need / float(budget):.2f}x over)"
                ))

    # ---- donation: the gradient each stage hands across its boundary
    if check_donation and len(stage_out_avals) == len(slices) and \
            not report.errors:
        report.checks.append("donation")
        dcache = _COTANGENT_CACHE
        for k, s in enumerate(slices):
            if k == 0:
                # the first stage returns no input cotangents
                # (differentiable_inputs=False): nothing to verify
                continue
            first_cfg = model_cfg[s["start"]]
            in_avals = stage_in_avals[k]
            key = (_canon(first_cfg), _sig(in_avals))
            try:
                if key in dcache:
                    dx = dcache[key]
                else:
                    # the threading loop above (which gates this block)
                    # already built every stage's first unit under
                    # exactly this key
                    _out, _parts, module = _LAYER_TRACE_CACHE[key]
                    dx = _trace_layer_cotangents(module, in_avals)
                    dcache[key] = dx
            except Exception as exc:
                issues.append(PlanIssue(
                    "donation", "error",
                    f"stage {k} ({s['label']}): backward does not "
                    f"abstractly evaluate: {type(exc).__name__}: "
                    f"{_exc_line(exc)}"
                ))
                continue
            for idx, (a, d) in enumerate(zip(in_avals, dx)):
                if not a.dtype.is_floating_point or d is None:
                    continue  # no cotangent crosses for this input
                if tuple(d.shape) != tuple(a.shape) or d.dtype != a.dtype:
                    issues.append(PlanIssue(
                        "donation", "error",
                        f"stage {k} ({s['label']}) input leaf {idx}: "
                        f"donated buffer is {_fmt(a)} "
                        f"but its cotangent is {_fmt(d)} — donation "
                        f"cannot alias (weak-type/dtype drift in the "
                        f"layer's vjp)"
                    ))

    report.elapsed_s = time.perf_counter() - t0
    return report


def verify_plan(
    model_cfg: List[Dict],
    worker_manager,
    example_inputs,
    *,
    layer_mem: Optional[Sequence[float]] = None,
    memory: str = "error",
    check_shapes: bool = True,
    check_donation: bool = True,
    param_scale: int = 2,
    serving: Optional[Dict] = None,
) -> PlanReport:
    """Verify an allocation written onto a ``WorkerManager`` against the
    intended ``model_cfg`` (coverage + contiguity + the abstract checks).

    ``memory``: 'error' | 'warn' | 'skip' — over-budget slices either
    fail the plan, surface as warnings (the bench's even baseline
    deliberately ignores budgets), or are not checked.

    ``serving`` (a serving operating point whose KV slabs count against
    the budgets) belongs to the serving allocation, queue A item 1, and
    raises ``NotImplementedError``.
    """
    if serving is not None:
        raise NotImplementedError(
            "verify_plan(serving=...) is not ported to PyTorch yet (queue "
            "A item 1: serving allocation and multi-stage serving)"
        )
    workers = _stage_workers(worker_manager)
    slices: List[Dict] = []
    issues: List[PlanIssue] = []
    cursor = 0
    for w in workers:
        n = len(w.model_config)
        expected = model_cfg[cursor:cursor + n]
        if [_canon(c) for c in w.model_config] != \
                [_canon(c) for c in expected]:
            got = [c.get("layer_type", "?") for c in w.model_config[:3]]
            want = [c.get("layer_type", "?") for c in expected[:3]]
            issues.append(PlanIssue(
                "coverage", "error",
                f"worker rank {w.rank} holds a slice that is not the "
                f"contiguous layers {cursor}..{cursor + n - 1} of the "
                f"model config (got {got}..., expected {want}...) — "
                f"the partition is shuffled or overlapping"
            ))
        slices.append(_worker_slice(w, cursor, cursor + n))
        cursor += n
    if cursor != len(model_cfg):
        issues.append(PlanIssue(
            "coverage", "error",
            f"the partition covers {cursor} of {len(model_cfg)} layers "
            f"— every layer must be owned by exactly one worker "
            f"(run an allocator, or fix the slice bounds)"
        ))
    if issues:
        # a broken cover makes the downstream checks meaningless
        return PlanReport(
            issues=issues, checks=["coverage"],
            stages=len(slices), layers=len(model_cfg),
        )
    report = _verify_slices(
        model_cfg, slices, example_inputs,
        layer_mem=layer_mem, memory=memory, check_shapes=check_shapes,
        check_donation=check_donation, param_scale=param_scale,
    )
    report.checks.insert(0, "coverage")
    return report


def has_plan(model) -> bool:
    """True when :func:`verify_pipeline` can verify this model type (a
    ``PipelineModel``: it carries a worker manager).  The reference also
    unwraps ``DataParallelPipeline``'s replicas, which wait for queue A
    item 3."""
    return hasattr(model, "_worker_manager")


def verify_pipeline(
    model,
    example_inputs,
    *,
    memory: str = "warn",
    check_donation: bool = True,
    param_scale: int = 2,
) -> PlanReport:
    """Verify a built :class:`~..parallel.pipeline.PipelineModel`'s plan
    (the Runner's entry point).  The INTENDED model config is the
    parameter server's — it was constructed with the ground-truth layer
    list — so this is the full :func:`verify_plan` contract, including
    shuffled/non-contiguous cover detection.  Use :func:`has_plan` to
    test verifiability first."""
    if not has_plan(model):
        raise TypeError(
            "verify_pipeline needs a PipelineModel; got a model with no "
            "worker manager"
        )
    return verify_plan(
        list(model._parameter_server._model_config),
        model._worker_manager, example_inputs,
        memory=memory, check_donation=check_donation,
        param_scale=param_scale,
    )


__all__ = [
    "PlanError",
    "PlanIssue",
    "PlanReport",
    "has_plan",
    "verify_pipeline",
    "verify_plan",
]
