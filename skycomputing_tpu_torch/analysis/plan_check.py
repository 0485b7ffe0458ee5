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

With ``serving=`` (an engine's operating point), each stage's KV slabs
or pages, and on stage 0 a speculative draft's head copy, count against
its budget, and a failed fit names the serving context.
:func:`verify_tuning_knobs` checks a knob-level change (buckets, rows,
page geometry, chunk size, ``spec_k``) with nothing to trace.

:func:`verify_mesh_payload` checks a mesh operating point (chips per
stage, devices, ``tp``, microbatch rows) before the mesh-native engine
takes it.

:func:`verify_allocation_payload` checks a ``realloc.json`` /
``SKYTPU_ALLOCATION`` payload before the elastic rendezvous
(``FileRendezvous.take_payload``) or a supervisor's launch
(``ElasticSupervisor._launch``) passes it on.

Not ported yet: ``verify_scale_payload``, ``verify_handoff_payload`` and
``verify_fault_plan`` (queue A item 4, the planes that call them).

Wiring: ``Runner`` runs :func:`verify_pipeline` on its first batch before
the first train step and again after a self-heal rebuild; the bench
verifies each allocation before building its pipeline; the serving
engine verifies a worker manager's plan under its serving context before
it allocates a slab, and ``reconfigure`` verifies its knobs (and that
plan again) before it changes anything.
"""

from __future__ import annotations

import json
import math
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

    code: str       # coverage | shape | memory | donation | knobs
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


def _serving_kv_profile(
    model_cfg: List[Dict], serving: Dict, issues: List[PlanIssue],
    memory: str,
) -> Optional[List[float]]:
    """Per-layer KV MB for a serving context, or None when the context
    is unusable (a diagnostic is appended).

    ``serving``: the SLOT operating point (``slots`` + ``max_len``,
    both required) or the PAGED one (``num_pages`` + ``page_size``,
    both required, with optional ``max_pages_per_request`` and
    ``kv_dtype``: ``"int8"`` charges the quantized width plus the scale
    slabs through ``serving/paging.paged_pool_mb``, the allocator's own
    formula); plus an optional ``bucket`` (named in diagnostics) and an
    optional explicit ``kv_mb_per_layer`` (one entry per layer; else
    computed from the config by the engine's slab formula).
    """
    severity = "error" if memory == "error" else "warning"
    paged = "num_pages" in serving or "page_size" in serving
    kv_dtype = serving.get("kv_dtype")
    if kv_dtype is not None and not paged:
        issues.append(PlanIssue(
            "memory", severity,
            f"serving kv_dtype={kv_dtype!r} requires the paged "
            f"operating point (num_pages/page_size) — slot slabs store "
            f"the model dtype"
        ))
        return None
    if paged:
        try:
            slots = int(serving["num_pages"])
            max_len = int(serving["page_size"])
        except (KeyError, TypeError, ValueError):
            issues.append(PlanIssue(
                "memory", severity,
                f"paged serving context must carry integer 'num_pages' "
                f"and 'page_size' (got {serving!r}) — cannot account "
                f"for page-pool memory"
            ))
            return None
        if kv_dtype is not None:
            from ..serving.paging import KV_DTYPE_ITEMSIZE

            if str(kv_dtype) not in KV_DTYPE_ITEMSIZE:
                issues.append(PlanIssue(
                    "memory", severity,
                    f"serving kv_dtype {kv_dtype!r} is not a known KV "
                    f"storage dtype ({sorted(KV_DTYPE_ITEMSIZE)}) — "
                    f"cannot account for page-pool memory"
                ))
                return None
    else:
        try:
            slots = int(serving["slots"])
            max_len = int(serving["max_len"])
        except (KeyError, TypeError, ValueError):
            issues.append(PlanIssue(
                "memory", severity,
                f"serving context must carry integer 'slots' and "
                f"'max_len' (got {serving!r}) — cannot account for "
                f"KV-slab memory"
            ))
            return None
    explicit = serving.get("kv_mb_per_layer")
    if explicit is not None:
        # malformed input degrades to a precise diagnostic, never a crash
        if not isinstance(explicit, (list, tuple)):
            issues.append(PlanIssue(
                "memory", severity,
                f"serving kv_mb_per_layer must be a list of per-layer "
                f"MB, got {type(explicit).__name__}"
            ))
            return None
        if len(explicit) != len(model_cfg):
            issues.append(PlanIssue(
                "memory", severity,
                f"serving kv_mb_per_layer holds {len(explicit)} entries "
                f"for {len(model_cfg)} layers — the KV profile does not "
                f"match this model config"
            ))
            return None
        try:
            return [float(m) for m in explicit]
        except (TypeError, ValueError):
            issues.append(PlanIssue(
                "memory", severity,
                f"serving kv_mb_per_layer entries must be numbers, got "
                f"{explicit!r}"
            ))
            return None
    if paged:
        from ..serving.kv_cache import paged_kv_mb_per_layer

        return paged_kv_mb_per_layer(
            model_cfg, slots, max_len,
            kv_dtype=str(kv_dtype) if kv_dtype is not None else None,
        )
    from ..serving.kv_cache import kv_mb_per_layer

    return kv_mb_per_layer(model_cfg, slots, max_len)


def _serving_label(serving: Dict) -> str:
    """The serving operating point as a memory diagnostic names it."""
    bucket = serving.get("bucket")
    try:
        tail = f", bucket {int(bucket)}" if bucket is not None else ""
    except (TypeError, ValueError):
        tail = f", bucket {bucket!r}"
    if "num_pages" in serving or "page_size" in serving:
        mpr = serving.get("max_pages_per_request")
        try:
            span = (
                f", {int(mpr)} pages/request" if mpr is not None else ""
            )
        except (TypeError, ValueError):
            span = f", {mpr!r} pages/request"
        kvd = serving.get("kv_dtype")
        quant = f", {kvd} pages + scale slabs" if kvd is not None else ""
        return (
            f"{int(serving['num_pages'])} KV pages x page_size "
            f"{int(serving['page_size'])}{span}{quant}{tail}"
        )
    return (
        f"{int(serving['slots'])} KV slots x max_len "
        f"{int(serving['max_len'])}{tail}"
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
    serving: Optional[Dict] = None,
) -> PlanReport:
    """Shared engine.  ``slices``: dicts with keys ``label`` (e.g.
    'worker rank 3'), ``start``, ``end``, ``mem_budget_mb`` (None = no
    budget configured).  ``serving`` (optional): the engine's operating
    point — each stage's preallocated KV slabs or pages then count
    against its budget, and memory diagnostics name the context."""
    t0 = time.perf_counter()
    report = PlanReport(stages=len(slices), layers=len(model_cfg))
    issues = report.issues

    kv_per_layer: Optional[List[float]] = None
    if serving is not None:
        kv_per_layer = _serving_kv_profile(model_cfg, serving, issues,
                                           memory)

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
    draft_mb = 0.0
    if serving is not None and serving.get("draft_mb") is not None:
        # the speculative draft's LM-head copy is resident on the FIRST
        # stage (serving/speculative.py): charged there
        try:
            draft_mb = float(serving["draft_mb"])
            if draft_mb < 0:
                raise ValueError
        except (TypeError, ValueError):
            issues.append(PlanIssue(
                "memory", "error" if memory == "error" else "warning",
                f"serving draft_mb must be a non-negative number "
                f"(speculative draft's resident params), got "
                f"{serving['draft_mb']!r}"
            ))
            draft_mb = 0.0
    if memory != "skip" and not any(m is None for m in mem_per_layer):
        report.checks.append("memory")
        for stage_k, s in enumerate(slices):
            budget = s.get("mem_budget_mb")
            need = float(sum(mem_per_layer[s["start"]:s["end"]]))
            kv_need = 0.0
            if kv_per_layer is not None:
                kv_need = float(sum(kv_per_layer[s["start"]:s["end"]]))
                need += kv_need
            draft_need = draft_mb if stage_k == 0 else 0.0
            need += draft_need
            if budget is None:
                continue
            if need > float(budget):
                # a serving failure names its operating point: the fix
                # is usually fewer slots or pages, not another partition
                detail = ""
                if kv_per_layer is not None:
                    detail = (
                        f" (serving {_serving_label(serving)}: "
                        f"preallocated KV slabs are {kv_need:.6g} MB "
                        f"of the need"
                        + (f", speculative draft params "
                           f"{draft_need:.6g} MB"
                           if draft_need else "")
                        + ")"
                    )
                issues.append(PlanIssue(
                    "memory", "error" if memory == "error" else "warning",
                    f"{s['label']} (layers {s['start']}..{s['end'] - 1}) "
                    f"needs {need:.6g} MB but its budget is "
                    f"{float(budget):.6g} MB "
                    f"({need / float(budget):.2f}x over)"
                    f"{detail}"
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

    ``serving``: optional serving operating point (``slots`` and
    ``max_len``, or ``num_pages`` and ``page_size``; optional
    ``bucket``, ``kv_dtype``, ``draft_mb`` and an explicit
    ``kv_mb_per_layer``) — each stage's preallocated KV memory then
    counts against its budget and a failed fit names the serving
    context.  The serving engine runs this before it allocates any slab.
    """
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
        serving=serving,
    )
    report.checks.insert(0, "coverage")
    return report


def _unwrap_model(model):
    """The verifiable ``PipelineModel`` behind ``model``, or None: a
    ``DataParallelPipeline`` is unwrapped to its first replica (every
    replica is built from the same worker manager and parameter server,
    so one replica's plan is the plan)."""
    if hasattr(model, "_worker_manager"):
        return model
    replicas = getattr(model, "replicas", None)
    if replicas and hasattr(replicas[0], "_worker_manager"):
        return replicas[0]
    return None


def has_plan(model) -> bool:
    """True when :func:`verify_pipeline` can verify this model type."""
    return _unwrap_model(model) is not None


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
    shuffled/non-contiguous cover detection.  Replica wrappers are
    unwrapped (see :func:`_unwrap_model`) and verified against the
    per-replica batch shard: each replica sees 1/R of the leading axis.
    Use :func:`has_plan` to test verifiability first."""
    inner = _unwrap_model(model)
    if inner is None:
        raise TypeError(
            "verify_pipeline needs a PipelineModel (or a replica wrapper "
            "around one); got a model with no worker manager"
        )
    if inner is not model:
        num_replicas = len(model.replicas)
        sharded = []
        for a in _avals(example_inputs):
            if not a.shape or a.shape[0] % num_replicas:
                axis = a.shape[0] if a.shape else "(scalar)"
                return PlanReport(
                    issues=[PlanIssue(
                        "shape", "error",
                        f"batch axis {axis} is not divisible by the "
                        f"wrapper's {num_replicas} replicas — "
                        f"_split_replicas will reject this batch at the "
                        f"first step"
                    )],
                    checks=["shapes"],
                    stages=0, layers=0,
                )
            sharded.append(torch.empty(
                (a.shape[0] // num_replicas,) + tuple(a.shape[1:]),
                dtype=a.dtype, device="meta"))
        example_inputs = tuple(sharded)
    model = inner
    return verify_plan(
        list(model._parameter_server._model_config),
        model._worker_manager, example_inputs,
        memory=memory, check_donation=check_donation,
        param_scale=param_scale,
    )


# --------------------------------------------------------------------------
# knob-level verification (the serving engine's reconfigure)
# --------------------------------------------------------------------------


def _pos_int(v) -> bool:
    return (
        not isinstance(v, bool) and isinstance(v, int) and v > 0
    )


def verify_allocation_payload(payload: Any) -> List[str]:
    """Validate a ``realloc.json`` / ``SKYTPU_ALLOCATION`` payload.

    Returns a list of precise problems (empty = valid).  The schema is
    what :class:`~..runner.hooks_collection.selfheal_hook.SelfHealHook`
    stages and the relaunched trainer consumes: ``device_scale`` (stable
    stim_index -> positive finite multiplier) required; optional
    ``measured_stage_times`` (positive finite seconds), ``epoch`` /
    ``iter`` (non-negative ints), ``serving`` and ``mesh`` (their own
    schemas)."""
    def finite_pos(v) -> bool:
        # a hand-edited payload can carry an arbitrary-precision JSON
        # integer; float() of a >1e308 int raises OverflowError, which
        # classifies it as not-a-valid-multiplier instead of crashing
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return False
        try:
            f = float(v)
        except OverflowError:
            return False
        return math.isfinite(f) and f > 0

    problems: List[str] = []
    if not isinstance(payload, dict):
        return [
            f"allocation payload must be a JSON object, got "
            f"{type(payload).__name__}"
        ]
    scales = payload.get("device_scale")
    if scales is None:
        problems.append(
            "missing required key 'device_scale' "
            "({stim_index: speed multiplier})"
        )
    elif not isinstance(scales, dict):
        problems.append(
            f"'device_scale' must be an object, got "
            f"{type(scales).__name__}"
        )
    else:
        for k, v in scales.items():
            try:
                int(k)
            except (TypeError, ValueError):
                problems.append(
                    f"device_scale key {k!r} is not a stable worker "
                    f"index (must parse as int)"
                )
            if not finite_pos(v):
                problems.append(
                    f"device_scale[{k!r}] = {v!r} is not a positive "
                    f"finite speed multiplier"
                )
    times = payload.get("measured_stage_times")
    if times is not None:
        if not isinstance(times, list):
            problems.append(
                f"'measured_stage_times' must be a list, got "
                f"{type(times).__name__}"
            )
        else:
            for i, t in enumerate(times):
                if not finite_pos(t):
                    problems.append(
                        f"measured_stage_times[{i}] = {t!r} is not a "
                        f"positive finite duration"
                    )
    for key in ("epoch", "iter"):
        v = payload.get(key)
        if v is not None and (
                isinstance(v, bool) or not isinstance(v, int) or v < 0):
            problems.append(
                f"'{key}' must be a non-negative int, got {v!r}"
            )
    serving = payload.get("serving")
    if serving is not None:
        problems.extend(_verify_serving_payload(serving))
    mesh = payload.get("mesh")
    if mesh is not None:
        problems.extend(verify_mesh_payload(mesh))
    return problems


def verify_mesh_payload(mesh: Any) -> List[str]:
    """Problems with a mesh operating point (empty = valid).

    Schema — what ``Allocator.mesh_allocate`` emits and the mesh-native
    engine consumes: ``chips_per_stage`` (required, non-empty list of
    positive ints — one sub-mesh width per pipeline stage),
    ``num_devices`` (required, positive int; the chips must fit:
    ``sum(chips_per_stage) <= num_devices``), optional ``tp`` (positive
    int dividing every stage's chips — each sub-mesh reshapes to
    ``(chips/tp, tp)``), optional ``microbatch_rows`` (positive int;
    every stage's dp = chips/tp must divide it, or the engine rejects
    the very first ``compute_gradients`` AFTER the plan was committed —
    callers that know the live batch shape must pass it so the reshape
    dies at verify time, not mid-training).  This is the
    verify-then-apply contract a mesh reshape passes through before
    ``rebuild()``.
    """
    problems: List[str] = []
    if not isinstance(mesh, dict):
        return [
            f"mesh operating point must be an object, got "
            f"{type(mesh).__name__}"
        ]
    chips = mesh.get("chips_per_stage")
    if not isinstance(chips, list) or not chips:
        problems.append(
            "mesh.chips_per_stage must be a non-empty list of positive "
            f"ints, got {chips!r}"
        )
        chips = []
    for i, k in enumerate(chips):
        if not _pos_int(k):
            problems.append(
                f"mesh.chips_per_stage[{i}] = {k!r} is not a positive int"
            )
    devices = mesh.get("num_devices")
    if not _pos_int(devices):
        problems.append(
            f"mesh.num_devices must be a positive int, got {devices!r}"
        )
    elif chips and all(_pos_int(k) for k in chips) and \
            sum(chips) > devices:
        problems.append(
            f"mesh shape {chips} needs {sum(chips)} chips but "
            f"num_devices is {devices} — the sub-mesh slices must fit "
            f"the global device order"
        )
    tp = mesh.get("tp")
    if tp is not None:
        if not _pos_int(tp):
            problems.append(
                f"mesh.tp must be a positive int, got {tp!r}"
            )
        else:
            for i, k in enumerate(chips):
                if _pos_int(k) and k % tp:
                    problems.append(
                        f"mesh.chips_per_stage[{i}] = {k} is not "
                        f"divisible by tp={tp}"
                    )
    rows = mesh.get("microbatch_rows")
    if rows is not None:
        if not _pos_int(rows):
            problems.append(
                f"mesh.microbatch_rows must be a positive int, got "
                f"{rows!r}"
            )
        else:
            tp_div = tp if _pos_int(tp) else 1
            for i, k in enumerate(chips):
                if not (_pos_int(k) and k % tp_div == 0):
                    continue
                dp = k // tp_div
                if rows % dp:
                    problems.append(
                        f"mesh.chips_per_stage[{i}] gives dp={dp}, "
                        f"which does not divide the {rows} microbatch "
                        f"rows — the engine would reject the first "
                        f"step after this plan committed"
                    )
    return problems


def _verify_serving_payload(serving: Any) -> List[str]:
    """Problems with a serving operating point.

    Slot layout: ``slots`` / ``max_len`` positive ints.  Paged layout
    (any of ``num_pages`` / ``page_size`` / ``max_pages_per_request``
    present): all three positive ints, and the per-request span is
    ``max_pages_per_request x page_size``.  Either way, optional
    ``buckets`` is a strictly increasing list of positive ints none of
    which exceeds the per-request span.
    """
    if not isinstance(serving, dict):
        return [
            f"'serving' must be an object, got {type(serving).__name__}"
        ]
    problems: List[str] = []
    paged = any(
        k in serving
        for k in ("num_pages", "page_size", "max_pages_per_request")
    )
    if paged:
        for key in ("num_pages", "page_size", "max_pages_per_request"):
            v = serving.get(key)
            if not _pos_int(v):
                problems.append(
                    f"serving.{key} must be a positive int (paged KV "
                    f"pool shape), got {v!r}"
                )
        np_, ps, mpr = (
            serving.get("num_pages"), serving.get("page_size"),
            serving.get("max_pages_per_request"),
        )
        if _pos_int(np_) and _pos_int(mpr) and mpr > np_:
            problems.append(
                f"serving.max_pages_per_request {mpr} exceeds "
                f"serving.num_pages {np_} — one request could never "
                f"be charged"
            )
        serving = dict(serving)
        if _pos_int(ps) and _pos_int(mpr):
            serving.setdefault("max_len", ps * mpr)
        kvd = serving.get("kv_dtype")
        if kvd is not None:
            from ..serving.paging import KV_DTYPE_ITEMSIZE

            if not isinstance(kvd, str) or kvd not in KV_DTYPE_ITEMSIZE:
                problems.append(
                    f"serving.kv_dtype {kvd!r} is not a known KV "
                    f"storage dtype ({sorted(KV_DTYPE_ITEMSIZE)}) — "
                    f"the page pool cannot be byte-accounted"
                )
    else:
        for key in ("slots", "max_len"):
            v = serving.get(key)
            if not _pos_int(v):
                problems.append(
                    f"serving.{key} must be a positive int (KV slot "
                    f"pool shape), got {v!r}"
                )
        if serving.get("kv_dtype") is not None:
            problems.append(
                f"serving.kv_dtype {serving['kv_dtype']!r} requires "
                f"the paged operating point — slot slabs store the "
                f"model dtype"
            )
    buckets = serving.get("buckets")
    if buckets is not None:
        if not isinstance(buckets, list) or not buckets:
            problems.append(
                f"serving.buckets must be a non-empty list of prompt "
                f"buckets, got {buckets!r}"
            )
        else:
            for i, b in enumerate(buckets):
                if not _pos_int(b):
                    problems.append(
                        f"serving.buckets[{i}] = {b!r} is not a "
                        f"positive int"
                    )
            ints = [b for b in buckets if _pos_int(b)]
            if ints != sorted(set(ints)):
                problems.append(
                    f"serving.buckets {buckets!r} must be strictly "
                    f"increasing (each prompt pads to the smallest "
                    f"bucket that holds it)"
                )
            max_len = serving.get("max_len")
            if ints and _pos_int(max_len) and ints[-1] > max_len:
                problems.append(
                    f"serving.buckets largest bucket {ints[-1]} "
                    f"exceeds serving.max_len {max_len} — prompts "
                    f"padded past the KV slab depth"
                )
    chunk = serving.get("prefill_chunk")
    if chunk is not None:
        if not _pos_int(chunk):
            problems.append(
                f"serving.prefill_chunk must be a positive int "
                f"(chunked-prefill chunk size), got {chunk!r}"
            )
        elif isinstance(buckets, list):
            ints = [b for b in buckets if _pos_int(b)]
            if ints and chunk not in ints:
                problems.append(
                    f"serving.prefill_chunk {chunk} is not one of "
                    f"serving.buckets {ints} — chunk waves must reuse "
                    f"a bucket's compiled prefill shape"
                )
    sk = serving.get("spec_k")
    if sk is not None and (
            isinstance(sk, bool) or not isinstance(sk, int) or sk < 0):
        problems.append(
            f"serving.spec_k must be a non-negative int (draft tokens "
            f"per speculative tick; 0 disables), got {sk!r}"
        )
    dmb = serving.get("draft_mb")
    if dmb is not None and (
            isinstance(dmb, bool)
            or not isinstance(dmb, (int, float)) or dmb < 0):
        problems.append(
            f"serving.draft_mb must be a non-negative number "
            f"(speculative draft's resident params MB), got {dmb!r}"
        )
    return problems


def verify_tuning_knobs(
    *,
    schedule: Optional[str] = None,
    num_microbatches: Optional[int] = None,
    batch_size: Optional[int] = None,
    buckets: Optional[Sequence[int]] = None,
    max_len: Optional[int] = None,
    num_slots: Optional[int] = None,
    prefill_batch: Optional[int] = None,
    num_pages: Optional[int] = None,
    page_size: Optional[int] = None,
    max_pages_per_request: Optional[int] = None,
    prefill_chunk: Optional[int] = None,
    spec_k: Optional[int] = None,
) -> PlanReport:
    """Pre-flight a knob-level operating-point change (nothing traced).

    Schedule swaps, microbatch counts, bucket sets, row counts, page
    geometry, chunk size and ``spec_k`` change no layer partition; what
    can go wrong is arithmetic (a microbatch count that does not divide
    the batch, a bucket past the cache depth).  Each knob passed is
    checked (code ``knobs``) before the caller applies it; the serving
    engine's ``reconfigure`` calls this first.
    """
    t0 = time.perf_counter()
    issues: List[PlanIssue] = []

    def err(msg: str) -> None:
        issues.append(PlanIssue("knobs", "error", msg))

    if schedule is not None and schedule not in ("gpipe", "1f1b"):
        err(f"unknown schedule {schedule!r}; use 'gpipe' or '1f1b'")
    if num_microbatches is not None:
        if not _pos_int(num_microbatches):
            err(f"num_microbatches must be a positive int, got "
                f"{num_microbatches!r}")
        elif batch_size is not None and batch_size % num_microbatches:
            err(f"microbatch count {num_microbatches} does not divide "
                f"batch size {batch_size} — a ragged split would "
                f"silently drop examples")
    if num_slots is not None and not _pos_int(num_slots):
        err(f"num_slots must be a positive int, got {num_slots!r}")
    if prefill_batch is not None and not _pos_int(prefill_batch):
        err(f"prefill_batch must be a positive int, got {prefill_batch!r}")
    for name, v in (("num_pages", num_pages), ("page_size", page_size),
                    ("max_pages_per_request", max_pages_per_request)):
        if v is not None and not _pos_int(v):
            err(f"{name} must be a positive int, got {v!r}")
    if (_pos_int(num_pages) and _pos_int(max_pages_per_request)
            and max_pages_per_request > num_pages):
        err(f"max_pages_per_request {max_pages_per_request} exceeds "
            f"num_pages {num_pages} — one request could never be "
            f"charged")
    if prefill_chunk is not None:
        if not _pos_int(prefill_chunk):
            err(f"prefill_chunk must be a positive int (the chunked-"
                f"prefill chunk size in tokens), got {prefill_chunk!r}")
        elif buckets is not None:
            well_formed = [b for b in buckets if _pos_int(b)]
            if well_formed and prefill_chunk not in well_formed:
                err(f"prefill_chunk {prefill_chunk} is not one of the "
                    f"buckets {sorted(set(well_formed))} — chunk waves "
                    f"must reuse a bucket's compiled prefill shape")
    if spec_k is not None:
        if isinstance(spec_k, bool) or not isinstance(spec_k, int) \
                or spec_k < 0:
            err(f"spec_k must be a non-negative int (draft tokens per "
                f"speculative tick; 0 disables), got {spec_k!r}")
        elif _pos_int(max_len) and spec_k + 1 > max_len:
            err(f"spec_k {spec_k} needs a verify window of "
                f"{spec_k + 1} positions, more than max_len {max_len}")
    if (_pos_int(page_size) and _pos_int(max_pages_per_request)
            and max_len is None):
        # the paged per-request span IS the bucket bound
        max_len = page_size * max_pages_per_request
    if buckets is not None:
        # a max_len fallback from the WELL-FORMED buckets only: a
        # malformed entry surfaces as a PlanIssue, never a TypeError
        well_formed = [b for b in buckets if _pos_int(b)]
        problems = _verify_serving_payload(
            dict(slots=num_slots if _pos_int(num_slots) else 1,
                 max_len=max_len if _pos_int(max_len) else (
                     max(well_formed) if well_formed else 1),
                 buckets=list(buckets))
        )
        for p in problems:
            err(p)

    return PlanReport(issues=issues, checks=["knobs"],
                      elapsed_s=time.perf_counter() - t0)


__all__ = [
    "PlanError",
    "PlanIssue",
    "PlanReport",
    "has_plan",
    "verify_allocation_payload",
    "verify_mesh_payload",
    "verify_pipeline",
    "verify_plan",
    "verify_tuning_knobs",
]
