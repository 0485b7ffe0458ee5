"""Static analysis (the port of ``skycomputing_tpu/analysis``): the
pre-flight plan verifier (:mod:`.plan_check`, exported here), and the
port's own linters, each pure stdlib and loaded by file path by its
command: :mod:`.lint` (skylint, eager PyTorch/CUDA hazards),
:mod:`.audit` (skyaudit, the port's layering manifest, locks and counter
types) and :mod:`.determinism` (skydet, the replay planes' determinism
and digest contracts)."""

from .plan_check import (
    PlanError,
    PlanIssue,
    PlanReport,
    has_plan,
    verify_allocation_payload,
    verify_fault_plan,
    verify_handoff_payload,
    verify_mesh_payload,
    verify_pipeline,
    verify_plan,
    verify_scale_payload,
    verify_tuning_knobs,
)

__all__ = [
    "PlanError",
    "PlanIssue",
    "PlanReport",
    "has_plan",
    "verify_allocation_payload",
    "verify_fault_plan",
    "verify_handoff_payload",
    "verify_mesh_payload",
    "verify_pipeline",
    "verify_plan",
    "verify_scale_payload",
    "verify_tuning_knobs",
]
