"""Static analysis of a plan before it runs (the port of
``skycomputing_tpu/analysis``: the pre-flight plan verifier).  The JAX
package's linters (skylint, skyaudit, skydet) check JAX hazards and are
queue A item 5."""

from .plan_check import (
    PlanError,
    PlanIssue,
    PlanReport,
    has_plan,
    verify_allocation_payload,
    verify_mesh_payload,
    verify_pipeline,
    verify_plan,
    verify_tuning_knobs,
)

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
