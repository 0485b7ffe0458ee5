"""Classification metrics for GLUE-style evaluation (the port's own copy
of ``skycomputing_tpu/ops/metrics.py``; numpy only): accuracy (MNLI,
SST-2), F1 (MRPC) and Matthews correlation (CoLA).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def accuracy(predictions, labels) -> float:
    predictions = np.asarray(predictions)
    labels = np.asarray(labels)
    return float((predictions == labels).mean()) if len(labels) else float("nan")


def f1_score(predictions, labels, positive: int = 1) -> float:
    predictions = np.asarray(predictions)
    labels = np.asarray(labels)
    tp = int(((predictions == positive) & (labels == positive)).sum())
    fp = int(((predictions == positive) & (labels != positive)).sum())
    fn = int(((predictions != positive) & (labels == positive)).sum())
    if 2 * tp + fp + fn == 0:
        return float("nan")
    return 2 * tp / (2 * tp + fp + fn)


def matthews_corrcoef(predictions, labels) -> float:
    predictions = np.asarray(predictions)
    labels = np.asarray(labels)
    tp = int(((predictions == 1) & (labels == 1)).sum())
    tn = int(((predictions == 0) & (labels == 0)).sum())
    fp = int(((predictions == 1) & (labels == 0)).sum())
    fn = int(((predictions == 0) & (labels == 1)).sum())
    denom = np.sqrt(
        float(tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)
    )
    if denom == 0:
        return 0.0
    return float((tp * tn - fp * fn) / denom)


TASK_METRICS: Dict[str, Dict] = {
    "mnli": {"accuracy": accuracy},
    "sst-2": {"accuracy": accuracy},
    "mrpc": {"accuracy": accuracy, "f1": f1_score},
    "cola": {"matthews": matthews_corrcoef},
}


def compute_task_metrics(task: str, predictions, labels) -> Dict[str, float]:
    fns = TASK_METRICS.get(task.lower(), {"accuracy": accuracy})
    return {name: fn(predictions, labels) for name, fn in fns.items()}


__all__ = [
    "accuracy",
    "f1_score",
    "matthews_corrcoef",
    "TASK_METRICS",
    "compute_task_metrics",
]
