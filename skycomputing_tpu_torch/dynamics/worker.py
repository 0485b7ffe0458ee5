"""Worker value object (the port's own copy of
``skycomputing_tpu/dynamics/worker.py``; stdlib only).

One cluster-node record with rank, name, uuid, pipeline order, running
flag, the assigned layer-config slice, and runtime knobs.  A "worker" is
a logical pipeline stage bound to a device index in the controller's
device list (``device_config.device_index``); ``extra_config`` carries
the stage-runtime knobs (slowdown, mem_limit).
"""

from __future__ import annotations

import uuid as _uuid
from typing import Any, Dict, List, Optional


class Worker:
    def __init__(
        self,
        rank: int,
        name: str,
        device_config: Optional[Dict[str, Any]] = None,
        server_config: Optional[Dict[str, Any]] = None,  # legacy-name alias
        worker_id: Optional[str] = None,
        order: Optional[int] = None,
        model_config: Optional[List[Dict]] = None,
        extra_config: Optional[Dict[str, Any]] = None,
        is_running: bool = False,
        stim_index: Optional[int] = None,
    ) -> None:
        self._rank = rank
        self._name = name
        # stable heterogeneity-profile index: allocation re-ranks workers
        # (``reset_rank_by_order``), so anything keyed by *current* rank —
        # the Stimulator's per-worker slowdown draw — mis-attributes after
        # the first allocate.  Freeze the identity at construction.
        self._stim_index = stim_index if stim_index is not None else rank
        self._is_running = is_running
        self._order = order
        self._worker_id = worker_id if worker_id is not None else str(_uuid.uuid4())
        self._device_config = device_config if device_config is not None else (
            server_config or {}
        )
        self._model_config = model_config
        self._extra_config = extra_config or {}

    # --- identity -----------------------------------------------------------
    @property
    def rank(self) -> int:
        return self._rank

    @rank.setter
    def rank(self, rank: int) -> None:
        self._rank = rank

    @property
    def id(self) -> str:
        return self._worker_id

    @property
    def name(self) -> str:
        return self._name

    @property
    def stim_index(self) -> int:
        """Rank at construction — the stable key for heterogeneity draws."""
        return self._stim_index

    # --- configs ------------------------------------------------------------
    @property
    def device_config(self) -> Dict[str, Any]:
        return self._device_config

    # legacy-name alias kept for reference-config compatibility
    server_config = device_config

    @property
    def device_index(self) -> int:
        return int(self._device_config.get("device_index", 0))

    @property
    def model_config(self) -> Optional[List[Dict]]:
        return self._model_config

    @model_config.setter
    def model_config(self, config: List[Dict]) -> None:
        self._model_config = config

    @property
    def extra_config(self) -> Dict[str, Any]:
        return self._extra_config

    # --- scheduling state ---------------------------------------------------
    @property
    def order(self) -> Optional[int]:
        return self._order

    @order.setter
    def order(self, order: int) -> None:
        self._order = order

    @property
    def is_running(self) -> bool:
        return self._is_running

    @is_running.setter
    def is_running(self, status: bool) -> None:
        self._is_running = status

    # --- transport ----------------------------------------------------------
    def serialize(self) -> Dict[str, Any]:
        return dict(self.__dict__)

    @staticmethod
    def deserialize(data: Dict[str, Any]) -> "Worker":
        kwargs = {k.lstrip("_"): v for k, v in data.items()}
        return Worker(**kwargs)

    def __repr__(self) -> str:  # pragma: no cover
        n_layers = len(self._model_config) if self._model_config else 0
        return (
            f"Worker(rank={self._rank}, name={self._name!r}, "
            f"device={self.device_index}, order={self._order}, "
            f"layers={n_layers})"
        )


__all__ = ["Worker"]
