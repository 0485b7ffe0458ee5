"""The training loop and its hook base (the port of
``skycomputing_tpu/runner``: slice 3 ports ``Hook`` and ``Runner.train``;
the hook collection waits for slice 4)."""

from .hooks import Hook
from .runner import Runner

__all__ = ["Hook", "Runner"]
