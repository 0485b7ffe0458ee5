"""Name -> constructor registries.

The port's copy of ``skycomputing_tpu/registry/__init__.py``:
string-keyed registries with a ``register_module`` decorator, plus a
fallback namespace so configs can name library layers directly.  The
JAX package falls back to ``flax.linen``; here the fallback is
``torch.nn``, so a config can say e.g. ``Linear`` without an explicit
registration.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    """A name -> class/callable registry with decorator-based registration."""

    def __init__(self, name: str, fallback_module: Any = None):
        self._name = name
        self._registry: Dict[str, Any] = {}
        self._fallback_module = fallback_module

    @property
    def name(self) -> str:
        return self._name

    @property
    def modules(self) -> Dict[str, Any]:
        return dict(self._registry)

    def register_module(self, cls: Optional[Callable] = None, *, name: Optional[str] = None):
        """Register a class/callable. Usable bare or with a ``name=`` override.

        ``@REG.register_module`` or ``@REG.register_module(name="Alias")``.
        """

        def _register(obj: Callable) -> Callable:
            key = name if name is not None else obj.__name__
            if key in self._registry and self._registry[key] is not obj:
                raise KeyError(
                    f"{key!r} is already registered in registry {self._name!r}"
                )
            self._registry[key] = obj
            return obj

        if cls is None:
            return _register
        return _register(cls)

    def register(self, name: str, obj: Any) -> None:
        """Non-decorator registration under an explicit name (aliases)."""
        self._registry[name] = obj

    def get_module(self, name: str) -> Any:
        if name in self._registry:
            return self._registry[name]
        if self._fallback_module is not None and hasattr(self._fallback_module, name):
            return getattr(self._fallback_module, name)
        raise KeyError(
            f"{name!r} is not registered in registry {self._name!r} and no "
            f"fallback provides it"
        )

    def __contains__(self, name: str) -> bool:
        try:
            self.get_module(name)
            return True
        except KeyError:
            return False

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Registry(name={self._name!r}, keys={sorted(self._registry)})"


def _torch_nn():
    import torch.nn as nn

    return nn


class _LazyFallback:
    """Defers the torch.nn import so registry import stays cheap."""

    def __init__(self, loader):
        self._loader = loader
        self._mod = None

    def __getattr__(self, item):
        if self._mod is None:
            self._mod = self._loader()
        return getattr(self._mod, item)

    def __bool__(self):
        return True

    # hasattr() goes through __getattr__; ensure missing names raise AttributeError
    # (getattr on the real module does that for us).


LAYER = Registry("layer", fallback_module=_LazyFallback(_torch_nn))
DATASET = Registry("dataset")
HOOKS = Registry("hooks")
DATA_GENERATOR = Registry("data_generator")
MODEL = Registry("model")
LOSS = Registry("loss")

__all__ = [
    "Registry",
    "LAYER",
    "DATASET",
    "HOOKS",
    "DATA_GENERATOR",
    "MODEL",
    "LOSS",
]
