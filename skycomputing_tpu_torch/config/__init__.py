"""Python-file-as-config (the port's own copy of
``skycomputing_tpu/config``; stdlib only).

A ``.py`` file is executed and its globals that are not dunders, modules
or classes are harvested into an attribute dict, :class:`Config`.  A
``base = "other.py"`` global (a path relative to the file) names a
config whose values the file's own override, one level deep.
"""

from __future__ import annotations

import importlib.util
import inspect
import os.path as osp
import sys
from typing import Any, Dict


class Config(dict):
    """Dict whose values are also reachable as attributes."""

    def __missing__(self, name):
        raise KeyError(name)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def update(self, config: Dict) -> "Config":  # type: ignore[override]
        for k, v in config.items():
            self[k] = v
        return self

    @staticmethod
    def from_dict(data: Dict) -> "Config":
        cfg = Config()
        cfg.update(data)
        return cfg


def _py_to_dict(py_path: str) -> Dict[str, Any]:
    """Execute a python file and harvest its plain-value globals."""
    if not py_path.endswith(".py"):
        raise ValueError(f"config file must be a .py file, got {py_path!r}")

    py_path = osp.abspath(py_path)
    parent_dir = osp.dirname(py_path)
    inserted = parent_dir not in sys.path
    if inserted:
        sys.path.insert(0, parent_dir)

    module_name = "_skytpu_torch_config_" + osp.splitext(
        osp.basename(py_path))[0]
    try:
        spec = importlib.util.spec_from_file_location(module_name, py_path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        if inserted:
            sys.path.remove(parent_dir)

    return {
        k: v
        for k, v in vars(module).items()
        if not k.startswith("__")
        and not inspect.ismodule(v)
        and not inspect.isclass(v)
    }


def load_config(file_path: str) -> Config:
    """Load a python config file, honoring a ``base = "other.py"`` field."""
    config = Config.from_dict(_py_to_dict(file_path))
    base = config.pop("base", None)
    if base:
        base_path = osp.join(osp.dirname(osp.abspath(file_path)), base)
        base_config = Config.from_dict(_py_to_dict(base_path))
        config = base_config.update(config)
    return config


__all__ = ["Config", "load_config"]
