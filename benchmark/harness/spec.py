"""Find a cell's configuration, traffic and metrics by name.

``BENCHMARK.json`` names the cells; each cell's traffic file is
``benchmark/traffic/<cell>.json`` and its configuration the file its
``configs`` entry names.  A per-layer metric is ``benchmark/metrics/
<metric>.py``, a loop kind ``benchmark/loops/<loop>.py``.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List

ROOT = Path(__file__).resolve().parents[2]


def load_json(path: Path) -> Any:
    with open(path) as fh:
        return json.load(fh)


def reported_for(metric: Dict, cell: str, e2e_names: Dict[str, List[str]]
                 ) -> bool:
    """True when ``metric`` is reported in ``cell``: listed under its
    ``workloads``, or, without that key, for an end-to-end metric in every
    cell and for a per-layer metric in every cell that reports the
    end-to-end metric it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_names.get(cell, [])
    return True


def load_cell(name: str, root: Path = ROOT) -> Dict[str, Any]:
    """The cell ``name`` with its configuration, traffic and metrics."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config_entry = configs[cell["config"]]
    e2e_names = {
        w: [m["name"] for m in bench["end_to_end"]
            if reported_for(m, w, {})]
        for w in cells
    }
    return dict(
        cell=cell,
        config_entry=config_entry,
        config=load_json(root / config_entry["file"]),
        traffic=load_json(root / "benchmark" / "traffic"
                          / f"{cell['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"]
                    if reported_for(m, name, e2e_names)],
        per_layer=[m for m in bench["per_layer"]
                   if reported_for(m, name, e2e_names)],
        run_seconds=bench["run_seconds"],
    )


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module called ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_loop(loop: str, root: Path = ROOT):
    return load_module(root / "benchmark" / "loops" / f"{loop}.py",
                       f"bench_loop_{loop}")


def load_metric(name: str, root: Path = ROOT):
    safe = name.replace(".", "_").replace("-", "_")
    return load_module(root / "benchmark" / "metrics" / f"{name}.py",
                       f"bench_metric_{safe}")


@dataclass
class RunArgs:
    """What a loop gets: the cell's files, the run's seed, window and
    trace flag, the device, where to write, and the process's start on
    ``time.perf_counter``'s clock."""

    cell: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: Any
    out_dir: Path
    t_start: float
