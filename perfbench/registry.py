"""Finds a cell's configuration, traffic mix, traffic kind and metric
readers by the names BENCHMARK.json and the mix give them, so that a cell,
a configuration, a kind or a metric is added by adding files and entries,
never by editing one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration's file (its `file` entry), with its name."""
    for cfg in bench["configs"]:
        if cfg["name"] == name:
            data = json.loads((root / cfg["file"]).read_text())
            return dict(data, name=name)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, base: Path = HERE) -> dict:
    path = base / "traffic" / f"{name}.json"
    return dict(json.loads(path.read_text()), name=name)


def metrics_for(bench: dict, cell: str, section: str) -> list:
    """The entries of `section` ("end_to_end" or "per_layer") that `cell`
    reports: those without a workloads list, and those whose list names
    it."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


_LOADED: dict = {}


def _module(path: Path, prefix: str):
    """The module of the file at `path`, executed once a process."""
    if path not in _LOADED:
        name = prefix + path.stem.replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _LOADED[path] = module
    return _LOADED[path]


def kind(name: str, base: Path = HERE):
    """kinds/<name>.py: the loop a traffic mix of that kind drives and the
    comparison of what it kept (kinds/__init__.py)."""
    return _module(base / "kinds" / f"{name}.py", "perfbench_kind_")


def reader(name: str, base: Path = HERE):
    """The read(run) function of metrics/<name>.py (end-to-end and
    per-layer metrics alike)."""
    return _module(base / "metrics" / f"{name}.py", "perfbench_metric_").read
