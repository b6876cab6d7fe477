"""What a run reads: ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, cell, metric
or kernel lives in a file of its own, found by its name:
``acobench/configs/<config>.json``, ``acobench/traffic/<traffic>.json``,
``acobench/workloads/<cell>.json``, ``acobench/metrics/<metric>.py`` and
``acobench/kernels/<kernel>.json`` (with the ``.py`` its ``work`` names).
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def root() -> Path:
    """The checkout: the directory that holds ``BENCHMARK.json``."""
    return HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A Python file of the benchmark loaded by its path (metric names hold
    dots, so they are not importable by name)."""
    spec = importlib.util.spec_from_file_location(f"acobench_file_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_spec(cell: str) -> dict:
    """The cell's entries: its workload entry, configuration, traffic and
    cell files, its end-to-end and per-layer metrics, and its kernels."""
    bench = load_json(root() / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if cell not in entries:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    entry = entries[cell]
    config_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    workload = load_json(HERE / "workloads" / f"{cell}.json")
    kernels = {name: load_json(HERE / "kernels" / f"{name}.json")
               for name in workload.get("kernels", [])}
    return {
        "name": cell,
        "entry": entry,
        "chips": entry["chips"],
        "config": load_json(root() / config_entry["file"]),
        "traffic": load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        "workload": workload,
        "end_to_end": [m for m in bench["end_to_end"] if _applies(m, cell)],
        "per_layer": [m for m in bench["per_layer"] if _applies(m, cell)],
        "kernels": kernels,
    }


def reader(metric: str):
    """The ``read(ctx)`` of ``acobench/metrics/<metric>.py``."""
    return load_module(HERE / "metrics" / f"{metric}.py").read
