"""The benchmark's files: each loads, names and units keep to their
characters, every cell finds its configuration, traffic, cell file, metric
readers and kernels, and the copied work counts reproduce the recorded
least times."""
from __future__ import annotations

import json
import re

import pytest

from acobench_tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
HERE = ROOT / "acobench"


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("folder", ["configs", "traffic", "workloads", "kernels"])
def test_every_json_file_loads(folder):
    files = sorted((HERE / folder).glob("*.json"))
    assert files
    for f in files:
        json.loads(f.read_text())
        assert NAME.match(f.stem), f


def test_every_metric_reader_loads():
    from acobench.spec import reader

    files = sorted((HERE / "metrics").glob("*.py"))
    assert files
    for f in files:
        assert callable(reader(f.stem))


def test_names_and_units():
    b = bench()
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]] \
        + [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in b["workloads"]]:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in b["configs"]:
        for key in c["reduced"]:
            assert NAME.match(key)


def test_every_cell_finds_its_files():
    from acobench.spec import cell_spec, reader

    b = bench()
    moved = {m["name"] for m in b["end_to_end"]}
    for w in b["workloads"]:
        spec = cell_spec(w["name"])
        assert spec["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
        assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
        reports = {m["name"] for m in spec["end_to_end"]}
        for m in spec["per_layer"]:
            assert m["moves"] in moved and m["moves"] in reports, (w["name"], m["name"])
            reader(m["name"])
        for k in spec["kernels"].values():
            assert (ROOT / k["work"]).exists()
        assert spec["workload"]["check"]["limits"]
    for c in b["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert (ROOT / cfg["checkpoint"]).exists()


def test_bounds_keep_to_the_contract():
    b = bench()
    assert 1 <= b["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("kernel, shape, want", [
    # chip_smoke.py's recorded least times at the main path's shapes (PERF.md's kernel table)
    ("K1", {"B": 100, "N": 500, "K": 50, "A": 20, "T": 1, "feats": 2, "layers": 12,
            "units": 32, "ls": None}, 0.5082),
    ("K2", {"B": 100, "N": 500, "K": 50, "A": 20, "T": 1, "feats": 2, "layers": 12,
            "units": 32, "ls": None}, 0.01612),
])
def test_work_counts_reproduce_the_recorded_bounds(kernel, shape, want):
    from acobench.spec import load_module

    got = load_module(HERE / "kernels" / f"{kernel}.py").request_least_ms(shape)
    assert got == pytest.approx(want, rel=5e-4)


def test_k3_work_reproduces_the_recorded_bound():
    from acobench.work import bound, k3_work

    assert bound(*k3_work(100, 500, 20, 2)) == (pytest.approx(0.1070, rel=5e-4), "bytes")
    assert bound(*k3_work(100, 500, 20, 0))[0] < 0.1070
