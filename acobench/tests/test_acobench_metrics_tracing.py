"""The readers of the program's own spans and counters
(``acobench/spans.py``): each reads nothing on an empty report or a program
without the tracer, and the value it should on a synthetic report; each
new metric is reported by the cells it names."""
from __future__ import annotations

import json

import pytest

from acobench_tiny import ROOT

NEW = ["prologue_ms.solve", "heuristic_host_ms.solve", "heuristic_glue_ms.solve",
       "k5_roofline_pct.solve", "k5_roofline_pct.train", "ls_scans_per_tour.solve",
       "ls_scans_per_tour.train", "heuristic_ms.train", "heuristic_host_ms.train",
       "optimizer_ms.train", "optimizer_host_ms.train"]

# 4 requests or steps; K5: 2 calls of 16 instances, 320 tours, n 500
NLS = {"nls.calls": 2, "nls.instances": 32, "nls.tours": 640, "nls.n": 1000,
       "nls.euclid_scans": 6400, "nls.metric_scans": 3200, "nls.moves": 5000}


def _span(count, host, device=None, counters=None):
    return {"count": count, "host_ms": host, "self_host_ms": host, "device_ms": device,
            "self_device_ms": device, "counters": counters or {}}


SYNTHETIC = {
    "request": _span(4, 100.0, 98.0), "step": _span(4, 400.0, 390.0),
    "request.prologue": _span(4, 6.0, 5.0),
    "heuristic": _span(8, 48.0, 40.0), "heuristic.k1": _span(4, 1.0, 22.0),
    "local_search": _span(4, 80.0, 78.0, NLS), "optimizer": _span(4, 120.0, 20.0),
}
K5_S = 0.5                     # K5's device seconds in the profiled stretch


def _want(name):
    from acobench.work import least_ms, ls_work

    k5 = 100.0 * least_ms(ls_work(500, 32, 20, 6400, 2 * 32 * 500 * 500)) / (K5_S * 1e3)
    return {"prologue_ms.solve": 1.5, "heuristic_host_ms.solve": 12.0,
            "heuristic_glue_ms.solve": 4.5, "k5_roofline_pct.solve": k5,
            "k5_roofline_pct.train": k5, "ls_scans_per_tour.solve": 15.0,
            "ls_scans_per_tour.train": 15.0, "heuristic_ms.train": 10.0,
            "heuristic_host_ms.train": 12.0, "optimizer_ms.train": 5.0,
            "optimizer_host_ms.train": 30.0}[name]


def _ctx():
    return {"profile": {"kernel_s": {"K5": K5_S}}, "requests": 4, "steps": 4}


@pytest.fixture
def report(monkeypatch):
    from deepaco_tpu_torch.utils import metrics

    def use(rep):
        monkeypatch.setattr(metrics, "report", lambda: rep)

    return use


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_nothing_on_an_empty_report(name, report):
    from acobench.spec import reader

    report({})
    assert reader(name)(_ctx()) is None
    report({"request": _span(0, 0.0), "step": _span(0, 0.0)})
    assert reader(name)(_ctx()) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_nothing_from_a_program_without_the_tracer(name, monkeypatch):
    from acobench.spec import reader
    from deepaco_tpu_torch.utils import metrics

    monkeypatch.delattr(metrics, "report")
    assert reader(name)(_ctx()) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_a_synthetic_report(name, report):
    from acobench.spec import reader

    report(SYNTHETIC)
    assert reader(name)(_ctx()) == pytest.approx(_want(name), rel=1e-12)


def test_the_k5_roofline_reads_nothing_without_k5_time(report):
    from acobench.spec import reader

    report(SYNTHETIC)
    assert reader("k5_roofline_pct.solve")({"profile": {"kernel_s": {}}}) is None


def test_new_metrics_are_entries_reported_by_their_cells():
    from acobench.spec import cell_spec

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    assert list(entries)[-len(NEW):] == NEW
    for name in NEW:
        m = entries[name]
        assert m["source"] in ("program_span", "program_counter")
        for cell in m["workloads"]:
            spec = cell_spec(cell)
            assert name in {p["name"] for p in spec["per_layer"]}
            assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
