"""What the program's own tracer recorded in the traced stretch
(``deepaco_tpu_torch.utils.metrics``): its spans by name and its counters.

The tracer records exactly while the profiler does, so its report covers the
profiled stretch and nothing else; each reader divides by the report's own
count of ``request`` (solve) or ``step`` (training) spans. A program without
the tracer, or a report without the span or counter, reads as nothing (None).
"""
from __future__ import annotations

from acobench.work import least_ms, ls_work


def program_report() -> dict:
    """The program's tracer's totals a span name, or ``{}`` where the program
    has no tracer."""
    try:
        from deepaco_tpu_torch.utils import metrics
    except ImportError:
        return {}
    report = getattr(metrics, "report", None)
    return report() if report is not None else {}


def _per(rep: dict, root: str, value) -> float | None:
    roots = rep.get(root, {}).get("count", 0)
    return None if not roots or value is None else value / roots


def per_root(root: str, name: str, field: str) -> float | None:
    """``field`` (``host_ms``, ``device_ms``, ...) of the spans ``name`` over
    the count of ``root`` spans."""
    rep = program_report()
    return _per(rep, root, rep.get(name, {}).get(field))


def device_less_child(root: str, name: str, child: str) -> float | None:
    """Device ms of the spans ``name`` less those of ``child``, over the count
    of ``root`` spans."""
    rep = program_report()
    whole = rep.get(name, {}).get("device_ms")
    part = rep.get(child, {}).get("device_ms")
    return None if whole is None or part is None else _per(rep, root, whole - part)


def nls_counts() -> dict | None:
    """K5's counters (``nls.*``) summed over every span, or None where no
    call was counted."""
    out: dict = {}
    for tot in program_report().values():
        for key, v in tot.get("counters", {}).items():
            if key.startswith("nls."):
                out[key[4:]] = out.get(key[4:], 0) + v
    return out if out.get("calls") and out.get("tours") else None


def scans_per_tour() -> float | None:
    """K5's scans (Euclidean and metric) a tour, a call."""
    c = nls_counts()
    if c is None or "euclid_scans" not in c:
        return None
    return (c["euclid_scans"] + c.get("metric_scans", 0)) / c["tours"]


def k5_roofline_pct(ctx: dict) -> float | None:
    """K5's least time at the Euclidean scans it counted (``ls_work``; a
    metric scan is priced at no pair work, so this is a lower bound of the
    work and of the share) over its device time in the profiled stretch."""
    c = nls_counts()
    t = ctx.get("profile", {}).get("kernel_s", {}).get("K5", 0.0)
    if c is None or not t or "euclid_scans" not in c or not c.get("instances"):
        return None
    b, n = c["instances"], c["n"] / c["calls"]
    work = ls_work(n, b, c["tours"] / b, c["euclid_scans"], 2 * b * n * n)
    return 100.0 * least_ms(work) / (t * 1e3)
